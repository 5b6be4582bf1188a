"""Serving artifacts through ``torch.export`` (counterpart of
``epnn_tpu/io/export_serving.py``).

An artifact is a directory::

    serving.pt2     the ``torch.export.save`` of the serving forward, the
                    weights in the program as its state
    manifest.json   input signature, model config, dispatch mode,
                    platforms, library versions

A serving process loads it with :func:`load_serving` and calls it without
the model source, the checkpoint or the Predictor's per-call host work
(the coordinate CRC, the neighbor-k cache, the spatial sort): every
static decision is baked in.  The three calling conventions (``mode``)
are the JAX package's:

* ``dense``   — ``f(x, q0, xyz, node_mask) -> q``: the dense model
  (small padded widths, the Predictor's small-molecule path);
* ``blocked`` — the same signature: the neighbor-split forward with the
  selection in the program (top-k, or the cell builder on the baked grid);
* ``md``      — ``f(x, q0, xyz, node_mask, idx, nbr_mask) -> q``: the
  caller supplies the neighbor tables (Verlet-skin MD loops); pair
  distances are gathered from the current coordinates in the program,
  the Predictor's skin step.

Static shapes are part of the artifact: pad inputs to the exported
``(B, N)`` that the manifest carries.

The route.  An artifact holds the hand-written kernels as the registered
operators ``epnn_torch::*`` (:mod:`epnn_tpu_torch.ops.kernels`), which
pick their route by the tensors' device when called: on the card a loaded
artifact launches the far-field and near kernels, each launch counted in
``kernels.LAUNCHES`` as a live call's; on the CPU the operators run their
plain versions.  A single-platform artifact (``cpu`` or ``cuda``) is
traced on that platform's device; a multi-platform one (for example
``("cuda", "cpu")``) on the CPU, and moved to the device it runs on when
loaded.  (JAX's multi-platform export takes its pure-XLA path, as a
Mosaic custom call lowers for one platform; the operators have no such
limit.)

Agreement: ``torch.export`` without a compiler records the aten operators
and kernels the live forward runs, so a loaded artifact gives the live
``Predictor.predict_batch``'s charges on the same device — except where
the live Predictor does what JAX's exporter does not: it cell-sorts the
atoms of graphs of ``infer.CELL_SORT_MIN_ATOMS`` padded atoms and more
(the artifact keeps the caller's order, as JAX's does), which moves
float32 sums at the charge bar, and it chunks the near field of huge
graphs (``near_row_chunk``), which moves nothing.

Departures from the JAX package: loading needs ``epnn_tpu_torch``
installed, for its operators (JAX's needs only ``jax``); the platforms
are ``cpu`` and ``cuda`` (``tpu`` is refused); the manifest names the
format ``epnn_tpu_torch.serving/1`` and carries ``torch_version`` in place
of ``jax_version``.
"""

from __future__ import annotations

import copy
import dataclasses
import io
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

ARTIFACT_FILE = "serving.pt2"
MANIFEST_FILE = "manifest.json"
FORMAT = "epnn_tpu_torch.serving/1"
#: the platforms an artifact can be exported for
PLATFORMS = ("cpu", "cuda")

_SIGNATURES = {
    "dense": ("x", "q0", "xyz", "node_mask"),
    "blocked": ("x", "q0", "xyz", "node_mask"),
    "md": ("x", "q0", "xyz", "node_mask", "idx", "nbr_mask"),
}


class _Slot(int):
    """A weight's place among a program's buffers."""


def _map_leaves(obj, kind, fn):
    """``obj`` (dataclasses, tuples and named tuples of weights) with each
    leaf of type ``kind`` replaced by ``fn(leaf)``."""
    if isinstance(obj, kind):
        return fn(obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _map_leaves(getattr(obj, f.name), kind, fn)
            for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        vals = [_map_leaves(v, kind, fn) for v in obj]
        return type(obj)(*vals) if hasattr(obj, "_fields") else tuple(vals)
    return obj


class _Program(torch.nn.Module):
    """``fn(weights, *inputs)`` as a module whose state is the weights: an
    ``nn.Module`` (the dense model) as a submodule, or a tree of tensors
    (``FusedParams``) as buffers, one per distinct tensor.  Each is a
    copy with a storage of its own (the weights are slices of shared
    storages, which the saved program would not restore apart)."""

    def __init__(self, fn, weights):
        super().__init__()
        self._fn = fn
        self._template = None
        if isinstance(weights, torch.nn.Module):
            self.model = copy.deepcopy(weights).requires_grad_(False)
            for t in [*self.model.parameters(), *self.model.buffers()]:
                t.data = t.data.clone()
            return
        slots: dict = {}

        def slot(t):
            if id(t) not in slots:
                slots[id(t)] = _Slot(len(slots))
                self.register_buffer(f"w{len(slots) - 1}",
                                     t.detach().clone())
            return slots[id(t)]

        self._template = _map_leaves(weights, torch.Tensor, slot)

    def forward(self, *inputs):
        if self._template is None:
            weights = self.model
        else:
            weights = _map_leaves(self._template, _Slot,
                                  lambda s: getattr(self, f"w{s}"))
        return self._fn(weights, *inputs)


def _platforms(pred, platforms) -> tuple:
    if platforms is None:
        return (pred.device.type,)
    platforms = tuple(str(p) for p in platforms)
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad or not platforms:
        raise ValueError(f"platforms {bad or platforms!r}: epnn_tpu_torch "
                         f"exports for {PLATFORMS} ('tpu' artifacts come "
                         "from the JAX package's export)")
    return platforms


def export_predictor(pred, batch, out_dir: str, *,
                     mode: Optional[str] = None,
                     platforms: Optional[Sequence[str]] = None,
                     use_pallas: Optional[bool] = None) -> dict:
    """Export ``pred``'s serving forward for ``batch``'s shapes to
    ``out_dir``; returns the manifest dict.

    ``mode`` defaults to the JAX exporter's dispatch for this batch
    (``dense`` up to :data:`epnn_tpu_torch.infer.DENSE_MAX_ATOMS` padded
    atoms, ``blocked`` above; ``md`` must be asked for and bakes the
    neighbor-table width from the batch's safe k, or the skin tables'
    width in skin mode).  ``platforms``: ``("cpu",)`` or ``("cuda",)``
    (default: the Predictor's device) traces on that device, several
    platforms on the CPU (module docstring).  ``use_pallas`` (default
    ``pred._use_pallas()``) selects the far field's int8 tier as in the
    live call.  The weights, the config and every static serving
    decision (neighbor_k, the cell grid, the round-1 collapse, the
    clustered far-field tier, the int8 constants) are baked in as this
    Predictor would serve them.
    """
    from epnn_tpu_torch.infer import DENSE_MAX_ATOMS
    from epnn_tpu_torch.io.checkpoint import _write_atomic
    from epnn_tpu_torch.ops.fused import forward_blocked

    if mode is None:
        mode = ("dense" if batch.padded_atoms <= DENSE_MAX_ATOMS
                else "blocked")
    if mode not in _SIGNATURES:
        raise ValueError(f"mode must be one of {sorted(_SIGNATURES)}, "
                         f"got {mode!r}")
    if use_pallas is None:
        use_pallas = pred._use_pallas()
    platforms = _platforms(pred, platforms)
    # the device traced on, the weights moved there where they live
    # elsewhere
    device = torch.device(platforms[0] if len(platforms) == 1 else "cpu")

    b, n = batch.x.shape[:2]
    uq0 = bool(pred._uniform_q0(batch))
    block = min(pred.block, batch.padded_atoms)
    cfg = pred.cfg
    far_cluster = int(pred.far_cluster)
    k = grid = None

    if mode == "dense":
        weights = pred._model
        from epnn_tpu_torch.featurize import rbf_edges

        def fn(model, x, q0, xyz, node_mask):
            e = rbf_edges(xyz, node_mask, e_dim=cfg.e_dim,
                          cutoff=cfg.cutoff, eta=cfg.eta)
            return model(x, q0, e, node_mask)
    else:
        weights = pred._fused
        if mode == "blocked":
            k = max(pred._neighbor_k(batch), 1)
            grid = pred._neighbor_grid(batch)

            def fn(fused, x, q0, xyz, node_mask):
                return forward_blocked(
                    fused, x, q0, xyz, node_mask, cfg, block=block,
                    neighbor_k=k, use_pallas=use_pallas, neighbor_grid=grid,
                    uniform_q0=uq0, far_cluster=far_cluster)
        else:  # md
            if pred.neighbor_skin > 0:
                # skin serving: the width of the tables selected at
                # cutoff + skin, the live Predictor's own
                k = int(pred._neighbors_skin(batch)[0].shape[-1])
            else:
                k = max(pred._neighbor_k(batch), 1)

            def fn(fused, x, q0, xyz, node_mask, idx, nbr_mask):
                # the 2-tuple: pair d² from the current xyz in the program
                return forward_blocked(
                    fused, x, q0, xyz, node_mask, cfg, block=block,
                    neighbor_k=int(idx.shape[-1]), use_pallas=use_pallas,
                    neighbors=(idx, nbr_mask), uniform_q0=uq0,
                    far_cluster=far_cluster)

    def tensor(a, dtype=np.float32):
        return torch.as_tensor(np.asarray(a, dtype)).to(device)

    inputs = [tensor(batch.x), tensor(batch.q0), tensor(batch.xyz),
              tensor(batch.node_mask)]
    if mode == "md":
        inputs += [torch.zeros((b, n, k), dtype=torch.int32, device=device),
                   torch.zeros((b, n, k), dtype=torch.float32,
                               device=device)]
    with torch.no_grad():
        program = torch.export.export(_Program(fn, weights).to(device),
                                      tuple(inputs), strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)

    manifest = {
        "format": FORMAT,
        "mode": mode,
        "signature": list(_SIGNATURES[mode]),
        "inputs": [
            {"name": name, "shape": list(t.shape),
             "dtype": str(t.dtype).replace("torch.", "")}
            for name, t in zip(_SIGNATURES[mode], inputs)
        ],
        "output": {"shape": [b, n], "dtype": "float32"},
        "batch_size": b,
        "padded_atoms": n,
        "neighbor_k": k,
        "neighbor_skin": float(getattr(pred, "neighbor_skin", 0.0)),
        "block": block,
        "neighbor_grid": list(grid) if grid else None,
        "uniform_q0": uq0,
        "far_cluster": far_cluster,
        "use_pallas": bool(use_pallas),
        "platforms": list(platforms),
        "config": dataclasses.asdict(cfg),
        "torch_version": torch.__version__,
        "calling_convention": (
            "pad inputs to (batch_size, padded_atoms); output is (B, N) "
            "per-atom charges, rows beyond each molecule's natoms are "
            "padding"),
    }
    os.makedirs(out_dir, exist_ok=True)
    _write_atomic(os.path.join(out_dir, ARTIFACT_FILE), buf.getvalue())
    _write_atomic(os.path.join(out_dir, MANIFEST_FILE),
                  json.dumps(manifest, indent=2), "w")
    return manifest


class ServingArtifact:
    """A loaded serving artifact: ``art(x, q0, xyz, node_mask[, idx,
    nbr_mask]) -> (B, N)`` float32 charges as numpy.

    It runs on :attr:`device` (see :func:`load_serving`); inputs (anything
    ``np.asarray`` takes) are cast to the manifest's dtypes, checked
    against its static shapes and copied there."""

    def __init__(self, program, manifest: dict, device: torch.device):
        self._program = program
        self.manifest = manifest
        self.device = device
        self._call = program.module()

    @property
    def mode(self) -> str:
        return self.manifest["mode"]

    def __call__(self, x, q0, xyz, node_mask, idx=None, nbr_mask=None):
        want = self.manifest["inputs"]
        args = [x, q0, xyz, node_mask]
        if self.mode == "md":
            if idx is None or nbr_mask is None:
                raise ValueError(
                    "md-mode artifact needs (idx, nbr_mask) neighbor tables")
            args += [idx, nbr_mask]
        elif idx is not None:
            raise ValueError(f"{self.mode}-mode artifact takes no neighbor "
                             "tables (selection is in the program)")
        args = [np.asarray(a, dtype=spec["dtype"])
                for a, spec in zip(args, want)]
        for a, spec in zip(args, want):
            if list(a.shape) != spec["shape"]:
                raise ValueError(
                    f"input {spec['name']!r} must have shape "
                    f"{tuple(spec['shape'])} (the artifact's static serving "
                    f"shape — pad to it), got {tuple(a.shape)}")
        with torch.no_grad():
            q = self._call(*[torch.from_numpy(np.ascontiguousarray(a))
                             .to(self.device) for a in args])
        return q.cpu().numpy()


def load_serving(path: str) -> ServingArtifact:
    """Load an artifact directory written by :func:`export_predictor`.

    It runs on the card where the artifact lists ``cuda`` and the process
    has one, else on the CPU where it lists ``cpu``.  Importing the
    port's kernels module registers the ``epnn_torch::*`` operators the
    program names (it compiles nothing; a library builds at its first
    launch)."""
    import epnn_tpu_torch.ops.kernels  # noqa: F401  (the operators)

    with open(os.path.join(path, MANIFEST_FILE)) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT:
        raise ValueError(f"{path}: not an epnn_tpu_torch serving artifact "
                         f"(format={manifest.get('format')!r})")
    platforms = manifest["platforms"]
    device = torch.device("cuda" if "cuda" in platforms
                          and torch.cuda.is_available() else "cpu")
    if device.type not in platforms:
        raise RuntimeError(f"{path}: exported for {platforms}, and this "
                           "process has no CUDA card")
    program = torch.export.load(os.path.join(path, ARTIFACT_FILE))
    if len(platforms) > 1:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, device)
    return ServingArtifact(program, manifest, device)
