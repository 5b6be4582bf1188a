"""High-level inference API (counterpart of ``epnn_tpu/infer.py``):

    predictor = Predictor.from_checkpoint("trained/mixed_b16")   # on the card
    charges = predictor.predict_molecules(mols)          # list of (n_i,)

Dispatch: padded widths up to :data:`DENSE_MAX_ATOMS` run the dense
:class:`~epnn_tpu_torch.models.EPNN` forward; larger graphs run the
neighbor-split blocked forward (:func:`~epnn_tpu_torch.ops.forward_blocked`)
whose hot loops are the CUDA kernels of :mod:`epnn_tpu_torch.ops.kernels`.

Every precision tier of the JAX package serves, with its names: the
config's precision fields pick each kernel's precision
(:mod:`epnn_tpu_torch.models.config`; on the card ``"default"`` is the
kernels' one-pass TF32 tier, ``"high"``/``"highest"`` 3xTF32),
``dense_matmul_precision="bf16x3"`` the split-float far field,
``"int8"`` the far field's int8 serving tier (on the card,
:meth:`Predictor._use_pallas`), and ``compute_dtype="bfloat16"`` the bf16
forward.  Plain products outside the kernels stay full float32 at every
tier: the port sets no TF32 flag (``torch.backends.cuda.matmul.allow_tf32``
stays at PyTorch's default, off).  The charges come back float32.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
import weakref
import zlib
from typing import List, Optional, Sequence

import numpy as np
import torch

from epnn_tpu_torch.data.dataset import (
    MolBatch,
    pad_molecules,
    round_up,
    uniform_q0_contract,
)
from epnn_tpu_torch.data.xyz import Molecule
from epnn_tpu_torch.device import resolve_device
from epnn_tpu_torch.elements import table_for_n_elems
from epnn_tpu_torch.featurize import rbf_edges
from epnn_tpu_torch.io import checkpoint as ckpt_io
from epnn_tpu_torch.models import EPNN, EPNNConfig
from epnn_tpu_torch.models.config import dense_precision
from epnn_tpu_torch.ops.cluster import mids_lipschitz_bound
from epnn_tpu_torch.ops.fused import (
    balanced_row_chunk,
    batch_cell_grid,
    build_neighbors,
    build_neighbors_batch,
    build_neighbors_cell,
    cell_sort_key,
    forward_blocked,
    fuse_params,
    max_neighbor_count,
    neighbor_window_width,
    pad_kernel_weights,
    quantize_far_field,
)

#: Above this padded width the blocked path runs (the dense path's
#: (B, N, N, 2F+E) pair tensor grows quadratically).
DENSE_MAX_ATOMS = 256

#: From this padded width up, ``neighbor_method='auto'`` selects neighbors
#: through the cell-list builder (N·27·cap candidates scored instead of N²
#: pairs; the same set as top-k), as the JAX package does.
CELL_GRID_MIN_ATOMS = 1024

#: From this padded width up, ``spatial_sort='auto'`` cell-sorts each
#: graph's atoms before the forward, as the JAX package does: spatially
#: near contributions then sit next to each other in the float32 row sums,
#: which keeps raw Σq closer to the net charge.  Charges come back in the
#: caller's order.
CELL_SORT_MIN_ATOMS = 16_384

#: From this padded width up, ``near_row_chunk=-1`` (auto) turns on the
#: huge-N memory mode: the forward's near field, and the cell builder's
#: candidate scoring, run in row blocks of about
#: :data:`HUGE_GRAPH_ROW_CHUNK` rows (:func:`~epnn_tpu_torch.ops.fused.
#: balanced_row_chunk`), with the full-width charges.  The JAX package's
#: values, kept for the card.
HUGE_GRAPH_MIN_ATOMS = 200_000
HUGE_GRAPH_ROW_CHUNK = 65_536


def _safe_k(count: int, batch: MolBatch) -> int:
    """A static neighbor_k from an exact neighbor count: four slots of
    room, rounded up to 8, at most N − 1."""
    return max(min(round_up(count + 4, 8), batch.padded_atoms - 1), 1)


@dataclasses.dataclass
class Predictor:
    """Inference front end on one device.  The fields follow the JAX
    package's ``Predictor`` (``params, cfg, block, force_mode``
    positionally); the rest are keyword-only.

    ``block`` — in the JAX package, the row block of the blocked
    forward's scans.  Accepted for its signature and unused: the port's
    blocked path (the neighbor split) has no row blocks, its far field
    being one kernel a round.

    ``force_mode`` — ``None`` (dispatch on size), ``'dense'`` or
    ``'blocked'``.

    ``device`` — where the forward runs.  ``None`` means the first CUDA
    card and raises when there is none: the CPU is used only when asked
    for (``device="cpu"``), never as a silent fallback.

    ``reuse_neighbors`` — keep each batch object's (idx, mask, d²) tables
    on the device and skip the selection on later calls; a coordinate CRC
    guards them, so editing ``batch.xyz`` in place rebuilds them.  The
    tables come from top-k, as in the JAX package.

    ``renormalize`` — redistribute the residue Σq − Σq0 uniformly over the
    real atoms in float64 after the forward (Σq then matches the net
    charge to ~32 f32 ulp at any size).

    ``neighbor_method`` — ``'auto'`` selects through the cell-list builder
    (:func:`~epnn_tpu_torch.ops.fused.build_neighbors_cell`) from
    :data:`CELL_GRID_MIN_ATOMS` padded atoms and by top-k over −d² below;
    ``'cell'`` and ``'topk'`` force one.  Both give the same set.  The
    grid's bounds are cached per batch behind the coordinate CRC.

    ``neighbor_skin`` — Verlet-skin tables for MD serving (requires
    ``reuse_neighbors``): the selection runs once at cutoff + skin (the
    cell builder from :data:`CELL_GRID_MIN_ATOMS` atoms unless
    ``'topk'``) and stands while no atom has moved more than skin/2 from
    the geometry it was built on; every call takes the slots' d² from the
    current coordinates.  Shell slots beyond the cutoff carry zero
    features and a zero gate, so charges are those of a cold call.
    :attr:`skin_rebuilds` counts the selections.  0 disables.

    ``collapse_round1`` — ``'auto'`` checks the round-1 collapse contract
    per batch on the host (uniform q0 on valid atoms, ``[Z, onehot]``
    features) and collapses message round 1's far field when it holds;
    ``'off'`` never does.

    ``spatial_sort`` — ``'auto'`` runs graphs of
    :data:`CELL_SORT_MIN_ATOMS` padded atoms and more on a cell-sorted
    twin of the batch (:func:`~epnn_tpu_torch.ops.fused.cell_sort_key`),
    ``'on'`` every blocked batch, ``'off'`` none; charges come back in
    the caller's atom order.  In skin mode the permutation stands while
    no atom has moved more than skin/2.

    ``far_cluster`` — the clustered far-field tier, an opt-in
    approximation (0: exact): the blocked path's message rounds after the
    first run their O(N²) far field over this many weighted k-means
    centroids of the j-side projections, O(N·C)
    (:func:`~epnn_tpu_torch.ops.fused.forward_blocked`).  The near field
    and every pass round stay exact, so Σq is conserved; measure the error
    on your system with :meth:`far_field_diagnostics`, or pick C with
    :meth:`calibrate_far_cluster`.  The dense path (small graphs, no O(N²)
    bottleneck) stays exact, as in the JAX package.

    ``near_row_chunk`` — the huge-N memory mode of the blocked path
    (:func:`~epnn_tpu_torch.ops.fused.forward_blocked`): ``-1`` (auto)
    chunks from :data:`HUGE_GRAPH_MIN_ATOMS` padded atoms at
    :func:`~epnn_tpu_torch.ops.fused.balanced_row_chunk` of
    :data:`HUGE_GRAPH_ROW_CHUNK`, and runs full width below; ``0`` never
    chunks; ``> 0`` is the chunk.  The cell builder then chunks its rows
    too, and reused tables come from it.  The charges are those of the
    full-width forward.

    ``near_window`` — windowed gathers on the chunked path: ``-1`` (auto)
    measures the safe width from the tables in hand (reuse, skin) or, on
    a cold call of a sorted batch, from the sorted cell keys, and windows
    when that is narrower than the batch; ``0`` never; ``> 0`` is the
    width, trusted (pairs outside it are dropped, which shows as a charge
    that is not conserved).  Compact windows need spatially ordered atoms,
    which ``spatial_sort='auto'`` gives chunked huge batches.
    """

    params: dict
    cfg: EPNNConfig
    block: int = 256
    force_mode: Optional[str] = None
    _: dataclasses.KW_ONLY
    reuse_neighbors: bool = False
    renormalize: bool = False
    neighbor_method: str = "auto"
    neighbor_skin: float = 0.0
    collapse_round1: str = "auto"
    spatial_sort: str = "auto"
    far_cluster: int = 0
    near_row_chunk: int = -1
    near_window: int = -1
    device: Optional[str] = None

    def __post_init__(self):
        self.device = resolve_device(self.device, "Predictor")
        if self.force_mode not in (None, "dense", "blocked"):
            raise ValueError("force_mode must be None, 'dense' or 'blocked'")
        if self.collapse_round1 not in ("auto", "off"):
            raise ValueError("collapse_round1 must be 'auto' or 'off'")
        if self.neighbor_method not in ("auto", "topk", "cell"):
            raise ValueError("neighbor_method must be 'auto', 'topk' or "
                             "'cell'")
        if self.neighbor_skin < 0:
            raise ValueError("neighbor_skin must be >= 0")
        if self.neighbor_skin > 0 and not self.reuse_neighbors:
            raise ValueError("neighbor_skin requires reuse_neighbors=True")
        if self.spatial_sort not in ("auto", "on", "off"):
            raise ValueError("spatial_sort must be 'auto', 'on', or 'off'")
        if self.far_cluster < 0:
            raise ValueError("far_cluster must be >= 0 (0 = exact)")
        if self.near_row_chunk < -1:
            raise ValueError("near_row_chunk must be -1 (auto), 0 (off), "
                             "or a positive chunk size")
        if self.near_window < -1:
            raise ValueError("near_window must be -1 (auto), 0 (off), or "
                             "a positive width in rows")
        self._model = EPNN.from_params(self.cfg, self.params, self.device)
        self._fused = fuse_params(self.params, self.cfg, self.device)
        if self.device.type == "cuda":
            # the kernel rounds' weights at the kernels' widths, once
            self._fused = pad_kernel_weights(self._fused)
        if self._use_pallas() and self.cfg.dense_matmul_precision == "int8":
            self._fused = quantize_far_field(self._fused)
        # per batch object, each guarded by the geometry CRC: the safe
        # neighbor_k, the cell grid's bounds, the reused tables
        weak = weakref.WeakKeyDictionary
        self._k_cache: "weakref.WeakKeyDictionary" = weak()
        self._grid_cache: "weakref.WeakKeyDictionary" = weak()
        self._nbr_cache: "weakref.WeakKeyDictionary" = weak()
        # Verlet-skin state: batch -> (xyz0 copy, idx, nbr_mask) selected
        # at cutoff + skin; spatial sort: batch -> [crc, perm, inv, sorted
        # twin, xyz0 copy]
        self._skin_cache: "weakref.WeakKeyDictionary" = weak()
        self._sort_cache: "weakref.WeakKeyDictionary" = weak()
        # batch -> {window key: width}, keyed by the tables' provenance
        # (the geometry, or the skin rebuild); sorted twin -> per graph
        # (sorted cell keys, key span), the cold calls' width source
        self._winw_cache: "weakref.WeakKeyDictionary" = weak()
        self._geom_keys: "weakref.WeakKeyDictionary" = weak()
        self.skin_rebuilds = 0

    @classmethod
    def from_checkpoint(cls, directory: str, **kw) -> "Predictor":
        if not os.path.isdir(directory) or not ckpt_io.has_checkpoint(directory):
            raise FileNotFoundError(
                f"no epnn_tpu checkpoint at {directory!r} (expected "
                f"{ckpt_io.PARAMS_FILE} + {ckpt_io.CONFIG_FILE})")
        cfg = ckpt_io.load_config(directory)
        return cls(params=ckpt_io.load_params(directory, cfg), cfg=cfg, **kw)

    @classmethod
    def from_reference(cls, models_dir: str, name: str = "decay_model",
                       **kw) -> "Predictor":
        """A Predictor of a reference TF checkpoint under ``models_dir``
        (:func:`~epnn_tpu_torch.io.tf_import.import_reference_model`:
        ``name`` is a preset name or the prefix's basename)."""
        from epnn_tpu_torch.io.tf_import import import_reference_model

        params, cfg = import_reference_model(models_dir, name)
        return cls(params=params, cfg=cfg, **kw)

    @staticmethod
    def _geom_fingerprint(batch: MolBatch):
        xyz = np.ascontiguousarray(np.asarray(batch.xyz))
        return (id(batch.xyz), xyz.shape, zlib.crc32(xyz.tobytes()))

    def _uniform_q0(self, batch: MolBatch) -> bool:
        """Host-side check of the round-1 collapse contract."""
        if self.collapse_round1 != "auto":
            return False
        return uniform_q0_contract(batch.x, batch.q0, batch.node_mask)

    def _mode(self, batch: MolBatch) -> str:
        return self.force_mode or (
            "dense" if batch.padded_atoms <= DENSE_MAX_ATOMS else "blocked")

    def _neighbor_k(self, batch: MolBatch) -> int:
        """Exact safe neighbor_k for a batch (:func:`_safe_k`), cached per
        batch object with a geometry-staleness guard.  Where the forward
        selects through the cell builder, the count is the builder's own
        ``count_only`` on the device (the same float32 predicate, one host
        sync); else the host's float64 count."""
        fp = self._geom_fingerprint(batch)
        cached = self._k_cache.get(batch)
        if cached is not None and cached[0] == fp:
            return cached[1]
        grid = self._neighbor_grid(batch)
        if grid is not None:
            k = self._cell_count(batch, self.cfg.cutoff, grid)
        else:
            k = max(max_neighbor_count(batch.xyz[b], batch.node_mask[b],
                                       self.cfg.cutoff)
                    for b in range(batch.batch_size))
        k = _safe_k(k, batch)
        self._k_cache[batch] = (fp, k)
        return k

    def _cell_count(self, batch: MolBatch, cutoff: float, grid) -> int:
        """The largest neighbor count of any row of any graph, from the
        cell builder's ``count_only`` on the device (in the grid's row
        chunks, if it has them): one host sync."""
        xyz, mask = self._tensor(batch.xyz), self._tensor(batch.node_mask)
        chunk = grid[3] if len(grid) > 3 else 0
        return int(torch.stack([
            build_neighbors_cell(xyz[b], mask[b], float(cutoff), 1, grid[0],
                                 grid[1], count_only=True, row_chunk=chunk)
            for b in range(batch.batch_size)]).amax())

    def _neighbor_grid(self, batch: MolBatch):
        """The cell builder's ``(ncells_pad, cell_cap)``, with ``('slices',
        row_chunk)`` appended when the batch runs chunked
        (:meth:`_near_chunk`), or None where top-k selects (``'topk'``;
        ``'auto'`` below :data:`CELL_GRID_MIN_ATOMS` padded atoms).  The
        bounds are cached per batch with the geometry fingerprint."""
        if self.neighbor_method == "topk" or (
                self.neighbor_method == "auto"
                and batch.padded_atoms < CELL_GRID_MIN_ATOMS):
            return None
        chunk = self._near_chunk(batch)
        ext = ("slices", chunk) if chunk else ()
        fp = self._geom_fingerprint(batch)
        cached = self._grid_cache.get(batch)
        if cached is not None and cached[0] == fp:
            return cached[1] + ext
        grid = batch_cell_grid(batch.xyz, batch.node_mask, self.cfg.cutoff)
        self._grid_cache[batch] = (fp, grid)
        return grid + ext

    def _neighbors(self, batch: MolBatch, k: int):
        """The batch's (idx, nbr_mask, d2) tables on the device when
        ``reuse_neighbors`` is on, built once per geometry and guarded by
        the geometry fingerprint; else None.  Top-k builds them, as in the
        JAX package, but for a chunked batch, where the row-chunked cell
        builder does (top-k's row blocks score N columns each)."""
        if not self.reuse_neighbors:
            return None
        fp = self._geom_fingerprint(batch)
        cached = self._nbr_cache.get(batch)
        if cached is not None and cached[0] == fp:
            return cached[1]
        xyz, mask = self._tensor(batch.xyz), self._tensor(batch.node_mask)
        grid = self._neighbor_grid(batch)
        if grid is not None and len(grid) > 3 and grid[3]:
            outs = [build_neighbors_cell(xyz[b], mask[b],
                                         float(self.cfg.cutoff), int(k),
                                         grid[0], grid[1], with_d2=True,
                                         row_chunk=grid[3])
                    for b in range(batch.batch_size)]
            nbrs = tuple(torch.stack(parts) for parts in zip(*outs))
        else:
            nbrs = build_neighbors_batch(xyz, mask, float(self.cfg.cutoff),
                                         int(k))
        self._nbr_cache[batch] = (fp, nbrs)
        return nbrs

    def _neighbors_skin(self, batch: MolBatch):
        """Verlet-skin ``(idx, nbr_mask)`` on the device for the current
        drift window (see ``neighbor_skin``): the selection at cutoff +
        skin runs when there is none yet or an atom has moved more than
        skin/2 from its geometry."""
        xyz = np.asarray(batch.xyz)
        cached = self._skin_cache.get(batch)
        if cached is not None:
            xyz0, idx, nbr_mask = cached
            if xyz.shape == xyz0.shape:
                disp2 = float((((xyz - xyz0) ** 2).sum(-1)
                               * (np.asarray(batch.node_mask) > 0)).max())
                if disp2 <= (self.neighbor_skin / 2.0) ** 2:
                    return idx, nbr_mask
        cutoff_sel = float(self.cfg.cutoff + self.neighbor_skin)
        xyz_t = self._tensor(batch.xyz)
        mask_t = self._tensor(batch.node_mask)
        if (self.neighbor_method != "topk"
                and batch.padded_atoms >= CELL_GRID_MIN_ATOMS):
            chunk = self._near_chunk(batch)
            grid = (*batch_cell_grid(batch.xyz, batch.node_mask, cutoff_sel),
                    "slices", chunk)
            k = _safe_k(self._cell_count(batch, cutoff_sel, grid), batch)
            outs = [build_neighbors_cell(xyz_t[b], mask_t[b], cutoff_sel, k,
                                         grid[0], grid[1], row_chunk=chunk)
                    for b in range(batch.batch_size)]
            idx, nbr_mask = (torch.stack(parts) for parts in zip(*outs))
        else:
            k = _safe_k(max(max_neighbor_count(batch.xyz[b],
                                               batch.node_mask[b], cutoff_sel)
                            for b in range(batch.batch_size)), batch)
            idx, nbr_mask, _ = build_neighbors_batch(xyz_t, mask_t,
                                                     cutoff_sel, k)
        self.skin_rebuilds += 1
        self._skin_cache[batch] = (xyz.copy(), idx, nbr_mask)
        return idx, nbr_mask

    def _spatial_view(self, batch: MolBatch):
        """None (no sort) or ``(sorted_batch, inv)``: the cell-sorted twin
        of ``batch`` and the (B, N) inverse permutation that takes its
        charges back to the caller's atom order.  Cached per batch object
        behind the coordinate CRC; in skin mode the permutation stands
        while no atom has moved more than skin/2 from the geometry it was
        made on, and the twin's coordinates are refreshed in place (its
        own CRC-guarded caches see the change).  ``'auto'`` sorts from
        :data:`CELL_SORT_MIN_ATOMS` padded atoms, and any batch that runs
        chunked from :data:`HUGE_GRAPH_MIN_ATOMS` (its windows need the
        order)."""
        if self.spatial_sort == "off":
            return None
        if self.spatial_sort == "auto" and not (
                (batch.padded_atoms >= HUGE_GRAPH_MIN_ATOMS
                 and self._effective_chunk(batch))
                or batch.padded_atoms >= CELL_SORT_MIN_ATOMS):
            return None
        xyz = np.asarray(batch.xyz)
        mask = np.asarray(batch.node_mask)
        fp = self._geom_fingerprint(batch)
        state = self._sort_cache.get(batch)
        if state is not None:
            crc0, perm, inv, batch2, xyz0 = state
            if crc0 == fp:
                return batch2, inv
            if xyz.shape == xyz0.shape and self.neighbor_skin > 0:
                disp2 = float((((xyz - xyz0) ** 2).sum(-1)
                               * (mask > 0)).max())
                if disp2 <= (self.neighbor_skin / 2.0) ** 2:
                    batch2.xyz[...] = np.take_along_axis(
                        xyz, perm[..., None], axis=1)
                    state[0] = fp
                    return batch2, inv
        # the permutation: the z-major cell key of the valid atoms, the
        # padding rows stable at the end; per graph, its sorted keys and
        # their span bound the window of a cold call
        b, n = xyz.shape[:2]
        perm = np.empty((b, n), np.int64)
        winfo = []
        for bi in range(b):
            valid = mask[bi] > 0
            if not valid.any():
                perm[bi] = np.arange(n)
                winfo.append((np.zeros((0,), np.int64), 1))
                continue
            key, span = cell_sort_key(xyz[bi][valid], self.cfg.cutoff)
            full = np.full((n,), np.iinfo(np.int64).max, np.int64)
            full[valid] = key
            perm[bi] = np.argsort(full, kind="stable")
            winfo.append((np.sort(key), span))
        inv = np.argsort(perm, axis=1, kind="stable")

        def take(a):
            if a.ndim == 1:
                return a
            p = perm.reshape(perm.shape + (1,) * (a.ndim - 2))
            return np.take_along_axis(np.asarray(a), p, axis=1)

        batch2 = dataclasses.replace(
            batch, x=take(batch.x), xyz=take(batch.xyz), q0=take(batch.q0),
            y=take(batch.y), node_mask=take(batch.node_mask))
        self._sort_cache[batch] = [fp, perm, inv, batch2, xyz.copy()]
        self._geom_keys[batch2] = winfo
        return batch2, inv

    @staticmethod
    def _keys_window_width(winfo, ranges, chunk: int) -> int:
        """A cold call's window bound from the sorted cell keys: a pair
        within the cutoff is ±1 cell an axis apart, so its keys differ by
        at most the span, and the rows a chunk can reach lie within its
        keys ± span.  ``winfo``: per graph (sorted valid keys, span);
        ``ranges``: the row ranges whose chunks restart at their start
        (one, (0, n), on one device).  Valid rows sort first."""
        w = 1
        for keys, span in winfo:
            nv = keys.shape[0]
            for r0, r1 in ranges:
                for s in range(r0, min(r1, nv), chunk):
                    e = min(s + chunk, r1, nv) - 1
                    lo = np.searchsorted(keys, keys[s] - span, "left")
                    hi = np.searchsorted(keys, keys[e] + span, "right")
                    w = max(w, int(hi - lo))
        return w

    def _near_window_for(self, batch: MolBatch, nbrs, chunk: int,
                         key) -> int:
        """The ``near_window`` of a dispatch (see the field): the explicit
        width, or the auto width from the tables in hand (``nbrs``, on
        the device: one reduction and one scalar read) or, on a cold call
        of a sorted twin, from its cell keys; 0 where it would not be
        narrower than the batch.  Cached per batch under ``key`` (the
        tables' provenance) and the chunk."""
        if self.near_window == 0 or not chunk:
            return 0
        if self.near_window > 0:
            return self.near_window
        if nbrs is None and self._geom_keys.get(batch) is None:
            return 0  # a cold call on an unsorted batch: no width source
        per_batch = self._winw_cache.setdefault(batch, {})
        full_key = key + (chunk,)
        w = per_batch.get(full_key)
        if w is None:
            # 4,096 rows at production sizes, finer on small graphs so the
            # rounding cannot widen a compact window past N
            n = batch.padded_atoms
            align = max(8, min(4096, n // 8))
            if nbrs is not None:
                w = neighbor_window_width(nbrs[0], nbrs[1], chunk,
                                          align=align)
            else:
                w = self._keys_window_width(self._geom_keys[batch],
                                            [(0, n)], chunk)
                w = min(-(-w // align) * align, n)
            if w >= n:
                w = 0  # no narrower than the batch: the same as off
            per_batch.clear()  # one live table set a batch
            per_batch[full_key] = w
        return w

    def _effective_chunk(self, batch: MolBatch) -> int:
        """The row chunk a dispatch of ``batch`` uses (one device: the
        :meth:`_near_chunk` policy)."""
        return self._near_chunk(batch)

    def _near_chunk(self, batch: MolBatch) -> int:
        """The huge-N row chunk of ``batch`` (see ``near_row_chunk``): the
        explicit setting, or from :data:`HUGE_GRAPH_MIN_ATOMS` padded atoms
        the balanced chunk of :data:`HUGE_GRAPH_ROW_CHUNK` (as many chunks,
        as little padding)."""
        if self.near_row_chunk >= 0:
            return self.near_row_chunk
        if batch.padded_atoms < HUGE_GRAPH_MIN_ATOMS:
            return 0
        return balanced_row_chunk(batch.padded_atoms, HUGE_GRAPH_ROW_CHUNK)

    def _use_pallas(self) -> bool:
        """The twin of JAX's ``Predictor._use_pallas``
        (``epnn_tpu/infer.py:1155-1167``) with the card in the TPU's place:
        on CUDA, when the far field's precision is ``'default'`` or
        ``'int8'``.  It selects the int8 tier under
        ``dense_matmul_precision='int8'`` and changes nothing else (the
        float32 kernels run on the card either way); so a CPU Predictor
        serves int8 unquantized, as JAX's CPU Predictor does."""
        return (self.device.type == "cuda"
                and dense_precision(self.cfg) == "default")

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32)).to(self.device)

    def predict_batch(self, batch: MolBatch) -> np.ndarray:
        """(B, N) per-atom float32 charges for a padded batch."""
        q = self._predict_batch_raw(batch)
        if self.renormalize:
            # float64 redistribution: at huge N the per-atom correction sits
            # below the f32 ulp of q, so an f32 subtraction would drop it
            mask = np.asarray(batch.node_mask, np.float64)
            q64 = q.astype(np.float64)
            n_real = np.maximum(mask.sum(axis=1), 1.0)
            target = (np.asarray(batch.q0, np.float64) * mask).sum(axis=1)
            residue = (q64 * mask).sum(axis=1) - target
            q = (((q64 - (residue / n_real)[:, None]) * mask)
                 .astype(np.float32))
            # the f32 output cast re-biases Σq at huge N; iterative
            # refinement spreads each remaining residue over just enough
            # atoms that the correction survives the cast
            eps = float(np.finfo(np.float32).eps)
            for _ in range(4):
                q64c = q.astype(np.float64)
                r = (q64c * mask).sum(axis=1) - target
                scale = np.maximum(np.abs(q64c).max(axis=1), 1e-30)
                if (np.abs(r) <= 32 * eps * scale).all():
                    break
                for bi in np.nonzero(np.abs(r) > 32 * eps * scale)[0]:
                    m = int(min(n_real[bi],
                                max(1.0, abs(r[bi]) / (8 * eps * scale[bi]))))
                    vi = np.nonzero(mask[bi] > 0)[0][:m]
                    q64c[bi, vi] -= r[bi] / m
                q = (q64c * mask).astype(np.float32)
        return q

    @torch.no_grad()
    def _predict_batch_raw(self, batch: MolBatch) -> np.ndarray:
        """Charges in the caller's atom order: a blocked batch runs on its
        cell-sorted twin where ``spatial_sort`` says so."""
        if self._mode(batch) == "blocked":
            view = self._spatial_view(batch)
            if view is not None:
                batch2, inv = view
                q = self._predict_batch_inner(batch2)
                return np.take_along_axis(q, inv, axis=1)
        return self._predict_batch_inner(batch)

    def _inputs(self, batch: MolBatch):
        """(x, q0, xyz, node_mask) of ``batch`` on the device."""
        return tuple(self._tensor(a) for a in (
            batch.x, batch.q0, batch.xyz, batch.node_mask))

    def _blocked_kw(self, batch: MolBatch, window: bool = True) -> dict:
        """The blocked forward's arguments for ``batch`` without the skin:
        the cached k, reused tables, the cell grid, the collapse, the row
        chunk and (``window``) the near window."""
        k = self._neighbor_k(batch)
        nbrs = self._neighbors(batch, k)
        chunk = self._near_chunk(batch)
        kw = dict(neighbor_k=k, use_pallas=self._use_pallas(),
                  neighbors=nbrs, neighbor_grid=self._neighbor_grid(batch),
                  uniform_q0=self._uniform_q0(batch), near_row_chunk=chunk)
        if window:
            kw["near_window"] = self._near_window_for(
                batch, nbrs, chunk, ("nbr", self._geom_fingerprint(batch)))
        return kw

    def _skin_kw(self, batch: MolBatch) -> dict:
        """The blocked forward's arguments for ``batch`` in skin mode: the
        Verlet-skin 2-tuple (the forward takes d² from the current
        coordinates), its k, the collapse, the row chunk and the window."""
        idx, nbr_mask = self._neighbors_skin(batch)
        chunk = self._near_chunk(batch)
        return dict(neighbor_k=int(idx.shape[-1]),
                    use_pallas=self._use_pallas(), neighbors=(idx, nbr_mask),
                    uniform_q0=self._uniform_q0(batch), near_row_chunk=chunk,
                    near_window=self._near_window_for(
                        batch, (idx, nbr_mask), chunk,
                        ("skin", self.skin_rebuilds)))

    def _dense_forward(self, x, q0, xyz, mask):
        e = rbf_edges(xyz, mask, e_dim=self.cfg.e_dim,
                      cutoff=self.cfg.cutoff, eta=self.cfg.eta)
        return self._model(x, q0, e, mask)

    def _predict_batch_inner(self, batch: MolBatch) -> np.ndarray:
        x, q0, xyz, mask = self._inputs(batch)
        mode = self._mode(batch)
        if (mode == "blocked" and self.far_cluster == 0
                and batch.padded_atoms >= 2 * HUGE_GRAPH_MIN_ATOMS):
            warnings.warn(
                f"exact far field at {batch.padded_atoms:,} padded atoms: "
                "its O(N²) reduction over every pair beyond the cutoff "
                "takes minutes a call at this scale; set far_cluster (the "
                "clustered tier, bounded error) for huge graphs",
                stacklevel=3)
        if mode == "dense":
            q = self._dense_forward(x, q0, xyz, mask)
        else:
            kw = (self._skin_kw(batch) if self.neighbor_skin > 0
                  else self._blocked_kw(batch))
            q = forward_blocked(self._fused, x, q0, xyz, mask, self.cfg,
                                far_cluster=self.far_cluster, **kw)
        # float() first: a bf16 dense forward returns bf16 charges
        return q.float().cpu().numpy()

    def benchmark_batch(self, batch: MolBatch, iters: int = 20,
                        warmup_loops: int = 2,
                        profile_dir: Optional[str] = None,
                        per_call: bool = False,
                        cost_analysis: bool = False) -> dict:
        """Steady-state latency of ``predict_batch(batch)``, as the JAX
        package's ``benchmark_batch`` measures it.

        By default the serialized chain with one terminal readback
        (:func:`~epnn_tpu_torch.utils.timing.benchmark_chained`): the
        forward the Predictor would dispatch (dense up to
        :data:`DENSE_MAX_ATOMS`, else the blocked forward on the spatially
        sorted twin where ``predict_batch`` would take it) runs on device
        tensors, with its neighbor tables (reused or skin), k, cell grid,
        round-1 collapse, row chunk and window computed once, outside the
        timed loop; what stays inside is what every call pays (the
        selection unless the tables are reused; the skin's d² gather).
        ``per_call=True`` times ``predict_batch`` itself call by call
        (:func:`~epnn_tpu_torch.utils.timing.benchmark_fn`), host copies
        included.  Returns ``mean_s``, ``iters``, ``method`` and, chained,
        ``warmup_loops``."""
        from epnn_tpu_torch.utils.timing import benchmark_chained, benchmark_fn

        if per_call:
            stats = benchmark_fn(self.predict_batch, batch,
                                 warmup=max(warmup_loops, 1), iters=iters,
                                 profile_dir=profile_dir)
            stats["method"] = "per_call"
            return stats
        mode = self._mode(batch)
        # the program predict_batch runs: its sorted twin where it sorts
        # (latency does not depend on the order, so no unpermute)
        if mode == "blocked":
            view = self._spatial_view(batch)
            if view is not None:
                batch = view[0]
        x, q0, xyz, mask = self._inputs(batch)
        if mode == "dense":
            def fn(q0_in):
                return self._dense_forward(x, q0_in, xyz, mask)
        else:
            kw = (self._skin_kw(batch) if self.neighbor_skin > 0
                  else self._blocked_kw(batch))

            def fn(q0_in):
                return forward_blocked(self._fused, x, q0_in, xyz, mask,
                                       self.cfg, far_cluster=self.far_cluster,
                                       **kw)
        return benchmark_chained(fn, q0, iters=iters,
                                 warmup_loops=warmup_loops,
                                 profile_dir=profile_dir,
                                 cost_analysis=cost_analysis)

    @torch.no_grad()
    def far_field_diagnostics(self, batch: MolBatch,
                              compare_exact: bool = True) -> dict:
        """The clustered tier's approximation on one batch, through the
        blocked path (requires ``far_cluster > 0``), as JAX's
        (``epnn_tpu/infer.py:591``): ``max_radius`` (B,), the largest
        intra-cluster radius over the message rounds; ``lipschitz``, the
        bound L on the message MLP's tail (:func:`~epnn_tpu_torch.ops.
        cluster.mids_lipschitz_bound`); ``message_bound`` (B,), the a
        priori bound (Σ_j jvec_j)·L·max_radius on one atom's summed message
        a round; and with ``compare_exact`` ``max_abs_dq`` (B,), the
        measured largest per-atom charge error against the exact forward,
        the number a serving decision should rest on."""
        if self.far_cluster <= 0:
            raise ValueError("far_field_diagnostics requires far_cluster>0")
        args = (self._fused, *self._inputs(batch), self.cfg)
        kw = self._blocked_kw(batch, window=False)
        q_c, rad = forward_blocked(*args, far_cluster=self.far_cluster,
                                   far_diag=True, **kw)
        rad = rad.cpu().numpy()
        lip = mids_lipschitz_bound(self._fused.messages)
        mask = np.asarray(batch.node_mask)
        n_sum = (mask.sum(axis=1) if self.cfg.mask_messages
                 else np.full(mask.shape[0], float(mask.shape[1])))
        out = {"max_radius": rad, "lipschitz": lip,
               "message_bound": n_sum * lip * rad}
        if compare_exact:
            q_e = forward_blocked(*args, **kw)
            out["max_abs_dq"] = (q_c - q_e).abs().amax(1).cpu().numpy()
        return out

    @torch.no_grad()
    def calibrate_far_cluster(self, batch: MolBatch, budget: float,
                              candidates=(16, 32, 64, 128, 256),
                              apply: bool = False) -> dict:
        """The smallest clustered tier C whose measured largest per-atom
        charge error on ``batch`` is within ``budget`` (e), as JAX's
        (``epnn_tpu/infer.py:643``): one exact forward, then clustered
        forwards in ascending C, stopping at the first within the budget.
        Returns ``{"selected": C or None, "errors": {C: max|dq|},
        "budget": budget}``; ``apply=True`` switches this Predictor to the
        selected tier (none selected: no change).  The error depends on
        the weights and the geometry: calibrate on a representative
        system."""
        args = (self._fused, *self._inputs(batch), self.cfg)
        kw = self._blocked_kw(batch, window=False)
        q_e = forward_blocked(*args, **kw)
        errors: dict = {}
        selected = None
        for cand in sorted({int(c) for c in candidates if int(c) > 0}):
            q_c = forward_blocked(*args, far_cluster=cand, **kw)
            errors[cand] = float((q_c - q_e).abs().amax())
            if errors[cand] <= budget:
                selected = cand
                break
        if apply and selected is not None:
            self.far_cluster = selected
        return {"selected": selected, "errors": errors, "budget": budget}

    def charge_position_vjp(self, batch: MolBatch,
                            cotangent: np.ndarray) -> np.ndarray:
        """(B, N, 3) pullback of the charges through the atom positions,
        ``Σ_i cotangent[b, i] · ∂q[b, i]/∂xyz[b]``: the charge-response
        force of an MD energy that depends on the predicted charges (with
        cotangent = ∂E/∂q), as JAX's (``epnn_tpu/infer.py:1169``).

        Differentiates the exact blocked forward.  The neighbor indices
        come from the selection (top-k, or the cell builder where the
        Predictor uses it) without a gradient, as in any cutoff-based MD
        force; the pairs' d² is taken again from the coordinates under
        autograd (the forward's ``(idx, mask)`` path).  The cosine envelope
        is C¹ with value 0 at the cutoff, so the pull is continuous as
        pairs cross it; the hard pass gate is piecewise constant and adds
        nothing.  The far field's backward is its CUDA kernel, the near
        kernels' backward a recompute through their plain versions.  A
        chunked batch (:meth:`_near_chunk`) runs the forward in its chunks
        and window under ``remat``, so the backward too holds one chunk's
        activations at a time.  Padding rows get exactly zero."""
        cot = torch.as_tensor(np.asarray(cotangent, np.float32))
        if tuple(cot.shape) != tuple(np.shape(batch.q0)):
            raise ValueError(
                f"cotangent must be (B, N) = {np.shape(batch.q0)}, "
                f"got {tuple(cot.shape)}")
        x, q0, xyz, mask = self._inputs(batch)
        k = self._neighbor_k(batch)
        grid = self._neighbor_grid(batch)
        chunk = self._near_chunk(batch)
        with torch.no_grad():
            if grid is None:
                tables = [build_neighbors(xyz[b], mask[b],
                                          float(self.cfg.cutoff), k)
                          for b in range(batch.batch_size)]
            else:
                tables = [build_neighbors_cell(xyz[b], mask[b],
                                               float(self.cfg.cutoff), k,
                                               grid[0], grid[1],
                                               row_chunk=chunk)
                          for b in range(batch.batch_size)]
        nbrs = tuple(torch.stack(parts) for parts in zip(*tables))
        win = self._near_window_for(batch, nbrs, chunk,
                                    ("vjp", self._geom_fingerprint(batch)))
        xyz = xyz.requires_grad_(True)
        with torch.enable_grad():
            q = forward_blocked(
                self._fused, x, q0, xyz, mask, self.cfg, neighbor_k=k,
                use_pallas=self._use_pallas(), remat=chunk > 0,
                neighbors=nbrs, uniform_q0=self._uniform_q0(batch),
                near_row_chunk=chunk, near_window=win)
            (pull,) = torch.autograd.grad(q, xyz, cot.to(self.device))
        return pull.cpu().numpy()

    def predict_trajectory(self, mol: Molecule, frames: np.ndarray,
                           pad_to: Optional[int] = None) -> np.ndarray:
        """(T, natoms) charges for an MD trajectory of one molecule.

        ``frames`` is (T, natoms, 3).  One padded batch is built and its
        coordinates are replaced in place frame by frame, so with
        ``reuse_neighbors=True, neighbor_skin=S`` the selection runs again
        only when the drift passes S/2 (each frame pays the O(N·k) d²
        gather and the forward).  Charges are exact per frame."""
        frames = np.asarray(frames, np.float32)
        if frames.ndim != 3 or frames.shape[1:] != (mol.natoms, 3):
            raise ValueError(
                f"frames must be (T, {mol.natoms}, 3), got {frames.shape}")
        table = table_for_n_elems(self.cfg.n_elems)
        batch = pad_molecules([mol], table, pad_to=pad_to)
        out = np.empty((len(frames), mol.natoms), np.float32)
        for t in range(len(frames)):
            batch.xyz[0, : mol.natoms] = frames[t]
            out[t] = self.predict_batch(batch)[0, : mol.natoms]
        return out

    def predict_molecules(
        self, mols: Sequence[Molecule], pad_to: Optional[int] = None
    ) -> List[np.ndarray]:
        """Per-molecule charge arrays (each trimmed to its real atoms),
        grouped by padded width; results follow input position."""
        table = table_for_n_elems(self.cfg.n_elems)
        results: List[Optional[np.ndarray]] = [None] * len(mols)
        groups: dict = {}
        for i, m in enumerate(mols):
            key = pad_to if pad_to is not None else round_up(max(m.natoms, 1), 8)
            groups.setdefault(key, []).append(i)
        for key, idxs in sorted(groups.items()):
            batch = pad_molecules([mols[i] for i in idxs], table, pad_to=key)
            q = self.predict_batch(batch)
            for row, i in enumerate(idxs):
                results[i] = q[row, : batch.natoms[row]]
        return results
