"""High-level inference API (counterpart of ``epnn_tpu/infer.py``):

    predictor = Predictor.from_checkpoint("trained/mixed_b16")   # on the card
    charges = predictor.predict_molecules(mols)          # list of (n_i,)

Dispatch: padded widths up to :data:`DENSE_MAX_ATOMS` run the dense
:class:`~epnn_tpu_torch.models.EPNN` forward; larger graphs run the
neighbor-split blocked forward (:func:`~epnn_tpu_torch.ops.forward_blocked`)
whose hot loops are the CUDA kernels of :mod:`epnn_tpu_torch.ops.kernels`.

Everything runs in float32, but for the far field's int8 serving tier
(``dense_matmul_precision="int8"`` on the card, :meth:`Predictor._use_pallas`).
Matmuls stay full fp32 as long as TF32 stays off
(``torch.backends.cuda.matmul.allow_tf32``, PyTorch's default).
"""

from __future__ import annotations

import dataclasses
import os
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
from epnn_tpu_torch.ops.fused import (
    forward_blocked,
    fuse_params,
    max_neighbor_count,
    pad_kernel_weights,
    quantize_far_field,
)

#: Above this padded width the blocked path runs (the dense path's
#: (B, N, N, 2F+E) pair tensor grows quadratically).
DENSE_MAX_ATOMS = 256


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

    ``collapse_round1`` — ``'auto'`` checks the round-1 collapse contract
    per batch on the host (uniform q0 on valid atoms, ``[Z, onehot]``
    features) and collapses message round 1's far field when it holds;
    ``'off'`` never does.

    ``renormalize`` — redistribute the residue Σq − Σq0 uniformly over the
    real atoms in float64 after the forward (Σq then matches the net
    charge to ~32 f32 ulp at any size).

    ``neighbor_method`` — ``'auto'`` and ``'topk'`` select neighbors by
    top-k over −d²; the cell-list builder (``'cell'``, and ``'auto'`` from
    1,024 atoms in the JAX package, same candidate set) is not ported yet.
    """

    params: dict
    cfg: EPNNConfig
    block: int = 256
    force_mode: Optional[str] = None
    _: dataclasses.KW_ONLY
    renormalize: bool = False
    neighbor_method: str = "auto"
    collapse_round1: str = "auto"
    device: Optional[str] = None

    def __post_init__(self):
        self.device = resolve_device(self.device, "Predictor")
        if self.force_mode not in (None, "dense", "blocked"):
            raise ValueError("force_mode must be None, 'dense' or 'blocked'")
        if self.collapse_round1 not in ("auto", "off"):
            raise ValueError("collapse_round1 must be 'auto' or 'off'")
        if self.neighbor_method == "cell":
            raise NotImplementedError(
                "neighbor_method='cell' (the cell-list builder) is not ported "
                "yet (ROADMAP queue 1: cell builder)")
        if self.neighbor_method not in ("auto", "topk"):
            raise ValueError("neighbor_method must be 'auto', 'topk' or "
                             "'cell'")
        self._model = EPNN.from_params(self.cfg, self.params, self.device)
        self._fused = fuse_params(self.params, self.cfg, self.device)
        if self.device.type == "cuda":
            # the kernel rounds' weights at the kernels' widths, once
            self._fused = pad_kernel_weights(self._fused)
        if self._use_pallas() and self.cfg.dense_matmul_precision == "int8":
            self._fused = quantize_far_field(self._fused)
        # safe neighbor_k per batch object, guarded by a geometry CRC
        self._k_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

    @classmethod
    def from_checkpoint(cls, directory: str, **kw) -> "Predictor":
        if not os.path.isdir(directory) or not ckpt_io.has_checkpoint(directory):
            raise FileNotFoundError(
                f"no epnn_tpu checkpoint at {directory!r} (expected "
                f"{ckpt_io.PARAMS_FILE} + {ckpt_io.CONFIG_FILE})")
        cfg = ckpt_io.load_config(directory)
        return cls(params=ckpt_io.load_params(directory, cfg), cfg=cfg, **kw)

    @staticmethod
    def _geom_fingerprint(batch: MolBatch):
        xyz = np.ascontiguousarray(np.asarray(batch.xyz))
        return (id(batch.xyz), xyz.shape, zlib.crc32(xyz.tobytes()))

    def _uniform_q0(self, batch: MolBatch) -> bool:
        """Host-side check of the round-1 collapse contract."""
        if self.collapse_round1 != "auto":
            return False
        return uniform_q0_contract(batch.x, batch.q0, batch.node_mask)

    def _neighbor_k(self, batch: MolBatch) -> int:
        """Exact safe neighbor_k for a batch (host count + 4, rounded up to
        8), cached per batch object with a geometry-staleness guard."""
        fp = self._geom_fingerprint(batch)
        cached = self._k_cache.get(batch)
        if cached is not None and cached[0] == fp:
            return cached[1]
        k = max(max_neighbor_count(batch.xyz[b], batch.node_mask[b],
                                   self.cfg.cutoff)
                for b in range(batch.batch_size))
        k = max(min(round_up(k + 4, 8), batch.padded_atoms - 1), 1)
        self._k_cache[batch] = (fp, k)
        return k

    def _use_pallas(self) -> bool:
        """The twin of JAX's ``Predictor._use_pallas``
        (``epnn_tpu/infer.py:1155-1167``) with the card in the TPU's place:
        on CUDA, when the far field's precision is ``'default'`` or
        ``'int8'``.  It selects the int8 tier under
        ``dense_matmul_precision='int8'`` and changes nothing else (the
        float32 kernels run on the card either way); so a CPU Predictor
        serves int8 unquantized, as JAX's CPU Predictor does."""
        cfg = self.cfg
        dense_prec = cfg.dense_matmul_precision or cfg.matmul_precision or (
            "highest" if cfg.highest_precision else "default")
        return self.device.type == "cuda" and dense_prec in ("default",
                                                             "int8")

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
        mode = self.force_mode or (
            "dense" if batch.padded_atoms <= DENSE_MAX_ATOMS else "blocked")
        x, q0, xyz, mask = (self._tensor(a) for a in (
            batch.x, batch.q0, batch.xyz, batch.node_mask))
        if mode == "dense":
            e = rbf_edges(xyz, mask, e_dim=self.cfg.e_dim,
                          cutoff=self.cfg.cutoff, eta=self.cfg.eta)
            q = self._model(x, q0, e, mask)
        else:
            q = forward_blocked(
                self._fused, x, q0, xyz, mask, self.cfg,
                neighbor_k=self._neighbor_k(batch),
                use_pallas=self._use_pallas(),
                uniform_q0=self._uniform_q0(batch))
        return q.cpu().numpy().astype(np.float32, copy=False)

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
