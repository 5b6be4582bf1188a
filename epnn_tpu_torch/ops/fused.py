"""The blocked forwards from raw coordinates (counterpart of
``epnn_tpu/ops/fused.py``): the neighbor-split forward, the big-graph
serving path, and the two dense blocked forwards.

The pair input of every MLP is a concat ``[a_i, a_j, e_ij]``, so its first
layer splits: ``concat @ W1 = a_i @ W1_i + a_j @ W1_j + e_ij @ W1_e``.
Beyond the cutoff the RBF features are exactly zero, so each message
round's sum over all pairs splits into

  Σ_j hid(full)_ij = Σ_j hid(nofeat)_ij                 (far field, O(N²))
                   + Σ_{near j} [hid(full) − hid(nofeat)]_ij   (O(N·k))

and the electron-passing rounds, gated to near pairs, run on the gathered
O(N·k) set only (:func:`_forward_single_nbr`, three CUDA kernels).  The
dense forwards featurize every pair instead: :func:`_forward_single` in
row blocks of plain PyTorch (differentiable, any MLP depth), and
:func:`_forward_single_pallas` with each round one fused CUDA kernel over
the whole pair grid (inference-only).  The kernels are those of
:mod:`epnn_tpu_torch.ops.kernels`; the gathers, projections and update MLP
stay plain PyTorch.

Precision follows the JAX package's policy by name
(:func:`~epnn_tpu_torch.models.config.main_precision`,
:func:`~epnn_tpu_torch.models.config.dense_precision`,
:func:`~epnn_tpu_torch.models.config.near_precision`): each kernel call
takes its precision as JAX's Pallas call does, which on the card selects
the kernel's TF32 tier (``"default"``: one TF32 product a k-step) and on
the CPU changes nothing (float32 plain versions, as XLA:CPU).  Plain
products stay float32 at every precision.  The far field's
``dense_matmul_precision="bf16x3"`` runs its plain version in JAX's
split-float arithmetic (:func:`dense_message_rowsum_bf16x3_plain`), and
``"int8"`` with ``use_pallas`` its int8 serving tier.
``compute_dtype="bfloat16"`` runs JAX's bf16 recursion
(:func:`forward_blocked`): bf16 messages through the plain versions,
float32 pass rounds through the kernels.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from epnn_tpu_torch.featurize import (
    envelope_rbf,
    hard_gate,
    pair_d2,
    rbf_centers,
)
from epnn_tpu_torch.models.config import (
    EPNNConfig,
    dense_precision,
    main_precision,
    near_precision,
)
from epnn_tpu_torch.ops.cluster import weighted_kmeans
from epnn_tpu_torch.ops.kernels import (
    dense_message_rowsum,
    dense_message_rowsum_int8,
    dense_message_rowsum_plain,
    KernelWeights,
    fused_epn_rowsum,
    fused_message_rowsum,
    int8_kernel_weights,
    near_message_corr,
    near_message_corr_plain,
    near_pass_rowsum,
    near_pass_rowsum_plain,
    pad_weights,
)
from epnn_tpu_torch.ops.kernels import _layers, _mid_layers, _plain_rows
from epnn_tpu_torch.utils.timing import span

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PairMLPWeights:
    """One pair MLP with its first layer split into [a_i | a_j | e] slices."""

    w1_i: Tensor  # (F', H1)
    w1_j: Tensor  # (F', H1)
    w1_e: Tensor  # (E, H1)
    b1: Tensor
    mids: Tuple[Tuple[Tensor, Tensor], ...]  # ((W, b), ...) hidden layers
    w_out: Tensor
    b_out: Tensor
    #: the far field's int8-tier constants, (w2q, sw, max(b1)) in the int8
    #: kernel's padded layout, made once per set of weights by
    #: :func:`quantize_far_field`; None: made per call
    int8: Optional[Tuple[Tensor, Tensor, Tensor]] = None
    #: (W1e, W2, b2) zero-padded to the kernels' widths, made once per set
    #: of weights by :func:`pad_kernel_weights`; None: made per call
    padded: Optional[KernelWeights] = None

    def to(self, device) -> "PairMLPWeights":
        mv = lambda a: a.to(device).contiguous()  # noqa: E731
        return PairMLPWeights(
            mv(self.w1_i), mv(self.w1_j), mv(self.w1_e), mv(self.b1),
            tuple((mv(w), mv(b)) for w, b in self.mids),
            mv(self.w_out), mv(self.b_out),
            None if self.int8 is None else tuple(map(mv, self.int8)),
            None if self.padded is None else KernelWeights(
                *map(mv, self.padded)))


@dataclasses.dataclass(frozen=True)
class FusedParams:
    """All model weights in split-first-layer layout: one
    :class:`PairMLPWeights` per round (the JAX package stacks them on a
    leading T axis for ``lax.scan``; here the rounds are a Python loop)."""

    messages: Tuple[PairMLPWeights, ...]
    passes: Tuple[PairMLPWeights, ...]
    update: Tuple[Tuple[Tensor, Tensor], ...]

    def to(self, device) -> "FusedParams":
        return FusedParams(
            tuple(w.to(device) for w in self.messages),
            tuple(w.to(device) for w in self.passes),
            tuple((w.to(device).contiguous(), b.to(device).contiguous())
                  for w, b in self.update))


def _cast_round(w: PairMLPWeights, dtype) -> PairMLPWeights:
    """A round's weights as ``dtype`` (differentiable casts, no padded or
    int8 constants: those are the float32 kernels')."""
    c = lambda a: a.to(dtype)  # noqa: E731
    return PairMLPWeights(c(w.w1_i), c(w.w1_j), c(w.w1_e), c(w.b1),
                          tuple((c(m), c(b)) for m, b in w.mids),
                          c(w.w_out), c(w.b_out))


def quantize_far_field(fused: FusedParams) -> FusedParams:
    """``fused`` with the int8 tier's weight constants on every message
    round that takes the kernels: W2 quantized per column in the int8
    kernel's padded layout
    (:func:`~epnn_tpu_torch.ops.kernels.int8_kernel_weights`) and max(b1),
    the pi of JAX's padding atoms.  They depend on the weights only;
    ``Predictor`` makes them once when it serves the tier."""
    def quantized(w):
        w2p = (pad_weights(*w.mids[0]) if w.padded is None else w.padded).w2
        return dataclasses.replace(w, int8=(*int8_kernel_weights(w2p),
                                            w.b1.amax()))

    return dataclasses.replace(fused, messages=tuple(
        quantized(w) if kernels_apply(w) else w for w in fused.messages))


def pad_kernel_weights(fused: FusedParams) -> FusedParams:
    """``fused`` with every kernel round's (W1e, W2, b2) zero-padded to the
    kernels' widths (:func:`~epnn_tpu_torch.ops.kernels.pad_weights`; the
    same tensors, no copy, at widths that are multiples of 8).  They depend
    on the weights only; ``Predictor`` makes them once when it serves on
    the card, so no round pads at every call."""
    def padded(w):
        return dataclasses.replace(w, padded=pad_weights(*w.mids[0], w.w1_e))

    return dataclasses.replace(
        fused,
        messages=tuple(padded(w) if kernels_apply(w) else w
                       for w in fused.messages),
        passes=tuple(padded(w) if kernels_apply(w) else w
                     for w in fused.passes))


def _mlp_layers(tree: dict) -> List[Tuple[Tensor, Tensor]]:
    return [(tree[f"dense_{k}"]["kernel"], tree[f"dense_{k}"]["bias"])
            for k in range(len(tree))]


def split_pair_mlp(tree: dict, cfg: EPNNConfig) -> PairMLPWeights:
    layers = _mlp_layers(tree)
    (w1, b1), mids, (wo, bo) = layers[0], layers[1:-1], layers[-1]
    f = cfg.atom_feat_dim
    return PairMLPWeights(w1_i=w1[:f], w1_j=w1[f:2 * f], w1_e=w1[2 * f:],
                          b1=b1, mids=tuple(mids), w_out=wo, b_out=bo)


def fuse_params(params: dict, cfg: EPNNConfig, device=None) -> FusedParams:
    """Convert a parameter tree (see :mod:`epnn_tpu_torch.models.epnn`) to
    fused layout, contiguous on ``device``."""
    p = params["params"] if "params" in params else params
    fused = FusedParams(
        messages=tuple(split_pair_mlp(p[f"message_{t}"], cfg)
                       for t in range(cfg.T)),
        passes=tuple(split_pair_mlp(p[f"pass_{t}"], cfg)
                     for t in range(cfg.T)),
        update=tuple(_mlp_layers(p["update"])),
    )
    return fused.to(device)


def _apply_mlp(layers, x):
    for w, b in layers[:-1]:
        x = torch.relu(x @ w + b)
    w, b = layers[-1]
    return x @ w + b


def _mids(hid, w: PairMLPWeights):
    for wm, bm in w.mids:
        hid = torch.relu(hid @ wm + bm)
    return hid


def rbf_and_gate(d2: Tensor, cmask: Tensor, cfg: EPNNConfig,
                 dtype=torch.float32):
    """Shared pair featurization: RBF edge features + electron-pass gate,
    from squared distances ``d2`` (any shape).  ``cmask`` multiplies the
    envelope (pair validity).  Returns ``(rbf, gate)`` with shapes
    ``d2.shape + (e_dim,)`` and ``d2.shape``, as ``dtype``: the math runs
    in float32 whatever it is, and only the outputs are cast (JAX's
    ``rbf_and_gate``, ``epnn_tpu/ops/fused.py:178-199``)."""
    d2, cmask = d2.float(), cmask.float()
    rbf, c = envelope_rbf(d2, cmask, cfg.cutoff, cfg.eta,
                          rbf_centers(cfg.e_dim, cfg.cutoff, d2.device))
    gate = c if cfg.pass_weighting == "soft_envelope" else hard_gate(
        rbf, cfg.is_near_tol)
    return rbf.to(dtype), gate.to(dtype)


# ---------------------------------------------------------------------------
# neighbor selection
# ---------------------------------------------------------------------------

#: above this atom count, neighbor selection runs in row blocks (the
#: one-shot (N, N) distance matrix would cost O(N²) memory)
_NEIGHBOR_BLOCK_THRESHOLD = 4096
_NEIGHBOR_BLOCK = 1024


def block_neighbor_select(xyz_full, mask_full, start, xyz_rows, mask_rows,
                          cutoff: float, k: int, with_d2: bool = False):
    """Rows [start, start+R) of the pair grid against all columns: the
    within-cutoff candidates (not self, both atoms valid), the k nearest by
    ``torch.topk`` on −d² with −inf for non-candidates.  Returns
    ``(idx, mask[, d2])``, each (R, k); invalid slots carry mask 0, d² 0."""
    n = xyz_full.shape[0]
    d2 = pair_d2(xyz_rows[:, None], xyz_full[None])
    rows = start + torch.arange(xyz_rows.shape[0], device=xyz_full.device)
    cols = torch.arange(n, device=xyz_full.device)
    cand = (d2 < cutoff * cutoff) & (rows[:, None] != cols[None, :])
    cand &= (mask_rows[:, None] > 0) & (mask_full[None, :] > 0)
    score = torch.where(cand, -d2, -math.inf)
    vals, idx = torch.topk(score, k, dim=1)
    valid = vals > -math.inf
    mask_out = valid.to(xyz_full.dtype)
    if with_d2:
        return idx, mask_out, torch.where(valid, -vals, 0.0)
    return idx, mask_out


def build_neighbors(xyz: Tensor, node_mask: Tensor, cutoff: float, k: int,
                    with_d2: bool = False):
    """(idx, nbr_mask)[, d2], each (N, k): the pairs within the cutoff.

    Requires k >= the true max neighbor count (see
    :func:`max_neighbor_count`): top-k drops pairs otherwise, breaking
    antisymmetry.  Row-blocked above ``_NEIGHBOR_BLOCK_THRESHOLD`` atoms."""
    n = xyz.shape[0]
    if n <= _NEIGHBOR_BLOCK_THRESHOLD:
        return block_neighbor_select(xyz, node_mask, 0, xyz, node_mask,
                                     cutoff, k, with_d2)
    outs = [block_neighbor_select(xyz, node_mask, s, xyz[s:s + _NEIGHBOR_BLOCK],
                                  node_mask[s:s + _NEIGHBOR_BLOCK], cutoff, k,
                                  with_d2)
            for s in range(0, n, _NEIGHBOR_BLOCK)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def build_neighbors_batch(xyz: Tensor, node_mask: Tensor, cutoff: float,
                          k: int):
    """Batched :func:`build_neighbors`: (B, N, k) idx + mask + d², graph by
    graph."""
    outs = [build_neighbors(xyz[b], node_mask[b], cutoff, k, with_d2=True)
            for b in range(xyz.shape[0])]
    return tuple(torch.stack(parts) for parts in zip(*outs))


def max_neighbor_count(xyz, node_mask, cutoff: float) -> int:
    """Host-side exact max neighbor count (for choosing a safe static k),
    NumPy float64.  Above ``_NEIGHBOR_BLOCK_THRESHOLD`` atoms by cell
    binning, else by a pairwise scan; both apply ``d² < cutoff²``."""
    xyz = np.asarray(xyz, np.float64)
    mask = np.asarray(node_mask) > 0
    if len(xyz) > _NEIGHBOR_BLOCK_THRESHOLD:
        return _max_neighbor_count_cells(xyz, mask, cutoff)
    return _max_neighbor_count_scan(xyz, mask, cutoff)


def _max_neighbor_count_scan(xyz, mask, cutoff: float) -> int:
    """The O(N²) blockwise pairwise scan (oracle for the cell twin)."""
    best = 0
    for s in range(0, len(xyz), 512):
        rows = slice(s, min(s + 512, len(xyz)))
        d2 = ((xyz[rows, None, :] - xyz[None, :, :]) ** 2).sum(-1)
        near = (d2 < cutoff * cutoff) & mask[None, :] & mask[rows, None]
        for r in range(near.shape[0]):
            near[r, s + r] = False  # exclude self
        best = max(best, int(near.sum(1).max()) if near.size else 0)
    return best


def _max_neighbor_count_cells(xyz, mask, cutoff: float) -> int:
    """Exact cell-binned twin of the O(N²) count: bin valid atoms into
    cutoff-sided cells, table them as (ncells, cap) padded rows, gather
    each atom's 27 neighboring cells' members, and count ``d² < cutoff²``
    in float64."""
    pts = xyz[mask]
    n = len(pts)
    if n == 0:
        return 0
    lo = pts.min(0)
    cell = np.floor((pts - lo) / cutoff).astype(np.int64)
    dims = cell.max(0) + 1
    if int(np.prod(dims)) > 64 * n:
        # sprawling geometry: the dense cell table would dwarf the scan
        return _max_neighbor_count_scan(xyz, mask, cutoff)
    strides = np.array([dims[1] * dims[2], dims[2], 1], np.int64)
    cid = cell @ strides
    order = np.argsort(cid, kind="stable")
    cid_sorted = cid[order]
    _, start, counts = np.unique(cid_sorted, return_index=True,
                                 return_counts=True)
    cap = int(counts.max())
    rank = np.arange(n) - np.repeat(start, counts)
    table = np.zeros((int(np.prod(dims)), cap), np.int64)
    table[cid_sorted, rank] = order + 1          # 1-based; 0 = empty
    offs = np.array([[dx, dy, dz] for dx in (-1, 0, 1)
                     for dy in (-1, 0, 1) for dz in (-1, 0, 1)], np.int64)
    nbr_cells = cell[:, None, :] + offs[None, :, :]          # (n, 27, 3)
    valid_c = np.all((nbr_cells >= 0) & (nbr_cells < dims), axis=-1)
    nbr_ids = np.clip(nbr_cells, 0, dims - 1) @ strides       # (n, 27)
    cand = table[nbr_ids].reshape(n, 27 * cap)
    cand_ok = (cand > 0) & np.repeat(valid_c, cap, axis=1)
    ci = np.maximum(cand - 1, 0)
    d2 = ((pts[:, None, :] - pts[ci]) ** 2).sum(-1)
    near = cand_ok & (d2 < cutoff * cutoff) & (ci != np.arange(n)[:, None])
    return int(near.sum(1).max())


def refresh_neighbor_d2(xyz: Tensor, idx: Tensor) -> Tensor:
    """(B, N, k) squared distances for a fixed (B, N, k) neighbor table
    from the current (B, N, 3) coordinates: the Verlet-skin step's O(N·k)
    gather in place of a selection.  The same expression as every
    selection's d² (:func:`~epnn_tpu_torch.featurize.pair_d2`), so a slot
    within the cutoff gets the selection's bits.  Invalid slots gather
    whatever row their idx names; the table's mask zeroes them."""
    rows = torch.arange(xyz.shape[0], device=xyz.device)[:, None, None]
    return pair_d2(xyz[:, :, None, :], xyz[rows, idx.to(torch.int64)])


def _CELL_INV(cutoff: float) -> float:
    """The binning reciprocal shared by host and device: cells of side
    cutoff/(1 − 1e-6), slightly larger than the cutoff, so that even after
    float32 rounding of the product a pair within the cutoff is within ±1
    cell on every axis."""
    return (1.0 - 1e-6) / cutoff


def cell_grid_params(xyz, node_mask, cutoff: float,
                     pad_cells: float = 1.25) -> Tuple[int, int]:
    """Host-side bounds ``(ncells_pad, cell_cap)`` for
    :func:`build_neighbors_cell`: ``cell_cap`` is the exact largest
    occupancy of one cell, ``ncells_pad`` bounds nx·ny·nz with ``pad_cells``
    of room for coordinate drift.  The binning repeats the builder's on
    the device bit for bit (a float32 subtract, then a float32 multiply
    by the reciprocal): a boundary atom binned differently here would make
    the cap wrong."""
    xyz = np.asarray(xyz, np.float32)
    pts = xyz[np.asarray(node_mask) > 0]
    if len(pts) == 0:
        return 1, 1
    cell = np.floor((pts - pts.min(0)) * np.float32(_CELL_INV(cutoff))
                    ).astype(np.int64)
    dims = cell.max(0) + 1
    # occupancy by linear cell id: the counts of a row-wise unique over
    # (n, 3), from a 1-D unique an order of magnitude faster
    lid = cell[:, 0] + dims[0] * (cell[:, 1] + dims[1] * cell[:, 2])
    _, counts = np.unique(lid, return_counts=True)
    return int(np.ceil(np.prod(dims) * pad_cells)), int(counts.max())


def batch_cell_grid(xyz, node_mask, cutoff: float) -> Tuple[int, int]:
    """:func:`cell_grid_params` over every graph of a (B, N, 3) batch,
    rounded up (ncells to 512, cap to 4) as the JAX package's callers do,
    so that similar geometries share bounds."""
    ncells, cap = 1, 1
    for b in range(len(xyz)):
        nc, cc = cell_grid_params(xyz[b], node_mask[b], float(cutoff))
        ncells, cap = max(ncells, nc), max(cap, cc)
    return -(-ncells // 512) * 512, -(-cap // 4) * 4


def balanced_row_chunk(n: int, max_chunk: int, align: int = 256) -> int:
    """A near-row chunk of at most ``max_chunk`` rows for width ``n``
    with as little padding as ``max_chunk``'s chunk count allows: that
    count of chunks, each ceil(n / count) rows rounded up to ``align``
    (the JAX package's rule and integers).  ``n`` ≤ ``max_chunk``, or
    ``max_chunk`` ≤ 0: ``max_chunk`` unchanged."""
    if max_chunk <= 0 or n <= max_chunk:
        return max_chunk
    nch = -(-n // max_chunk)
    return min(max_chunk, -(-(-(-n // nch)) // align) * align)


def _window_width_device(idx: Tensor, nbr_mask: Tensor, row_chunk: int):
    """:func:`neighbor_window_width`'s raw width on the device: the largest
    (max valid index − min valid index + 1) over row chunks, chunks
    restarting at row 0 of every leading batch entry; a 0-dim tensor."""
    n, k = idx.shape[-2], idx.shape[-1]
    nck = -(-n // row_chunk) * row_chunk
    idx3 = idx.reshape(-1, n, k).to(torch.int64)
    m3 = nbr_mask.reshape(-1, n, k) > 0
    pad = (0, 0, 0, nck - n)
    lo = torch.nn.functional.pad(torch.where(m3, idx3, n - 1), pad,
                                 value=n - 1)
    hi = torch.nn.functional.pad(torch.where(m3, idx3, 0), pad)
    lo = lo.reshape(idx3.shape[0], nck // row_chunk, -1).amin(-1)
    hi = hi.reshape(idx3.shape[0], nck // row_chunk, -1).amax(-1)
    return ((hi - lo).amax() + 1).clamp(min=1)


def neighbor_window_width(idx, nbr_mask, row_chunk: int, align: int = 4096,
                          table_rows: Optional[int] = None) -> int:
    """A safe ``near_window`` for the chunked forward: the largest spread
    (max valid neighbor index − min valid + 1) of any chunk of
    ``row_chunk`` rows, rounded up to ``align`` and capped at the table's
    height (``table_rows``, default ``idx``'s rows).  Compact only when
    the atoms are spatially ordered (cell-sorted); a random order gives
    about N, which the forward treats as no window.  Chunks restart at
    row 0 of every leading batch entry, as the forward runs graph by
    graph.  NumPy tables are scanned on the host, chunk by chunk; tensors
    are reduced on their device with one scalar read back.  0 when
    ``row_chunk`` ≤ 0."""
    if row_chunk <= 0:
        return 0
    n_tbl = int(table_rows) if table_rows is not None else int(
        idx.shape[-2])
    if isinstance(idx, torch.Tensor) or isinstance(nbr_mask, torch.Tensor):
        w = int(_window_width_device(torch.as_tensor(idx),
                                     torch.as_tensor(nbr_mask), row_chunk))
        return min(-(-max(w, 1) // align) * align, n_tbl)
    idx = np.asarray(idx)
    m = np.asarray(nbr_mask) > 0
    n = int(idx.shape[-2])
    idx3 = idx.reshape(-1, n, idx.shape[-1])
    m3 = m.reshape(-1, n, m.shape[-1])
    width = 1
    for b in range(idx3.shape[0]):
        for s in range(0, n, row_chunk):
            mc = m3[b, s:s + row_chunk]
            if not mc.any():
                continue
            ic = idx3[b, s:s + row_chunk][mc]
            width = max(width, int(ic.max()) - int(ic.min()) + 1)
    return min(-(-width // align) * align, n_tbl)


def cell_sort_key(xyz: np.ndarray, cutoff: float):
    """Host-side cutoff-sided cell key of (n, 3) coordinates, x the
    slowest axis and z the fastest: the ordering of ``Predictor``'s
    spatial sort (the JAX package's, the same definition).  Returns ``(key, span)``:
    ``np.argsort(key, kind='stable')`` is the cell-sorted atom order, and
    the keys of a pair within the cutoff (±1 cell a axis) differ by at
    most ``span`` = nmax² + nmax + 1."""
    xyz = np.asarray(xyz)
    cell = np.floor((xyz - xyz.min(0)) / float(cutoff)).astype(np.int64)
    nmax = int(cell.max()) + 1 if cell.size else 1
    key = (cell[:, 0] * nmax + cell[:, 1]) * nmax + cell[:, 2]
    return key, nmax * nmax + nmax + 1


#: the JAX builder's device layouts of the cell table; they give the same
#: bits, so the port has one layout and accepts each name
CELL_TABLE_LAYOUTS = ("slices", "flat", "rows")


def build_neighbors_cell(xyz: Tensor, node_mask: Tensor, cutoff: float,
                         k: int, ncells_pad: int, cell_cap: int,
                         with_d2: bool = False, table_layout: str = "slices",
                         count_only: bool = False, row_chunk: int = 0):
    """Cell-list neighbor selection with :func:`build_neighbors`'s
    ``(idx, nbr_mask[, d2])`` contract, each (N, k), scoring N·27·cap
    candidates instead of N² pairs.

    Atoms are binned into cells of side ~cutoff (:func:`_CELL_INV`) and
    tabled as ``(ncells_pad + 1, cell_cap)`` slots (a stable sort by cell
    id, ranks within a cell in ascending atom order; the last row is the
    sentinel of empty and off-grid cells).  Each atom's candidates are the
    slots of its 27 neighboring cells in (dx, dy, dz) order, slots minor;
    one stable sort by d² carrying the candidate ids picks the nearest k,
    so equal d² keep candidate order.  A pair within the cutoff is within
    ±1 cell a axis, so the candidates hold every neighbor as long as
    ``cell_cap`` is the true largest occupancy (get both bounds from
    :func:`cell_grid_params`; too small a cap or k drops pairs).

    ``count_only`` returns the largest number of neighbors of any row as
    a 0-dim tensor, from the same float32 predicate: the exact safe k for
    a build (``k`` unused).  ``table_layout`` names one of the JAX
    package's layouts (:data:`CELL_TABLE_LAYOUTS`), which give the same
    bits.  ``row_chunk`` > 0 scores and sorts rows in blocks of that many
    (the same bits, peak memory O(row_chunk·27·cap)); ``'slices'`` only,
    as in JAX.  Runs on the device of ``xyz`` without a host sync."""
    if table_layout not in CELL_TABLE_LAYOUTS:
        raise ValueError(f"table_layout must be one of {CELL_TABLE_LAYOUTS}")
    if row_chunk and table_layout != "slices":
        raise ValueError("row_chunk is supported for the 'slices' layout "
                         "only (the default)")
    dev = xyz.device
    n = xyz.shape[0]
    xyz = xyz.to(torch.float32)
    real = node_mask > 0
    # float32 scalars on the host: a Python float could be taken at another
    # precision, and a card tensor would cost a copy and a sync
    f32 = lambda v: torch.tensor(np.float32(v))  # noqa: E731
    origin = torch.where(real[:, None], xyz, 3e38).amin(0)
    c3 = torch.floor((xyz - origin) * f32(_CELL_INV(cutoff)))
    c3 = c3.clamp(0.0, 2.0 ** 30).to(torch.int64)
    dims = torch.where(real[:, None], c3, 0).amax(0) + 1
    lid = c3[:, 0] + dims[0] * (c3[:, 1] + dims[1] * c3[:, 2])
    lid = torch.where(real, lid.clamp(max=ncells_pad - 1), ncells_pad)

    # slots: a stable sort by cell id, then each atom's rank in its cell
    pos = torch.arange(n, device=dev)
    order = torch.argsort(lid, stable=True)
    s_lid = lid[order]
    head = torch.ones(n, dtype=torch.bool, device=dev)
    head[1:] = s_lid[1:] != s_lid[:-1]
    rank = pos - torch.cummax(torch.where(head, pos, 0), dim=0).values
    tbl_len = (ncells_pad + 1) * cell_cap
    slot = torch.where(rank < cell_cap, s_lid * cell_cap + rank, tbl_len)
    tbl = torch.full((tbl_len + 1,), n, dtype=torch.int64, device=dev)
    tbl[slot] = order                    # rank >= cap: the spare slot
    tbl = tbl[:tbl_len].view(ncells_pad + 1, cell_cap)

    # the 27 neighbor cells of each atom (off-grid: the sentinel row)
    o = torch.arange(27, device=dev)
    offs = torch.stack([o // 9, o // 3 % 3, o % 3], dim=1) - 1
    nc = c3[:, None, :] + offs[None]
    ok = ((nc >= 0) & (nc < dims)).all(-1) & real[:, None]
    nlid = nc[..., 0] + dims[0] * (nc[..., 1] + dims[1] * nc[..., 2])
    nlid = torch.where(ok, nlid.clamp(max=ncells_pad - 1), ncells_pad)

    # candidates of an empty slot read the sentinel atom n: no mask
    xyz_ext = torch.cat([xyz, xyz.new_zeros((1, 3))])
    mask_ext = torch.cat([node_mask.to(torch.float32),
                          xyz.new_zeros((1,))])
    cut2 = f32(cutoff * cutoff)

    def score(sl):
        """(dkey, cand) of rows ``sl``, each (rows, 27·cap): d² of the
        candidates within the cutoff, +inf elsewhere."""
        cand = tbl[nlid[sl]]                               # (m, 27, cap)
        d2 = pair_d2(xyz[sl, None, None, :], xyz_ext[cand])
        valid = ((cand < n) & (cand != pos[sl, None, None])
                 & (mask_ext[cand] > 0) & real[sl, None, None]
                 & (d2 < cut2))
        m = cand.shape[0]
        return (torch.where(valid, d2, math.inf).reshape(m, -1),
                cand.reshape(m, -1))

    blocks = [slice(s, s + row_chunk) for s in range(0, n, row_chunk)] \
        if row_chunk else [slice(None)]
    if count_only:
        return torch.stack([(score(sl)[0] < math.inf).sum(1).amax()
                            for sl in blocks]).amax()
    dks, idxs = [], []
    for sl in blocks:
        dkey, cand = score(sl)
        dsort, perm = torch.sort(dkey, dim=1, stable=True)
        dks.append(dsort[:, :k])
        idxs.append(cand.gather(1, perm[:, :k]))
    dk, idx = torch.cat(dks), torch.cat(idxs).clamp(0, n - 1)
    valid = dk < math.inf
    nbr_mask = valid.to(xyz.dtype)
    if with_d2:
        return idx, nbr_mask, torch.where(valid, dk, 0.0)
    return idx, nbr_mask


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

def kernels_apply(w: PairMLPWeights) -> bool:
    """Whether a round's weights take the CUDA kernels: JAX's rule, exactly
    one mid layer (``epnn_tpu/ops/fused.py:1245``, ``:1301``, ``:1356``,
    ``:1798``).  Rounds of another depth run the same split through the
    plain versions at any width, on the CPU and the card alike, as JAX's
    XLA branches do: a rule of the configuration, not a fallback on
    failure."""
    return len(w.mids) == 1


def _kernel_round(w: PairMLPWeights) -> bool:
    """Whether a round takes the kernels: :func:`kernels_apply`, and its
    weights in float32 (the kernels' type).  Under
    ``compute_dtype="bfloat16"`` the message rounds run in bf16 through
    the plain versions, as JAX's bf16 recursion runs no Pallas call; its
    float32 pass rounds keep the kernels."""
    return kernels_apply(w) and w.w1_i.dtype == torch.float32


def _bf16_halves(x: Tensor) -> Tuple[Tensor, Tensor]:
    """(hi, lo) of JAX's split-float: hi = bf16(x), lo = bf16(x − hi), both
    as float32 (exact)."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x.float() - hi).to(torch.bfloat16).float()


def _mm_bf16x3(a: Tensor, b: Tensor, c: Optional[Tensor] = None) -> Tensor:
    """``a @ b (+ c)`` in JAX's bf16x3 (``_split_dot``,
    ``epnn_tpu/ops/fused.py:55-72``): a_hi·b_hi + (a_hi·b_lo + a_lo·b_hi),
    float32 out.  The halves are upcast before the products, so each
    product of two bf16 values is exact in float32, as JAX's
    ``preferred_element_type=float32`` gives it; only the order of the
    float32 sums differs."""
    ah, al = _bf16_halves(a)
    bh, bl = _bf16_halves(b)
    out = ah @ bh + (ah @ bl + al @ bh)
    return out if c is None else out + c


def dense_message_rowsum_bf16x3_plain(pi, pj, col_vec, *mids):
    """The far field in ``dense_matmul_precision="bf16x3"`` (JAX's
    ``dense_scan``, ``epnn_tpu/ops/fused.py:1256-1272``): every mid layer
    through :func:`_mm_bf16x3`, then the j-reduction Σ_j col_vec_j · hid
    split the same way, as (R, H) float32, row-blocked.  JAX runs no
    kernel in this tier, so neither does the port, on the CPU or the
    card.  ``mids`` as in
    :func:`~epnn_tpu_torch.ops.kernels.dense_message_rowsum_plain`."""
    layers = _layers(mids)
    r, h = pi.shape
    n = pj.shape[0]
    rb = _plain_rows(r, n, max([h] + [w.shape[1] for w, _ in layers]))
    out = pi.new_empty((r, layers[-1][0].shape[1] if layers else h),
                       dtype=torch.float32)
    vh, vl = _bf16_halves(col_vec)
    for s in range(0, r, rb):
        hid = _mid_layers(pi[s:s + rb, None, :] + pj[None, :, :], layers,
                          _mm_bf16x3)
        hh, hl = _bf16_halves(hid)
        out[s:s + rb] = (torch.einsum("n,bnh->bh", vh, hh)
                         + (torch.einsum("n,bnh->bh", vh, hl)
                            + torch.einsum("n,bnh->bh", vl, hh)))
    return out


def _dense_message_pad(block_i: int, block_jp: int, h: int) -> int:
    """The atom-count multiple the JAX far-field kernel requires
    (``epnn_tpu/ops/pallas_kernels.py:138``)."""
    pack = max(1, 128 // h) if 128 % h == 0 else 1
    return math.lcm(block_i, pack * block_jp)


def _int8_pad_pi(w: PairMLPWeights, n: int) -> Optional[Tensor]:
    """The pi of the padding rows JAX's int8 kernel would see in its
    maxima, or None where it pads none.  From 128 atoms
    ``forward_blocked`` pads the graph to a multiple of
    ``dense_message_pad(128, 64, H)`` with empty atoms, whose pi is b1 and
    pj 0 (``epnn_tpu/ops/fused.py:902-915``); below 128 the kernel's
    operands are padded with zero rows to a multiple of
    ``dense_message_pad(8, 8, H)`` (``:1091-1095``, ``:1250-1253``).  The
    port pads nothing; the int8 kernel adds these rows to its maxima."""
    h = w.b1.shape[0]
    if n >= 128:
        if n % _dense_message_pad(128, 64, h) == 0:
            return None
        return w.b1.amax() if w.int8 is None else w.int8[2]
    if n % _dense_message_pad(8, 8, h) == 0:
        return None
    return w.b1.new_zeros(())


def _padded(w: PairMLPWeights) -> dict:
    """The kernel wrappers' ``padded`` keyword where the round keeps padded
    weights (:func:`pad_kernel_weights`); else the wrappers pad per call."""
    return {} if w.padded is None else {"padded": w.padded}


def _flat(mids) -> Tuple[Tensor, ...]:
    """``((W2, b2), ...)`` → ``(W2, b2, ...)``, as the kernel wrappers and
    the plain versions take them."""
    return tuple(t for layer in mids for t in layer)


def _atom_inputs(x: Tensor, h: Tensor, q: Tensor) -> Tensor:
    return torch.cat([x, h, q[:, None].to(x.dtype)], dim=-1)


def far_cluster_fit_kw() -> dict:
    """The clustered far field's fit settings, read from the environment at
    every call with the JAX package's names and defaults (JAX reads them
    when it traces, ``epnn_tpu/ops/fused.py:1141-1152``):
    ``EPNN_FAR_CLUSTER_ITERS`` (8), ``EPNN_FAR_CLUSTER_FIT_PREC``
    ('highest'; any other value is JAX's 'default'),
    ``EPNN_FAR_CLUSTER_FIT_ROWS`` (0) and ``EPNN_FAR_CLUSTER_SEED``
    ('norm').  They move only where the centroids land."""
    env = os.environ.get
    return dict(
        iters=int(env("EPNN_FAR_CLUSTER_ITERS", "8")),
        fit_precision=("highest" if env("EPNN_FAR_CLUSTER_FIT_PREC",
                                        "highest") == "highest"
                       else "default"),
        fit_rows=int(env("EPNN_FAR_CLUSTER_FIT_ROWS", "0")),
        seed=env("EPNN_FAR_CLUSTER_SEED", "norm"))


def _cluster_pad_rows(c: int, h: int) -> int:
    """The centroid row count JAX's far-field kernel call pads C to
    (``epnn_tpu/ops/fused.py:1216-1222``, its packed-row contract): the
    int8 tier's max(pj) takes the zero rows it adds."""
    pack = max(1, 128 // h) if 128 % h == 0 else 1
    rows = -(-c // pack)
    if rows > 64:
        rows = -(-rows // 64) * 64
    return rows * pack


def _clustered_far_field(w: PairMLPWeights, pi: Tensor, pj: Tensor,
                         jvec: Tensor, c: int, grad: bool, int8: bool,
                         fit_kw: dict, precision: str):
    """One message round's far field over C weighted k-means centroids of
    the pj rows (JAX ``epnn_tpu/ops/fused.py:1197-1244``): ``(dense_sum,
    radius)``.  A round that :func:`_kernel_round` admits runs the
    far-field kernel at ``precision`` with the C centroids as its columns
    and their weights as cv (under ``int8`` its int8 tier, pi's padding as
    on the exact path and pj's as JAX pads the centroid rows); another
    depth runs the plain version over the centroids, as JAX's XLA branch
    does."""
    with span("epnn.forward.far_cluster_fit"):
        cent, wts, rad = weighted_kmeans(pj, jvec, c, differentiable=grad,
                                         **fit_kw)
    cent = cent.contiguous()
    mids = _flat(w.mids)
    if not _kernel_round(w):
        return dense_message_rowsum_plain(pi, cent, wts, *mids), rad
    if int8:
        return dense_message_rowsum_int8(
            pi, cent, wts, *mids, pad_pi=_int8_pad_pi(w, pi.shape[0]),
            pad_pj=_cluster_pad_rows(c, w.b1.shape[0]) > c,
            w2_int8=None if w.int8 is None else w.int8[:2],
            precision=precision, **_padded(w)), rad
    return dense_message_rowsum(pi, cent, wts, *mids, precision=precision,
                                **_padded(w)), rad


def round1_counts(x: Tensor, jvec: Tensor) -> Tuple[Tensor, Tensor]:
    """The round-1 collapse's per-element table of rows ``x`` (``[Z,
    onehot]``): ``(zvec (E,), counts (E+1,))``, each element's Z and the
    jvec-weighted count of its atoms, the padding rows' last.  Counts in
    float32 whatever the compute type, as JAX's (17,760 is no bf16
    integer).  Sharded callers reduce both over their blocks (max, sum)."""
    oh = x[:, 1:]
    zvec = torch.amax(x[:, :1] * oh, dim=0)
    jvec32 = jvec.float()
    counts = jvec32 @ oh.float()
    return zvec, torch.cat([counts, (jvec32.sum() - counts.sum())[None]])


def round1_far_field(pi: Tensor, w: PairMLPWeights, cfg: EPNNConfig,
                     zvec: Tensor, q0v: Tensor, counts: Tensor) -> Tensor:
    """Message round 1's far field collapsed to the count-weighted grid:
    a valid atom's input row is [Z_e, onehot_e | 0_h | q0], fixed by its
    element, and padding rows are all zero, so Σ_j over the atoms is Σ_e
    counts_e over the E + 1 grid rows.  ``q0v`` (1,): the valid atoms'
    shared q0; ``zvec``, ``counts`` from :func:`round1_counts`."""
    e_cnt = zvec.shape[0]
    dt, dev = zvec.dtype, zvec.device
    grid_in = torch.cat([
        zvec[:, None],
        torch.eye(e_cnt, dtype=dt, device=dev),
        zvec.new_zeros((e_cnt, cfg.h_dim)),
        q0v[:, None].to(dt).expand(e_cnt, 1),
    ], dim=1)
    grid_in = torch.cat([grid_in, zvec.new_zeros((1, grid_in.shape[1]))])
    pj_grid = grid_in @ w.w1_j
    hid_g = _mids(torch.relu(pi[:, None, :] + pj_grid[None, :, :]), w)
    return torch.einsum("e,neh->nh", counts, hid_g.float()).to(dt)


def _run(remat: bool):
    """How a round or a chunk body runs: under
    ``torch.utils.checkpoint.checkpoint`` (``use_reentrant=False``; no
    randomness to replay) when ``remat`` is asked for and autograd
    records, so the backward recomputes the region instead of keeping
    its activations; else as a plain call."""
    if remat and torch.is_grad_enabled():
        return lambda fn, *args: checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False)
    return lambda fn, *args: fn(*args)


def _neighbor_tables(xyz: Tensor, node_mask: Tensor, cfg: EPNNConfig,
                     k: int, neighbors, neighbor_grid):
    """``(idx, nbr_mask, d2)``, each (N, k), of one graph: the given
    3-tuple; a 2-tuple with d² from the current coordinates
    (:func:`refresh_neighbor_d2`, once a call); else the cell-list
    builder on ``neighbor_grid`` = ``(ncells_pad, cell_cap[,
    table_layout[, row_chunk]])``, or top-k without one."""
    if neighbors is None and neighbor_grid is not None:
        ncells_pad, cell_cap, *rest = neighbor_grid
        neighbors = build_neighbors_cell(
            xyz, node_mask, cfg.cutoff, k, ncells_pad, cell_cap,
            with_d2=True, table_layout=rest[0] if rest else "slices",
            row_chunk=rest[1] if len(rest) > 1 else 0)
    elif neighbors is None:
        neighbors = build_neighbors(xyz, node_mask, cfg.cutoff, k,
                                    with_d2=True)
    if len(neighbors) == 3:
        return neighbors
    # d² from the current coordinates: symmetric bit for bit, as
    # near_pass_rowsum's antisymmetry needs
    idx, nbr_mask = neighbors
    idx = idx.to(torch.int64)
    return idx, nbr_mask, refresh_neighbor_d2(xyz[None], idx[None])[0]


def _window_rows(idx: Tensor, mask: Tensor, n: int, nwin: int):
    """A row block's gather rows (flat) and slot weights.  With a window
    of ``nwin`` rows (0 < nwin < n) the block reads only table rows
    [start, start + nwin), start its smallest valid neighbor index
    clipped to [0, n − nwin], at window-relative indices; a slot whose
    neighbor lies outside gets weight 0 (dropped, never read as another
    row's value)."""
    if not nwin or idx.numel() == 0:
        return idx.reshape(-1), mask
    idx = idx.to(torch.int64)
    start = torch.where(mask > 0, idx, n - 1).amin().clamp(0, n - nwin)
    rel = idx - start
    inside = (rel >= 0) & (rel < nwin)
    return ((start + rel.clamp(0, nwin - 1)).reshape(-1),
            mask * inside.to(mask.dtype))


def _forward_single_nbr(
    fused: FusedParams,
    x: Tensor,          # (N, n_elems)
    q0: Tensor,         # (N,)
    xyz: Tensor,        # (N, 3)
    node_mask: Tensor,  # (N,)
    cfg: EPNNConfig,
    k: int,
    uniform_q0: bool = False,
    neighbors: Optional[Tuple[Tensor, ...]] = None,
    int8: bool = False,
    neighbor_grid: Optional[Tuple] = None,
    far_cluster: int = 0,
    far_diag: bool = False,
    far_cluster_grad: bool = False,
    remat: bool = False,
    near_row_chunk: int = 0,
    near_window: int = 0,
):
    """One graph through the neighbor-split forward.

    ``uniform_q0`` asserts the caller's contract that every valid atom
    carries the same initial charge (valid atoms first, zeros on padding)
    and that x rows are ``[Z, onehot]``: message round 1 then has h = 0
    and q = q0, so the j-side projection takes one value per element plus
    the all-zero padding row, and the round's O(N²) far-field reduction
    collapses exactly to a count-weighted (N, E+1) grid.  Rounds 2+ run
    the far-field kernel, or with ``int8`` its int8 tier
    (:func:`dense_message_rowsum_int8`; the collapse, the near correction
    and the pass rounds keep float32, so conservation is untouched).

    Each round takes the three kernels where :func:`kernels_apply` says
    so, and otherwise runs the same split through their plain versions at
    any depth (``int8`` then has no effect, as in JAX's XLA branch).

    ``neighbors`` — precomputed ``(idx, nbr_mask, d2)``, each (N, k), from
    :func:`build_neighbors`, or ``(idx, nbr_mask)`` (as
    :func:`epnn_tpu_torch.ops.kernels.neighbor_compact` builds it, or a
    Verlet-skin table), whose d² is then taken from the current
    coordinates (:func:`refresh_neighbor_d2`, once a call); skips the
    selection.  Without it, ``neighbor_grid`` — ``(ncells_pad, cell_cap[,
    table_layout[, row_chunk]])`` from :func:`cell_grid_params` — selects
    through the cell-list builder (:func:`build_neighbors_cell`, its
    ``row_chunk`` bounding the build's memory), and otherwise top-k over
    −d² does (:func:`build_neighbors`); both give the same set.

    ``far_cluster`` = C > 0: the clustered far-field tier, JAX's opt-in
    approximation.  Every message round that the round-1 collapse does not
    take fits C weighted k-means centroids to its pj rows
    (:func:`~epnn_tpu_torch.ops.cluster.weighted_kmeans`, the fit settings
    of :func:`far_cluster_fit_kw`) and runs its far field over them,
    O(N·C) in place of O(N²) (:func:`_clustered_far_field`).  The near
    correction and every pass round stay exact, so conservation is
    untouched.  ``far_cluster_grad``: the fit's differentiable mode (the
    training tier's exact VJP of the approximation).  ``far_diag``: return
    ``(q, radius)``, the largest intra-cluster radius over the rounds, the
    measured factor of the error bound.

    ``near_row_chunk`` > 0: the huge-N memory mode.  Only the (N, k)
    tables (idx, mask, d²) stay resident; each round runs its near
    correction or pass sums in blocks of that many rows, rebuilding the
    block's RBF and gate from its d² rows, gathering the block's pj (or
    [pi | pj]) rows and launching the near kernel on the block.  The
    kernels sum each row over its own slots in a fixed order, so the
    charges are those of the full-width forward, and each pair of a pass
    round stays an exact negation.  The far field is O(N) in memory
    already and runs full width.  ``near_window`` (0 < W < N, with
    chunks): each block gathers through a window of W table rows
    (:func:`_window_rows`); it is the full-width result when every
    block's neighbor spread fits (:func:`neighbor_window_width`), and
    drops the pairs outside otherwise.  ``remat``: each round, and each
    block under chunking, runs under ``torch.utils.checkpoint`` (the
    backward recomputes it; the near kernels' plain backward then holds
    one block's activations at a time)."""
    if far_diag and far_cluster <= 0:
        raise ValueError("far_diag requires far_cluster > 0")
    n = x.shape[0]
    dense, near = dense_precision(cfg), near_precision(cfg)
    # the clustered far field runs JAX's kernel call at the far field's
    # precision, and under bf16x3 (no kernel in JAX) the model's
    far_c = main_precision(cfg) if dense == "bf16x3" else dense
    with span("epnn.select.build"):
        idx, nbr_mask, d2_nbr = _neighbor_tables(xyz, node_mask, cfg, k,
                                                 neighbors, neighbor_grid)
    nbr_mask = nbr_mask.to(x.dtype).contiguous()
    chunks = ([slice(s, min(s + near_row_chunk, n))
               for s in range(0, n, near_row_chunk)]
              if near_row_chunk > 0 else [slice(0, n)])
    nwin = near_window if near_row_chunk > 0 and 0 < near_window < n else 0
    gathers = [_window_rows(idx[sl], nbr_mask[sl], n, nwin) for sl in chunks]

    def features(i: int):
        """(rbf (c·k, E), gh (c, k)) of row block i: RBF from the block's
        d² rows, gh = 0.5 · gate · slot weight."""
        sl = chunks[i]
        with span("epnn.forward.features"):
            rbf, gate = rbf_and_gate(d2_nbr[sl], nbr_mask[sl], cfg, x.dtype)
            return (rbf.reshape(-1, rbf.shape[-1]).contiguous(),
                    (0.5 * (gate * gathers[i][1])).contiguous())

    # full width: the features once a call; chunked: once a block a round
    resident = [features(0)] if near_row_chunk <= 0 else None
    run, run_block = _run(remat), _run(remat and near_row_chunk > 0)

    def near_blocks(body, *args):
        outs = [run_block(body, i, *args) for i in range(len(chunks))]
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def near_message(i, pi, pj, w):
        rbf, _ = resident[0] if resident else features(i)
        gidx, wgt = gathers[i]
        args = (pi[chunks[i]], torch.index_select(pj, 0, gidx), rbf, wgt,
                w.w1_e, *_flat(w.mids))
        return (near_message_corr(*args, precision=near, **_padded(w))
                if _kernel_round(w) else near_message_corr_plain(*args))

    def near_pass(i, rs, w):
        rbf, gh = resident[0] if resident else features(i)
        # the pass rounds run at the pass weights' type (float32 under
        # bf16 compute; JAX upcasts the bf16 features the same way)
        args = (rs[chunks[i]], torch.index_select(rs, 0, gathers[i][0]),
                rbf.to(rs.dtype), gh.to(rs.dtype), w.w1_e, *_flat(w.mids))
        return (near_pass_rowsum(*args, precision=near, **_padded(w))
                if _kernel_round(w) else near_pass_rowsum_plain(*args))

    # Σ_j pair_mask_ij = mask_i · Σ_j mask_j, without the (N, N) plane
    if cfg.mask_messages:
        msg_count = node_mask * torch.sum(node_mask)
        jvec = node_mask.contiguous()
    else:
        msg_count = torch.full((n,), float(n), dtype=x.dtype, device=x.device)
        jvec = torch.ones(n, dtype=x.dtype, device=x.device)

    nm = node_mask[:, None]
    fit_kw = far_cluster_fit_kw() if far_cluster > 0 else {}

    def message_round(t, h, q, rad):
        w = fused.messages[t]
        kern = _kernel_round(w)
        mids = _flat(w.mids)
        a = _atom_inputs(x, h, q)
        pi = (a @ w.w1_i + w.b1).contiguous()   # b1 folded once per atom
        pj = (a @ w.w1_j).contiguous()
        if t == 0 and uniform_q0:
            zvec, counts = round1_counts(x, jvec)
            dense_sum = round1_far_field(pi, w, cfg, zvec, q[:1], counts)
        elif far_cluster > 0:
            dense_sum, r_round = _clustered_far_field(
                w, pi, pj, jvec, far_cluster, far_cluster_grad, int8, fit_kw,
                far_c)
            rad = torch.maximum(rad, r_round)
        elif dense == "bf16x3":
            dense_sum = dense_message_rowsum_bf16x3_plain(
                pi, pj, jvec, *mids).to(pi.dtype)
        elif not kern:
            dense_sum = dense_message_rowsum_plain(pi, pj, jvec, *mids)
        elif int8:
            dense_sum = dense_message_rowsum_int8(
                pi, pj, jvec, *mids, pad_pi=_int8_pad_pi(w, n),
                w2_int8=None if w.int8 is None else w.int8[:2],
                precision=dense, **_padded(w))
        else:
            dense_sum = dense_message_rowsum(pi, pj, jvec, *mids,
                                             precision=dense, **_padded(w))
        hsum = dense_sum + near_blocks(near_message, pi, pj, w)
        messages = hsum @ w.w_out + msg_count[:, None] * w.b_out
        upd_in = torch.cat([h, messages], dim=-1) * nm
        return _apply_mlp(fused.update, upd_in) * nm, rad

    # electron passing: gathered pairs only (the gate is zero off the near set)
    def pass_round(t, h, q):
        w = fused.passes[t]
        a = _atom_inputs(x, h, q).to(w.w1_i.dtype)
        rs = torch.cat([a @ w.w1_i + w.b1, a @ w.w1_j], dim=-1)
        dsum = near_blocks(near_pass, rs, w)
        return q + (dsum @ w.w_out)[:, 0]

    h = x.new_zeros((n, cfg.h_dim))
    q = q0
    rad = x.new_zeros(())
    for t in range(len(fused.messages)):
        with span("epnn.forward.message", t):
            h, rad = run(message_round, t, h, q, rad)
    for t in range(len(fused.passes)):
        with span("epnn.forward.pass", t):
            q = run(pass_round, t, h, q)
    if far_diag:
        return q * node_mask, rad
    return q * node_mask


def _forward_single(
    fused: FusedParams,
    x: Tensor,          # (N, n_elems)
    q0: Tensor,         # (N,)
    xyz: Tensor,        # (N, 3)
    node_mask: Tensor,  # (N,)
    cfg: EPNNConfig,
    block: int = 128,
    remat: bool = False,
) -> Tensor:
    """One graph through the dense blocked forward in plain PyTorch (the
    JAX package runs this path in XLA): rows in blocks of ``block`` against
    all atoms, so peak memory is O(block·N·E).  Any MLP depth;
    differentiable through autograd.  Messages weight pairs by the pair
    mask with its diagonal kept (``mask_messages``) or count all N
    columns; the RBF clears self pairs.  ``remat``: each round runs under
    ``torch.utils.checkpoint``.  On the card it is the plain reference of
    the fused dense path."""
    n = x.shape[0]
    cols = torch.arange(n, device=x.device)
    if cfg.mask_messages:
        msg_count = node_mask * torch.sum(node_mask)
    else:
        msg_count = torch.full((n,), float(n), dtype=x.dtype, device=x.device)

    def row_blocks():
        """(rows, pair mask, RBF validity, rbf, gate) of each row block, the
        features in float32 (a bf16 message round casts them at use);
        rebuilt every round, as the JAX scan does, to keep memory at
        O(block·N·E)."""
        for s in range(0, n, block):
            sl = slice(s, s + block)
            rows = s + torch.arange(xyz[sl].shape[0], device=x.device)
            pairm = node_mask[sl, None] * node_mask[None, :]
            valid = pairm * (rows[:, None] != cols[None, :])
            rbf, gate = rbf_and_gate(pair_d2(xyz[sl, None], xyz[None]),
                                     valid, cfg)
            yield sl, pairm, valid, rbf, gate

    nm = node_mask[:, None]

    def message_round(w, h, q):
        a = _atom_inputs(x, h, q)
        pi, pj = a @ w.w1_i, a @ w.w1_j
        sums = []
        for sl, pairm, _, rbf, _ in row_blocks():
            hid = torch.relu((pi[sl, None, :] + pj[None, :, :])
                             + rbf.to(w.w1_e.dtype) @ w.w1_e + w.b1)
            hid = _mids(hid, w)
            if cfg.mask_messages:
                hid = hid * pairm[:, :, None]
            sums.append(torch.sum(hid, dim=1))
        messages = torch.cat(sums) @ w.w_out + msg_count[:, None] * w.b_out
        upd_in = torch.cat([h, messages], dim=-1) * nm
        return _apply_mlp(fused.update, upd_in) * nm

    # b_out cancels in f_ij − f_ji: the transfer is a W_out contraction;
    # float32 under bf16 compute (the pass weights' type), as JAX's
    def pass_round(w, h, q):
        a = _atom_inputs(x, h, q).to(w.w1_i.dtype)
        pi, pj = a @ w.w1_i, a @ w.w1_j
        sums = []
        for sl, _, valid, rbf, gate in row_blocks():
            epart = rbf @ w.w1_e
            hid_n = torch.relu((pi[sl, None, :] + pj[None, :, :]) + epart
                               + w.b1)
            hid_t = torch.relu((pi[None, :, :] + pj[sl, None, :]) + epart
                               + w.b1)
            hid_n, hid_t = _mids(hid_n, w), _mids(hid_t, w)
            weight = (valid * gate)[:, :, None]
            sums.append(torch.sum(0.5 * weight * (hid_n - hid_t), dim=1))
        return q + (torch.cat(sums) @ w.w_out)[:, 0]

    run = _run(remat)
    h = x.new_zeros((n, cfg.h_dim))
    q = q0
    for w in fused.messages:
        h = run(message_round, w, h, q)
    for w in fused.passes:
        q = run(pass_round, w, h, q)
    return q * node_mask


def _forward_single_pallas(
    fused: FusedParams,
    x: Tensor,          # (N, n_elems)
    q0: Tensor,         # (N,)
    xyz: Tensor,        # (N, 3)
    node_mask: Tensor,  # (N,)
    cfg: EPNNConfig,
    remat: bool = False,
    rbf_method: str = "direct",
) -> Tensor:
    """One graph through the fully fused dense forward: each round is one
    kernel over the whole pair grid at the model's precision
    (:func:`~epnn_tpu_torch.models.config.main_precision`, as JAX's calls)
    — :func:`fused_message_rowsum` for the message rounds,
    :func:`fused_epn_rowsum` for the pass rounds — with the
    RBF, gate, pair MLP and (for passing) both orderings built in the tile;
    only (N, ·) tensors leave it.  Inference-only, as in the JAX package
    (``remat`` checkpoints each round, as JAX's does, and changes nothing
    here: the kernels record no graph).  ``rbf_method``: the kernels'
    channels, JAX's "direct" or "doubling" (two exps a pair; ~1e-6
    relative from direct, which can flip a hard gate at the tolerance).
    No padding: the kernels mask their own edges, and ``col_vec`` is ones
    on the caller's width, so ``mask_messages=False`` counts exactly its
    columns."""
    n = x.shape[0]
    xyz = xyz.contiguous()
    node_mask = node_mask.contiguous()
    col_vec = torch.ones(n, dtype=x.dtype, device=x.device)
    if cfg.mask_messages:
        msg_count = node_mask * torch.sum(node_mask)
    else:
        msg_count = torch.full((n,), float(n), dtype=x.dtype, device=x.device)
    pair_kw = dict(cutoff=cfg.cutoff, eta=cfg.eta, tol=cfg.is_near_tol,
                   rbf_method=rbf_method)

    nm = node_mask[:, None]
    soft = cfg.pass_weighting == "soft_envelope"
    precision = main_precision(cfg)

    def message_round(w, h, q):
        (w2, b2), = w.mids
        a = _atom_inputs(x, h, q)
        pi = (a @ w.w1_i + w.b1).contiguous()   # b1 folded once per atom
        pj = (a @ w.w1_j).contiguous()
        hsum = fused_message_rowsum(pi, pj, xyz, node_mask, col_vec, w.w1_e,
                                    w2, b2, masked=cfg.mask_messages,
                                    precision=precision, **_padded(w),
                                    **pair_kw)
        messages = hsum @ w.w_out + msg_count[:, None] * w.b_out
        upd_in = torch.cat([h, messages], dim=-1) * nm
        return _apply_mlp(fused.update, upd_in) * nm

    def pass_round(w, h, q):
        (w2, b2), = w.mids
        a = _atom_inputs(x, h, q)
        pi = (a @ w.w1_i + w.b1).contiguous()
        pj = (a @ w.w1_j).contiguous()
        dsum = fused_epn_rowsum(pi, pj, xyz, node_mask, w.w1_e, w2, b2,
                                soft_gate=soft, precision=precision,
                                **_padded(w), **pair_kw)
        return q + (dsum @ w.w_out)[:, 0]        # b_out cancels

    run = _run(remat)
    h = x.new_zeros((n, cfg.h_dim))
    q = q0
    for w in fused.messages:
        h = run(message_round, w, h, q)
    for w in fused.passes:
        q = run(pass_round, w, h, q)
    return q * node_mask


def forward_blocked(
    fused: FusedParams,
    x: Tensor,          # (B, N, n_elems)
    q0: Tensor,         # (B, N)
    xyz: Tensor,        # (B, N, 3)
    node_mask: Tensor,  # (B, N)
    cfg: EPNNConfig,
    block: int = 128,
    neighbor_k: Optional[int] = None,
    use_pallas: bool = False,
    pack_to: int = 1,
    remat: bool = False,
    neighbors: Optional[Tuple[Tensor, ...]] = None,
    neighbor_grid: Optional[Tuple] = None,
    uniform_q0: bool = False,
    far_cluster: int = 0,
    far_diag: bool = False,
    far_cluster_grad: bool = False,
    near_row_chunk: int = 0,
    near_window: int = 0,
):
    """Batched blocked forward from raw coordinates: (B, N) charges.
    Graphs run one after another (a Python loop, not a batched kernel).
    The parameters are JAX's, in JAX's order.

    With ``neighbor_k`` (≥ the true max neighbor count within the cutoff,
    :func:`max_neighbor_count`): the neighbor-split forward
    (:func:`_forward_single_nbr`).  ``neighbors`` — optional precomputed
    ``(idx, nbr_mask, d2)`` batch arrays (B, N, neighbor_k) from
    :func:`build_neighbors_batch`, or ``(idx, nbr_mask)`` (e.g. from
    :func:`epnn_tpu_torch.ops.kernels.neighbor_compact`), whose d² is
    recomputed from the coordinates.  Without ``neighbors``,
    ``neighbor_grid`` (``(ncells_pad, cell_cap)`` covering every graph,
    :func:`cell_grid_params`, optionally with ``table_layout`` and the
    builder's ``row_chunk``) selects each graph's neighbors through the
    cell-list builder, else top-k does.  ``uniform_q0`` — see
    :func:`_forward_single_nbr`.  The float32 kernels run on every CUDA
    tensor whose round :func:`kernels_apply` admits, whatever
    ``use_pallas`` says; ``use_pallas`` selects the far field's int8 tier
    when ``cfg.dense_matmul_precision == "int8"`` (as JAX's ``pallas_ok``,
    ``epnn_tpu/ops/fused.py:1091-1101``).  Without it, int8 runs the
    unquantized far field, as JAX's XLA path does.

    ``far_cluster`` = C > 0 (requires ``neighbor_k``): the clustered
    far-field tier, an opt-in approximation (:func:`_forward_single_nbr`);
    ``far_diag`` then returns ``(q, radius)`` with the (B,) largest
    intra-cluster radius, the measured factor of the error bound
    (:func:`~epnn_tpu_torch.ops.cluster.mids_lipschitz_bound`).  The
    default fit carries no gradient and gives the same bits on every call
    (serving); ``far_cluster_grad=True`` makes the final centroids
    differentiable (training; forward values move by one more half Lloyd
    step).

    ``near_row_chunk`` > 0 (requires ``neighbor_k``): the huge-N memory
    mode, the near field in blocks of that many rows with the charges of
    the full-width forward; ``near_window`` > 0 (requires
    ``near_row_chunk``): each block gathers through a window of that many
    table rows, the full-width result when the window covers every
    block's neighbor spread (:func:`neighbor_window_width`; ≥ N is no
    window), pairs outside it dropped otherwise (see
    :func:`_forward_single_nbr`).  ``remat``: rounds (and chunk bodies)
    under ``torch.utils.checkpoint`` when autograd records, trading a
    recompute in the backward for activation memory.

    Without ``neighbor_k``: the dense blocked forwards.  ``use_pallas``
    with every round admitted by :func:`kernels_apply` selects the fully
    fused kernels (:func:`_forward_single_pallas`, inference-only);
    otherwise :func:`_forward_single` runs in plain PyTorch in row blocks
    of ``block`` (any depth, differentiable).  Both ignore ``uniform_q0``
    and the int8 tier, as JAX's dense paths do.

    ``pack_to`` is JAX's lane-packing width of the v5e layout: accepted,
    no effect on the math (as ``block`` on the neighbor split); the near
    kernels stay on at any value.  Equivalent to ``EPNN(cfg)(x, q0,
    rbf_edges(xyz, mask), mask)`` up to float32 association noise.

    Precision (see the module docstring): every kernel call takes JAX's
    precision for it.  ``cfg.compute_dtype == "bfloat16"`` is JAX's bf16
    recursion (``epnn_tpu/ops/fused.py:1737-1772``): x, the node mask, the
    message and update weights (cast at use, so autograd reaches the
    float32 leaves) and every message-round activation in bfloat16; the
    pass weights, q0 and the charge accumulator float32; the recursion at
    precision ``"default"`` without ``use_pallas`` (so no int8 tier); the
    output float32 · mask.  The bf16 message rounds run the plain
    versions, as JAX runs no Pallas call there; the float32 pass rounds
    keep ``near_pass_rowsum`` (at ``"default"``), as the port keeps its
    kernels on in every mode.  Conservation stays float32-grade: the pass
    rounds are float32 and each pair's two terms exact negations."""
    if cfg.compute_dtype == "bfloat16":
        bf = torch.bfloat16
        fused = dataclasses.replace(
            fused, messages=tuple(_cast_round(w, bf) for w in fused.messages),
            update=tuple((w.to(bf), b.to(bf)) for w, b in fused.update))
        out = forward_blocked(
            fused, x.to(bf), q0, xyz, node_mask.to(bf),
            cfg.replace(compute_dtype="float32", matmul_precision="default",
                        highest_precision=False),
            block=block, neighbor_k=neighbor_k, use_pallas=False,
            pack_to=pack_to, remat=remat, neighbors=neighbors,
            neighbor_grid=neighbor_grid, uniform_q0=uniform_q0,
            far_cluster=far_cluster, far_diag=far_diag,
            far_cluster_grad=far_cluster_grad,
            near_row_chunk=near_row_chunk, near_window=near_window)
        if far_diag:
            return out[0].float() * node_mask, out[1]
        return out.float() * node_mask
    if cfg.compute_dtype != "float32":
        raise ValueError(f"compute_dtype={cfg.compute_dtype!r}: 'float32' "
                         "or 'bfloat16'")
    if far_diag and far_cluster <= 0:
        raise ValueError("far_diag requires far_cluster > 0")
    if neighbors is not None and neighbor_k is None:
        raise ValueError("neighbors requires neighbor_k")
    if far_cluster > 0 and neighbor_k is None:
        raise ValueError("far_cluster requires neighbor_k (the clustered "
                         "far-field tier lives on the neighbor-split path)")
    if near_row_chunk and neighbor_k is None:
        raise ValueError("near_row_chunk requires neighbor_k (the huge-N "
                         "memory mode lives on the neighbor-split path)")
    if near_window and not near_row_chunk:
        raise ValueError("near_window requires near_row_chunk (windowed "
                         "gathers live on the chunked huge-N path)")
    int8 = use_pallas and cfg.dense_matmul_precision == "int8"
    outs = []
    for b in range(x.shape[0]):
        args = (fused, x[b], q0[b], xyz[b], node_mask[b], cfg)
        if neighbor_k is not None:
            nb = None if neighbors is None else tuple(a[b] for a in neighbors)
            outs.append(_forward_single_nbr(
                *args, k=neighbor_k, uniform_q0=uniform_q0, neighbors=nb,
                int8=int8, neighbor_grid=neighbor_grid,
                far_cluster=far_cluster, far_diag=far_diag,
                far_cluster_grad=far_cluster_grad, remat=remat,
                near_row_chunk=near_row_chunk, near_window=near_window))
        elif use_pallas and all(kernels_apply(w) for w in
                                fused.messages + fused.passes):
            outs.append(_forward_single_pallas(*args, remat=remat))
        else:
            outs.append(_forward_single(*args, block=block, remat=remat))
    if far_diag:
        return (torch.stack([q for q, _ in outs]),
                torch.stack([r for _, r in outs]))
    return torch.stack(outs)
