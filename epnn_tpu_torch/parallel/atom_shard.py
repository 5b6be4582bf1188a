"""Atom-sharded forwards: one graph's pair grid in row blocks over the
``atoms`` axis of a mesh (counterpart of ``epnn_tpu/parallel/
atom_shard.py``, its serving half).

Each rank of the ``atoms`` axis owns R = N/D rows of every graph and
computes their message sums and transfer sums against all N atoms; the
only data it exchanges a round is its (R, h) updated hidden rows or its
(R,) charges, all-gathered so that every rank holds the whole per-atom
state again.  The batch splits over the ``data`` axis: each coordinate
along it takes B / n_data molecules.  The callers pass the whole batch on
every rank, as the JAX package's callers pass global arrays, and every
rank gets the whole (B, N) charges back.

Charge conservation survives the sharding exactly: both orderings of a
pair (i, j) are evaluated, by the rank that owns i and the rank that owns
j, from projections that every rank computes bit for bit alike from the
same gathered state, so the two transfers are exact negations.

Two forwards:

* :func:`forward_atom_sharded_batch` — dense featurized row blocks, for
  graphs up to ``infer.DENSE_MAX_ATOMS``: plain PyTorch, as the JAX
  package runs no Pallas call there;
* :func:`forward_atom_sharded_nbr_batch` — the neighbor split, each rank
  running the far field (``dense_message_rowsum`` or its int8 tier, R
  rows against all N columns, or R × C over clustered centroids) and the
  two near kernels on its own rows.  The port keeps its kernels on here
  as everywhere; JAX runs only the far-field kernel on this path.

Both forwards are differentiable: the collectives' VJPs
(:mod:`~epnn_tpu_torch.parallel._collectives`) carry the gradients back
to the ranks that own the rows, the far field's backward kernel runs on
each rank's R × N block, and the near kernels back-propagate through
their plain versions, as on one device.  :func:`make_sharded_train_step`
and :func:`make_sharded_eval_step` build JAX's sharded train and eval
steps on them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from epnn_tpu_torch.featurize import pair_d2
from epnn_tpu_torch.models.config import (
    EPNNConfig,
    dense_precision,
    main_precision,
    near_precision,
)
from epnn_tpu_torch.ops import kernels
from epnn_tpu_torch.ops.cluster import weighted_kmeans
from epnn_tpu_torch.ops.fused import (
    _NEIGHBOR_BLOCK,
    FusedParams,
    _apply_mlp,
    _atom_inputs,
    _cast_round,
    _cluster_pad_rows,
    _dense_message_pad,
    _flat,
    _kernel_round,
    _mids,
    _padded,
    _run,
    _window_rows,
    block_neighbor_select,
    dense_message_rowsum_bf16x3_plain,
    rbf_and_gate,
    round1_counts,
    round1_far_field,
)
from epnn_tpu_torch.parallel import _collectives as C
from epnn_tpu_torch.parallel.sharding import (
    ATOM_AXIS,
    DATA_AXIS,
    axis_size,
    mesh_device,
)

Tensor = torch.Tensor


def _as_device(a, device):
    """``a`` on ``device``: a tensor as it is, an array as a tensor with
    its floats in float32."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    t = torch.as_tensor(a)
    return t.to(device=device,
                dtype=torch.float32 if t.is_floating_point() else t.dtype)


def _check_shape(b: int, n: int, mesh) -> None:
    n_at, n_dp = axis_size(mesh, ATOM_AXIS), axis_size(mesh, DATA_AXIS)
    if n % n_at:
        raise ValueError(f"N={n} not divisible by atoms axis {n_at}")
    if b % n_dp:
        raise ValueError(f"B={b} not divisible by data axis {n_dp}")


def local_batch(mesh, b: int) -> slice:
    """The molecules of this rank's ``data`` coordinate."""
    per = b // axis_size(mesh, DATA_AXIS)
    d = mesh.get_local_rank(DATA_AXIS)
    return slice(d * per, (d + 1) * per)


def gather_batch(q_local: Tensor, mesh) -> Tensor:
    """The (B, N) result from each ``data`` coordinate's (B/n_data, N)."""
    return C.all_gather(q_local, mesh.get_group(DATA_AXIS))


def _kernel_pads(r: int, n: int, h: int):
    """Whether JAX pads the far-field kernel's operands on a rank's R rows
    against n columns (``epnn_tpu/parallel/atom_shard.py:453-458``):
    ``(rows padded, columns padded)`` — the rows pad with zeros to a
    multiple of 128 (8 below 128 rows), the columns to
    ``dense_message_pad``'s multiple.  Only the int8 tier's scale sees
    the padding (its maxima); the float32 kernel takes any R and N as
    they are."""
    bi, bjp = (128, 64) if r >= 128 else (8, 8)
    lcm = _dense_message_pad(bi, bjp, h)
    return r % bi != 0, n % lcm != 0


def far_field_rows(w, pi_rows: Tensor, pj: Tensor, jvec: Tensor,
                   int8: bool, dense: str) -> Tensor:
    """The far field of R rows against the n columns of ``pj`` (all of a
    graph's atoms, or one ring block): the kernel (its int8 tier with
    JAX's sharded padding), the bf16x3 plain version, or the plain
    version at another depth (:func:`~epnn_tpu_torch.ops.fused.
    kernels_apply`)."""
    mids = _flat(w.mids)
    if dense == "bf16x3":
        return dense_message_rowsum_bf16x3_plain(
            pi_rows, pj, jvec, *mids).to(pi_rows.dtype)
    if not _kernel_round(w):
        return kernels.dense_message_rowsum_plain(pi_rows, pj, jvec, *mids)
    if int8:
        pad_r, pad_c = _kernel_pads(pi_rows.shape[0], pj.shape[0],
                                    w.b1.shape[0])
        return kernels.dense_message_rowsum_int8(
            pi_rows, pj, jvec, *mids,
            pad_pi=pi_rows.new_zeros(()) if pad_r else None, pad_pj=pad_c,
            w2_int8=None if w.int8 is None else w.int8[:2],
            precision=dense, **_padded(w))
    return kernels.dense_message_rowsum(pi_rows, pj, jvec, *mids,
                                        precision=dense, **_padded(w))


def cluster_far_field(w, pi_rows: Tensor, cent: Tensor, wts: Tensor,
                      int8: bool, precision: str) -> Tensor:
    """The clustered far field of R rows over C fitted centroids (JAX
    ``atom_shard.py:492-528``, ``ring_shard.py:486-519``): the kernel R × C
    with the centroid weights as cv (int8: the rows and the centroids
    padded as JAX pads them), or the plain version at another depth."""
    c = cent.shape[0]
    mids = _flat(w.mids)
    cent = cent.to(pi_rows.dtype).contiguous()
    if not _kernel_round(w):
        return kernels.dense_message_rowsum_plain(pi_rows, cent, wts, *mids)
    if int8:
        h = w.b1.shape[0]
        pad_r, _ = _kernel_pads(pi_rows.shape[0], c, h)
        return kernels.dense_message_rowsum_int8(
            pi_rows, cent, wts, *mids,
            pad_pi=pi_rows.new_zeros(()) if pad_r else None,
            pad_pj=_cluster_pad_rows(c, h) > c,
            w2_int8=None if w.int8 is None else w.int8[:2],
            precision=precision, **_padded(w))
    return kernels.dense_message_rowsum(pi_rows, cent, wts, *mids,
                                        precision=precision, **_padded(w))


def _select_rows(xyz_f, mask_f, r0: int, r: int, cutoff: float, k: int):
    """``block_neighbor_select`` for rows [r0, r0 + R) against all
    atoms, in row blocks of ``_NEIGHBOR_BLOCK`` (top-k is per row, so the
    blocks change nothing but the (rows, N) distance plane's size)."""
    outs = [block_neighbor_select(xyz_f, mask_f, s,
                                  xyz_f[s:min(s + _NEIGHBOR_BLOCK, r0 + r)],
                                  mask_f[s:min(s + _NEIGHBOR_BLOCK, r0 + r)],
                                  cutoff, k, with_d2=True)
            for s in range(r0, r0 + r, _NEIGHBOR_BLOCK)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _rows_forward(fused: FusedParams, x_f, q0_f, xyz_f, mask_f,
                  cfg: EPNNConfig, group, k: int, nbr_rows, uniform_q0: bool,
                  int8: bool, far_cluster: int, far_cluster_grad: bool,
                  near_row_chunk: int, near_window: int,
                  remat: bool = False) -> Tensor:
    """One graph on this rank: its R rows against all N atoms, the state
    all-gathered over ``group`` every round.  Returns the (N,) charges.
    ``remat``: each round's row computation, and each row chunk's near
    body, under ``torch.utils.checkpoint`` (the all-gathers stay outside,
    so a recomputed segment issues no collective)."""
    n = x_f.shape[0]
    d = C.size(group)
    r = n // d
    r0 = C.index(group) * r
    rows = slice(r0, r0 + r)
    mask_rows = mask_f[rows]
    dense, near = dense_precision(cfg), near_precision(cfg)
    far_c = main_precision(cfg) if dense == "bf16x3" else dense

    if nbr_rows is None:
        idx, nbr_mask, d2 = _select_rows(xyz_f, mask_f, r0, r, cfg.cutoff,
                                         k)
    elif len(nbr_rows) == 3:
        idx, nbr_mask, d2 = nbr_rows
    else:
        # Verlet-skin serving: d² from the current coordinates
        idx, nbr_mask = nbr_rows
        d2 = pair_d2(xyz_f[rows][:, None, :], xyz_f[idx.to(torch.int64)])
    idx = idx.to(torch.int64)
    nbr_mask = nbr_mask.to(x_f.dtype).contiguous()
    chunks = ([slice(s, min(s + near_row_chunk, r))
               for s in range(0, r, near_row_chunk)]
              if near_row_chunk > 0 else [slice(0, r)])
    # the window slices the GLOBAL (N, ·) projection tables
    nwin = near_window if near_row_chunk > 0 and 0 < near_window < n else 0
    gathers = [_window_rows(idx[sl], nbr_mask[sl], n, nwin) for sl in chunks]

    def features(i: int):
        sl = chunks[i]
        rbf, gate = rbf_and_gate(d2[sl], nbr_mask[sl], cfg, x_f.dtype)
        return (rbf.reshape(-1, rbf.shape[-1]).contiguous(),
                (0.5 * (gate * gathers[i][1])).contiguous())

    resident = [features(0)] if near_row_chunk <= 0 else None
    run, run_block = _run(remat), _run(remat and near_row_chunk > 0)

    def near_blocks(body, *args):
        outs = [run_block(body, i, *args) for i in range(len(chunks))]
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def near_message(i, pi_rows, pj, w):
        rbf, _ = resident[0] if resident else features(i)
        gidx, wgt = gathers[i]
        args = (pi_rows[chunks[i]].contiguous(),
                torch.index_select(pj, 0, gidx), rbf, wgt, w.w1_e,
                *_flat(w.mids))
        return (kernels.near_message_corr(*args, precision=near,
                                          **_padded(w))
                if _kernel_round(w) else kernels.near_message_corr_plain(*args))

    def near_pass(i, rs, w):
        rbf, gh = resident[0] if resident else features(i)
        args = (rs[rows][chunks[i]].contiguous(),
                torch.index_select(rs, 0, gathers[i][0]),
                rbf.to(rs.dtype), gh.to(rs.dtype), w.w1_e, *_flat(w.mids))
        return (kernels.near_pass_rowsum(*args, precision=near, **_padded(w))
                if _kernel_round(w) else kernels.near_pass_rowsum_plain(*args))

    if cfg.mask_messages:
        msg_count = mask_rows * torch.sum(mask_f)
        jvec = mask_f.contiguous()
    else:
        msg_count = torch.full((r,), float(n), dtype=x_f.dtype,
                               device=x_f.device)
        jvec = torch.ones(n, dtype=x_f.dtype, device=x_f.device)
    nm = mask_rows[:, None]
    iters = int(os.environ.get("EPNN_FAR_CLUSTER_ITERS", "8"))

    def message_round(t, h_f, q_f):
        w = fused.messages[t]
        a = _atom_inputs(x_f, h_f, q_f)
        pi_f = (a @ w.w1_i + w.b1).contiguous()
        pj_f = (a @ w.w1_j).contiguous()
        pi_rows = pi_f[rows].contiguous()
        if t == 0 and uniform_q0:
            zvec, counts = round1_counts(x_f, jvec)
            dense_sum = round1_far_field(pi_rows, w, cfg, zvec, q_f[:1],
                                         counts)
        elif far_cluster > 0:
            # the fit replicated on the gathered pj: every rank computes
            # the same centroids
            cent, wts, _ = weighted_kmeans(pj_f, jvec, far_cluster,
                                           iters=iters,
                                           differentiable=far_cluster_grad)
            dense_sum = cluster_far_field(w, pi_rows, cent, wts, int8, far_c)
        else:
            dense_sum = far_field_rows(w, pi_rows, pj_f, jvec, int8, dense)
        hsum = dense_sum + near_blocks(near_message, pi_rows, pj_f, w)
        messages = hsum @ w.w_out + msg_count[:, None] * w.b_out
        upd_in = torch.cat([h_f[rows], messages], dim=-1) * nm
        return (_apply_mlp(fused.update, upd_in) * nm).contiguous()

    def pass_round(t, h_f, q_f):
        w = fused.passes[t]
        a = _atom_inputs(x_f, h_f, q_f).to(w.w1_i.dtype)
        rs = torch.cat([a @ w.w1_i + w.b1, a @ w.w1_j], dim=-1)
        dsum = near_blocks(near_pass, rs, w)
        return (q_f[rows] + (dsum @ w.w_out)[:, 0]).contiguous()

    h_f = x_f.new_zeros((n, cfg.h_dim))
    q_f = q0_f
    for t in range(len(fused.messages)):
        h_f = C.all_gather(run(message_round, t, h_f, q_f), group)
    for t in range(len(fused.passes)):
        q_f = C.all_gather(run(pass_round, t, h_f, q_f), group)
    return q_f * mask_f


def forward_atom_sharded_nbr_batch(
    fused: FusedParams,
    x: Tensor,          # (B, N, n_elems); B % data axis == 0
    q0: Tensor,         # (B, N);          N % atoms axis == 0
    xyz: Tensor,        # (B, N, 3)
    node_mask: Tensor,  # (B, N)
    cfg: EPNNConfig,
    mesh,
    k: int,
    use_pallas: bool = False,
    remat: bool = False,
    uniform_q0: bool = False,
    neighbors: "Optional[tuple]" = None,
    far_cluster: int = 0,
    far_cluster_grad: bool = False,
    near_row_chunk: int = 0,
    near_window: int = 0,
) -> Tensor:
    """Neighbor-split atom-sharded forward: the multi-device twin of
    :func:`~epnn_tpu_torch.ops.fused.forward_blocked` with ``neighbor_k``
    (JAX ``epnn_tpu/parallel/atom_shard.py:186``), its parameters in
    JAX's order.  Called on every rank of ``mesh`` with the whole batch
    (arrays or tensors); returns the whole (B, N) charges on every rank.

    Each rank owns R = N/D rows of each of its ``data`` coordinate's
    graphs: it selects their k neighbors (top-k over the (R, N) distance
    slice, or its rows of the precomputed ``neighbors`` — ``(idx, mask,
    d2)`` or the Verlet-skin ``(idx, mask)``, each (B, N, k) with global
    column indices, whose d² is then taken from the current
    coordinates), runs every round's far field on its R rows against all
    N columns (the far-field kernel; under ``use_pallas`` and
    ``dense_matmul_precision='int8'`` its int8 tier, with JAX's padding of
    the rank's operands in its scale), the near correction and the pass
    rounds through the two near kernels on its rows, and all-gathers its
    updated rows.  ``uniform_q0``: message round 1's far field collapses
    to the count-weighted element grid (built from the replicated x, so
    every rank sees the same j-side values).  ``far_cluster`` = C > 0:
    the clustered far-field tier, the fit replicated on the gathered pj
    rows (:func:`~epnn_tpu_torch.ops.cluster.weighted_kmeans`, the same
    centroids on every rank), each rank's R rows × C centroids through
    the kernel; ``far_cluster_grad`` selects the fit's differentiable
    mode (its values move by one more half Lloyd step).
    ``near_row_chunk`` / ``near_window``: the huge-N levers on each
    rank's rows — chunks restart at each rank's row origin, and the
    window slices the global projection tables (a safe width is the
    largest of ``neighbor_window_width`` over the ranks' row slices).
    ``remat``: when autograd records, each round (and each row chunk's
    near body) runs under ``torch.utils.checkpoint``, the backward
    recomputing it; the all-gathers stay outside the checkpoints.  The
    gradients reach every rank's own rows through the all-gathers' VJPs
    (:mod:`~epnn_tpu_torch.parallel._collectives`).  ``k`` must bound
    every row's neighbor count
    (:func:`~epnn_tpu_torch.ops.fused.max_neighbor_count`)."""
    b, n = x.shape[:2]
    _check_shape(b, n, mesh)
    if near_window and not near_row_chunk:
        raise ValueError("near_window requires near_row_chunk (windowed "
                         "gathers ride the chunked near path)")
    device = mesh_device(mesh)
    x, q0, xyz, node_mask = (_as_device(a, device)
                             for a in (x, q0, xyz, node_mask))
    if neighbors is not None:
        neighbors = tuple(_as_device(a, device) for a in neighbors)
    if cfg.compute_dtype == "bfloat16":
        # JAX's bf16 recursion: bf16 messages and update, float32 pass
        # rounds, charges and coordinates
        bf = torch.bfloat16
        fused = dataclasses.replace(
            fused, messages=tuple(_cast_round(w, bf) for w in fused.messages),
            update=tuple((w.to(bf), bb.to(bf)) for w, bb in fused.update))
        out = forward_atom_sharded_nbr_batch(
            fused, x.to(bf), q0, xyz, node_mask.to(bf),
            cfg.replace(compute_dtype="float32", matmul_precision="default",
                        highest_precision=False),
            mesh, k=k, use_pallas=False, remat=remat, uniform_q0=uniform_q0,
            neighbors=neighbors, far_cluster=far_cluster,
            far_cluster_grad=far_cluster_grad,
            near_row_chunk=near_row_chunk, near_window=near_window)
        return out.float() * node_mask
    int8 = use_pallas and cfg.dense_matmul_precision == "int8"
    group = mesh.get_group(ATOM_AXIS)
    r = n // axis_size(mesh, ATOM_AXIS)
    r0 = C.index(group) * r
    outs = []
    for g in range(b)[local_batch(mesh, b)]:
        nb = None if neighbors is None else tuple(
            a[g, r0:r0 + r] for a in neighbors)
        outs.append(_rows_forward(
            fused, x[g], q0[g], xyz[g], node_mask[g], cfg, group, k, nb,
            uniform_q0, int8, far_cluster, far_cluster_grad,
            near_row_chunk, near_window, remat))
    return gather_batch(torch.stack(outs), mesh)


def _dense_rows_forward(fused: FusedParams, x, q0, xyz, node_mask,
                        cfg: EPNNConfig, group) -> Tensor:
    """One graph through the dense featurized forward on this rank's R
    rows (JAX ``atom_shard.py:61-183``): the pair grid's rows against all
    atoms, messages weighted by the pair mask with its diagonal kept, the
    RBF clearing self pairs; the rows all-gathered every round."""
    n = x.shape[0]
    r = n // C.size(group)
    r0 = C.index(group) * r
    rows = slice(r0, r0 + r)
    pairm = node_mask[rows, None] * node_mask[None, :]
    cols = torch.arange(n, device=x.device)
    valid = pairm * ((r0 + torch.arange(r, device=x.device))[:, None]
                     != cols[None, :])
    e_rows, gate = rbf_and_gate(pair_d2(xyz[rows, None], xyz[None]), valid,
                                cfg)
    nm = node_mask[:, None]
    h = x.new_zeros((n, cfg.h_dim))
    q = q0
    for w in fused.messages:
        a = _atom_inputs(x, h, q)
        pi, pj = a @ w.w1_i, a @ w.w1_j
        epart = e_rows @ w.w1_e
        hid = _mids(torch.relu((pi[rows, None, :] + pj[None, :, :]) + epart
                               + w.b1), w)
        m = hid @ w.w_out + w.b_out
        if cfg.mask_messages:
            m = m * pairm[:, :, None]
        upd_in = torch.cat([h[rows], m.sum(1)], dim=-1) * nm[rows]
        h = C.all_gather((_apply_mlp(fused.update, upd_in)
                          * nm[rows]).contiguous(), group)
    for w in fused.passes:
        a = _atom_inputs(x, h, q)
        pi, pj = a @ w.w1_i, a @ w.w1_j
        epart = e_rows @ w.w1_e
        hid_n = _mids(torch.relu((pi[rows, None, :] + pj[None, :, :])
                                 + epart + w.b1), w)
        hid_t = _mids(torch.relu((pi[None, :, :] + pj[rows, None, :])
                                 + epart + w.b1), w)
        f_n = (hid_n @ w.w_out + w.b_out)[..., 0]
        f_t = (hid_t @ w.w_out + w.b_out)[..., 0]
        dq = torch.sum(0.5 * (f_n - f_t) * valid * gate, dim=1)
        q = C.all_gather((q[rows] + dq).contiguous(), group)
    return q * node_mask


def forward_atom_sharded_batch(
    fused: FusedParams,
    x: Tensor,          # (B, N, n_elems); B % data axis == 0
    q0: Tensor,         # (B, N);          N % atoms axis == 0
    xyz: Tensor,        # (B, N, 3)
    node_mask: Tensor,  # (B, N)
    cfg: EPNNConfig,
    mesh,
) -> Tensor:
    """Batched dense forward on a (data × atoms) mesh (JAX ``atom_shard.
    py:84``): the batch over ``data``, each graph's pair-grid rows over
    ``atoms``.  Plain PyTorch, any MLP depth, the dense model's pair terms
    (JAX runs no Pallas call here).  Called on every rank with the whole
    batch; returns the whole (B, N) charges on every rank, differentiable
    in ``fused``."""
    b, n = x.shape[:2]
    _check_shape(b, n, mesh)
    device = mesh_device(mesh)
    x, q0, xyz, node_mask = (_as_device(a, device)
                             for a in (x, q0, xyz, node_mask))
    group = mesh.get_group(ATOM_AXIS)
    outs = [_dense_rows_forward(fused, x[g], q0[g], xyz[g], node_mask[g],
                                cfg, group)
            for g in range(b)[local_batch(mesh, b)]]
    return gather_batch(torch.stack(outs), mesh)


def forward_atom_sharded(
    fused: FusedParams,
    x: Tensor,          # (N, n_elems) — one graph, N divisible by the mesh
    q0: Tensor,         # (N,)
    xyz: Tensor,        # (N, 3)
    node_mask: Tensor,  # (N,)
    cfg: EPNNConfig,
    mesh,
) -> Tensor:
    """Single-graph forward with the atom axis sharded over ``mesh`` (its
    ``data`` axis must have size 1)."""
    return forward_atom_sharded_batch(
        fused, torch.as_tensor(x)[None], torch.as_tensor(q0)[None],
        torch.as_tensor(xyz)[None], torch.as_tensor(node_mask)[None], cfg,
        mesh)[0]


def _sharded_forward(fused, x, q0, xyz, node_mask, cfg, mesh, neighbor_k,
                     use_pallas, shard_mode, neighbors, **kw):
    """The step builders' forward: the ring (``shard_mode='ring'``), the
    atom-sharded neighbor split (``neighbor_k`` given), or the dense row
    blocks."""
    if shard_mode == "ring":
        from epnn_tpu_torch.parallel.ring_shard import (
            forward_ring_sharded_nbr_batch)

        return forward_ring_sharded_nbr_batch(
            fused, x, q0, xyz, node_mask, cfg, mesh, k_blk=neighbor_k,
            use_pallas=use_pallas, neighbors=neighbors, **kw)
    if neighbor_k is not None:
        return forward_atom_sharded_nbr_batch(
            fused, x, q0, xyz, node_mask, cfg, mesh, k=neighbor_k,
            use_pallas=use_pallas, neighbors=neighbors, **kw)
    if neighbors is not None:
        raise ValueError("precomputed neighbors require neighbor_k")
    return forward_atom_sharded_batch(fused, x, q0, xyz, node_mask, cfg,
                                      mesh)


def make_sharded_train_step(cfg: EPNNConfig, opt, mesh,
                            loss_name: str = "masked_mse",
                            neighbor_k: Optional[int] = None,
                            use_pallas: bool = False,
                            shard_mode: str = "atom",
                            uniform_q0: bool = False,
                            far_cluster: int = 0,
                            far_cluster_grad: bool = False,
                            remat: bool = True,
                            near_row_chunk: int = 0,
                            near_window: int = 0):
    """A training step whose forward and backward run sharded over
    ``mesh`` (JAX ``atom_shard.py:764``, its parameters in JAX's order and
    defaults): trains on graphs whose pair grid does not fit one device.
    Returns ``step(state, x, q0, xyz, node_mask, y, weight,
    neighbors=None) -> (state, loss, pred, mae_sums)``, the contract of
    :func:`epnn_tpu_torch.train.train_step`, called on every rank of the
    mesh with the whole batch (arrays or tensors) and the replicated
    :class:`~epnn_tpu_torch.train.TrainState`; it updates the state in
    place.  ``opt``: an optimizer over the state's leaves, ``None`` for
    the state's own.

    The forward is :func:`forward_atom_sharded_batch` (``neighbor_k``
    None: dense row blocks), :func:`forward_atom_sharded_nbr_batch`
    (``neighbor_k``: the neighbor split with its kernels on each rank's
    rows) or, with ``shard_mode='ring'`` (requires ``neighbor_k``),
    :func:`~epnn_tpu_torch.parallel.ring_shard.
    forward_ring_sharded_nbr_batch`; ``uniform_q0``, ``far_cluster`` /
    ``far_cluster_grad`` (require ``neighbor_k``), ``remat`` and
    ``near_row_chunk`` / ``near_window`` (atom mode; chunks require
    ``remat``) are theirs.  Every rank computes the whole batch's loss
    from the gathered charges; the gradients come back to each rank's
    rows through the collectives' VJPs and are summed over the mesh
    before the update (:func:`epnn_tpu_torch.train.loop._apply`), so the
    parameters stay replicated bit for bit."""
    from epnn_tpu_torch.ops.fused import fuse_params
    from epnn_tpu_torch.train import metrics as M
    from epnn_tpu_torch.train.loop import _apply

    if shard_mode == "ring" and neighbor_k is None:
        raise ValueError("shard_mode='ring' requires neighbor_k")
    if far_cluster and neighbor_k is None:
        raise ValueError("far_cluster requires neighbor_k")
    if near_row_chunk and neighbor_k is None:
        raise ValueError("near_row_chunk requires neighbor_k")
    if near_row_chunk and shard_mode == "ring":
        raise ValueError("near_row_chunk applies to the atom-sharded "
                         "neighbor-split step only (ring circulates "
                         "blocks already)")
    if near_row_chunk and not remat:
        raise ValueError("near_row_chunk training requires remat=True "
                         "(the chunk body is checkpointed so the backward "
                         "recomputes chunk by chunk)")
    if near_window and not near_row_chunk:
        raise ValueError("near_window requires near_row_chunk")
    device = mesh_device(mesh)
    nbr_kw = dict(remat=remat, uniform_q0=uniform_q0,
                  far_cluster=far_cluster, far_cluster_grad=far_cluster_grad)
    if shard_mode != "ring":
        nbr_kw.update(near_row_chunk=near_row_chunk, near_window=near_window)

    def step(state, x, q0, xyz, node_mask, y, weight, neighbors=None):
        y, node_mask, weight = (_as_device(a, device)
                                for a in (y, node_mask, weight))
        pred = _sharded_forward(
            fuse_params(state.params, cfg, device), x, q0, xyz, node_mask,
            cfg, mesh, neighbor_k, use_pallas, shard_mode, neighbors,
            **(nbr_kw if neighbor_k is not None else {}))
        loss = M.LOSSES[loss_name](pred, y, node_mask, weight)
        _apply(state, loss, opt, mesh=mesh)
        pred = pred.detach()
        return (state, loss.detach(), pred,
                M.mae_sums(pred, y, node_mask, weight))

    return step


def make_sharded_eval_step(cfg: EPNNConfig, mesh,
                           loss_name: str = "masked_mse",
                           neighbor_k: Optional[int] = None,
                           use_pallas: bool = False,
                           shard_mode: str = "atom",
                           uniform_q0: bool = False,
                           near_row_chunk: int = 0,
                           near_window: int = 0):
    """The eval twin of :func:`make_sharded_train_step` (JAX
    ``atom_shard.py:884``): ``step(params, x, q0, xyz, node_mask, y,
    weight, neighbors=None) -> (loss, pred, mae_sums)`` of the exact
    sharded forward, without a graph (the chunk and window levers need no
    remat here)."""
    from epnn_tpu_torch.ops.fused import fuse_params
    from epnn_tpu_torch.train import metrics as M

    if shard_mode == "ring" and neighbor_k is None:
        raise ValueError("shard_mode='ring' requires neighbor_k")
    if near_row_chunk and neighbor_k is None:
        raise ValueError("near_row_chunk requires neighbor_k")
    if near_window and not near_row_chunk:
        raise ValueError("near_window requires near_row_chunk")
    device = mesh_device(mesh)
    nbr_kw = dict(uniform_q0=uniform_q0)
    if shard_mode != "ring":
        nbr_kw.update(near_row_chunk=near_row_chunk, near_window=near_window)

    @torch.no_grad()
    def step(params, x, q0, xyz, node_mask, y, weight, neighbors=None):
        y, node_mask, weight = (_as_device(a, device)
                                for a in (y, node_mask, weight))
        pred = _sharded_forward(
            fuse_params(params, cfg, device), x, q0, xyz, node_mask, cfg,
            mesh, neighbor_k, use_pallas, shard_mode, neighbors,
            **(nbr_kw if neighbor_k is not None else {}))
        loss = M.LOSSES[loss_name](pred, y, node_mask, weight)
        return loss, pred, M.mae_sums(pred, y, node_mask, weight)

    return step
