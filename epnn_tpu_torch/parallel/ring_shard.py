"""Ring-sharded forwards: atom blocks circulate around the ``atoms`` axis
(counterpart of ``epnn_tpu/parallel/ring_shard.py``, its serving half).

Each rank owns one block of N/D atoms of a graph (coordinates, masks,
projections) and holds no other atom's state: at each of D ring steps it
computes its rows against the block passing by, then hands that block to
the next rank (``ppermute``; D − 1 exchanges a round, the last step's
block staying put).  Nothing is all-gathered; a rank's memory is O(N/D)
atoms and one circulating block.

Charge conservation: for a pair (i, j) the owner of i computes
0.5·(f_ij − f_ji) when j's block passes, and the owner of j the same
expression with the roles swapped when i's block passes, from the same
circulated bits and a bit-for-bit symmetric d², so the two transfers are
exact negations.  The diagonal is told apart by the global offsets of
the blocks, known from each ring step's place.

Called on every rank of the mesh with the whole batch, each rank slices
its own block; every rank gets the whole (B, N) charges back.  Both
forwards are differentiable: a ring step's cotangents ride the reverse
ring back to the block's owner (``ppermute``'s VJP,
:mod:`~epnn_tpu_torch.parallel._collectives`), and each step's far field
back-propagates through the far-field backward kernel at N/D × N/D.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Tuple

import torch

from epnn_tpu_torch.featurize import pair_d2
from epnn_tpu_torch.models.config import (
    EPNNConfig,
    dense_precision,
    main_precision,
    near_precision,
)
from epnn_tpu_torch.ops import kernels
from epnn_tpu_torch.ops.cluster import weighted_kmeans_sharded
from epnn_tpu_torch.ops.fused import (
    FusedParams,
    _apply_mlp,
    _atom_inputs,
    _cast_round,
    _flat,
    _kernel_round,
    _mids,
    _padded,
    _run,
    block_neighbor_select,
    rbf_and_gate,
    round1_counts,
    round1_far_field,
)
from epnn_tpu_torch.parallel import _collectives as C
from epnn_tpu_torch.parallel.atom_shard import (
    _as_device,
    _check_shape,
    cluster_far_field,
    far_field_rows,
    gather_batch,
    local_batch,
)
from epnn_tpu_torch.parallel.sharding import ATOM_AXIS, axis_size, mesh_device

Tensor = torch.Tensor


def _pair_terms(xyz_i, xyz_j, same, valid, cfg):
    """RBF features and gate of a (rows, cols) block; ``same`` marks self
    pairs, ``valid`` pairs of two valid atoms."""
    d2 = pair_d2(xyz_i[:, None, :], xyz_j[None, :, :])
    return rbf_and_gate(d2, torch.where(same, 0.0, valid), cfg)


def forward_ring_sharded(
    fused: FusedParams,
    x: Tensor,          # (N, n_elems) — N divisible by the atoms axis
    q0: Tensor,         # (N,)
    xyz: Tensor,        # (N, 3)
    node_mask: Tensor,  # (N,)
    cfg: EPNNConfig,
    mesh,
) -> Tensor:
    """One graph through the dense ring forward (JAX ``ring_shard.py:57``):
    every pair featurized, plain PyTorch (JAX runs no Pallas call here),
    each rank's block against each circulating block.  Returns the whole
    (N,) charges on every rank."""
    n = x.shape[0]
    n_dev = axis_size(mesh, ATOM_AXIS)
    if n % n_dev:
        raise ValueError(f"N={n} not divisible by atoms axis {n_dev}")
    device = mesh_device(mesh)
    x, q0, xyz, node_mask = (_as_device(a, device)
                             for a in (x, q0, xyz, node_mask))
    group = mesh.get_group(ATOM_AXIS)
    nd = n // n_dev
    start = C.index(group) * nd
    own = slice(start, start + nd)
    x_d, q_d, xyz_d, mask_d = x[own], q0[own], xyz[own], node_mask[own]
    gidx_d = torch.arange(start, start + nd, device=device)
    nm = mask_d[:, None]
    if cfg.mask_messages:
        msg_count = mask_d * C.psum(mask_d.sum(), group)
    else:
        msg_count = torch.full((nd,), float(n), dtype=x.dtype, device=device)

    def ring(acc, blk, step):
        for i in range(n_dev):
            acc = step(acc, blk)
            if i + 1 < n_dev:
                blk = C.ppermute(blk, group)
        return acc

    h_d = x.new_zeros((nd, cfg.h_dim))
    for w in fused.messages:
        a = _atom_inputs(x_d, h_d, q_d)
        pi = a @ w.w1_i + w.b1
        pj = a @ w.w1_j

        def msg_step(acc, blk):
            xyz_j, pj_j, mask_j, gidx_j = blk
            same = gidx_d[:, None] == gidx_j[None, :]
            valid = mask_d[:, None] * mask_j[None, :]
            rbf, _ = _pair_terms(xyz_d, xyz_j, same, valid, cfg)
            hid = _mids(torch.relu((pi[:, None, :] + pj_j[None, :, :])
                                   + rbf @ w.w1_e), w)
            jvec = mask_j if cfg.mask_messages else torch.ones_like(mask_j)
            return acc + torch.einsum("n,bnh->bh", jvec, hid)

        hsum = ring(x.new_zeros((nd, w.w_out.shape[0])),
                    (xyz_d, pj, mask_d, gidx_d), msg_step)
        messages = hsum @ w.w_out + msg_count[:, None] * w.b_out
        upd_in = torch.cat([h_d, messages], dim=-1) * nm
        h_d = _apply_mlp(fused.update, upd_in) * nm
    for w in fused.passes:
        a = _atom_inputs(x_d, h_d, q_d)
        pi = a @ w.w1_i + w.b1
        pj = a @ w.w1_j

        def pass_step(acc, blk):
            xyz_j, pi_j, pj_j, mask_j, gidx_j = blk
            same = gidx_d[:, None] == gidx_j[None, :]
            valid = mask_d[:, None] * mask_j[None, :]
            rbf, gate = _pair_terms(xyz_d, xyz_j, same, valid, cfg)
            epart = rbf @ w.w1_e
            hid_n = _mids(torch.relu((pi[:, None, :] + pj_j[None, :, :])
                                     + epart), w)
            hid_t = _mids(torch.relu((pi_j[None, :, :] + pj[:, None, :])
                                     + epart), w)
            weight = gate * valid
            return acc + torch.sum(
                0.5 * weight[:, :, None] * (hid_n - hid_t), dim=1)

        dsum = ring(x.new_zeros((nd, w.w_out.shape[0])),
                    (xyz_d, pi, pj, mask_d, gidx_d), pass_step)
        q_d = q_d + (dsum @ w.w_out)[:, 0]
    return C.all_gather((q_d * mask_d).contiguous(), group)


def _ring_rows_forward(fused: FusedParams, x_d, q0_d, xyz_d, mask_d,
                       cfg: EPNNConfig, group, n: int, k_blk: int, nbr_rows,
                       uniform_q0: bool, int8: bool, far_cluster: int,
                       far_cluster_grad: bool, remat: bool = False) -> Tensor:
    """One graph's block on this rank (nd rows), D ring steps a round.
    Returns the block's (nd,) charges.  ``remat``: each round under
    ``torch.utils.checkpoint``; its recomputation re-issues the round's
    ring exchanges, on every rank at the same point of the backward."""
    d = C.size(group)
    nd = x_d.shape[0]
    my_start = C.index(group) * nd
    dev = x_d.device
    dt = x_d.dtype
    dense, near = dense_precision(cfg), near_precision(cfg)
    far_c = main_precision(cfg) if dense == "bf16x3" else dense

    def start_of(step: int) -> int:
        """The global offset of the block this rank holds at ring step
        ``step``: the block of the rank ``step`` places before it."""
        return (C.index(group) - step) % d * nd

    # the pre-pass: per ring step, this block's near pairs in the block
    # passing by, (D, nd, k_blk) tables with block-local column indices
    sel = []
    if nbr_rows is None:
        # geometry-only: top-k of each row within the circulating block
        blk = (xyz_d, mask_d.float())
        for step in range(d):
            xyz_j, mask_j = blk
            sel.append(block_neighbor_select(
                xyz_j, mask_j, my_start - start_of(step), xyz_d, mask_d,
                cfg.cutoff, k_blk, with_d2=True))
            if step + 1 < d:
                blk = C.ppermute(blk, group)
    else:
        # conversion: this block's rows of the global table, compacted per
        # circulating block (in-table order kept)
        g_idx = nbr_rows[0].to(torch.int64)
        g_mask = nbr_rows[1] > 0
        k_tab = g_idx.shape[-1]
        col_pos = torch.arange(k_tab, device=dev).expand_as(g_idx)
        blk = (xyz_d,)
        for step in range(d):
            (xyz_j,), start_j = blk, start_of(step)
            in_blk = g_mask & (g_idx // nd == start_j // nd)
            order = torch.argsort(torch.where(in_blk, col_pos, k_tab + 1),
                                  dim=1, stable=True)[:, :k_blk]
            m = torch.gather(in_blk, 1, order)
            idx = torch.where(m, torch.gather(g_idx, 1, order) - start_j, 0)
            if len(nbr_rows) == 3:
                d2 = torch.where(m, torch.gather(nbr_rows[2], 1, order), 0.0)
            else:
                # Verlet-skin serving: d² from the current coordinates
                d2 = torch.where(m, pair_d2(xyz_d[:, None, :], xyz_j[idx]),
                                 0.0)
            sel.append((idx, m, d2))
            if step + 1 < d:
                blk = C.ppermute(blk, group)

    def features(i):
        idx, m, d2 = sel[i]
        m = m.to(dt)
        rbf, gate = rbf_and_gate(d2, m, cfg, dt)
        return (idx.reshape(-1), m.contiguous(),
                rbf.reshape(-1, rbf.shape[-1]).contiguous(),
                (0.5 * (gate * m)).contiguous())

    feats = [features(i) for i in range(d)]
    if cfg.mask_messages:
        msg_count = mask_d * C.psum(torch.sum(mask_d), group)
    else:
        msg_count = torch.full((nd,), float(n), dtype=dt, device=dev)
    jvec_d = mask_d if cfg.mask_messages else torch.ones_like(mask_d)
    nm = mask_d[:, None]
    iters = int(os.environ.get("EPNN_FAR_CLUSTER_ITERS", "8"))

    def message_round(t, h_d, q_d):
        w = fused.messages[t]
        a = _atom_inputs(x_d, h_d, q_d)
        pi = (a @ w.w1_i + w.b1).contiguous()
        pj = (a @ w.w1_j).contiguous()
        collapse = t == 0 and uniform_q0
        if collapse:
            # the element grid from O(E) collectives: nothing is replicated
            zvec, counts = round1_counts(x_d, jvec_d)
            qv = C.pmax(torch.where(mask_d > 0, q_d, -math.inf).amax()[None],
                        group)
            qv = torch.where(torch.isfinite(qv), qv, 0.0)
            acc = round1_far_field(pi, w, cfg, C.pmax(zvec, group), qv,
                                   C.psum(counts, group))
        elif far_cluster > 0:
            cent, wts, _ = weighted_kmeans_sharded(
                pj, jvec_d, far_cluster, group, iters=iters,
                differentiable=far_cluster_grad)
            acc = cluster_far_field(w, pi, cent, wts, int8, far_c)
        else:
            acc = pi.new_zeros((nd, pi.shape[-1]))
        dense_in_ring = not collapse and far_cluster <= 0
        blk = (pj, jvec_d.contiguous())
        for i in range(d):
            pj_j, jvec_j = blk
            if dense_in_ring:
                acc = acc + far_field_rows(w, pi, pj_j, jvec_j, int8, dense)
            gidx, m, rbf, _ = feats[i]
            args = (pi, torch.index_select(pj_j, 0, gidx), rbf, m, w.w1_e,
                    *_flat(w.mids))
            acc = acc + (kernels.near_message_corr(
                *args, precision=near, **_padded(w)) if _kernel_round(w)
                else kernels.near_message_corr_plain(*args))
            if i + 1 < d:
                blk = C.ppermute(blk, group)
        messages = acc @ w.w_out + msg_count[:, None] * w.b_out
        upd_in = torch.cat([h_d, messages], dim=-1) * nm
        return _apply_mlp(fused.update, upd_in) * nm

    def pass_round(t, h_d, q_d):
        w = fused.passes[t]
        a = _atom_inputs(x_d, h_d, q_d).to(w.w1_i.dtype)
        rs = torch.cat([a @ w.w1_i + w.b1, a @ w.w1_j], dim=-1).contiguous()
        acc = rs.new_zeros((nd, rs.shape[-1] // 2))
        blk = (rs,)
        for i in range(d):
            (rs_j,) = blk
            gidx, _, rbf, gh = feats[i]
            args = (rs, torch.index_select(rs_j, 0, gidx), rbf.to(rs.dtype),
                    gh.to(rs.dtype), w.w1_e, *_flat(w.mids))
            acc = acc + (kernels.near_pass_rowsum(
                *args, precision=near, **_padded(w)) if _kernel_round(w)
                else kernels.near_pass_rowsum_plain(*args))
            if i + 1 < d:
                blk = C.ppermute(blk, group)
        return q_d + (acc @ w.w_out)[:, 0]

    run = _run(remat)
    h_d = x_d.new_zeros((nd, cfg.h_dim))
    q_d = q0_d
    for t in range(len(fused.messages)):
        h_d = run(message_round, t, h_d, q_d)
    for t in range(len(fused.passes)):
        q_d = run(pass_round, t, h_d, q_d)
    return q_d * mask_d


def forward_ring_sharded_nbr_batch(
    fused: FusedParams,
    x: Tensor,          # (B, N, n_elems); B % data axis == 0
    q0: Tensor,         # (B, N);          N % atoms axis == 0
    xyz: Tensor,        # (B, N, 3)
    node_mask: Tensor,  # (B, N)
    cfg: EPNNConfig,
    mesh,
    k_blk: int,
    use_pallas: bool = False,
    remat: bool = False,
    uniform_q0: bool = False,
    neighbors: "Tuple[Tensor, ...] | None" = None,
    far_cluster: int = 0,
    far_cluster_grad: bool = False,
) -> Tensor:
    """Neighbor-split ring forward (JAX ``ring_shard.py:182``), its
    parameters in JAX's order.  Called on every rank of ``mesh`` with the
    whole batch; returns the whole (B, N) charges on every rank.

    Each rank owns an N/D atom block of each of its ``data`` coordinate's
    graphs.  A geometry pre-pass circulates the blocks' coordinates once
    and keeps, per ring step, the within-cutoff pairs of this block's rows
    in the block passing by (top-k of ``k_blk`` over the (nd, nd) slice;
    ``k_blk`` must bound a row's within-cutoff count inside one block,
    ``min(k, N/D)`` always does).  With ``neighbors`` — the global (B, N,
    k) ``(idx, mask, d2)`` tables, or the Verlet-skin ``(idx, mask)``
    whose d² comes from the current circulating coordinates — a
    conversion pre-pass compacts this block's rows of the table per
    circulating block instead.  Every message round then circulates the
    pj block: each step runs the far field of this block's rows against
    the passing block's columns (``dense_message_rowsum`` N/D × N/D, or
    its int8 tier under ``use_pallas`` and ``dense_matmul_precision=
    'int8'``), summed over the D steps, and ``near_message_corr`` on the
    step's near pairs; a pass round circulates [pi | pj] and runs
    ``near_pass_rowsum`` a step.  A step whose block holds none of this
    block's near pairs adds the kernels' exact zeros (JAX skips it with a
    ``cond``; the port avoids the host sync the test would cost).
    ``uniform_q0``: round 1's far field is the count-weighted element
    grid, built with O(E) collectives (psum of the counts, pmax of the Z
    table and of the shared q0).  ``far_cluster`` = C > 0: the clustered
    tier through the distributed fit
    (:func:`~epnn_tpu_torch.ops.cluster.weighted_kmeans_sharded`), its
    far field R × C on each rank and only the near field in the ring.
    ``far_cluster_grad``: the distributed fit's differentiable mode, its
    final half Lloyd step ``psum``-ed over the differentiable rows (the
    training tier's exact VJP).  ``remat``: when autograd records, each
    round runs under ``torch.utils.checkpoint``."""
    b, n = x.shape[:2]
    _check_shape(b, n, mesh)
    nd = n // axis_size(mesh, ATOM_AXIS)
    if k_blk > nd:
        raise ValueError(f"k_blk={k_blk} exceeds the block width {nd}")
    if far_cluster < 0:
        raise ValueError("far_cluster must be >= 0 (0 = exact)")
    if neighbors is not None:
        k_tab = int(neighbors[0].shape[-1])
        if k_blk < min(k_tab, nd):
            raise ValueError(
                f"k_blk={k_blk} cannot hold a global table of k={k_tab} "
                f"(need min(k, N/D) = {min(k_tab, nd)})")
    device = mesh_device(mesh)
    x, q0, xyz, node_mask = (_as_device(a, device)
                             for a in (x, q0, xyz, node_mask))
    if neighbors is not None:
        neighbors = tuple(_as_device(a, device) for a in neighbors)
    if cfg.compute_dtype == "bfloat16":
        bf = torch.bfloat16
        fused = dataclasses.replace(
            fused, messages=tuple(_cast_round(w, bf) for w in fused.messages),
            update=tuple((w.to(bf), bb.to(bf)) for w, bb in fused.update))
        out = forward_ring_sharded_nbr_batch(
            fused, x.to(bf), q0, xyz, node_mask.to(bf),
            cfg.replace(compute_dtype="float32", matmul_precision="default",
                        highest_precision=False),
            mesh, k_blk=k_blk, use_pallas=False, remat=remat,
            uniform_q0=uniform_q0, neighbors=neighbors,
            far_cluster=far_cluster, far_cluster_grad=far_cluster_grad)
        return out.float() * node_mask
    int8 = use_pallas and cfg.dense_matmul_precision == "int8"
    group = mesh.get_group(ATOM_AXIS)
    own = slice(C.index(group) * nd, (C.index(group) + 1) * nd)
    outs = []
    for g in range(b)[local_batch(mesh, b)]:
        nb = None if neighbors is None else tuple(
            a[g, own] for a in neighbors)
        q_d = _ring_rows_forward(
            fused, x[g, own], q0[g, own], xyz[g, own].contiguous(),
            node_mask[g, own], cfg, group, n, k_blk, nb, uniform_q0,
            int8, far_cluster, far_cluster_grad, remat)
        outs.append(C.all_gather(q_d.contiguous(), group))
    return gather_batch(torch.stack(outs), mesh)
