"""The near kernels' tensor-core arithmetic (3xTF32) on the CPU: the port's
emulations ``near_message_corr_3xtf32_plain`` and
``near_pass_rowsum_3xtf32_plain`` — what the CUDA kernels compute, up to
summation order — against the JAX Pallas kernels with
``precision="highest"`` (interpret mode off the TPU) and their XLA twins;
and the host-side mirror of the kernels' live-slot walk,
``kernels.near_tile_positions``, against a plain loop.

Tolerance: max|Δ| ≤ 1e-5·(max|ref| + 1), the bar of the fp32 plain
versions (``tests/test_torch_kernels.py``): 3xTF32 drops only lo·lo
(~2^-22 relative).  One TF32 pass (~2^-11) misses it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epnn_tpu.io import checkpoint as jax_ckpt
from epnn_tpu.models import init_params as jax_init_params
from epnn_tpu.ops import forward_blocked as jax_forward_blocked
from epnn_tpu.ops import fuse_params as jax_fuse_params
from epnn_tpu.ops.fused import max_neighbor_count as jax_max_neighbor_count
from epnn_tpu.ops.pallas_kernels import (
    _near_msg_ref,
    _near_pass_ref,
    near_message_corr as jax_near_message_corr,
    near_pass_rowsum as jax_near_pass_rowsum,
)
from epnn_tpu_torch.data import pad_molecules
from epnn_tpu_torch.elements import TRAIN_TABLE, table_for_n_elems
from epnn_tpu_torch.io import checkpoint as ckpt
from epnn_tpu_torch.models import EPNNConfig
from epnn_tpu_torch.ops import fused, kernels
from epnn_tpu_torch.testing import disjoint_pair_gh, water_box

torch.set_num_threads(1)

CKPT = "trained/mixed_b16"
H, E = 32, 48


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _err(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    return float(np.abs(out - ref).max()), 1e-5 * (float(np.abs(ref).max())
                                                   + 1.0)


def near_inputs(rng, n, k):
    """Seeded inputs at the kernels' widths (H = 32, E = 48): random
    neighbor indices, about half the slots live, rows 0–2 with no live
    slot and rows 3–5 with every slot live; rbf zero on dead slots."""
    pi = rng.normal(size=(n, H)).astype(np.float32)
    pj = rng.normal(size=(n, H)).astype(np.float32)
    idx = rng.integers(0, n, size=(n, k))
    mask = (rng.uniform(size=(n, k)) > 0.5).astype(np.float32)
    mask[0:3] = 0.0
    mask[3:6] = 1.0
    rbf = (rng.uniform(size=(n * k, E)).astype(np.float32)
           * mask.reshape(-1, 1))
    w1e = (rng.normal(size=(E, H)) * 0.3).astype(np.float32)
    w2 = (rng.normal(size=(H, H)) * 0.3).astype(np.float32)
    b2 = rng.normal(size=(H,)).astype(np.float32)
    return pi, pj, idx, mask, rbf, w1e, w2, b2


def msg_args(rng, n, k):
    pi, pj, idx, mask, rbf, w1e, w2, b2 = near_inputs(rng, n, k)
    return pi, pj[idx.reshape(-1)], rbf, mask, w1e, w2, b2


def pass_args(rng, n, k):
    pi, pj, idx, mask, rbf, w1e, w2, b2 = near_inputs(rng, n, k)
    rs = np.concatenate([pi, pj], axis=-1)
    return rs, rs[idx.reshape(-1)], rbf, 0.5 * mask, w1e, w2, b2


CASES = {
    "near_message_corr": (msg_args, jax_near_message_corr, _near_msg_ref,
                          kernels._near_msg_rows),
    "near_pass_rowsum": (pass_args, jax_near_pass_rowsum, _near_pass_ref,
                         kernels._near_pass_rows),
}
# K = 24 is the water boxes'; the others are no multiple of 16 either
SHAPES = [(64, 24), (40, 12), (33, 37), (16, 5)]


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("n,k", SHAPES)
def test_3xtf32_matches_jax(rng, name, n, k):
    """(a) Each emulation against the Pallas kernel and its XLA twin at
    "highest"; rows with no live slot come out exactly 0."""
    make, jax_fn, jax_ref, _ = CASES[name]
    args = make(rng, n, k)
    out = getattr(kernels, name + "_3xtf32_plain")(
        *(_t(a) for a in args)).numpy()
    jargs = [jnp.asarray(a) for a in args]
    for ref in (jax_fn(*jargs, block_i=8, precision="highest"),
                jax_ref(*jargs, prec=jax.lax.Precision.HIGHEST)):
        err, tol = _err(out, ref)
        assert err <= tol, (err, tol)
    assert not out[0:3].any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_one_tf32_pass_misses_the_bar(rng, name):
    """(b) hi·hi alone — one TF32 product a k-step — misses (a)'s bar by
    far, so the kernels keep both correction products."""
    make, _, jax_ref, rows = CASES[name]
    args = make(rng, 64, 24)

    def one_pass(a, b, c=None):
        out = kernels.tf32_round(a) @ kernels.tf32_round(b)
        return out if c is None else out + c

    targs = [_t(a) for a in args]
    out = rows(*targs[:-2], (tuple(targs[-2:]),), one_pass).numpy()
    err, tol = _err(out, jax_ref(*(jnp.asarray(a) for a in args),
                                 prec=jax.lax.Precision.HIGHEST))
    assert err > 10 * tol, (err, tol)


def test_3xtf32_pass_pairs_are_exact_negations(rng):
    """(c) The disjoint-pair probe of chip_smoke.py through the pass
    kernel's emulation: on a water box's own neighbor table, each pair's
    two rows are exact negations."""
    cfg = EPNNConfig()
    batch = pad_molecules([water_box(40, seed=4)], TRAIN_TABLE)
    xyz, mask = _t(batch.xyz[0]), _t(batch.node_mask[0])
    k = 24
    idx, nbr_mask, d2 = fused.build_neighbors(xyz, mask, cfg.cutoff, k,
                                              with_d2=True)
    rbf, _ = fused.rbf_and_gate(d2, nbr_mask, cfg)
    gh, pairs = disjoint_pair_gh(idx.numpy(), nbr_mask.numpy())
    assert len(pairs) >= 40
    n = xyz.shape[0]
    rs = _t(rng.normal(size=(n, 2 * H)))
    out = kernels.near_pass_rowsum_3xtf32_plain(
        rs, rs[idx.reshape(-1)].contiguous(), rbf.reshape(n * k, E), _t(gh),
        _t(rng.normal(size=(E, H)) * 0.3), _t(rng.normal(size=(H, H)) * 0.3),
        _t(rng.normal(size=H)))
    i, j = torch.from_numpy(pairs[:, 0]), torch.from_numpy(pairs[:, 1])
    assert torch.count_nonzero(out[i]) > 0
    assert torch.equal(out[i], -out[j])


def test_3xtf32_near_kernels_in_the_forward_match_jax(monkeypatch):
    """(d) ``_forward_single_nbr`` with both near kernels' emulations in
    place of the fp32 ones, on a 300-atom water box with trained/mixed_b16
    (Q = +1), against JAX ``forward_blocked`` on the neighbor split: the
    charge bar and conservation."""
    jcfg = jax_ckpt.load_config(CKPT)
    jparams = jax.tree_util.tree_map(np.asarray, jax_ckpt.load_params(
        CKPT, jax_init_params(jcfg, jax.random.key(0))))
    batch = pad_molecules([water_box(100, seed=12, charge=1.0)],
                          table_for_n_elems(jcfg.n_elems))
    arrays = (batch.x, batch.q0, batch.xyz, batch.node_mask)
    k = min(jax_max_neighbor_count(batch.xyz[0], batch.node_mask[0],
                                   jcfg.cutoff) + 4, batch.padded_atoms - 1)
    ref = np.asarray(jax_forward_blocked(
        jax_fuse_params(jparams, jcfg), *arrays, jcfg, neighbor_k=k,
        use_pallas=False, uniform_q0=True))

    calls = []
    for name in ("near_message_corr", "near_pass_rowsum"):
        emu = getattr(kernels, name + "_3xtf32_plain")

        def near(*args, precision, emu=emu, name=name):
            # the shipped config resolves to 'highest': 3xTF32
            assert precision == "highest"
            calls.append(name)
            return emu(*args)
        monkeypatch.setattr(fused, name, near)
    cfg = ckpt.load_config(CKPT)
    fp = fused.fuse_params(ckpt.from_jax_params(jparams, cfg), cfg)
    with torch.no_grad():
        q = fused.forward_blocked(fp, *(_t(a) for a in arrays), cfg,
                                  neighbor_k=k, uniform_q0=True).numpy()
    assert calls.count("near_message_corr") == jcfg.T
    assert calls.count("near_pass_rowsum") == jcfg.T
    err, tol = _err(q, ref)
    assert err < tol, (err, tol)
    cons = np.abs(q.astype(np.float64).sum(1) - batch.total_q)
    assert np.all(cons <= 1e-4), cons


def walk_positions(wgt, n_warps):
    """The kernels' walk written as loops: warp w takes rows
    [N·w // W, N·(w + 1) // W), its live slots in row-major order, 16 a
    tile; a live slot's M row, −1 for a dead one."""
    n, k = wgt.shape
    pos = -np.ones((n, k), np.int64)
    for w in range(n_warps):
        count = 0
        for r in range(n * w // n_warps, n * (w + 1) // n_warps):
            for s in range(k):
                if wgt[r, s] != 0:
                    pos[r, s] = count % kernels.NEAR_TILE
                    count += 1
    return pos


@pytest.mark.parametrize("n,k,n_warps", [(37, 24, 5), (64, 12, 16),
                                         (10, 40, 1), (16, 7, 4),
                                         (100, 24, 25)])
def test_tile_positions_match_the_walk(rng, n, k, n_warps):
    """(e) The host mirror of the kernels' compaction against a plain loop,
    on tables with empty and full rows, K no multiple of 16."""
    wgt = rng.uniform(size=(n, k)) * (rng.uniform(size=(n, k)) > 0.6)
    wgt[1] = 0.0
    wgt[2] = 0.7
    got = kernels.near_tile_positions(_t(wgt), n_warps).numpy()
    np.testing.assert_array_equal(got, walk_positions(wgt, n_warps))
