"""The port's fused dense kernels and kernel-built neighbor lists (on the
CPU: their plain versions) against the JAX Pallas kernels in interpret
mode, as tests/test_pallas.py runs them.  Tolerance: max|Δ| ≤
1e-5·(max|ref| + 1) — float32 summation order only."""

import jax
import numpy as np
import pytest
import torch

from epnn_tpu.models import EPNNConfig
from epnn_tpu.ops import forward_blocked as jax_forward_blocked
from epnn_tpu.ops import fuse_params as jax_fuse_params
from epnn_tpu.ops.pallas_kernels import (
    fused_epn_rowsum as jax_fused_epn_rowsum,
    fused_message_rowsum as jax_fused_message_rowsum,
    neighbor_compact as jax_neighbor_compact,
)
from epnn_tpu.ops.fused import max_neighbor_count as jax_max_neighbor_count
from epnn_tpu_torch.featurize import pair_d2
from epnn_tpu_torch.io.checkpoint import from_jax_params
from epnn_tpu_torch.ops import fused, kernels
from epnn_tpu_torch.testing import dimer_probe
from test_torch_fused import _t, build, port_cfg, safe_k

torch.set_num_threads(2)


def _close(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= 1e-5 * (np.abs(ref).max() + 1.0), err


def pair_inputs(rng, n, h, e, n_real=None, span=4.0):
    """tests/test_pallas.py's pair_setup at any width: pi, pj, xyz, mask
    (atoms from ``n_real`` on masked), a column vector with a zero tail,
    W1e, W2, b2."""
    n_real = n - 5 if n_real is None else n_real
    mask = (np.arange(n) < n_real).astype(np.float32)
    cv = np.ones(n, np.float32)
    cv[-3:] = 0.0
    return dict(
        pi=rng.normal(size=(n, h)).astype(np.float32),
        pj=rng.normal(size=(n, h)).astype(np.float32),
        xyz=rng.uniform(-span, span, size=(n, 3)).astype(np.float32),
        mask=mask, cv=cv,
        w1e=(rng.normal(size=(e, h)) * 0.3).astype(np.float32),
        w2=(rng.normal(size=(h, h)) * 0.3).astype(np.float32),
        b2=rng.normal(size=(h,)).astype(np.float32))


WIDTHS = [(24, 8, 16), (24, 32, 48)]


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("n,h,e", WIDTHS)
def test_fused_message_rowsum(rng, n, h, e, masked):
    a = pair_inputs(rng, n, h, e)
    kernels.reset_launch_counts()
    out = kernels.fused_message_rowsum(
        *(_t(a[k]) for k in ("pi", "pj", "xyz", "mask", "cv", "w1e", "w2",
                             "b2")), cutoff=3.0, eta=2.0, tol=1e-5,
        masked=masked, precision="highest").numpy()
    assert sum(kernels.LAUNCHES.values()) == 0  # CPU: the plain version
    ref = jax_fused_message_rowsum(
        a["pi"], a["pj"], a["xyz"], a["mask"], a["cv"], a["w1e"], a["w2"],
        a["b2"], masked=masked, block_i=8, block_j=8, precision="highest",
        packed=False)
    _close(out, ref)


@pytest.mark.parametrize("soft_gate", [False, True])
@pytest.mark.parametrize("n,h,e", WIDTHS)
def test_fused_epn_rowsum(rng, n, h, e, soft_gate):
    a = pair_inputs(rng, n, h, e)
    kernels.reset_launch_counts()
    out = kernels.fused_epn_rowsum(
        *(_t(a[k]) for k in ("pi", "pj", "xyz", "mask", "w1e", "w2", "b2")),
        cutoff=3.0, eta=2.0, tol=1e-5, soft_gate=soft_gate,
        precision="highest").numpy()
    assert sum(kernels.LAUNCHES.values()) == 0
    ref = jax_fused_epn_rowsum(
        a["pi"], a["pj"], a["xyz"], a["mask"], a["w1e"], a["w2"], a["b2"],
        soft_gate=soft_gate, block_i=8, block_j=8, precision="highest",
        packed=False)
    _close(out, ref)
    assert np.all(out[a["mask"] == 0] == 0.0)


@pytest.mark.parametrize("variant", ["message_masked", "message_cv",
                                     "epn_hard", "epn_soft"])
def test_fused_kernels_against_packed_jax(rng, variant):
    """The TPU's lane-packed variants compute the same function."""
    a = pair_inputs(rng, 64, 32, 48, n_real=57, span=5.0)
    if variant.startswith("message"):
        masked = variant == "message_masked"
        out = kernels.fused_message_rowsum_plain(
            *(_t(a[k]) for k in ("pi", "pj", "xyz", "mask", "cv", "w1e", "w2",
                                 "b2")), masked=masked)
        ref = jax_fused_message_rowsum(
            a["pi"], a["pj"], a["xyz"], a["mask"], a["cv"], a["w1e"],
            a["w2"], a["b2"], masked=masked, block_i=8, block_j=32,
            precision="highest", packed=True)
    else:
        soft = variant == "epn_soft"
        out = kernels.fused_epn_rowsum_plain(
            *(_t(a[k]) for k in ("pi", "pj", "xyz", "mask", "w1e", "w2",
                                 "b2")), soft_gate=soft)
        ref = jax_fused_epn_rowsum(
            a["pi"], a["pj"], a["xyz"], a["mask"], a["w1e"], a["w2"],
            a["b2"], soft_gate=soft, block_i=8, block_j=32,
            precision="highest", packed=True)
    _close(out.numpy(), ref)


def test_plain_row_blocks_do_not_change_the_result(rng, monkeypatch):
    a = pair_inputs(rng, 40, 32, 48)
    args = [_t(a[k]) for k in ("pi", "pj", "xyz", "mask", "w1e", "w2", "b2")]
    full = kernels.fused_epn_rowsum_plain(*args)
    monkeypatch.setattr(kernels, "_plain_rows", lambda r, n, w: 7)
    _close(kernels.fused_epn_rowsum_plain(*args).numpy(), full.numpy())


@pytest.mark.parametrize("soft_gate", [False, True])
def test_fused_epn_dimer_probe(rng, soft_gate):
    """Disjoint near pairs, each ≥ 4 Å from all other atoms: every row
    holds one live transfer, and a pair's two rows are exact negations."""
    xyz, pairs = dimer_probe(24, seed=3)
    a = pair_inputs(rng, len(xyz), 32, 48, n_real=len(xyz))
    a["xyz"] = xyz
    out = kernels.fused_epn_rowsum(
        *(_t(a[k]) for k in ("pi", "pj", "xyz", "mask", "w1e", "w2", "b2")),
        soft_gate=soft_gate, precision="highest")
    i, j = torch.from_numpy(pairs[:, 0]), torch.from_numpy(pairs[:, 1])
    assert torch.count_nonzero(out[i]) > 0
    assert torch.equal(out[i], -out[j])


def test_dimer_probe_geometry():
    xyz, pairs = dimer_probe(1110, seed=0)
    assert xyz.shape == (2220, 3) and pairs.shape == (1110, 2)
    assert sorted(pairs.ravel().tolist()) == list(range(2220))
    sep = np.linalg.norm(xyz[pairs[:, 0]] - xyz[pairs[:, 1]], axis=1)
    assert sep.min() >= 1.0 - 1e-5 and sep.max() <= 2.5 + 1e-5
    partner = np.empty(2220, np.int64)
    partner[pairs[:, 0]], partner[pairs[:, 1]] = pairs[:, 1], pairs[:, 0]
    for s in range(0, 2220, 555):
        d = np.linalg.norm(xyz[s:s + 555, None] - xyz[None], axis=-1)
        d[np.arange(d.shape[0]), np.arange(s, s + d.shape[0])] = np.inf
        d[np.arange(d.shape[0]), partner[s:s + 555]] = np.inf
        assert d.min() >= 4.0
    # most pairs straddle two 16-row tiles of the grid
    assert np.mean(pairs[:, 0] // 16 != pairs[:, 1] // 16) > 0.9


def test_fused_wrappers_are_inference_only(rng):
    a = pair_inputs(rng, 24, 32, 48)
    pi = _t(a["pi"]).requires_grad_(True)
    out = kernels.fused_epn_rowsum(
        pi, *(_t(a[k]) for k in ("pj", "xyz", "mask", "w1e", "w2", "b2")),
        precision="highest")
    with pytest.raises(NotImplementedError, match="inference-only"):
        out.sum().backward()


def _compact_inputs(rng, case):
    if case == "n200":
        n = 200
        xyz = rng.uniform(0, (n / 0.1) ** (1 / 3), (n, 3)).astype(np.float32)
        mask = np.ones(n, np.float32)
        mask[-20:] = 0.0
        return xyz, mask, int(jax_max_neighbor_count(xyz, mask, 3.0)) + 4
    if case == "n57":
        xyz = rng.uniform(0, 8.0, (57, 3)).astype(np.float32)
        mask = np.ones(57, np.float32)
        return xyz, mask, int(jax_max_neighbor_count(xyz, mask, 3.0)) + 2
    xyz = np.zeros((8, 3), np.float32)   # coincident and masked atoms
    xyz[2] = [1.0, 0, 0]
    xyz[3] = [0, 1.5, 0]
    mask = np.ones(8, np.float32)
    mask[5:] = 0.0
    return xyz, mask, 8


@pytest.mark.parametrize("case", ["n200", "n57", "coincident"])
def test_neighbor_compact_matches_jax(rng, case):
    xyz, mask, k = _compact_inputs(rng, case)
    kernels.reset_launch_counts()
    idx, m = kernels.neighbor_compact(_t(xyz), _t(mask), 3.0, k)
    assert sum(kernels.LAUNCHES.values()) == 0
    assert idx.dtype == torch.int64 and m.dtype == torch.float32
    i_j, m_j = (np.asarray(a) for a in jax_neighbor_compact(xyz, mask, 3.0,
                                                            k))
    assert np.array_equal(idx.numpy(), i_j.astype(np.int64))
    assert np.array_equal(m.numpy(), m_j)
    # the same set as the port's top-k selection, row by row
    i_t, m_t = fused.build_neighbors(_t(xyz), _t(mask), 3.0, k)
    for r in range(len(xyz)):
        assert (set(idx[r][m[r] > 0].tolist())
                == set(i_t[r][m_t[r] > 0].tolist()))


def test_neighbor_compact_drops_hits_beyond_k(rng):
    xyz, mask, k = _compact_inputs(rng, "n57")
    full, fm = kernels.neighbor_compact(_t(xyz), _t(mask), 3.0, k)
    cut, cm = kernels.neighbor_compact(_t(xyz), _t(mask), 3.0, 3)
    assert torch.equal(cut, full[:, :3]) and torch.equal(cm, fm[:, :3])


@pytest.mark.parametrize("mask_messages", [True, False])
@pytest.mark.parametrize("b", [1, 2])
def test_forward_with_kernel_neighbors_matches_jax(rng, b, mask_messages):
    """``neighbors=(idx, mask)``: the forward recomputes d² from the
    gathered coordinates, as JAX's ``_rbf_gathered`` does."""
    cfg = EPNNConfig(mask_messages=mask_messages)
    params, x, q0, xyz, mask, q_total = build(rng, cfg, b)
    k = safe_k(xyz, mask, cfg.cutoff)
    tables = [kernels.neighbor_compact(_t(xyz[g]), _t(mask[g]), cfg.cutoff, k)
              for g in range(b)]
    idx = torch.stack([t[0] for t in tables])
    nmask = torch.stack([t[1] for t in tables])
    ref = np.asarray(jax_forward_blocked(
        jax_fuse_params(params, cfg), x, q0, xyz, mask, cfg, block=8,
        neighbor_k=k, neighbors=(idx.numpy().astype(np.int32),
                                 nmask.numpy())))
    pcfg = port_cfg(cfg)
    fp = fused.fuse_params(from_jax_params(params, pcfg), pcfg)
    with torch.no_grad():
        out = fused.forward_blocked(fp, _t(x), _t(q0), _t(xyz), _t(mask),
                                    pcfg, neighbor_k=k,
                                    neighbors=(idx, nmask)).numpy()
        top = fused.forward_blocked(fp, _t(x), _t(q0), _t(xyz), _t(mask),
                                    pcfg, neighbor_k=k).numpy()
    scale = np.abs(ref).max() + 1.0
    assert np.abs(out - ref).max() < 1e-5 * scale
    assert np.abs(out - top).max() < 1e-5 * scale
    err = np.abs(out.sum(1) - q_total)
    assert np.all(err < 2e-6 * (np.abs(out).sum(1) + 1.0)), err


def test_gathered_d2_is_symmetric_bit_for_bit(rng):
    xyz = _t(rng.uniform(-3, 3, size=(30, 3)))
    idx, m = kernels.neighbor_compact(xyz, torch.ones(30), 3.0, 29)
    d2 = pair_d2(xyz[:, None], xyz[idx]).numpy()
    idx, m = idx.numpy(), m.numpy()
    for r in range(30):
        for s in np.nonzero(m[r])[0]:
            j = idx[r, s]
            back = d2[j][(idx[j] == r) & (m[j] > 0)]
            assert back.tolist() == [d2[r, s]]
