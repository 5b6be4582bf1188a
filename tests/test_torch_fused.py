"""The port's neighbor-split forward against JAX ``forward_blocked`` (XLA
path) and the JAX dense model, with the same weights.  Tolerance
1e-5·(max|q| + 1) (tests/test_fused.py's bar between the two JAX paths);
conservation |Σq − Q| < 2e-6·(Σ|q| + 1)."""

import jax
import numpy as np
import pytest
import torch

from epnn_tpu.featurize import rbf_edges as jax_rbf_edges
from epnn_tpu.models import EPNN as JaxEPNN
from epnn_tpu.models import EPNNConfig
from epnn_tpu.models import init_params as jax_init_params
from epnn_tpu.ops import forward_blocked as jax_forward_blocked
from epnn_tpu.ops import fuse_params as jax_fuse_params
from epnn_tpu.ops.fused import build_neighbors as jax_build_neighbors
from epnn_tpu.ops.fused import max_neighbor_count as jax_max_neighbor_count
from epnn_tpu_torch.elements import TRAIN_TABLE
from epnn_tpu_torch.io.checkpoint import from_jax_params
from epnn_tpu_torch.models import EPNNConfig as PortConfig
from epnn_tpu_torch.ops import fused
from epnn_tpu_torch.ops import kernels

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def port_cfg(cfg):
    return PortConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


def build(rng, cfg, b, n=24, n_real=(24, 17), seed=0):
    """Bias-perturbed weights and [Z, onehot] element features (valid rows
    first, uniform q0 = Q/n — the round-1 collapse contract)."""
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a + 0.3 if a.ndim == 1 else a),
        jax_init_params(cfg, jax.random.key(seed)))
    symbols = np.array(TRAIN_TABLE.symbols)
    x = np.zeros((b, n, cfg.n_elems), np.float32)
    xyz = np.zeros((b, n, 3), np.float32)
    mask = np.zeros((b, n), np.float32)
    q_total = np.arange(b, dtype=np.float32) - 1.0
    q0 = np.zeros((b, n), np.float32)
    for g in range(b):
        m = n_real[g]
        x[g, :m] = TRAIN_TABLE.featurize_symbols(
            rng.choice(symbols[:5], size=m))
        xyz[g, :m] = rng.uniform(-3.5, 3.5, size=(m, 3))
        mask[g, :m] = 1
        q0[g, :m] = q_total[g] / np.float32(m)
    return params, x, q0, xyz, mask, q_total


def safe_k(xyz, mask, cutoff):
    k = max(jax_max_neighbor_count(xyz[g], mask[g], cutoff)
            for g in range(len(xyz)))
    return min(k + 4, xyz.shape[1] - 1)


@pytest.mark.parametrize("mask_messages", [True, False])
@pytest.mark.parametrize("uniform_q0", [True, False])
@pytest.mark.parametrize("b", [1, 2])
def test_forward_blocked_matches_jax(rng, b, uniform_q0, mask_messages):
    cfg = EPNNConfig(mask_messages=mask_messages)
    params, x, q0, xyz, mask, q_total = build(rng, cfg, b)
    k = safe_k(xyz, mask, cfg.cutoff)
    ref = np.asarray(jax_forward_blocked(
        jax_fuse_params(params, cfg), x, q0, xyz, mask, cfg, block=8,
        neighbor_k=k, use_pallas=False, uniform_q0=uniform_q0))
    dense = np.asarray(JaxEPNN(cfg).apply(
        params, x, q0, jax_rbf_edges(xyz, mask), mask))

    pcfg = port_cfg(cfg)
    fp = fused.fuse_params(from_jax_params(params, pcfg), pcfg)
    kernels.reset_launch_counts()
    with torch.no_grad():
        out = fused.forward_blocked(fp, _t(x), _t(q0), _t(xyz), _t(mask),
                                    pcfg, neighbor_k=k,
                                    uniform_q0=uniform_q0).numpy()
    assert sum(kernels.LAUNCHES.values()) == 0  # CPU runs the plain versions
    scale = np.abs(ref).max() + 1.0
    assert np.abs(out - ref).max() < 1e-5 * scale
    assert np.abs(out - dense).max() < 1e-5 * scale
    err = np.abs(out.sum(1) - q_total)
    assert np.all(err < 2e-6 * (np.abs(out).sum(1) + 1.0)), err
    assert np.all(out[mask == 0] == 0.0)


def _pair_sets(idx, mask):
    return [set(int(j) for j, m in zip(r, mr) if m > 0)
            for r, mr in zip(idx, mask)]


@pytest.mark.parametrize("n_real", [24, 15])
def test_build_neighbors_matches_jax_as_sets(rng, n_real):
    xyz = np.zeros((24, 3), np.float32)
    xyz[:n_real] = rng.uniform(-3, 3, size=(n_real, 3))
    mask = (np.arange(24) < n_real).astype(np.float32)
    k = safe_k(xyz[None], mask[None], 3.0)
    i_j, m_j, d_j = (np.asarray(a) for a in jax_build_neighbors(
        xyz, mask, 3.0, k, with_d2=True))
    i_t, m_t, d_t = (a.numpy() for a in fused.build_neighbors(
        _t(xyz), _t(mask), 3.0, k, with_d2=True))
    assert _pair_sets(i_t, m_t) == _pair_sets(i_j, m_j)
    for r in range(24):
        dj = {int(j): d for j, d, m in zip(i_j[r], d_j[r], m_j[r]) if m}
        dt = {int(j): d for j, d, m in zip(i_t[r], d_t[r], m_t[r]) if m}
        for j in dj:
            assert abs(dj[j] - dt[j]) <= 1e-6 * (dj[j] + 1.0)
    # the pair d² is symmetric bit for bit (the pass rounds rely on it)
    for r in range(24):
        for j, d, m in zip(i_t[r], d_t[r], m_t[r]):
            if m:
                back = d_t[j][(i_t[j] == r) & (m_t[j] > 0)]
                assert back.tolist() == [d]


def test_blocked_selection_matches_one_shot(rng, monkeypatch):
    xyz = _t(rng.uniform(-4, 4, size=(40, 3)))
    mask = _t((np.arange(40) < 37).astype(np.float32))
    one = fused.build_neighbors(xyz, mask, 3.0, 12, with_d2=True)
    monkeypatch.setattr(fused, "_NEIGHBOR_BLOCK_THRESHOLD", 8)
    monkeypatch.setattr(fused, "_NEIGHBOR_BLOCK", 16)
    blk = fused.build_neighbors(xyz, mask, 3.0, 12, with_d2=True)
    for a, b in zip(one, blk):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [200, 5000])
def test_max_neighbor_count_matches_jax(rng, n):
    xyz = rng.uniform(0, (n / 0.1) ** (1 / 3), size=(n, 3))
    mask = np.ones((n,), np.float32)
    mask[-7:] = 0
    got = fused.max_neighbor_count(xyz, mask, 3.0)
    assert got == jax_max_neighbor_count(xyz, mask, 3.0)
    assert got == fused._max_neighbor_count_scan(
        np.asarray(xyz, np.float64), mask > 0, 3.0)


def test_rbf_and_gate_matches_jax(rng):
    from epnn_tpu.ops.fused import rbf_and_gate as jax_rbf_and_gate

    for weighting in ("hard_gate", "soft_envelope"):
        cfg = EPNNConfig(pass_weighting=weighting)
        d2 = rng.uniform(0, 10, size=(30, 7)).astype(np.float32)
        d2[0, :3] = [0.0, 9.0, 8.9999]
        cm = (rng.uniform(size=(30, 7)) > 0.2).astype(np.float32)
        rj, gj = jax_rbf_and_gate(d2, cm, cfg)
        rt, gt = fused.rbf_and_gate(_t(d2), _t(cm), port_cfg(cfg))
        assert np.abs(rt.numpy() - np.asarray(rj)).max() <= 1e-6
        assert np.abs(gt.numpy() - np.asarray(gj)).max() <= 1e-6
