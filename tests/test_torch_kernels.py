"""The port's kernel wrappers (on the CPU: their plain versions) against the
JAX Pallas kernels (interpret mode off the TPU) and their XLA/NumPy twins.
Tolerance: max|Δ| ≤ 1e-5·(max|ref| + 1) — float32 summation order only."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epnn_tpu.ops.pallas_kernels import (
    _near_msg_ref,
    _near_pass_ref,
    dense_message_rowsum as jax_dense_message_rowsum,
    dense_message_rowsum_reference,
    near_message_corr as jax_near_message_corr,
    near_pass_rowsum as jax_near_pass_rowsum,
)
from epnn_tpu_torch.ops import kernels

torch.set_num_threads(2)


def _close(out, ref):
    out = np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= 1e-5 * (np.abs(ref).max() + 1.0), err


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


@pytest.fixture
def near_setup(rng):
    """The shapes of tests/test_pallas.py's near_setup."""
    n, k, h, e = 96, 12, 32, 16
    pi = rng.normal(size=(n, h)).astype(np.float32)
    pj = rng.normal(size=(n, h)).astype(np.float32)
    idx = rng.integers(0, n, size=(n, k)).astype(np.int32)
    mask = (rng.uniform(size=(n, k)) > 0.3).astype(np.float32)
    rbf = (rng.normal(size=(n * k, e)).astype(np.float32)
           * mask.reshape(-1, 1))
    w1e = (rng.normal(size=(e, h)) * 0.3).astype(np.float32)
    w2 = (rng.normal(size=(h, h)) * 0.3).astype(np.float32)
    b2 = rng.normal(size=(h,)).astype(np.float32)
    return n, k, h, pi, pj, idx, mask, rbf, w1e, w2, b2


@pytest.mark.parametrize("rows,cols,n_real", [(64, 64, 64), (40, 128, 100)])
def test_dense_message_rowsum(rng, rows, cols, n_real):
    """Square and rectangular R≠N; padded columns carry cv = 0."""
    h = 32
    pi = rng.normal(size=(rows, h)).astype(np.float32)
    pj = rng.normal(size=(cols, h)).astype(np.float32)
    pj[n_real:] = rng.normal(size=(cols - n_real, h)) * 5.0  # junk padding
    cv = np.zeros((cols,), np.float32)
    cv[:n_real] = 1.0
    w2 = (rng.normal(size=(h, h)) * 0.3).astype(np.float32)
    b2 = rng.normal(size=(h,)).astype(np.float32)
    out = kernels.dense_message_rowsum(_t(pi), _t(pj), _t(cv), _t(w2),
                                       _t(b2), precision="highest").numpy()
    _close(out, dense_message_rowsum_reference(pi, pj, cv, w2, b2))
    ref = jax_dense_message_rowsum(
        jnp.asarray(pi), jnp.asarray(pj), jnp.asarray(cv), jnp.asarray(w2),
        jnp.asarray(b2), block_i=8, block_jp=8, precision="highest")
    _close(out, ref)
    assert kernels.LAUNCHES["dense_message_rowsum"] == 0  # CPU: plain path


def test_dense_message_rowsum_row_blocks(rng, monkeypatch):
    """The plain version's row blocking does not change the result."""
    pi, pj = (_t(rng.normal(size=(50, 32))) for _ in range(2))
    cv, w2, b2 = _t(rng.uniform(size=50)), _t(rng.normal(size=(32, 32))), \
        _t(rng.normal(size=32))
    full = kernels.dense_message_rowsum_plain(pi, pj, cv, w2, b2)
    small = torch.cat([kernels.dense_message_rowsum_plain(
        pi[s:s + 7], pj, cv, w2, b2) for s in range(0, 50, 7)])
    _close(full.numpy(), small.numpy())


def test_near_message_corr(near_setup):
    n, k, h, pi, pj, idx, mask, rbf, w1e, w2, b2 = near_setup
    pjn = pj[idx.reshape(-1)]
    out = kernels.near_message_corr(_t(pi), _t(pjn), _t(rbf), _t(mask),
                                    _t(w1e), _t(w2), _t(b2),
                                    precision="highest").numpy()
    args = [jnp.asarray(a) for a in (pi, pjn, rbf, mask, w1e, w2, b2)]
    _close(out, _near_msg_ref(*args, prec=jax.lax.Precision.HIGHEST))
    _close(out, jax_near_message_corr(*args, block_i=32, precision="highest"))


def test_near_pass_rowsum(near_setup):
    n, k, h, pi, pj, idx, mask, rbf, w1e, w2, b2 = near_setup
    rs = np.concatenate([pi, pj], axis=-1)
    ppn = rs[idx.reshape(-1)]
    gh = 0.5 * mask
    out = kernels.near_pass_rowsum(_t(rs), _t(ppn), _t(rbf), _t(gh), _t(w1e),
                                   _t(w2), _t(b2), precision="highest").numpy()
    args = [jnp.asarray(a) for a in (rs, ppn, rbf, gh, w1e, w2, b2)]
    _close(out, _near_pass_ref(*args, prec=jax.lax.Precision.HIGHEST))
    _close(out, jax_near_pass_rowsum(*args, block_i=32, precision="highest"))


def near_pass_probe(rng, n=24, k=6, h=32, e=48, device="cpu"):
    """Inputs for the antisymmetry probe: a symmetric neighbor table (ring
    neighbors ±1..±k/2), symmetric per-pair RBF rows, and gh non-zero on
    exactly one slot of row i and its reciprocal slot of row j."""
    half = k // 2
    offs = [d for d in range(1, half + 1)] + [-d for d in range(1, half + 1)]
    idx = np.array([[(i + d) % n for d in offs] for i in range(n)])
    pair_rbf = {}
    rbf = np.zeros((n, k, e), np.float32)
    for i in range(n):
        for s, j in enumerate(idx[i]):
            key = (min(i, j), max(i, j))
            if key not in pair_rbf:
                pair_rbf[key] = rng.uniform(0, 1, size=e).astype(np.float32)
            rbf[i, s] = pair_rbf[key]
    i, s = 5, 2
    j = int(idx[i, s])
    s_back = int(np.nonzero(idx[j] == i)[0][0])
    gh = np.zeros((n, k), np.float32)
    gh[i, s] = gh[j, s_back] = 0.5
    rs = rng.normal(size=(n, 2 * h)).astype(np.float32)
    w1e = (rng.normal(size=(e, h)) * 0.3).astype(np.float32)
    w2 = (rng.normal(size=(h, h)) * 0.3).astype(np.float32)
    b2 = rng.normal(size=(h,)).astype(np.float32)
    args = [_t(a).to(device) for a in (rs, rs[idx.reshape(-1)],
                                        rbf.reshape(n * k, e), gh, w1e, w2,
                                        b2)]
    return args, i, j


def test_near_pass_antisymmetry_probe(rng):
    args, i, j = near_pass_probe(rng)
    out = kernels.near_pass_rowsum(*args, precision="highest")
    assert torch.count_nonzero(out[i]) > 0
    assert torch.equal(out[i], -out[j])
    others = [r for r in range(out.shape[0]) if r not in (i, j)]
    assert torch.count_nonzero(out[others]) == 0


def test_near_pass_probe_on_a_real_neighbor_table(rng):
    """The probe chip_smoke.py runs on the card, here through the plain
    version: disjoint near pairs of a water box's own neighbor table (d²
    from the selection, RBF from rbf_and_gate), one slot each."""
    from epnn_tpu_torch.data import pad_molecules
    from epnn_tpu_torch.elements import TRAIN_TABLE
    from epnn_tpu_torch.models import EPNNConfig
    from epnn_tpu_torch.ops.fused import build_neighbors, rbf_and_gate
    from epnn_tpu_torch.testing import disjoint_pair_gh, water_box

    cfg = EPNNConfig()
    batch = pad_molecules([water_box(40, seed=4)], TRAIN_TABLE)
    xyz, mask = _t(batch.xyz[0]), _t(batch.node_mask[0])
    idx, nbr_mask, d2 = build_neighbors(xyz, mask, cfg.cutoff, 24,
                                        with_d2=True)
    rbf, _ = rbf_and_gate(d2, nbr_mask, cfg)
    gh, pairs = disjoint_pair_gh(idx.numpy(), nbr_mask.numpy())
    assert len(pairs) >= 40
    n, h, e = xyz.shape[0], 32, cfg.e_dim
    rs = _t(rng.normal(size=(n, 2 * h)))
    out = kernels.near_pass_rowsum(
        rs, rs[idx.reshape(-1)].contiguous(), rbf.reshape(n * 24, e), _t(gh),
        _t(rng.normal(size=(e, h)) * 0.3), _t(rng.normal(size=(h, h)) * 0.3),
        _t(rng.normal(size=h)), precision="highest")
    i, j = torch.from_numpy(pairs[:, 0]), torch.from_numpy(pairs[:, 1])
    assert torch.count_nonzero(out[i]) > 0
    assert torch.equal(out[i], -out[j])


def test_wrappers_check_inputs(near_setup):
    n, k, h, pi, pj, idx, mask, rbf, w1e, w2, b2 = near_setup
    pjn = pj[idx.reshape(-1)]
    good = [_t(a) for a in (pi, pjn, rbf, mask, w1e, w2, b2)]
    with pytest.raises(ValueError, match="shape"):
        kernels.near_message_corr(good[0][:, :16].contiguous(), *good[1:])
    with pytest.raises(TypeError, match="float32"):
        kernels.near_message_corr(good[0].double(), *good[1:])
    with pytest.raises(ValueError, match="contiguous"):
        kernels.dense_message_rowsum(good[0].T.contiguous().T, _t(pj),
                                     torch.ones(n), good[5], good[6])
