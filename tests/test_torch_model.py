"""The port's dense EPNN module against JAX ``EPNN.apply`` with the same
bias-perturbed weights.  Tolerance 2e-5·(max|q| + 1), the JAX suite's own
bar between two paths of the same math (tests/test_fused.py)."""

import jax
import numpy as np
import pytest
import torch

from epnn_tpu.featurize import rbf_edges as jax_rbf_edges
from epnn_tpu.models import EPNN as JaxEPNN
from epnn_tpu.models import EPNNConfig
from epnn_tpu.models import init_params as jax_init_params
from epnn_tpu_torch.io.checkpoint import from_jax_params
from epnn_tpu_torch.models import EPNN
from epnn_tpu_torch.models import EPNNConfig as PortConfig
from epnn_tpu_torch.models import pair_gate

torch.set_num_threads(2)


def jax_params(cfg, seed=0):
    """JAX init with every 1-D leaf perturbed, so biases carry load."""
    params = jax_init_params(cfg, jax.random.key(seed))
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a + 0.3 if a.ndim == 1 else a), params)


def inputs(rng, cfg, b=2, n=12, n_real=9):
    x = rng.normal(size=(b, n, cfg.n_elems)).astype(np.float32)
    xyz = rng.uniform(-3, 3, size=(b, n, 3)).astype(np.float32)
    mask = np.zeros((b, n), np.float32)
    mask[:, :n_real] = 1
    x[:, n_real:] = 0
    q_total = np.arange(b, dtype=np.float32) - 1.0
    q0 = mask * (q_total[:, None] / n_real)
    e = np.asarray(jax_rbf_edges(xyz, mask, e_dim=cfg.e_dim))
    return x, q0, e, mask


def port_model(cfg, params):
    pcfg = PortConfig(**{f: getattr(cfg, f) for f in
                         cfg.__dataclass_fields__})
    return EPNN.from_params(pcfg, from_jax_params(params, pcfg))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("pass_weighting", ["hard_gate", "soft_envelope"])
@pytest.mark.parametrize("mask_messages", [True, False])
def test_dense_epnn_matches_jax(rng, mask_messages, pass_weighting):
    cfg = EPNNConfig(mask_messages=mask_messages,
                     pass_weighting=pass_weighting)
    params = jax_params(cfg)
    x, q0, e, mask = inputs(rng, cfg)
    kw = {}
    if pass_weighting == "soft_envelope":
        env = rng.uniform(size=(2, 12, 12)).astype(np.float32)
        kw["soft_env"] = env + env.transpose(0, 2, 1)
    ref = np.asarray(JaxEPNN(cfg).apply(params, x, q0, e, mask, **kw))
    with torch.no_grad():
        out = port_model(cfg, params)(
            _t(x), _t(q0), _t(e), _t(mask),
            **{k: _t(v) for k, v in kw.items()}).numpy()
    assert np.abs(out - ref).max() < 2e-5 * (np.abs(ref).max() + 1.0)
    # charge conservation: Σq = Q to f32 summation noise
    err = np.abs(out.sum(1) - q0.sum(1))
    assert np.all(err < 2e-6 * (np.abs(out).sum(1) + 1.0)), err


def test_dense_epnn_h0_matches_jax(rng):
    cfg = EPNNConfig(T=3)
    params = jax_params(cfg, seed=1)
    x, q0, e, mask = inputs(rng, cfg)
    h0 = rng.normal(size=(2, 12, cfg.h_dim)).astype(np.float32)
    ref = np.asarray(JaxEPNN(cfg).apply(params, x, q0, e, mask, h0=h0))
    with torch.no_grad():
        out = port_model(cfg, params)(_t(x), _t(q0), _t(e), _t(mask),
                                      h0=_t(h0)).numpy()
    assert np.abs(out - ref).max() < 2e-5 * (np.abs(ref).max() + 1.0)


def test_soft_envelope_needs_env(rng):
    cfg = EPNNConfig(pass_weighting="soft_envelope", T=1)
    x, q0, e, mask = inputs(rng, cfg)
    with pytest.raises(ValueError, match="soft_env"):
        port_model(cfg, jax_params(cfg))(_t(x), _t(q0), _t(e), _t(mask))


def test_pair_gate_matches_jax(rng):
    from epnn_tpu.models.epnn import pair_gate as jax_pair_gate

    e = rng.uniform(0, 3e-5, size=(4, 5, 8)).astype(np.float32)
    e[0, 0] = 0.0
    np.testing.assert_array_equal(
        pair_gate(_t(e), 1e-5).numpy(), np.asarray(jax_pair_gate(e, 1e-5)))
