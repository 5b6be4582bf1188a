"""The port's dense blocked forwards — ``forward_blocked`` without
``neighbor_k``: the fully fused path (``use_pallas=True``, the fused
kernels' plain versions on the CPU) and the plain row-blocked
``_forward_single`` — against JAX ``forward_blocked(use_pallas=True)``
(Pallas in interpret mode), JAX ``forward_blocked(block=8)`` and the JAX
dense model, with the same weights.  Tolerance 1e-5·(max|q| + 1)
(tests/test_fused.py's bar between two JAX paths); conservation
|Σq − Q| < 2e-6·(Σ|q| + 1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epnn_tpu.featurize import rbf_edges as jax_rbf_edges
from epnn_tpu.featurize import soft_envelope_np as jax_soft_envelope_np
from epnn_tpu.io import checkpoint as jax_ckpt
from epnn_tpu.models import EPNN as JaxEPNN
from epnn_tpu.models import EPNNConfig
from epnn_tpu.models import init_params as jax_init_params
from epnn_tpu.ops import forward_blocked as jax_forward_blocked
from epnn_tpu.ops import fuse_params as jax_fuse_params
from epnn_tpu_torch.data import pad_molecules
from epnn_tpu_torch.elements import table_for_n_elems
from epnn_tpu_torch.featurize import soft_envelope_np
from epnn_tpu_torch.io import checkpoint as ckpt
from epnn_tpu_torch.io.checkpoint import from_jax_params
from epnn_tpu_torch.models import tree_leaves
from epnn_tpu_torch.ops import fused, kernels
from epnn_tpu_torch.testing import water_box
from test_torch_fused import _t, build, port_cfg

torch.set_num_threads(2)

CKPT = "trained/mixed_b16"


def run_port(params, cfg, x, q0, xyz, mask, **kw):
    pcfg = port_cfg(cfg)
    fp = fused.fuse_params(from_jax_params(params, pcfg), pcfg)
    kernels.reset_launch_counts()
    with torch.no_grad():
        out = fused.forward_blocked(fp, _t(x), _t(q0), _t(xyz), _t(mask),
                                    pcfg, **kw).numpy()
    assert sum(kernels.LAUNCHES.values()) == 0  # CPU runs the plain versions
    return out


def jax_refs(params, cfg, x, q0, xyz, mask):
    fp = jax_fuse_params(params, cfg)
    kw = {}
    if cfg.pass_weighting == "soft_envelope":
        kw["soft_env"] = np.stack([
            soft_envelope_np(xyz[g]) * mask[g][:, None] * mask[g][None, :]
            for g in range(len(xyz))]).astype(np.float32)
    return [np.asarray(jax_forward_blocked(fp, x, q0, xyz, mask, cfg,
                                           use_pallas=True)),
            np.asarray(jax_forward_blocked(fp, x, q0, xyz, mask, cfg,
                                           block=8)),
            np.asarray(JaxEPNN(cfg).apply(params, x, q0,
                                          jax_rbf_edges(xyz, mask), mask,
                                          **kw))]


def test_soft_envelope_np_is_jaxs():
    """The port's copy of the NumPy oracle (which feeds the JAX dense
    model's soft envelope below) equals the JAX package's bit for bit, on
    a water box with a coincident pair and at another cutoff."""
    xyz = water_box(20, seed=3).xyz.copy()
    xyz[5] = xyz[4]
    for cutoff in (3.0, 2.5):
        np.testing.assert_array_equal(soft_envelope_np(xyz, cutoff),
                                      jax_soft_envelope_np(xyz, cutoff))
    assert soft_envelope_np(xyz).shape == (60, 60)


def check(out, refs, mask, q_total):
    scale = np.abs(refs[0]).max() + 1.0
    for ref in refs:
        assert np.abs(out - ref).max() < 1e-5 * scale
    err = np.abs(out.astype(np.float64).sum(1) - q_total)
    assert np.all(err < 2e-6 * (np.abs(out).sum(1) + 1.0)), err
    assert np.all(out[mask == 0] == 0.0)


CASES = {
    **{f"mask{int(m)}_b{b}": (dict(mask_messages=m), b, 24, (24, 17))
       for m in (True, False) for b in (1, 2)},
    "soft_envelope": (dict(pass_weighting="soft_envelope"), 2, 24, (24, 17)),
    "width21": (dict(mask_messages=False), 2, 21, (21, 14)),
}


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_dense_forwards_match_jax(rng, case, use_pallas):
    kw, b, n, n_real = CASES[case]
    cfg = EPNNConfig(**kw)
    params, x, q0, xyz, mask, q_total = build(rng, cfg, b, n=n,
                                              n_real=n_real)
    out = run_port(params, cfg, x, q0, xyz, mask, use_pallas=use_pallas,
                   block=8)
    check(out, jax_refs(params, cfg, x, q0, xyz, mask), mask, q_total)


def test_mixed_b16_water_box_matches_jax():
    jcfg = jax_ckpt.load_config(CKPT)
    params = jax_ckpt.load_params(CKPT, jax_init_params(jcfg,
                                                        jax.random.key(0)))
    params = jax.tree_util.tree_map(np.asarray, params)
    batch = pad_molecules([water_box(32, seed=9, charge=-1.0)],
                          table_for_n_elems(jcfg.n_elems))
    args = (batch.x, batch.q0, batch.xyz, batch.node_mask)
    out = run_port(params, jcfg, *args, use_pallas=True)
    refs = jax_refs(params, jcfg, *args)
    check(out, refs, batch.node_mask, batch.total_q)
    check(run_port(params, jcfg, *args), refs, batch.node_mask,
          batch.total_q)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_deeper_mids_run_the_plain_dense_path(rng, use_pallas):
    """Any MLP depth runs on ``_forward_single``; ``use_pallas`` at that
    depth falls to it, as in JAX.  T = 2: at T = 5 with these bias-shifted
    weights the charges grow to ~10 e and the two JAX paths already differ
    by more than the bar."""
    cfg = EPNNConfig(mlp_hidden=(32, 32, 32), T=2)
    params, x, q0, xyz, mask, q_total = build(rng, cfg, 2)
    out = run_port(params, cfg, x, q0, xyz, mask, use_pallas=use_pallas,
                   block=8)
    refs = jax_refs(params, cfg, x, q0, xyz, mask)
    check(out, refs[1:], mask, q_total)


def test_fused_path_has_no_gradient(rng):
    cfg = EPNNConfig()
    params, x, q0, xyz, mask, _ = build(rng, cfg, 1)
    pcfg = port_cfg(cfg)
    tree = from_jax_params(params, pcfg)
    for leaf in tree_leaves(tree):
        leaf.requires_grad_(True)
    q = fused.forward_blocked(fused.fuse_params(tree, pcfg, "cpu"), _t(x),
                              _t(q0), _t(xyz), _t(mask), pcfg,
                              use_pallas=True)
    with pytest.raises(NotImplementedError, match="inference-only"):
        q.sum().backward()


@pytest.mark.parametrize("mask_messages", [True, False])
def test_plain_dense_gradients_match_jax(rng, mask_messages):
    cfg = EPNNConfig(mask_messages=mask_messages)
    params, x, q0, xyz, mask, _ = build(rng, cfg, 2)
    wts = rng.normal(size=mask.shape).astype(np.float32)

    def loss(p):
        q = jax_forward_blocked(jax_fuse_params(p, cfg), x, q0, xyz, mask,
                                cfg, block=8)
        return jnp.sum(q * wts)

    jgrads = from_jax_params(jax.tree_util.tree_map(
        np.asarray, jax.grad(loss)(params)))
    pcfg = port_cfg(cfg)
    tree = from_jax_params(params, pcfg)
    for leaf in tree_leaves(tree):
        leaf.requires_grad_(True)
    q = fused.forward_blocked(fused.fuse_params(tree, pcfg, "cpu"), _t(x),
                              _t(q0), _t(xyz), _t(mask), pcfg, block=8)
    torch.sum(q * _t(wts)).backward()
    leaves = tree_leaves(tree)
    refs = tree_leaves(jgrads)
    assert len(leaves) == len(refs)
    for got, ref in zip(leaves, refs):
        g = torch.zeros_like(ref) if got.grad is None else got.grad
        assert float((g - ref).abs().max()) <= 1e-4 * (
            float(ref.abs().max()) + 1.0)


def test_unported_dense_options_raise(rng):
    cfg = EPNNConfig()
    params, x, q0, xyz, mask, _ = build(rng, cfg, 1)
    pcfg = port_cfg(cfg)
    fp = fused.fuse_params(from_jax_params(params, pcfg), pcfg)
    args = (fp, _t(x), _t(q0), _t(xyz), _t(mask), pcfg)
    # remat is ported: JAX's dispatch keeps the fused dense path, whose
    # checkpointed rounds give the same charges
    assert torch.equal(fused.forward_blocked(*args, use_pallas=True,
                                             remat=True),
                       fused.forward_blocked(*args, use_pallas=True))
    with pytest.raises(ValueError, match="neighbor_k"):
        fused.forward_blocked(*args, neighbors=(torch.zeros(1, 24, 4),
                                                torch.zeros(1, 24, 4)))
    # bf16 compute is ported: as JAX's bf16 branch, it drops use_pallas and
    # runs the plain dense forward (tests/test_torch_precision.py)
    cfg16 = port_cfg(EPNNConfig(compute_dtype="bfloat16"))
    assert torch.equal(fused.forward_blocked(fp, *args[1:5], cfg16,
                                             use_pallas=True),
                       fused.forward_blocked(fp, *args[1:5], cfg16))
