"""The neighbor split's kernel gate and the API of the JAX package in the
port.  JAX's rule: a round with one mid layer takes the kernels, any other
depth runs the same split through the plain versions (JAX's XLA
branches).  Both are held to JAX ``forward_blocked(neighbor_k=…)`` and the
JAX ``Predictor`` at 1e-5·(max|q| + 1) (tests/test_fused.py's bar between
two JAX paths).  A one-mid round at another width (H 16, E 24, and H = E
= 128 on the kernels' wide path) reaches the kernels on the card
(compiled for its widths; here their launch is emulated).  Also
``Predictor``'s positional ``block`` and ``bucket_molecules``'s
``max_batch_atoms2`` (both accepted and unused, as the JAX package does
with the latter)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from epnn_tpu.data.dataset import bucket_molecules as jax_bucket_molecules
from epnn_tpu.data.dataset import pad_molecules as jax_pad_molecules
from epnn_tpu.elements import table_for_n_elems as jax_table
from epnn_tpu.infer import Predictor as JaxPredictor
from epnn_tpu.models import EPNNConfig
from epnn_tpu.ops import forward_blocked as jax_forward_blocked
from epnn_tpu.ops import fuse_params as jax_fuse_params
from epnn_tpu_torch.data import bucket_molecules, pad_molecules
from epnn_tpu_torch.elements import table_for_n_elems
from epnn_tpu_torch.infer import Predictor
from epnn_tpu_torch.io.checkpoint import from_jax_params
from epnn_tpu_torch.ops import fused, kernels
from epnn_tpu_torch.testing import water_box
from test_torch_fused import _t, build, port_cfg, safe_k
from test_torch_widths import arm_card

torch.set_num_threads(1)

#: configurations off the shipped one: a deeper mid MLP (the gate sends it
#: to the plain versions on any device), and H = 16 / E = 24 and H = E =
#: 128 (through the kernels at those widths on the card, the latter on
#: their wide path).  T = 2: with the bias-shifted weights of ``build``
#: deeper stacks grow the charges to ~10 e by T = 5, where two JAX paths
#: already differ by more than the bar (tests/test_torch_fused_dense.py).
GATED_OUT = {
    "mlp_32_32_32": dict(mlp_hidden=(32, 32, 32), T=2),
    "h16_e24": dict(h_dim=16, e_dim=24, msg_dim=8, mlp_hidden=(16, 16), T=2),
    "h128_e128": dict(h_dim=16, e_dim=128, msg_dim=8, mlp_hidden=(128, 128),
                      T=2),
}


def _close(out, ref):
    assert np.abs(out - ref).max() < 1e-5 * (np.abs(ref).max() + 1.0)


def _port_fused(params, cfg):
    pcfg = port_cfg(cfg)
    return fused.fuse_params(from_jax_params(params, pcfg), pcfg), pcfg


def test_kernel_gate_is_a_configuration_rule():
    """JAX's one-mid-layer rule, whatever the widths."""
    rng = np.random.default_rng(0)
    want = {"default": True, "mlp_32_32_32": False, "h16_e24": True,
            "h128_e128": True}
    for name, kw in {"default": {}, **GATED_OUT}.items():
        params, *_ = build(rng, EPNNConfig(**kw), 1)
        fp, _ = _port_fused(params, EPNNConfig(**kw))
        for w in fp.messages + fp.passes:
            assert fused.kernels_apply(w) is want[name], name


@pytest.mark.parametrize("uniform_q0", [True, False])
@pytest.mark.parametrize("case", sorted(GATED_OUT))
def test_gated_out_config_matches_jax(rng, monkeypatch, case, uniform_q0):
    """The neighbor split at a depth or width the kernels are not built
    for, against JAX's.  The deeper MLP never reaches a kernel wrapper
    (each is patched to fail); H 16 runs the wrappers' plain versions."""
    cfg = EPNNConfig(**GATED_OUT[case])
    params, x, q0, xyz, mask, q_total = build(rng, cfg, 2)
    k = safe_k(xyz, mask, cfg.cutoff)
    ref = np.asarray(jax_forward_blocked(
        jax_fuse_params(params, cfg), x, q0, xyz, mask, cfg, block=8,
        neighbor_k=k, uniform_q0=uniform_q0))
    fp, pcfg = _port_fused(params, cfg)

    def refuse(*a, **kw):
        raise AssertionError("a kernel wrapper ran on a gated-out round")

    if not fused.kernels_apply(fp.messages[0]):
        for name in ("dense_message_rowsum", "dense_message_rowsum_int8",
                     "near_message_corr", "near_pass_rowsum"):
            monkeypatch.setattr(fused, name, refuse)
    for use_pallas in (False, True):
        with torch.no_grad():
            out = fused.forward_blocked(
                fp, _t(x), _t(q0), _t(xyz), _t(mask), pcfg, neighbor_k=k,
                use_pallas=use_pallas, uniform_q0=uniform_q0).numpy()
        _close(out, ref)
        err = np.abs(out.astype(np.float64).sum(1) - q_total)
        assert np.all(err < 2e-6 * (np.abs(out).sum(1) + 1.0)), err
        assert np.all(out[mask == 0] == 0.0)


def _random_predictors(cfg, seed=0):
    params, *_ = build(np.random.default_rng(seed), cfg, 1)
    pcfg = port_cfg(cfg)
    port = Predictor(from_jax_params(params, pcfg), pcfg, force_mode="blocked",
                     device="cpu")
    return port, JaxPredictor(params, cfg, force_mode="blocked")


@pytest.mark.parametrize("case", sorted(GATED_OUT))
def test_gated_out_config_through_predictor(case):
    """``Predictor`` serves such a config on the blocked path as JAX's
    does (a 150-atom water box, Q = −1)."""
    port, ref = _random_predictors(EPNNConfig(**GATED_OUT[case]))
    box = water_box(50, seed=4, charge=-1.0)
    out = port.predict_batch(pad_molecules([box], table_for_n_elems(10)))
    want = ref.predict_batch(jax_pad_molecules([box], jax_table(10)))
    _close(out, want)


@pytest.mark.parametrize("case", sorted(GATED_OUT))
def test_other_widths_reach_the_kernels(rng, monkeypatch, case):
    """On a CUDA tensor (``kernels._check`` patched to report one, and the
    kernels' launch emulated by ``test_torch_widths.emulate``, so no card
    is needed) the forward at H 16 (and 128) reaches the kernels at those
    widths, on the neighbor split and the dense fused path alike, and
    gives the plain forwards' charges.  The deeper MLP reaches no wrapper,
    so the same patch leaves its charges as they were."""
    cfg = EPNNConfig(**GATED_OUT[case])
    params, x, q0, xyz, mask, _ = build(rng, cfg, 1)
    k = safe_k(xyz, mask, cfg.cutoff)
    fp, pcfg = _port_fused(params, cfg)
    args = (fp, _t(x), _t(q0), _t(xyz), _t(mask), pcfg)
    hh, ee = pcfg.mlp_hidden[0], pcfg.e_dim
    with torch.no_grad():
        plain = fused.forward_blocked(*args, neighbor_k=k)
        plain_dense = fused.forward_blocked(*args)
    on_card = arm_card(monkeypatch)
    with torch.no_grad():
        if fused.kernels_apply(fp.messages[0]):
            for kw, want, names in (
                    (dict(neighbor_k=k), plain,
                     {"dense_message_rowsum", "near_message_corr",
                      "near_pass_rowsum"}),
                    (dict(use_pallas=True), plain_dense,
                     {"fused_message_rowsum", "fused_epn_rowsum"})):
                on_card.clear()
                _close(fused.forward_blocked(*args, **kw).numpy(),
                       want.numpy())
                assert {c["name"] for c in on_card} == names
                assert all(c["h"] == hh and c["e"] in (ee, None)
                           for c in on_card)
        else:
            assert torch.equal(fused.forward_blocked(*args, neighbor_k=k),
                               plain)
            assert on_card == []


def test_predictor_fields_follow_jax():
    """``params, cfg, block, force_mode, mesh, shard_mode`` positionally,
    as in JAX; the rest keyword-only."""
    names = [f.name for f in dataclasses.fields(Predictor)
             if not f.kw_only]
    jax_names = [f.name for f in dataclasses.fields(JaxPredictor)][:6]
    assert names == jax_names == ["params", "cfg", "block", "force_mode",
                                  "mesh", "shard_mode"]
    assert {f.name: f.default for f in dataclasses.fields(Predictor)}[
        "block"] == 256
    assert all(f.kw_only for f in dataclasses.fields(Predictor)
               if f.name == "device")


@pytest.mark.parametrize("how", ["positional", "keyword"])
def test_predictor_block_gives_the_same_charges(how):
    """``Predictor(params, cfg, 256)`` and ``Predictor(params, cfg,
    block=128, device="cpu")`` are accepted and serve the default's
    charges: ``block`` is JAX's row block, which the port's neighbor split
    does not have."""
    port, _ = _random_predictors(EPNNConfig(T=2))
    pred = (Predictor(port.params, port.cfg, 256, "blocked", device="cpu")
            if how == "positional" else
            Predictor(port.params, port.cfg, block=128, force_mode="blocked",
                      device="cpu"))
    assert pred.block == (256 if how == "positional" else 128)
    mols = [water_box(40, seed=6), water_box(3, seed=7, charge=1.0)]
    for got, want in zip(pred.predict_molecules(mols),
                         port.predict_molecules(mols)):
        np.testing.assert_array_equal(got, want)


def test_bucket_molecules_takes_max_batch_atoms2():
    """Accepted and unused, as in JAX: the same buckets."""
    mols = [water_box(m, seed=m) for m in (1, 2, 3, 5, 9)]
    plain = bucket_molecules(mols, table_for_n_elems(10))
    capped = bucket_molecules(mols, table_for_n_elems(10),
                              max_batch_atoms2=1 << 20)
    ref = jax_bucket_molecules(mols, jax_table(10), max_batch_atoms2=1 << 20)
    assert sorted(plain) == sorted(capped) == sorted(ref)
    for width, batch in capped.items():
        for field in ("x", "xyz", "q0", "node_mask", "natoms"):
            np.testing.assert_array_equal(getattr(batch, field),
                                          getattr(plain[width], field))
            np.testing.assert_array_equal(getattr(batch, field),
                                          np.asarray(getattr(ref[width],
                                                             field)))
