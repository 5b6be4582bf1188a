"""The fused dense kernels' ``rbf_method="doubling"`` in the port, on the
CPU: the channels built from two exps a pair on the uniform centers
(``kernels.envelope_rbf_doubling``, JAX's ``_tile_rbf_flat`` at
``epnn_tpu/ops/pallas_kernels.py:238-250``).

The plain versions of ``fused_epn_rowsum`` (hard and soft gate) and
``fused_message_rowsum`` (masked and by col_vec) under the doubling
against the JAX kernels under the doubling in interpret mode (as
``tests/test_pallas.py`` runs them) and against the port's own "direct";
each pass pair an exact negation on the dense dimer probe and the row sums
cancelling; atoms 800 Å away finite; the 3xTF32 and one-pass emulations
under the doubling against the float32 plain version; the emulated card
path handing the kernel the gains and 2ηΔ; and
``_forward_single_pallas(rbf_method="doubling")`` against JAX's on a
two-round random-weight model.

Bars: JAX's own between the two methods, rtol 1e-5 and atol 1e-4
(``tests/test_pallas.py:95-140``: the doubling is ~1e-6 relative from
direct); the emulations 1e-5·(max|ref| + 1) (3xTF32 is fp32-grade; the
one-pass tier's bar is the emulation's own TF32 rounding, 2e-3, as
``tests/test_torch_precision.py`` holds it); the forward 1e-5·(max|q| +
1) (``tests/test_fused.py:105``)."""

import jax
import numpy as np
import pytest
import torch

from epnn_tpu.models import EPNNConfig
from epnn_tpu.ops import fuse_params as jax_fuse_params
from epnn_tpu.ops.fused import _forward_single_pallas as jax_forward_pallas
from epnn_tpu.ops.pallas_kernels import _tile_rbf_flat
from epnn_tpu.ops.pallas_kernels import (
    fused_epn_rowsum as jax_fused_epn_rowsum,
    fused_message_rowsum as jax_fused_message_rowsum,
)
from epnn_tpu_torch.featurize import (doubling_gains, envelope_rbf_doubling,
                                      pair_d2)
from epnn_tpu_torch.io.checkpoint import from_jax_params
from epnn_tpu_torch.ops import fused, kernels
from epnn_tpu_torch.testing import dimer_probe
from test_torch_fused import _t, build, port_cfg
from test_torch_kernels_fused import pair_inputs
from test_torch_widths import arm_card

torch.set_num_threads(1)

MSG = ("pi", "pj", "xyz", "mask", "cv", "w1e", "w2", "b2")
EPN = ("pi", "pj", "xyz", "mask", "w1e", "w2", "b2")
#: (kernel, its mode keywords)
MODES = [("fused_epn_rowsum", dict(soft_gate=False)),
         ("fused_epn_rowsum", dict(soft_gate=True)),
         ("fused_message_rowsum", dict(masked=True)),
         ("fused_message_rowsum", dict(masked=False))]
IDS = ["epn_hard", "epn_soft", "msg_masked", "msg_col_vec"]
JAX_FN = {"fused_epn_rowsum": jax_fused_epn_rowsum,
          "fused_message_rowsum": jax_fused_message_rowsum}


def _inputs(rng, n=24, h=8, e=16):
    """tests/test_pallas.py's pair_setup (24 atoms, H 8, E 16, the last
    five masked), as numpy."""
    return pair_inputs(rng, n, h, e)


def _keys(name):
    return MSG if name == "fused_message_rowsum" else EPN


def _port(name, a, method, suffix="_plain", **kw):
    return getattr(kernels, name + suffix)(
        *(_t(a[k]) for k in _keys(name)), cutoff=3.0, eta=2.0, tol=1e-5,
        rbf_method=method, **kw).numpy()


def _jax(name, a, method, **kw):
    return np.asarray(JAX_FN[name](
        *(a[k] for k in _keys(name)), cutoff=3.0, eta=2.0, tol=1e-5,
        block_i=8, block_j=8, packed=False, rbf_method=method, **kw))


def _jax_bar(out, ref):
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-4)


def test_channels_match_jax_featurization(rng):
    """The port's doubled channels against JAX's ``_tile_rbf_flat`` under
    "doubling" on one pair tile (24 × 24, E = 16 and 48): the envelope bit
    for bit, the hard gates equal, the channels within (E + 2)·2⁻²²
    relative (above 1e-37).  The two libraries' exp may round u apart by
    an ulp or two (2⁻²³ each), and u^ch carries that error ch ≤ E − 1
    times (measured: 4.9e-6 at E = 48; direct, whose exps are not raised
    to a power, stays within 2 ulps)."""
    a = _inputs(rng)
    xyz, mask = a["xyz"], a["mask"]
    n = len(xyz)
    for e in (16, 48):
        rbf_j, c_j, _, gate_j = (np.asarray(t) for t in _tile_rbf_flat(
            xyz, xyz.T.copy(), mask[:, None], mask[None, :], 0, 0,
            cutoff=3.0, eta=2.0, e_dim=e, tol=1e-5, method="doubling"))
        cmask = _t(mask[:, None] * mask[None, :] * (1.0 - np.eye(n)))
        t = _t(xyz)
        rbf, c = envelope_rbf_doubling(pair_d2(t[:, None], t[None]), cmask,
                                       3.0, 2.0, doubling_gains(e, 3.0, 2.0))
        np.testing.assert_array_equal(c.numpy(), c_j)
        rbf = rbf.numpy().reshape(n * n, e)
        big = np.maximum(np.abs(rbf), np.abs(rbf_j))
        assert np.all(np.abs(rbf - rbf_j) <= (e + 2) * 2.0 ** -22 * big
                      + 1e-37)
        gate = kernels.hard_gate(torch.from_numpy(rbf.reshape(n, n, e)),
                                 1e-5).numpy()
        np.testing.assert_array_equal(gate, gate_j)
        assert gate.sum() > 0


@pytest.mark.parametrize("name,kw", MODES, ids=IDS)
def test_plain_doubling_matches_jax_doubling(rng, name, kw):
    a = _inputs(rng)
    out = _port(name, a, "doubling", **kw)
    _jax_bar(out, _jax(name, a, "doubling", **kw))
    assert np.count_nonzero(out) > 0


@pytest.mark.parametrize("name,kw", MODES, ids=IDS)
def test_plain_doubling_matches_direct(rng, name, kw):
    """As JAX's TestDoublingRBF: the doubling within rtol 1e-5 / atol 1e-4
    of direct; the pass round's row sums cancel to 1e-4·(Σ|out| + 1)."""
    a = _inputs(rng)
    out = _port(name, a, "doubling", **kw)
    _jax_bar(out, _port(name, a, "direct", **kw))
    if name == "fused_epn_rowsum":
        assert np.abs(out.sum(0)).max() < 1e-4 * (np.abs(out).sum(0).max()
                                                   + 1)


@pytest.mark.parametrize("suffix", ["_plain", "_3xtf32_plain",
                                    "_tf32_plain"])
@pytest.mark.parametrize("soft_gate", [False, True])
def test_pass_pairs_negate_exactly(rng, soft_gate, suffix):
    """The dense dimer probe (disjoint pairs 1.0–2.5 Å apart, ≥ 4 Å from
    all else): under the doubling every pair's two rows are exact
    negations — the doubled channels are a function of the pair's d²,
    which has the same bits both ways — in the plain version and both
    emulations."""
    xyz, pairs = dimer_probe(24, seed=3)
    a = pair_inputs(rng, len(xyz), 32, 48, n_real=len(xyz))
    a["xyz"] = xyz
    out = torch.from_numpy(_port("fused_epn_rowsum", a, "doubling", suffix,
                                 soft_gate=soft_gate))
    i, j = torch.from_numpy(pairs[:, 0]), torch.from_numpy(pairs[:, 1])
    assert torch.count_nonzero(out[i]) > 0
    assert torch.equal(out[i], -out[j])


@pytest.mark.parametrize("name", ["fused_epn_rowsum",
                                  "fused_message_rowsum"])
def test_far_atoms_stay_finite(rng, name):
    """Half the atoms moved 800 Å away (JAX's test_far_atoms_stay_finite):
    d is clamped to the cutoff before u^ch, so the doubling stays finite
    and matches direct."""
    a = _inputs(rng)
    a["xyz"] = a["xyz"].copy()
    a["xyz"][:12] += 800.0
    out = _port(name, a, "doubling")
    assert np.all(np.isfinite(out))
    _jax_bar(out, _port(name, a, "direct"))


@pytest.mark.parametrize("name,kw", MODES, ids=IDS)
def test_emulations_under_doubling(rng, name, kw):
    """The 3xTF32 emulation under the doubling against the float32 plain
    version within 1e-5·(max|ref| + 1); the one-pass emulation within its
    TF32 tier's 2e-3·(max|ref| + 1) and not bit for bit the 3xTF32 one."""
    a = pair_inputs(rng, 24, 32, 48)
    ref = _port(name, a, "doubling", **kw)
    hi = _port(name, a, "doubling", "_3xtf32_plain", **kw)
    lo = _port(name, a, "doubling", "_tf32_plain", **kw)
    scale = np.abs(ref).max() + 1.0
    assert np.abs(hi - ref).max() <= 1e-5 * scale
    assert np.abs(lo - ref).max() <= 2e-3 * scale
    assert not np.array_equal(lo, hi)


@pytest.mark.parametrize("name", ["fused_epn_rowsum",
                                  "fused_message_rowsum"])
def test_card_path_hands_the_kernel_the_gains(rng, monkeypatch, name):
    """On a tensor ``_check`` reports as CUDA, one launch whose table is
    the doubling's gains, its flag 1 and its scale 2ηΔ
    (``test_torch_widths.emulate`` checks them and runs the contract);
    the result is the plain version's bit for bit."""
    a = pair_inputs(rng, 24, 32, 48)
    want = _port(name, a, "doubling")
    calls = arm_card(monkeypatch)
    got = getattr(kernels, name)(*(_t(a[k]) for k in _keys(name)),
                                 rbf_method="doubling").numpy()
    assert len(calls) == 1
    tab = calls[0]["tensors"][8 if name == "fused_message_rowsum" else 7]
    assert torch.equal(tab, doubling_gains(48, 3.0, 2.0))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["fused_epn_rowsum",
                                  "fused_message_rowsum"])
def test_unknown_method_raises(rng, name):
    a = pair_inputs(rng, 8, 8, 16)
    args = [_t(a[k]) for k in _keys(name)]
    with pytest.raises(ValueError, match="rbf_method"):
        getattr(kernels, name)(*args, rbf_method="Doubling")
    with pytest.raises(ValueError, match="rbf_method"):
        getattr(kernels, name + "_plain")(*args, rbf_method="squaring")
    with pytest.raises(ValueError, match="E >= 2"):
        getattr(kernels, name)(*args[:-3], args[-3][:1], *args[-2:],
                               rbf_method="doubling")


@pytest.mark.parametrize("soft", [False, True])
def test_forward_single_pallas_doubling_matches_jax(rng, soft):
    """``_forward_single_pallas(rbf_method="doubling")`` against JAX's on a
    two-round random-weight model (24 atoms, 17 valid; hard gate and the
    soft envelope), at 1e-5·(max|q| + 1), and conserving."""
    cfg = EPNNConfig(T=2, pass_weighting="soft_envelope" if soft
                     else "hard")
    params, x, q0, xyz, mask, q_total = build(rng, cfg, 1)
    ref = np.asarray(jax_forward_pallas(
        jax_fuse_params(params, cfg), x[0], q0[0], xyz[0], mask[0], cfg,
        rbf_method="doubling"))
    pcfg = port_cfg(cfg)
    fp = fused.fuse_params(from_jax_params(params, pcfg), pcfg)
    with torch.no_grad():
        q = fused._forward_single_pallas(
            fp, _t(x[0]), _t(q0[0]), _t(xyz[0]), _t(mask[0]), pcfg,
            rbf_method="doubling").numpy()
        direct = fused._forward_single_pallas(
            fp, _t(x[0]), _t(q0[0]), _t(xyz[0]), _t(mask[0]), pcfg).numpy()
    scale = np.abs(ref).max() + 1.0
    assert np.abs(q - ref).max() < 1e-5 * scale
    assert np.abs(q - direct).max() < 1e-5 * scale
    assert abs(float(q.astype(np.float64).sum()) - q_total[0]) < 2e-6 * (
        np.abs(q).sum() + 1.0)
    with pytest.raises(ValueError, match="rbf_method"):
        fused._forward_single_pallas(fp, _t(x[0]), _t(q0[0]), _t(xyz[0]),
                                     _t(mask[0]), pcfg, rbf_method="x")
