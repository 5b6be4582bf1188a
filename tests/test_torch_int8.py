"""The far field's int8 serving tier (``dense_matmul_precision="int8"``)
against the JAX package.

Kernel level: ``dense_message_rowsum_int8_plain`` against JAX
``dense_message_rowsum(..., mid_dtype="int8")`` (Pallas in interpret
mode) on the same arrays, at the fp32 bar 1e-5·(max|ref| + 1): within the
tier everything is exact integers (|q|, |w2q| ≤ 127, a row of 32 products
≤ 516,128 < 2^24), so only the float32 order of the sum over j differs.

Forward level: ``forward_blocked(use_pallas=True, neighbor_k=…)`` against
JAX's at ``BAR``·(max|q| + 1), with conservation at the JAX test's
2e-6·(Σ|q| + 1); and every path that JAX runs unquantized under int8 (no
``use_pallas``, the CPU ``Predictor``, the dense forwards, the trainer)
equal to the default config's, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epnn_tpu.io import checkpoint as jax_ckpt
from epnn_tpu.models import EPNNConfig
from epnn_tpu.models import init_params as jax_init_params
from epnn_tpu.ops import forward_blocked as jax_forward_blocked
from epnn_tpu.ops import fuse_params as jax_fuse_params
from epnn_tpu.ops.pallas_kernels import dense_message_rowsum as jax_dmr
from epnn_tpu_torch.data import pad_molecules
from epnn_tpu_torch.elements import table_for_n_elems
from epnn_tpu_torch.infer import Predictor
from epnn_tpu_torch.io.checkpoint import from_jax_params
from epnn_tpu_torch.models import tree_leaves
from epnn_tpu_torch.ops import fused, kernels
from epnn_tpu_torch.testing import water_box
from epnn_tpu_torch.train import TrainConfig
from epnn_tpu_torch.train import loop as L
from test_torch_fused import _t, build, port_cfg, safe_k

torch.set_num_threads(1)

CKPT = "trained/mixed_b16"
INT8 = dict(dense_matmul_precision="int8")

#: The forward-level bar, in units of max|q| + 1.  The port computes JAX's
#: scales from the same row sets, so it quantizes onto the same grid; pi
#: and pj differ from XLA's by float32 rounding only, so an activation moves
#: one level only where it lies within rounding of a .5 boundary — a
#: handful in a forward, each one quantization step of one pair's z2
#: (s_in·max|W2 column|, ~1% of its scale).  5e-3 is 10× under the tier
#: bar the JAX suite uses between int8 and float32, 0.05
#: (tests/test_fused.py::test_int8_tier_end_to_end), and the random-weight
#: cases below check that the tier itself moves the charges by more.
BAR = 5e-3


def _jax_int8_kernel(pi, pj, cv, w2, b2):
    return np.asarray(jax_dmr(pi, pj, cv, w2, b2, mid_dtype="int8"))


def _kernel_inputs(rng, r, n, dead=0.3):
    h = 32
    pi = (rng.normal(0, 1, (r, h)) + 0.3).astype(np.float32)
    pj = rng.normal(0, 1, (n, h)).astype(np.float32)
    cv = (rng.uniform(size=n) >= dead).astype(np.float32)
    w2 = rng.normal(0, 0.2, (h, h)).astype(np.float32)
    b2 = rng.normal(0, 0.1, h).astype(np.float32)
    return pi, pj, cv, w2, b2


def _port_int8(pi, pj, cv, w2, b2):
    """The plain version on the arrays, and its s_in: no padding rows (JAX's
    kernel takes its maxima over exactly these arrays)."""
    t = [_t(a) for a in (pi, pj, cv, w2, b2)]
    return (kernels.dense_message_rowsum_int8_plain(*t), t,
            kernels.int8_activation_scale(t[0], t[1]))


@pytest.mark.parametrize("r,n,dead", [(96, 96, 0.2), (48, 96, 0.3),
                                      (32, 128, 0.3)])
def test_int8_plain_matches_jax_kernel(rng, r, n, dead):
    pi, pj, cv, w2, b2 = _kernel_inputs(rng, r, n, dead)
    ref = _jax_int8_kernel(pi, pj, cv, w2, b2)
    out, t, s_in = _port_int8(pi, pj, cv, w2, b2)
    tol = 1e-5 * (np.abs(ref).max() + 1.0)
    assert np.abs(out.numpy() - ref).max() <= tol
    # the CPU wrapper is the plain version; the tier is not the fp32 field
    assert torch.equal(kernels.dense_message_rowsum_int8(*t), out)
    f32 = kernels.dense_message_rowsum_plain(*t).numpy()
    assert np.abs(f32 - ref).max() > 100 * tol


@pytest.mark.parametrize("pad", [8.0, 0.0])
def test_int8_pad_pi_is_jax_on_padded_operands(rng, pad):
    """``pad_pi`` stands for padding rows (pi = pad_pi, pj = 0, cv = 0):
    the plain version equals JAX's kernel on operands padded with 32 such
    rows, though they only move the maxima.  pad = 8 lies above every
    pi, so it sets s_in; 0.0 lifts a negative max(pj) to 0."""
    pi, pj, cv, w2, b2 = _kernel_inputs(rng, 64, 64)
    if pad == 0.0:
        pj -= pj.max() + 0.25
    assert pad > pi.max() or pj.max() < 0.0
    padded = [np.concatenate([a, np.full((32,) + a.shape[1:], v,
                                         np.float32)])
              for a, v in ((pi, pad), (pj, 0.0), (cv, 0.0))]
    ref = _jax_int8_kernel(*padded, w2, b2)[:64]
    t = [_t(a) for a in (pi, pj, cv, w2, b2)]
    pad_pi = torch.tensor(pad)
    out = kernels.dense_message_rowsum_int8_plain(*t, pad_pi)
    tol = 1e-5 * (np.abs(ref).max() + 1.0)
    assert np.abs(out.numpy() - ref).max() <= tol
    assert torch.equal(kernels.dense_message_rowsum_int8(*t, pad_pi), out)
    unpadded = kernels.dense_message_rowsum_int8_plain(*t).numpy()
    assert np.abs(unpadded - ref).max() > 100 * tol


def test_int8_scales_match_jax(rng):
    """sw, w2q (round half to even), s_in, dq and inv as JAX computes them
    (``pallas_kernels.py:1023-1033``), bit for bit."""
    pi, pj, _, w2, _ = _kernel_inputs(rng, 40, 40)
    # column 5: sw = 1 exactly, three exact ties
    w2[:, 5] = 0.0
    w2[0, 5], w2[3, 5], w2[4, 5], w2[6, 5] = 127.0, 2.5, -3.5, 0.5
    s_in = jnp.maximum(jax.nn.relu(jnp.max(pi) + jnp.max(pj)), 1e-30) / 127.0
    sw = jnp.maximum(jnp.max(jnp.abs(w2), axis=0), 1e-30) / 127.0
    w2q = jnp.clip(jnp.round(w2 / sw), -127, 127)
    got_s = kernels.int8_activation_scale(_t(pi), _t(pj))
    got_w2q, got_sw = kernels.int8_weights(_t(w2))
    got_dq, got_inv = kernels.int8_scales(got_s, got_sw)
    assert got_s.item() == float(s_in)
    assert got_w2q.dtype == torch.int8
    np.testing.assert_array_equal(got_w2q.numpy(), np.asarray(w2q))
    np.testing.assert_array_equal(got_sw.numpy(), np.asarray(sw))
    np.testing.assert_array_equal(got_dq.numpy(), np.asarray(s_in * sw))
    assert got_inv.item() == float(1.0 / s_in)
    assert got_w2q[[3, 4, 6], 5].tolist() == [2.0, -4.0, 0.0]


def test_int8_rounds_ties_half_up(rng):
    """max(pi) + max(pj) = 127, so s_in = inv = 1 and every activation
    relu(pi + pj) is a half-integer or an integer: each half-integer rounds
    up, as JAX's float32 add of 0.5 and truncation do.  Rounding half to
    even (``torch.round``) would miss JAX by far more than the bar."""
    r = n = 64
    pi = (rng.integers(-40, 120, (r, 32)) / 2.0).astype(np.float32)
    pj = rng.integers(-40, 67, (n, 32)).astype(np.float32)
    pi[0, 0], pj[0, 0] = 60.0, 67.0
    cv = (rng.uniform(size=n) > 0.3).astype(np.float32)
    w2 = rng.normal(0, 0.2, (32, 32)).astype(np.float32)
    b2 = rng.normal(0, 0.1, 32).astype(np.float32)
    ref = _jax_int8_kernel(pi, pj, cv, w2, b2)
    out, t, s_in = _port_int8(pi, pj, cv, w2, b2)
    assert s_in.item() == 1.0
    act = np.maximum(pi[:, None, :] + pj[None, :, :], 0.0)
    assert np.mean(act % 1.0 == 0.5) > 0.3      # ties everywhere
    tol = 1e-5 * (np.abs(ref).max() + 1.0)
    assert np.abs(out.numpy() - ref).max() <= tol
    w2q, sw = kernels.int8_weights(t[3])
    dq = kernels.int8_scales(s_in, sw)[0].numpy()
    w2q = w2q.to(torch.float32).numpy()
    even = np.round(np.clip(act, 0, 127))        # half to even
    z2 = np.maximum((even @ w2q) * dq + b2, 0.0)
    assert np.abs(np.einsum("n,rnh->rh", cv, z2) - ref).max() > 100 * tol


def test_int8_backward_is_straight_through(rng):
    """The tier's gradient is the float32 far field's (JAX's custom VJP
    ignores ``mid_dtype``); ``pad_pi`` gets none."""
    pi, pj, cv, w2, b2 = _kernel_inputs(rng, 24, 40)
    g = _t(rng.normal(size=(24, 32)))
    grads = []
    for fn in ("dense_message_rowsum", "dense_message_rowsum_int8"):
        t = [_t(a).requires_grad_(i != 2) for i, a in
             enumerate((pi, pj, cv, w2, b2))]
        extra = ([torch.tensor(0.5, requires_grad=True)]
                 if fn.endswith("int8") else [])
        out = getattr(kernels, fn)(*t, *extra)
        out.backward(g)
        grads.append([a.grad for i, a in enumerate(t) if i != 2])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def mixed():
    jcfg = jax_ckpt.load_config(CKPT)
    params = jax_ckpt.load_params(CKPT, jax_init_params(jcfg,
                                                        jax.random.key(0)))
    return jax.tree_util.tree_map(np.asarray, params), jcfg


def _forward_case(case, rng, mixed):
    """(params, JAX cfg with int8, x, q0, xyz, mask, total_q)."""
    if case == "mixed_b16":
        params, jcfg = mixed
        b = pad_molecules([water_box(14, seed=1), water_box(12, seed=2,
                                                            charge=1.0)],
                          table_for_n_elems(jcfg.n_elems))
        return (params, jcfg.replace(**INT8), b.x, b.q0, b.xyz, b.node_mask,
                b.total_q)
    cfg = EPNNConfig(T=2, **INT8)
    params, x, q0, xyz, mask, q_total = build(rng, cfg, 2, n=48,
                                              n_real=(44, 37))
    return params, cfg, x, q0, xyz, mask, q_total


def _run_port(params, cfg, x, q0, xyz, mask, k, **kw):
    pcfg = port_cfg(cfg)
    fp = fused.fuse_params(from_jax_params(params, pcfg), pcfg)
    with torch.no_grad():
        return fused.forward_blocked(fp, _t(x), _t(q0), _t(xyz), _t(mask),
                                     pcfg, neighbor_k=k, **kw).numpy()


def _conserves(out, q_total):
    err = np.abs(out.astype(np.float64).sum(1) - q_total)
    assert np.all(err < 2e-6 * (np.abs(out).sum(1) + 1.0)), err


@pytest.mark.parametrize("uniform_q0", [True, False])
@pytest.mark.parametrize("case", ["mixed_b16", "random"])
def test_int8_forward_matches_jax(rng, mixed, case, uniform_q0):
    """Below 128 atoms (48 here) JAX pads its kernel operands with zero
    rows; the port adds them to the maxima.  The shipped checkpoint's
    charges do not read the far field on these boxes (its last update
    MLP's hidden layer is dead on every real atom), so only the random
    weights show the tier moving them."""
    params, cfg, x, q0, xyz, mask, q_total = _forward_case(case, rng, mixed)
    k = safe_k(xyz, mask, cfg.cutoff)
    ref = np.asarray(jax_forward_blocked(
        jax_fuse_params(params, cfg), x, q0, xyz, mask, cfg, block=8,
        neighbor_k=k, use_pallas=True, uniform_q0=uniform_q0))
    out = _run_port(params, cfg, x, q0, xyz, mask, k, use_pallas=True,
                    uniform_q0=uniform_q0)
    scale = np.abs(ref).max() + 1.0
    assert np.abs(out - ref).max() < BAR * scale
    _conserves(out, q_total)
    assert np.all(out[mask == 0] == 0.0)
    f32 = _run_port(params, cfg.replace(dense_matmul_precision=""), x, q0,
                    xyz, mask, k, use_pallas=True, uniform_q0=uniform_q0)
    gap = np.abs(out - f32).max()
    assert gap < 0.05 * scale                    # the JAX suite's tier bar
    if case == "random":
        assert gap > BAR * scale                 # the tier is engaged


def test_padding_rows_set_the_scale(rng, monkeypatch):
    """At 136 atoms, none of them padding, JAX pads the graph to 256 with
    empty atoms (pi = b1, pj = 0).  Channel 0 of every message round is
    made to hold its maximum there: b1 = 20 and −0.5 per unit of the
    element features, so every real atom sits below 20.  The port matches
    JAX only by counting those rows (``fused._int8_pad_pi``): without them
    the grid shifts and the charges miss by far more than the bar."""
    cfg = EPNNConfig(T=2, **INT8)
    params, x, q0, xyz, mask, q_total = build(rng, cfg, 1, n=136,
                                              n_real=(136,))
    f = cfg.atom_feat_dim
    tree = params["params"] if "params" in params else params
    for t in range(cfg.T):
        d0 = tree[f"message_{t}"]["dense_0"]
        d0["kernel"], d0["bias"] = d0["kernel"].copy(), d0["bias"].copy()
        d0["bias"][0] = 20.0
        d0["kernel"][:f, 0] = 0.0
        d0["kernel"][:cfg.n_elems, 0] = -0.5
    k = safe_k(xyz, mask, cfg.cutoff)
    ref = np.asarray(jax_forward_blocked(
        jax_fuse_params(params, cfg), x, q0, xyz, mask, cfg, block=8,
        neighbor_k=k, use_pallas=True))
    scale = np.abs(ref).max() + 1.0
    out = _run_port(params, cfg, x, q0, xyz, mask, k, use_pallas=True)
    assert np.abs(out - ref).max() < BAR * scale
    _conserves(out, q_total)
    monkeypatch.setattr(fused, "_int8_pad_pi", lambda w, n: None)
    unpadded = _run_port(params, cfg, x, q0, xyz, mask, k, use_pallas=True)
    assert np.abs(unpadded - ref).max() > 10 * BAR * scale


def test_int8_without_use_pallas_is_the_fp32_path(rng, mixed):
    """JAX runs int8 unquantized off its kernel (``prec_dense = None``)."""
    params, cfg, x, q0, xyz, mask, _ = _forward_case("random", rng, mixed)
    k = safe_k(xyz, mask, cfg.cutoff)
    for uq in (True, False):
        np.testing.assert_array_equal(
            _run_port(params, cfg, x, q0, xyz, mask, k, uniform_q0=uq),
            _run_port(params, cfg.replace(dense_matmul_precision=""), x, q0,
                      xyz, mask, k, uniform_q0=uq))


def test_cpu_predictor_serves_int8_unquantized(mixed):
    """A CPU Predictor under int8 gives the unquantized charges, as JAX's
    CPU Predictor does (``_use_pallas`` is true on the card only)."""
    params, jcfg = mixed
    pred = Predictor.from_checkpoint(CKPT, device="cpu", force_mode="blocked")
    int8 = Predictor(pred.params, pred.cfg.replace(**INT8),
                     force_mode="blocked", device="cpu")
    assert not int8._use_pallas()
    batch = pad_molecules([water_box(30, seed=5, charge=-1.0)],
                          table_for_n_elems(jcfg.n_elems))
    np.testing.assert_array_equal(int8.predict_batch(batch),
                                  pred.predict_batch(batch))


@pytest.mark.parametrize("use_pallas", [True, False])
def test_dense_forwards_ignore_int8(rng, use_pallas):
    """Without ``neighbor_k`` the dense forwards run as if the option were
    not set (JAX's ``_forward_single`` and ``_forward_single_pallas`` never
    read it)."""
    cfg = EPNNConfig(T=2, **INT8)
    params, x, q0, xyz, mask, _ = build(rng, cfg, 2)
    pcfg = port_cfg(cfg)
    fp = fused.fuse_params(from_jax_params(params, pcfg), pcfg)
    with torch.no_grad():
        outs = [fused.forward_blocked(fp, _t(x), _t(q0), _t(xyz), _t(mask),
                                      c, block=8, use_pallas=use_pallas)
                for c in (pcfg, pcfg.replace(dense_matmul_precision=""))]
    assert torch.equal(*outs)


def test_int8_trains_unquantized(rng):
    """The trainer keeps the unquantized far field under int8, as JAX's
    (``epnn_tpu/train/loop.py:646-652``): one fused step and one dense step
    give the default config's loss and weights, bit for bit, while the
    serving tier would have moved the loss."""
    cfg = EPNNConfig(T=2, **INT8)
    params, x, q0, xyz, mask, _ = build(rng, cfg, 2, n=48, n_real=(44, 37))
    y = (mask * rng.normal(0, 0.3, mask.shape)).astype(np.float32)
    args = [_t(a) for a in (x, q0, xyz, mask, y, np.ones(2, np.float32))]
    k = safe_k(xyz, mask, cfg.cutoff)
    pcfg = port_cfg(cfg)
    runs = []
    for c in (pcfg, pcfg.replace(dense_matmul_precision="")):
        state = L.create_state(c, TrainConfig(), device="cpu",
                               params=from_jax_params(params, c))
        _, loss_f, _, _ = L.train_step_fused(state, c, "masked_mse", None,
                                             8, k, *args, uniform_q0=True,
                                             remat=False)
        _, loss_d, _, _ = L.train_step(state, c, "masked_mse", None, *args)
        runs.append((loss_f, loss_d, [p.detach() for p in
                                      tree_leaves(state.params)]))
    (lf8, ld8, p8), (lf, ld, p) = runs
    assert torch.equal(lf8, lf) and torch.equal(ld8, ld)
    assert all(torch.equal(a, b) for a, b in zip(p8, p))
    with torch.no_grad():
        served, _ = L._loss_fused(from_jax_params(params, pcfg), pcfg,
                                  "masked_mse", 8, k, False, *args,
                                  uniform_q0=True)
        tier = fused.forward_blocked(
            fused.fuse_params(from_jax_params(params, pcfg), pcfg), *args[:4],
            pcfg, neighbor_k=k, use_pallas=True, uniform_q0=True)
        plain = fused.forward_blocked(
            fused.fuse_params(from_jax_params(params, pcfg), pcfg), *args[:4],
            pcfg, neighbor_k=k, uniform_q0=True)
    assert not torch.equal(tier, plain)
    assert torch.equal(served, lf)


def test_shipped_checkpoint_charges_ignore_the_far_field(monkeypatch):
    """Why the int8 tier cannot move ``trained/mixed_b16``'s charges on
    water boxes (``chip_smoke.py`` ``[slice f]`` shows it by the far sums
    instead): its round-5 update layer is dead on every real atom, so the
    far sums of rounds 2+ can be halved without moving a charge bit."""
    pred = Predictor.from_checkpoint(CKPT, device="cpu", force_mode="blocked")
    batch = pad_molecules([water_box(30, seed=5, charge=-1.0)],
                          table_for_n_elems(pred.cfg.n_elems))
    q = pred.predict_batch(batch)
    far = fused.dense_message_rowsum
    for scale in (0.5, 1.01):
        monkeypatch.setattr(fused, "dense_message_rowsum",
                            lambda *a, s=scale, **kw: far(*a, **kw) * s)
        np.testing.assert_array_equal(pred.predict_batch(batch), q)
