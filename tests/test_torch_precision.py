"""The precision tiers of the port against the JAX package's, with the
same numpy-seeded inputs and ``from_jax_params`` weights in both.

* ``"default"`` (the CLI's ``parity`` and ``fast``, and
  ``highest_precision=False``): on the CPU the port runs its kernels'
  float32 plain versions, as XLA:CPU runs ``"default"``; the forward
  equals JAX's (its Pallas calls in interpret mode, as tests/test_fused.py
  runs them) at 1e-5·(max|q|+1), JAX's bar between two paths of the same
  math (tests/test_fused.py:105).
* The six ``*_tf32_plain`` twins: every product is one TF32 pass, the
  float32 sum of the products of TF32-rounded operands (held to the same
  products in float64 within float32 summation); the pass twins keep a
  pair's two rows exact negations.
* Routing on the card (``_check``/``_launch`` patched, as
  tests/test_torch_gate_api.py does): the TF32 tier each launch asks for.
* ``dense_matmul_precision="bf16x3"`` and ``compute_dtype="bfloat16"`` at
  JAX's own sizes and bars, the round-1 collapse under both, and a train
  step under ``fast`` and ``bfloat16`` against JAX's.
"""

import jax
import numpy as np
import pytest
import torch

from epnn_tpu.data.dataset import pad_molecules as jax_pad_molecules
from epnn_tpu.data.xyz import Molecule as JaxMolecule
from epnn_tpu.elements import table_for_n_elems as jax_table
from epnn_tpu.featurize import rbf_edges as jax_rbf_edges
from epnn_tpu.models import EPNN as JaxEPNN
from epnn_tpu.models import EPNNConfig
from epnn_tpu.models import init_params as jax_init_params
from epnn_tpu.ops import forward_blocked as jax_forward_blocked
from epnn_tpu.ops import fuse_params as jax_fuse_params
from epnn_tpu.ops.fused import _split_dot as jax_split_dot
from epnn_tpu.train.loop import _loss_fn_fused as jax_loss_fn_fused
from epnn_tpu_torch.io.checkpoint import from_jax_params
from epnn_tpu_torch.models import EPNN, dense_apply
from epnn_tpu_torch.models.config import (dense_precision, main_precision,
                                          near_precision)
from epnn_tpu_torch.ops import fused, kernels
from epnn_tpu_torch.testing import dimer_probe
from epnn_tpu_torch.train import loop as L
from test_torch_fused import _t, port_cfg
from test_torch_widths import arm_card

torch.set_num_threads(2)

#: JAX's names for the tiers (``epnn_tpu/cli.py:165-185``), and the
#: config's own "default" spelling
TIERS = {
    "highest": {},
    "parity": dict(matmul_precision="highest",
                   dense_matmul_precision="default"),
    "fast": dict(matmul_precision="default"),
    "no_highest": dict(highest_precision=False),
    "bf16x3": dict(dense_matmul_precision="bf16x3"),
    "bfloat16": dict(compute_dtype="bfloat16"),
}
#: the small config of JAX's bf16 tests (tests/test_fused.py:292-311)
SMALL = dict(h_dim=16, e_dim=16, msg_dim=8, mlp_hidden=(8, 8), T=2)


def build(rng, cfg, b=2, n=24, n_real=20, seed=0):
    """tests/test_fused.py's fixture: bias-perturbed JAX weights (every 1-D
    leaf + 0.3), random features and coordinates, uniform q0 on the valid
    rows."""
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a + 0.3 if a.ndim == 1 else a),
        jax_init_params(cfg, jax.random.key(seed)))
    x = rng.normal(size=(b, n, cfg.n_elems)).astype(np.float32)
    xyz = rng.uniform(-4, 4, size=(b, n, 3)).astype(np.float32)
    mask = np.zeros((b, n), np.float32)
    mask[:, :n_real] = 1
    x[:, n_real:] = 0
    xyz[:, n_real:] = 0
    q_total = np.arange(b, dtype=np.float32) - 1.0
    q0 = mask * (q_total[:, None] / n_real)
    return params, x, q0, xyz, mask, q_total


def port(params, cfg):
    pcfg = port_cfg(cfg)
    return fused.fuse_params(from_jax_params(params, pcfg), pcfg), pcfg


def port_forward(params, cfg, arrays, **kw):
    fp, pcfg = port(params, cfg)
    with torch.no_grad():
        return fused.forward_blocked(fp, *(_t(a) for a in arrays), pcfg,
                                     **kw).numpy()


def _close(out, ref, bar=1e-5):
    scale = np.abs(ref).max() + 1.0
    assert np.abs(out - ref).max() < bar * scale, (
        np.abs(out - ref).max(), bar * scale)


def test_resolvers_follow_jax():
    """The three resolvers give JAX's names (``_resolve_precision``,
    the far field's ``prec_name``, ``near_prec``)."""
    want = {  # tier: (main, dense, near)
        "highest": ("highest", "highest", "highest"),
        "parity": ("highest", "default", "highest"),
        "fast": ("default", "default", "default"),
        "no_highest": ("default", "default", "default"),
        "bf16x3": ("highest", "bf16x3", "highest"),
    }
    for tier, names in want.items():
        cfg = port_cfg(EPNNConfig(**TIERS[tier]))
        assert (main_precision(cfg), dense_precision(cfg),
                near_precision(cfg)) == names, tier
    assert dense_precision(port_cfg(EPNNConfig(
        dense_matmul_precision="int8"))) == "default"
    with pytest.raises(ValueError):
        main_precision(port_cfg(EPNNConfig(matmul_precision="fastest")))


@pytest.mark.parametrize("path", ["neighbor", "dense", "fused_dense"])
@pytest.mark.parametrize("tier", ["parity", "fast", "no_highest"])
def test_default_tier_matches_jax(rng, tier, path):
    """The port's forward under each "default" tier equals JAX's on the
    neighbor split (JAX's far-field Pallas kernel in interpret mode), the
    dense blocked forward and the fused dense path (JAX's fused kernels in
    interpret mode)."""
    cfg = EPNNConfig(**TIERS[tier])
    params, *arrays, _ = build(rng, cfg, b=1)
    kw = {"neighbor": dict(block=8, neighbor_k=20, use_pallas=True),
          "dense": dict(block=8),
          "fused_dense": dict(use_pallas=True)}[path]
    ref = np.asarray(jax_forward_blocked(jax_fuse_params(params, cfg),
                                         *arrays, cfg, **kw))
    _close(port_forward(params, cfg, arrays, **kw), ref)


def _mm_checked(calls):
    """``kernels._mm_tf32`` that holds every product it makes to the same
    product of TF32-rounded operands in float64: within the float32
    summation bound (K + 2)·2^-24·(|a|·|b| + |c|), K the contraction."""
    real = kernels._mm_tf32

    def mm(a, b, c=None):
        out = real(a, b, c)
        ar, br = kernels.tf32_round(a), kernels.tf32_round(b)
        ref = ar.double() @ br.double()
        mag = ar.double().abs() @ br.double().abs()
        if c is not None:
            ref, mag = ref + c.double(), mag + c.double().abs()
        bound = (a.shape[-1] + 2) * 2.0 ** -24 * mag
        assert bool(((out.double() - ref).abs() <= bound).all())
        # operands already in TF32 come back unchanged: one pass only
        assert torch.equal(kernels.tf32_round(ar), ar)
        calls.append(a.shape[-1])
        return out
    return mm


def _twin_args(g, name, n=30, k=6, h=32, e=48):
    t = lambda *s, sc=1.0: torch.from_numpy(  # noqa: E731
        (g.normal(size=s) * sc).astype(np.float32))
    pi, pj = t(n, h), t(n, h)
    w2, b2, w1e = t(h, h, sc=h ** -0.5), t(h, sc=0.1), t(e, h, sc=e ** -0.5)
    cv = torch.from_numpy((g.uniform(size=n) < 0.8).astype(np.float32))
    idx = torch.from_numpy(g.integers(0, n, size=n * k))
    rbf = t(n * k, e).abs()
    mask = torch.from_numpy((g.uniform(size=(n, k)) < 0.6).astype(np.float32))
    xyz = torch.from_numpy(g.uniform(0, 6, size=(n, 3)).astype(np.float32))
    nm = torch.ones(n)
    rs = torch.cat([pi, pj], 1)
    return {
        "dense_message_rowsum": ((pi, pj, cv, w2, b2), {}, 1),
        "dense_message_rowsum_bwd": ((pi, pj, cv, w2, b2, t(n, h)), {}, 3),
        "near_message_corr": ((pi, pj[idx], rbf, mask, w1e, w2, b2), {}, 3),
        "near_pass_rowsum": ((rs, rs[idx], rbf, 0.5 * mask, w1e, w2, b2),
                             {}, 3),
        "fused_message_rowsum": ((pi, pj, xyz, nm, nm, w1e, w2, b2),
                                 dict(masked=True), 4),
        "fused_epn_rowsum": ((pi, pj, xyz, nm, w1e, w2, b2),
                             dict(soft_gate=False), 3),
    }[name]


@pytest.mark.parametrize("name", kernels.TIERED)
def test_tf32_twins_are_one_pass(monkeypatch, name):
    """Each kernel's one-pass twin makes every product of TF32-rounded
    operands (the float64 product within float32 summation), at least
    the kernel's products a call, and differs from the float32 plain
    version by more than the 3xTF32 emulation does: it is not the float32
    or the 3xTF32 arithmetic.  The gap stays below 2^-5 of max|ref| + 1
    (one pass keeps 2^-11 of each product; the backward's dW2 sums
    products over every pair, with cancellation)."""
    args, kw, n_mm = _twin_args(np.random.default_rng(3), name)
    calls = []
    monkeypatch.setattr(kernels, "_mm_tf32", _mm_checked(calls))
    twin = getattr(kernels, name + "_tf32_plain")(*args, **kw)
    assert len(calls) >= n_mm
    monkeypatch.undo()
    plain = getattr(kernels, name + "_plain")(*args, **kw)
    emu3 = getattr(kernels, name + "_3xtf32_plain")(*args, **kw)
    for t1, p, e3 in zip(*(o if isinstance(o, tuple) else (o,)
                           for o in (twin, plain, emu3))):
        scale = float(p.abs().max()) + 1.0
        gap = float((t1 - p).abs().max())
        assert float((e3 - p).abs().max()) < gap < 2.0 ** -5 * scale


def test_tf32_pass_twins_keep_pairs_exact_negations():
    """Disjoint pairs, one live slot each, both slots the same RBF row:
    ``near_pass_rowsum_tf32_plain``'s two rows of a pair are exact
    negations; ``fused_epn_rowsum_tf32_plain`` on the dimer probe too, at
    both gates."""
    g = np.random.default_rng(4)
    n, k, h, e = 20, 4, 32, 48
    args, _, _ = _twin_args(g, "near_pass_rowsum", n, k, h, e)
    rs, _, _, _, w1e, w2, b2 = args
    idx = g.integers(0, n, size=(n, k))
    gh = np.zeros((n, k), np.float32)
    for i in range(0, n, 2):
        idx[i, 1], idx[i + 1, 2] = i + 1, i
        gh[i, 1] = gh[i + 1, 2] = 0.5
    rbf = np.abs(g.normal(size=(n, k, e))).astype(np.float32)
    for i in range(0, n, 2):
        rbf[i + 1, 2] = rbf[i, 1]
    idx_t = torch.from_numpy(idx.reshape(-1))
    out = kernels.near_pass_rowsum_tf32_plain(
        rs, rs[idx_t], torch.from_numpy(rbf.reshape(n * k, e)),
        torch.from_numpy(gh), w1e, w2, b2)
    assert torch.equal(out[0::2], -out[1::2]) and bool(out.abs().sum() > 0)

    xyz_d, pairs = dimer_probe(8, seed=0)
    m = len(xyz_d)
    pi, pj = (torch.from_numpy(g.normal(size=(m, h)).astype(np.float32))
              for _ in range(2))
    for soft in (False, True):
        out = kernels.fused_epn_rowsum_tf32_plain(
            pi, pj, torch.from_numpy(xyz_d), torch.ones(m), w1e,
            w2, b2, soft_gate=soft)
        pt = torch.from_numpy(pairs)
        assert torch.equal(out[pt[:, 0]], -out[pt[:, 1]])


#: the TF32 tier (products a k-step) each kernel launch asks for under
#: each tier: JAX's routes
ROUTES = {
    "highest": {"dense_message_rowsum": 3, "near_message_corr": 3,
                "near_pass_rowsum": 3, "fused_message_rowsum": 3,
                "fused_epn_rowsum": 3, "dense_message_rowsum_bwd": 3},
    "parity": {"dense_message_rowsum": 1, "near_message_corr": 3,
               "near_pass_rowsum": 3, "fused_message_rowsum": 3,
               "fused_epn_rowsum": 3, "dense_message_rowsum_bwd": 1},
    "fast": {"dense_message_rowsum": 1, "near_message_corr": 1,
             "near_pass_rowsum": 1, "fused_message_rowsum": 1,
             "fused_epn_rowsum": 1, "dense_message_rowsum_bwd": 1},
    # JAX runs no far-field kernel under bf16x3, and under bfloat16 none
    # in the bf16 message rounds; the fused dense path stays at main
    "bf16x3": {"near_message_corr": 3, "near_pass_rowsum": 3,
               "fused_message_rowsum": 3, "fused_epn_rowsum": 3},
    # JAX's bf16 branch also drops use_pallas: the dense path runs plain
    "bfloat16": {"near_pass_rowsum": 1},
}


@pytest.mark.parametrize("tier", sorted(ROUTES))
def test_tier_routes_on_the_card(rng, monkeypatch, tier):
    """On a CUDA tensor (launches emulated, ``arm_card``), each launch of
    the neighbor split (a forward and its backward) and of the fused
    dense path asks for its tier's TF32 passes, and the charges are the
    CPU path's."""
    cfg = EPNNConfig(**SMALL, **TIERS[tier])
    params, *arrays, _ = build(rng, cfg, b=1)
    fp, pcfg = port(params, cfg)
    args = [_t(a) for a in arrays]
    with torch.no_grad():
        want = {path: fused.forward_blocked(fp, *args, pcfg, **kw)
                for path, kw in (("split", dict(neighbor_k=20)),
                                 ("dense", dict(use_pallas=True)))}
    calls = arm_card(monkeypatch)
    leaves = [p.requires_grad_(True) for w in fp.messages + fp.passes
              for p in (w.w1_i, w.b1)]
    q = fused.forward_blocked(fp, *args, pcfg, neighbor_k=20)
    q.square().sum().backward()
    assert all(p.grad is not None for p in leaves)
    with torch.no_grad():
        qd = fused.forward_blocked(fp, *args, pcfg, use_pallas=True)
    seen = {}
    for c in calls:
        seen.setdefault(c["name"], set()).add(c["passes"])
    assert seen == {name: {p} for name, p in ROUTES[tier].items()}
    _close(q.detach().numpy(), want["split"].numpy())
    _close(qd.numpy(), want["dense"].numpy())


def test_tier_libraries_differ():
    """Each tier is a library of its own (its flag is in the hashed
    name), built only for the tensor-core kernels."""
    for name in kernels.TIERED:
        widths = kernels.lib_widths(name)
        one, three = (kernels._lib_path(name, widths, p) for p in (1, 3))
        assert one != three and "tf32x1" in one.name
        assert "-DEPNN_TF32_PASSES=1" in kernels._flags(name, widths, 1)
        assert not any("TF32" in f for f in kernels._flags(name, widths))
    with pytest.raises(ValueError):
        kernels._flags("neighbor_compact", (), 1)
    with pytest.raises(ValueError):
        kernels.tf32_passes("fastest")


def test_mm_bf16x3_is_jax_split_dot(rng):
    """``_mm_bf16x3`` and JAX's ``_split_dot`` compute exact bf16 products
    in float32: equal within float32 summation."""
    a = rng.normal(size=(37, 24)).astype(np.float32)
    b = rng.normal(size=(24, 16)).astype(np.float32)
    ref = np.asarray(jax_split_dot(a, b))
    got = fused._mm_bf16x3(_t(a), _t(b)).numpy()
    assert np.abs(got - ref).max() <= 1e-6 * (np.abs(ref).max() + 1.0)


def test_bf16x3_matches_jax(rng):
    """The far field's split-float tier equals JAX's ``_split_dot`` route,
    stays within 5e-5·scale of highest and conserves to 2e-6·(Σ|q|+1)
    (tests/test_fused.py:314-327)."""
    cfg = EPNNConfig(matmul_precision="highest")
    cfg_split = cfg.replace(dense_matmul_precision="bf16x3")
    params, *arrays, q_total = build(rng, cfg)
    kw = dict(block=8, neighbor_k=20)
    ref = np.asarray(jax_forward_blocked(jax_fuse_params(params, cfg_split),
                                         *arrays, cfg_split, **kw))
    qs = port_forward(params, cfg_split, arrays, **kw)
    _close(qs, ref)
    qh = port_forward(params, cfg, arrays, **kw)
    _close(qs, qh, 5e-5)
    cons = np.abs(qs.astype(np.float64).sum(1) - q_total)
    assert np.all(cons < 2e-6 * (np.abs(qs).sum(1) + 1.0))


@pytest.mark.parametrize("path", ["dense", "neighbor"])
def test_bf16_forward(rng, path):
    """compute_dtype='bfloat16' (tests/test_fused.py:292-311's sizes):
    float32 out, padded rows exactly 0, within 3e-2·(max|q|+1) of the
    port's float32 result and of JAX's bf16 result, and conserving to
    2e-6·(Σ|q|+1): the pass rounds run in float32."""
    cfg32 = EPNNConfig(**SMALL, matmul_precision="default")
    cfg16 = cfg32.replace(compute_dtype="bfloat16")
    params, *arrays, q_total = build(rng, cfg32)
    kw = dict(block=8) if path == "dense" else dict(block=8, neighbor_k=20)
    q32 = port_forward(params, cfg32, arrays, **kw)
    q16 = port_forward(params, cfg16, arrays, **kw)
    assert q16.dtype == np.float32 and np.all(q16[:, 20:] == 0.0)
    _close(q16, q32, 3e-2)
    jax16 = np.asarray(jax_forward_blocked(jax_fuse_params(params, cfg16),
                                           *arrays, cfg16, **kw))
    _close(q16, jax16, 3e-2)
    cons = np.abs(q16.astype(np.float64).sum(1) - q_total)
    assert np.all(cons < 2e-6 * (np.abs(q16).sum(1) + 1.0))


def test_bf16_dense_model(rng):
    """The dense model under bf16 (tests/test_model.py:160-169): its
    charges sum to Q within JAX's atol 2e-2 and lie within 3e-2·(max|q|+1)
    of JAX's bf16 charges; the tree's leaves stay float32 and get float32
    gradients through ``dense_apply``."""
    cfg = EPNNConfig(compute_dtype="bfloat16", highest_precision=False)
    params = jax.tree_util.tree_map(np.asarray,
                                    jax_init_params(cfg, jax.random.key(5)))
    b, n = 2, 8
    x = rng.normal(size=(b, n, cfg.n_elems)).astype(np.float32)
    xyz = rng.uniform(-3, 3, size=(b, n, 3)).astype(np.float32)
    mask = np.ones((b, n), np.float32)
    q_total = rng.integers(-2, 3, size=(b,)).astype(np.float32)
    q0 = (q_total[:, None] / n) * mask
    e = np.asarray(jax_rbf_edges(xyz, mask, e_dim=cfg.e_dim))
    ref = np.asarray(JaxEPNN(cfg).apply(params, x, q0, e, mask), np.float32)
    pcfg = port_cfg(cfg)
    tree = from_jax_params(params, pcfg)
    with torch.no_grad():
        q = EPNN.from_params(pcfg, tree)(_t(x), _t(q0), _t(e), _t(mask))
    assert q.dtype == torch.bfloat16
    q = q.float().numpy()
    np.testing.assert_allclose(q.sum(1), q_total, atol=2e-2)
    _close(q, ref, 3e-2)
    leaves = jax.tree_util.tree_map(lambda a: a, tree)
    w = leaves["message_0"]["dense_0"]["kernel"].requires_grad_(True)
    out = dense_apply(leaves, pcfg, _t(x), _t(q0), _t(e), _t(mask))
    out.float().sum().backward()
    assert w.dtype == torch.float32 and w.grad.dtype == torch.float32


def _contract_batch(seed=0, n_mols=3, natoms=34, pad_to=40):
    """tests/test_fused.py's collapse batch: [Z, onehot] features, valid
    rows first, uniform q0."""
    g = np.random.default_rng(seed)
    mols = [JaxMolecule(name=f"m{i}",
                        symbols=list(g.choice(["H", "C", "N", "O", "S"],
                                              natoms)),
                        xyz=g.uniform(0, 8, (natoms, 3)).astype(np.float32),
                        total_charge=float(i - 1))
            for i in range(n_mols)]
    return jax_pad_molecules(mols, jax_table(10), pad_to=pad_to)


@pytest.mark.parametrize("tier", ["bfloat16", "bf16x3"])
def test_collapse_under_the_tier(tier):
    """The round-1 collapse tracks the uncollapsed forward at JAX's bars
    (tests/test_fused.py:1183-1219): bfloat16 2e-2, bf16x3 1e-4 of
    max|q| + 1; conservation within 1e-4 of the same scale."""
    cfg = EPNNConfig(n_elems=10, **SMALL, **TIERS[tier])
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a + 0.3 if a.ndim == 1 else a),
        jax_init_params(cfg, jax.random.key(0)))
    b = _contract_batch()
    arrays = (b.x, b.q0, b.xyz, b.node_mask)
    base = port_forward(params, cfg, arrays, block=16, neighbor_k=12)
    col = port_forward(params, cfg, arrays, block=16, neighbor_k=12,
                       uniform_q0=True)
    scale = np.abs(base).max() + 1.0
    tol = {"bfloat16": 2e-2, "bf16x3": 1e-4}[tier]
    assert np.abs(col - base).max() < tol * scale
    cons = np.abs((col * b.node_mask).sum(1) - (b.q0 * b.node_mask).sum(1))
    assert np.all(cons < 1e-4 * scale)


def _grads(params, cfg, arrays):
    """(loss, gradient tree) of one fused step: JAX's ``_loss_fn_fused``
    and the port's ``_loss_fused``, in the port's tree layout."""
    (jloss, _), jgrads = jax.value_and_grad(jax_loss_fn_fused, has_aux=True)(
        params, cfg, "masked_mse", 8, 20, False, *arrays, remat=False)
    pcfg = port_cfg(cfg)
    state = L.create_state(pcfg, L.TrainConfig(), device="cpu",
                           params=from_jax_params(params, pcfg))
    loss, _ = L._loss_fused(state.params, pcfg, "masked_mse", 8, 20, False,
                            *(_t(a) for a in arrays))
    loss.backward()
    ref = from_jax_params(jax.tree_util.tree_map(np.asarray, jgrads), pcfg)
    got = {name: {dname: {key: (torch.zeros_like(r) if p.grad is None
                                else p.grad)
                          for key, r in leaf.items()
                          for p in (state.params[name][dname][key],)}
                  for dname, leaf in layers.items()}
           for name, layers in ref.items()}
    assert all(p.dtype == torch.float32 and (p.grad is None or
                                             p.grad.dtype == torch.float32)
               for layers in state.params.values()
               for leaf in layers.values() for p in leaf.values())
    return (loss.item(), got), (float(jloss), ref)


def _leaves(tree):
    return [(f"{n}/{d}/{k}", t) for n, layers in sorted(tree.items())
            for d, leaf in sorted(layers.items())
            for k, t in sorted(leaf.items())]


@pytest.mark.parametrize("tier", ["fast", "bfloat16"])
def test_train_step_matches_jax(rng, tier):
    """One fused train step under the tier against JAX's
    ``_loss_fn_fused``; the parameters and their gradients stay float32.
    fast: both packages run float32 on the CPU, so the loss agrees within
    1e-5 relative and each leaf's gradient within 1e-5·(max|g|+1), the
    float32 association noise of tests/test_torch_train.py.  bfloat16: the
    loss within JAX's bf16 charge bar, 3e-2 relative.  A bf16 gradient is
    itself ~10% off the float32 one at these bias-perturbed weights (8
    mantissa bits, compounded through the rounds), and the two frameworks
    round bf16 at other points, so the per-leaf bar is the float32
    gradient: the port's bf16 gradient may be no farther from it than 1.5
    times JAX's bf16 gradient is, plus 1e-2·(max|g|+1)."""
    cfg = EPNNConfig(**SMALL, **TIERS[tier])
    params, x, q0, xyz, mask, _ = build(rng, cfg, b=2)
    y = (mask * rng.normal(0, 0.3, size=mask.shape)).astype(np.float32)
    arrays = (x, q0, xyz, mask, y, np.ones(2, np.float32))
    (loss, got), (jloss, ref) = _grads(params, cfg, arrays)
    loss_bar = {"fast": 1e-5, "bfloat16": 3e-2}[tier]
    assert abs(loss - jloss) <= loss_bar * (abs(jloss) + 1.0)
    if tier == "fast":
        for (name, g), (_, r) in zip(_leaves(got), _leaves(ref)):
            err = float((g - r).abs().max())
            assert err <= 1e-5 * (float(r.abs().max()) + 1.0), (name, err)
        return
    _, (_, ref32) = _grads(params, cfg.replace(compute_dtype="float32"),
                           arrays)
    for (name, g), (_, r), (_, r32) in zip(_leaves(got), _leaves(ref),
                                           _leaves(ref32)):
        err = float((g - r32).abs().max())
        err_jax = float((r - r32).abs().max())
        assert err <= 1.5 * err_jax + 1e-2 * (float(r32.abs().max()) + 1.0), (
            name, err, err_jax)


def test_no_global_tf32_state(rng):
    """Nothing in the port switches PyTorch's TF32 flags or its float32
    matmul precision: plain products stay float32 at every tier."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    for tier in TIERS:
        cfg = EPNNConfig(**SMALL, **TIERS[tier])
        params, *arrays, _ = build(rng, cfg, b=1)
        port_forward(params, cfg, arrays, neighbor_k=20)
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32,
                torch.get_float32_matmul_precision()) == flags, tier
