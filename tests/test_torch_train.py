"""The port's training slice against the JAX trainer, on the CPU.

* First-step loss and every parameter gradient of the blocked (fused) and
  the dense step against ``jax.value_and_grad`` of the JAX losses, with
  the ``trained/mixed_b16`` weights on two water boxes of 39 and 36 atoms.
  Tolerance: loss within 1e-6·(|loss| + 1); each leaf's gradient within
  1e-5·(max|g_jax| + 1) — float32 summation order (measured ≤ 7e-7).
* Four Adam steps' losses against the JAX steps: rtol 1e-4
  (``tests/test_train.py``'s bar between two paths).
* The loop's data helpers equal the JAX functions exactly; ``train`` cuts
  the loss, routes wide buckets to the fused step, resumes bit for bit,
  and writes checkpoints the JAX package serves within 1e-5·(max|q| + 1).
"""

import os

import jax
import numpy as np
import pytest
import torch

from epnn_tpu.data import dataset as jax_dataset
from epnn_tpu.data.xyz import Molecule as JaxMolecule
from epnn_tpu.elements import table_for_n_elems as jax_table
from epnn_tpu.io import checkpoint as jax_ckpt
from epnn_tpu.models import EPNN as JaxEPNN
from epnn_tpu.models import init_params as jax_init_params
from epnn_tpu.train import TrainConfig as JaxTrainConfig
from epnn_tpu.train import create_state as jax_create_state
from epnn_tpu.train import make_optimizer as jax_make_optimizer
from epnn_tpu.train import metrics as jax_metrics
from epnn_tpu.train import train_step as jax_train_step
from epnn_tpu.train import train_step_fused as jax_train_step_fused
from epnn_tpu.train.loop import _loss_fn as jax_loss_fn
from epnn_tpu.train.loop import _loss_fn_fused as jax_loss_fn_fused
from epnn_tpu_torch.data import dataset
from epnn_tpu_torch.data.xyz import Molecule
from epnn_tpu_torch.elements import table_for_n_elems
from epnn_tpu_torch.io import checkpoint as ckpt
from epnn_tpu_torch.models import (
    EPNN,
    EPNNConfig,
    dense_apply,
    map_tree,
    tree_leaves,
)
from epnn_tpu_torch.ops import kernels
from epnn_tpu_torch.ops.fused import max_neighbor_count
from epnn_tpu_torch.testing import water_box
from epnn_tpu_torch.train import TrainConfig, metrics, train
from epnn_tpu_torch.train import loop as L

torch.set_num_threads(1)

CKPT = "trained/mixed_b16"
SMALL = EPNNConfig(h_dim=16, e_dim=16, msg_dim=8, mlp_hidden=(8, 8), T=2)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def mixed():
    """(port cfg, JAX cfg, JAX params tree) of trained/mixed_b16."""
    jcfg = jax_ckpt.load_config(CKPT)
    jparams = jax_ckpt.load_params(CKPT, jax_init_params(jcfg,
                                                         jax.random.key(0)))
    return ckpt.load_config(CKPT), jcfg, jparams


@pytest.fixture(scope="module")
def water_batch():
    """Two boxes (39 atoms, Q = 0; 36 atoms, Q = +1) padded to 40, seeded
    labels, and the safe neighbor k."""
    mols = [water_box(13, seed=3, charge=0.0), water_box(12, seed=4,
                                                         charge=1.0)]
    b = dataset.pad_molecules(mols, table_for_n_elems(10))
    g = np.random.default_rng(0)
    y = (b.node_mask * g.normal(0, 0.3, size=b.node_mask.shape)).astype(
        np.float32)
    args = (b.x, b.q0, b.xyz, b.node_mask, y, np.ones(2, np.float32))
    k = max(max_neighbor_count(b.xyz[i], b.node_mask[i], 3.0)
            for i in range(2))
    return args, min(dataset.round_up(k + 4, 8), b.padded_atoms - 1)


def port_state(mixed, tc=None):
    cfg, _, jparams = mixed
    return L.create_state(
        cfg, tc or TrainConfig(), device="cpu",
        params=ckpt.from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                           jparams)))


def assert_grads_match(jgrads, state):
    ref = ckpt.from_jax_params(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, layers in ref.items():
        for dname, leaf in layers.items():
            for key, r in leaf.items():
                got = state.params[name][dname][key].grad
                got = torch.zeros_like(r) if got is None else got
                err = float((got - r).abs().max())
                assert err <= 1e-5 * (float(r.abs().max()) + 1.0), (
                    name, dname, key, err)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("uniform_q0", [False, True])
def test_first_fused_step_matches_jax(mixed, water_batch, use_pallas,
                                      uniform_q0):
    cfg, jcfg, jparams = mixed
    args, k = water_batch
    (jloss, _), jgrads = jax.value_and_grad(jax_loss_fn_fused, has_aux=True)(
        jparams, jcfg, "masked_mse", 8, k, use_pallas, *args,
        uniform_q0=uniform_q0, remat=False)
    state = port_state(mixed)
    kernels.reset_launch_counts()
    loss, _ = L._loss_fused(state.params, cfg, "masked_mse", 8, k, False,
                            *(_t(a) for a in args), uniform_q0=uniform_q0)
    loss.backward()
    assert sum(kernels.LAUNCHES.values()) == 0  # CPU: plain versions
    assert abs(loss.item() - float(jloss)) <= 1e-6 * (abs(float(jloss)) + 1)
    assert_grads_match(jgrads, state)


def test_first_dense_step_matches_jax(mixed, water_batch):
    cfg, jcfg, jparams = mixed
    args, _ = water_batch
    (jloss, _), jgrads = jax.value_and_grad(jax_loss_fn, has_aux=True)(
        jparams, JaxEPNN(jcfg), "masked_mse", *args)
    state = port_state(mixed)
    loss, _ = L._loss_dense(state.params, cfg, "masked_mse",
                            *(_t(a) for a in args))
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-6 * (abs(float(jloss)) + 1)
    assert_grads_match(jgrads, state)


@pytest.mark.parametrize("fused", [False, True])
def test_four_adam_steps_match_jax(mixed, water_batch, fused):
    cfg, jcfg, jparams = mixed
    args, k = water_batch
    jtc = JaxTrainConfig(learning_rate=3e-3)
    opt = jax_make_optimizer(jtc)
    jstate = jax_create_state(jcfg, jtc, jax.random.key(0)).replace(
        params=jparams, opt_state=opt.init(jparams))
    state = port_state(mixed, TrainConfig(learning_rate=3e-3))
    targs = [_t(a) for a in args]
    jl, pl = [], []
    for _ in range(4):
        if fused:
            jstate, loss, _, _ = jax_train_step_fused(
                jstate, jcfg, "masked_mse", opt, 8, k, *args,
                uniform_q0=True, remat=False)
            _, ploss, _, _ = L.train_step_fused(
                state, cfg, "masked_mse", None, 8, k, *targs,
                uniform_q0=True, remat=False)
        else:
            jstate, loss, _, _ = jax_train_step(
                jstate, JaxEPNN(jcfg), "masked_mse", opt, *args)
            _, ploss, _, _ = L.train_step(state, cfg, "masked_mse", None,
                                          *targs)
        jl.append(float(loss))
        pl.append(float(ploss))
    assert state.step == 4
    assert pl[-1] < pl[0]
    np.testing.assert_allclose(pl, jl, rtol=1e-4)


def test_dense_apply_matches_the_module(rng):
    """The functional forward over the tree equals the module built from
    it, and differentiates the tree's own leaves."""
    from epnn_tpu_torch.featurize import rbf_edges
    from epnn_tpu_torch.models import init_params

    params = init_params(SMALL, torch.Generator().manual_seed(0))
    x = _t(rng.normal(size=(2, 8, SMALL.n_elems)))
    xyz = _t(rng.uniform(-2, 2, size=(2, 8, 3)))
    mask = _t(np.ones((2, 8)))
    q0 = _t(np.zeros((2, 8)))
    e = rbf_edges(xyz, mask, e_dim=SMALL.e_dim)
    with torch.no_grad():
        ref = EPNN.from_params(SMALL, params)(x, q0, e, mask)
    leaf = params["update"]["dense_0"]["kernel"].requires_grad_(True)
    out = dense_apply(params, SMALL, x, q0, e, mask)
    assert torch.equal(out.detach(), ref)
    out.sum().backward()
    assert leaf.grad is not None and leaf.grad.abs().sum() > 0


def test_metrics_match_jax(rng):
    pred, y = (rng.normal(size=(3, 7)).astype(np.float32) for _ in range(2))
    mask = (rng.uniform(size=(3, 7)) > 0.3).astype(np.float32)
    w = np.array([1, 1, 0], np.float32)
    for name in ("masked_mse", "padded_mse"):
        for sw in (None, w):
            got = metrics.LOSSES[name](_t(pred), _t(y), _t(mask),
                                       None if sw is None else _t(sw))
            ref = jax_metrics.LOSSES[name](pred, y, mask, sw)
            assert abs(float(got) - float(ref)) <= 1e-6
    got = metrics.mae_sums(_t(pred), _t(y), _t(mask), _t(w)).numpy()
    np.testing.assert_allclose(
        got, [float(a) for a in jax_metrics.mae_sums(pred, y, mask, w)],
        rtol=1e-6)


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

def toy_mols(seed=3, count=24, lo=3, hi=12, side=3.0):
    """Random H/C/N/O molecules with labels that sum to the net charge, in
    both packages' Molecule types."""
    g = np.random.default_rng(seed)
    port, ref = [], []
    for i in range(count):
        n = int(g.integers(lo, hi))
        symbols = [str(s) for s in g.choice(["H", "C", "N", "O"], size=n)]
        xyz = g.uniform(-side, side, size=(n, 3)).astype(np.float32)
        q_total = float(g.integers(-1, 2))
        labels = g.normal(0, 0.2, size=n).astype(np.float32)
        labels += (q_total - labels.sum()) / n
        for cls, out in ((Molecule, port), (JaxMolecule, ref)):
            out.append(cls(name=f"m{i}", symbols=symbols, xyz=xyz.copy(),
                           total_charge=q_total, labels=labels.copy()))
    return port, ref


def test_bucket_molecules_and_minibatches_match_jax():
    port, ref = toy_mols(count=30, lo=2, hi=30)
    pb = dataset.bucket_molecules(port, table_for_n_elems(10))
    jb = jax_dataset.bucket_molecules(ref, jax_table(10))
    assert list(pb) == list(jb)
    fields = ("x", "xyz", "q0", "total_q", "y", "node_mask", "natoms",
              "has_labels")
    for pad in pb:
        for f in fields:
            np.testing.assert_array_equal(getattr(pb[pad], f),
                                          getattr(jb[pad], f))
        for bs in (1, 3, 8):
            for seed in (None, 5):
                a = dataset.minibatches(
                    pb[pad], bs, with_indices=True,
                    rng=None if seed is None else np.random.default_rng(seed))
                b = jax_dataset.minibatches(
                    jb[pad], bs, with_indices=True,
                    rng=None if seed is None else np.random.default_rng(seed))
                for (ma, na, ia), (mb, nb, ib) in zip(a, b, strict=True):
                    assert na == nb and ma.names == mb.names
                    np.testing.assert_array_equal(ia, ib)
                    np.testing.assert_array_equal(ma.x, mb.x)


@pytest.mark.parametrize("n,test_size,seed", [(24, 0.2, 42), (871, 0.2, 42),
                                              (7, 0.33, 3), (101, 0.5, 0)])
def test_train_val_split_matches_sklearn_split(n, test_size, seed):
    for a, b in zip(dataset.train_val_split(n, test_size, seed),
                    jax_dataset.train_val_split(n, test_size, seed),
                    strict=True):
        np.testing.assert_array_equal(a, b)


def test_train_reduces_loss_and_routes_wide_buckets_to_fused(monkeypatch):
    port, _ = toy_mols(seed=8, count=8, lo=20, hi=28, side=5.0)
    small, _ = toy_mols(count=6)
    calls = {"train_step": 0, "train_step_fused": 0}
    for name in calls:
        def spy(*a, _fn=getattr(L, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(L, name, spy)
    tc = TrainConfig(epochs=6, batch_size=4, seed=1, dense_max_atoms=16,
                     learning_rate=3e-3)
    res = train(port + small, SMALL, tc, progress=False, device="cpu")
    assert calls["train_step_fused"] > 0 and calls["train_step"] > 0, calls
    first, last = res.history[0]["train_loss"], res.history[-1]["train_loss"]
    assert last < first * 0.9, (first, last)
    assert np.isfinite(res.best_val_masked_mae)


def test_resume_reproduces_the_uninterrupted_run(tmp_path):
    port, _ = toy_mols(count=16, hi=22)
    base = dict(batch_size=4, seed=1, dense_max_atoms=8)
    full = train(port, SMALL, TrainConfig(epochs=4, checkpoint_dir=str(
        tmp_path / "a"), **base), progress=False, device="cpu")
    train(port, SMALL, TrainConfig(epochs=2, checkpoint_dir=str(
        tmp_path / "b"), **base), progress=False, device="cpu")
    resumed = train(port, SMALL, TrainConfig(
        epochs=4, checkpoint_dir=str(tmp_path / "b"), resume=True, **base),
        progress=False, device="cpu")
    assert [r["epoch"] for r in resumed.history] == [2, 3]
    for a, b in zip(full.history[2:], resumed.history, strict=True):
        assert {k: v for k, v in a.items() if k != "seconds"} == {
            k: v for k, v in b.items() if k != "seconds"}
    for a, b in zip(tree_leaves(full.state.params),
                    tree_leaves(resumed.state.params), strict=True):
        assert torch.equal(a, b)
    assert resumed.state.step == full.state.step


def test_best_checkpoint_serves_in_the_jax_package(tmp_path):
    """``best/`` written by the port loads in ``epnn_tpu.io.checkpoint``
    and the JAX Predictor gives the port Predictor's charges."""
    from epnn_tpu.infer import Predictor as JaxPredictor
    from epnn_tpu_torch.infer import Predictor

    port, ref = toy_mols(count=12)
    run = str(tmp_path / "run")
    log = str(tmp_path / "log.jsonl")
    train(port, SMALL, TrainConfig(epochs=2, batch_size=8, seed=1,
                                   checkpoint_dir=run, log_path=log,
                                   dump_predictions=True),
          progress=False, device="cpu")
    best = os.path.join(run, "best")
    jparams = jax_ckpt.load_params(best, jax_init_params(
        jax_ckpt.load_config(best), jax.random.key(0)))
    tparams = ckpt.load_params(best, SMALL)
    for a, b in zip(jax.tree_util.tree_leaves(jparams),
                    jax.tree_util.tree_leaves(
                        {"params": tparams}), strict=True):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    q_port = Predictor.from_checkpoint(best, device="cpu").predict_molecules(
        port[:4])
    q_jax = JaxPredictor.from_checkpoint(best).predict_molecules(ref[:4])
    for qp, qj in zip(q_port, q_jax, strict=True):
        assert np.abs(qp - qj).max() <= 1e-5 * (np.abs(qj).max() + 1.0)
    assert len(open(log).read().splitlines()) == 2
    assert os.path.exists(os.path.join(run, "artifacts",
                                       "val_pred_charges.npy"))


def test_eval_every_skips_epochs_and_early_stop_fires():
    """``eval_every`` evaluates every Nth epoch and the last; with a zero
    learning rate nothing improves after the first evaluation, so
    ``early_stop_patience=1`` stops at the second evaluated epoch."""
    port, _ = toy_mols(count=10)
    res = train(port, SMALL, TrainConfig(epochs=5, batch_size=4,
                                         eval_every=2), progress=False,
                device="cpu")
    assert [r["val_loss"] is not None for r in res.history] == [
        False, True, False, True, True]
    res = train(port, SMALL, TrainConfig(epochs=5, batch_size=4,
                                         learning_rate=0.0,
                                         early_stop_patience=1),
                progress=False, device="cpu")
    assert len(res.history) == 2


def test_init_from_loads_the_checkpoint():
    port, _ = toy_mols(count=6)
    cfg = ckpt.load_config(CKPT)
    res = train(port, cfg, TrainConfig(epochs=1, learning_rate=0.0,
                                       init_from=CKPT),
                progress=False, device="cpu")
    for a, b in zip(tree_leaves(res.state.params),
                    tree_leaves(ckpt.load_params(CKPT, cfg)), strict=True):
        assert torch.equal(a.detach(), b)
    assert res.state.step > 0


def test_train_state_round_trip(tmp_path):
    state = L.create_state(SMALL, TrainConfig(), seed=2, device="cpu")
    x = _t(np.ones((1, 8, SMALL.n_elems)))
    loss = dense_apply(state.params, SMALL, x, _t(np.zeros((1, 8))),
                       _t(np.zeros((1, 8, 8, SMALL.e_dim))),
                       _t(np.ones((1, 8)))).square().sum()
    L._apply(state, loss)
    m, v = L._adam_moments(state)
    ckpt.save_train_state(str(tmp_path), state.params, m, v, state.step,
                          meta={"epoch": np.int64(3)})
    params, m2, v2, step, extras = ckpt.load_train_state(str(tmp_path))
    assert step == 1 and extras == {}
    assert ckpt.load_meta(str(tmp_path)) == {"epoch": 3}
    for a, b in ((state.params, params), (m, m2), (v, v2)):
        for x1, x2 in zip(tree_leaves(a), tree_leaves(b), strict=True):
            assert torch.equal(x1.detach(), x2)


def test_checkpoint_save_is_atomic(tmp_path, monkeypatch):
    """A crash at the rename leaves the previous file intact, no litter."""
    d = str(tmp_path / "ck")
    params = L.create_state(SMALL, TrainConfig(), device="cpu").params
    ckpt.save_params(d, params, SMALL)
    path = os.path.join(d, ckpt.PARAMS_FILE)
    before = open(path, "rb").read()

    def boom(src, dst):
        raise OSError("simulated crash during checkpoint rename")

    monkeypatch.setattr(os, "replace", boom)
    with pytest.raises(OSError, match="simulated crash"):
        ckpt.save_params(d, map_tree(lambda a: a + 1.0, params), SMALL)
    monkeypatch.undo()
    assert open(path, "rb").read() == before
    assert not [f for f in os.listdir(d) if ".tmp." in f]


def test_train_without_a_card_raises():
    port, _ = toy_mols(count=4)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: train() would run on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(port, SMALL, TrainConfig(epochs=1), progress=False)


@pytest.mark.parametrize("kw", [
    dict(remat=True), dict(near_row_chunk=8, remat=True),
    dict(near_window=32, near_row_chunk=8, remat=True)])
def test_huge_n_options_run(kw):
    """``remat``, ``near_row_chunk`` and ``near_window`` (ported; they
    raised before) train the fused buckets to the losses of the default
    run: the chunked forward is the full-width one, remat recomputes the
    same values (float32 summation order of the gradients aside), and a
    window as wide as the bucket (these buckets pad to ≤ 24 atoms) drops
    no pair.  Narrower windows: ``tests/test_torch_huge_n.py``."""
    port, _ = toy_mols(count=6, lo=10, hi=20)
    base = dict(epochs=2, batch_size=3, dense_max_atoms=8, seed=2)
    ref = train(port, SMALL, TrainConfig(**base), progress=False,
                device="cpu")
    res = train(port, SMALL, TrainConfig(**base, **kw), progress=False,
                device="cpu")
    for got, want in zip(res.history, ref.history, strict=True):
        np.testing.assert_allclose(got["train_loss"], want["train_loss"],
                                   rtol=1e-5)


def test_train_far_cluster_runs_and_loss_falls(monkeypatch):
    """``TrainConfig(far_cluster=4)``: the fused buckets train through the
    clustered far field (the differentiable fit) and the loss falls, after
    JAX's ``tests/test_train.py::test_public_train_far_cluster``; eval
    steps run exact."""
    port, _ = toy_mols(seed=8, count=8, lo=20, hi=28, side=5.0)
    seen = []
    real = L.forward_blocked

    def spy(*a, **kw):
        seen.append((kw["far_cluster"], kw["far_cluster_grad"],
                     torch.is_grad_enabled()))
        return real(*a, **kw)

    monkeypatch.setattr(L, "forward_blocked", spy)
    tc = TrainConfig(epochs=5, batch_size=4, seed=1, dense_max_atoms=16,
                     learning_rate=3e-3, far_cluster=4)
    res = train(port, SMALL, tc, progress=False, device="cpu")
    assert set(seen) == {(4, True, True), (0, False, False)}, set(seen)
    first, last = res.history[0]["train_loss"], res.history[-1]["train_loss"]
    assert np.isfinite(last) and last < first, (first, last)
