"""The trainer's options (ROADMAP queue 1 items 9.2 and 9.5) against the
JAX trainer, on the CPU.

* ``lr_schedule='cosine'``, ``lr_plateau_*``, ``grad_clip_norm`` and
  ``grad_accum``: the rates against optax's float32 schedule, and four or
  more update steps of the dense and the fused step (``trained/mixed_b16``
  on two water boxes) against the JAX steps with JAX's optimizer, each
  option alone and together, at ``tests/test_torch_train.py``'s rtol 1e-4
  on the losses;
* ``ema_decay``, the plateau and the accumulator in ``train()``: the port's
  loop against JAX's ``train()`` from the same checkpoint on the same
  molecules (rtol 1e-4 on every row's losses and MAEs, and on ``best/``);
  the EMA's end points (decay 0 and 1), ``best/`` holding the EMA, a
  plateau drop surviving a resume, the accumulator's window and its
  resume check;
* ``debug_nans`` raising at a NaN coordinate, ``tensorboard_dir`` writing
  events (and raising without a writer), and the CLI's flags running.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from epnn_tpu.io import checkpoint as jax_ckpt
from epnn_tpu.models import EPNN as JaxEPNN
from epnn_tpu.train import TrainConfig as JaxTrainConfig
from epnn_tpu.train import create_state as jax_create_state
from epnn_tpu.train import make_optimizer as jax_make_optimizer
from epnn_tpu.train import train as jax_train
from epnn_tpu.train import train_step as jax_train_step
from epnn_tpu.train import train_step_fused as jax_train_step_fused
from epnn_tpu.train.loop import _scale_plateau_lr
from epnn_tpu_torch import cli
from epnn_tpu_torch.io import checkpoint as ckpt
from epnn_tpu_torch.models import map_tree, tree_leaves
from epnn_tpu_torch.testing import write_xyz
from epnn_tpu_torch.train import TrainConfig, train
from epnn_tpu_torch.train import loop as L

from test_torch_train import SMALL, _t, mixed, port_state, toy_mols  # noqa: F401
from test_torch_train import water_batch  # noqa: F401

torch.set_num_threads(1)

#: the options of item 9.2 that act in a train step, alone and together
#: (the plateau and the cosine schedule exclude each other, as in JAX)
STEP_OPTIONS = {
    "cosine": dict(lr_schedule="cosine", warmup_steps=2, total_steps=6),
    "plateau": dict(lr_plateau_factor=0.5),
    "clip": dict(grad_clip_norm=0.05),
    "accum": dict(grad_accum=2),
    "cosine+clip+accum": dict(lr_schedule="cosine", warmup_steps=1,
                              total_steps=4, grad_clip_norm=0.05,
                              grad_accum=2),
    "plateau+clip+accum": dict(lr_plateau_factor=0.5, grad_clip_norm=0.05,
                               grad_accum=2),
}


def _jax_lr(jtc):
    return optax.warmup_cosine_decay_schedule(
        init_value=0.0 if jtc.warmup_steps else jtc.learning_rate,
        peak_value=jtc.learning_rate, warmup_steps=jtc.warmup_steps,
        decay_steps=jtc.total_steps or 100_000,
        end_value=jtc.learning_rate * jtc.lr_final_fraction)


@pytest.mark.parametrize("kw", [
    dict(warmup_steps=3, total_steps=12),
    dict(warmup_steps=0, total_steps=9, lr_final_fraction=0.2),
    dict(warmup_steps=5, total_steps=None)])
def test_rates_match_optax_schedule(kw):
    """``lr_at`` is optax's float32 warmup-cosine schedule of the update
    count (step 0's rate first: 0 under a warmup)."""
    tc = TrainConfig(lr_schedule="cosine", learning_rate=3e-3, **kw)
    sched = _jax_lr(JaxTrainConfig(lr_schedule="cosine", learning_rate=3e-3,
                                   **kw))
    counts = list(range(16)) + [99_990, 100_000, 100_005]
    got = np.array([L.lr_at(tc, c) for c in counts], np.float32)
    want = np.array([np.float32(sched(jnp.int32(c))) for c in counts])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if kw["warmup_steps"]:
        assert got[0] == 0.0
    assert L.lr_at(TrainConfig(learning_rate=3e-3), 7) == float(
        np.float32(3e-3))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", list(STEP_OPTIONS))
def test_option_steps_match_jax(mixed, water_batch, name, fused):  # noqa: F811
    """Six step calls with the option(s) against the JAX steps with JAX's
    optimizer; under the plateau both rates are scaled by the factor after
    the third call (JAX's ``_scale_plateau_lr``, the port's
    ``Optimizer.scale_lr``).  ``grad_clip_norm=0.05`` sits below every
    update's gradient norm, so the clip acts on each: the gradient Adam
    took (left in ``.grad``) has norm 0.05."""
    cfg, jcfg, jparams = mixed
    args, k = water_batch
    kw = dict(learning_rate=3e-3, **STEP_OPTIONS[name])
    jtc = JaxTrainConfig(**kw)
    opt = jax_make_optimizer(jtc)
    jstate = jax_create_state(jcfg, jtc, jax.random.key(0)).replace(
        params=jparams, opt_state=opt.init(jparams))
    state = port_state(mixed, TrainConfig(**kw))
    targs = [_t(a) for a in args]
    jl, pl, norms = [], [], []
    for i in range(6):
        if i == 3 and "plateau" in name:
            jstate = jstate.replace(opt_state=_scale_plateau_lr(
                jstate.opt_state, 0.5))
            state.opt.scale_lr(0.5)
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
        norms.append(float(torch.sqrt(sum(
            (p.grad ** 2).sum() for p in tree_leaves(state.params)))))
        jl.append(float(loss))
        pl.append(float(ploss))
    assert state.step == 6
    every = 2 if "accum" in name else 1
    assert state.opt.count == 6 // every
    if "clip" in name:
        np.testing.assert_allclose(norms[every - 1::every], 0.05, rtol=1e-5)
    np.testing.assert_allclose(pl, jl, rtol=1e-4)


def test_clip_is_optax_global_norm():
    """Clipping is ``optax.clip_by_global_norm`` (no ``+1e-6`` in the
    divisor): engaged when ‖g‖ ≥ max, the identity below."""
    g = np.random.default_rng(0)
    tree = {"a": {"k": g.normal(size=(3, 4)).astype(np.float32)},
            "b": {"k": g.normal(size=(5,)).astype(np.float32)}}
    norm = float(np.sqrt(sum((v["k"].astype(np.float64) ** 2).sum()
                             for v in tree.values())))
    for mx in (0.5 * norm, 2.0 * norm):
        params = map_tree(lambda a: torch.zeros(a.shape, requires_grad=True),
                          tree)
        opt = L.Optimizer(TrainConfig(grad_clip_norm=mx, learning_rate=0.0),
                          params)
        for p, v in zip(tree_leaves(params), tree_leaves(tree)):
            p.grad = torch.from_numpy(v.copy())
        opt.step()
        want, _ = optax.clip_by_global_norm(mx).update(
            jax.tree_util.tree_map(jnp.asarray, tree), None)
        for p, w in zip(tree_leaves(params), tree_leaves(
                jax.tree_util.tree_map(np.asarray, want))):
            np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-6)
        if mx > norm:  # below the bar: the gradient as it was
            for p, v in zip(tree_leaves(params), tree_leaves(tree)):
                assert np.array_equal(p.grad.numpy(), v)


def test_grad_accum_is_one_step_of_the_mean(mixed, water_batch):  # noqa: F811
    """``grad_accum=2``: the first minibatch moves no parameter, the second
    applies one Adam step of the two gradients' mean — a step of plain
    Adam fed (g1 + g2)/2 — and Adam's count advances once.  The two losses
    are L and L/2 at the same weights, so g2 = g1/2 and the mean is
    0.75·g1."""
    cfg, _, _ = mixed
    args, _ = water_batch
    targs = [_t(a) for a in args]
    acc = port_state(mixed, TrainConfig(learning_rate=3e-3, grad_accum=2))
    ref = port_state(mixed, TrainConfig(learning_rate=3e-3))
    p0 = [p.detach().clone() for p in tree_leaves(acc.params)]
    loss, _ = L._loss_dense(acc.params, cfg, "masked_mse", *targs)
    L._apply(acc, loss)
    g1 = [p.grad.clone() for p in tree_leaves(acc.params)]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(acc.params), p0))
    assert acc.opt.count == 0 and acc.opt.mini_step == 1
    loss, _ = L._loss_dense(acc.params, cfg, "masked_mse", *targs)
    L._apply(acc, 0.5 * loss)
    assert acc.opt.count == 1 and acc.opt.mini_step == 0 and acc.step == 2
    for p, g in zip(tree_leaves(ref.params), g1):
        p.grad = 0.75 * g
    ref.opt.step()
    for a, b in zip(tree_leaves(acc.params), tree_leaves(ref.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-6, atol=1e-9)
    assert any(not torch.equal(a, b) for a, b in zip(
        tree_leaves(acc.params), p0))


# ---------------------------------------------------------------------------
# train(): the port's loop against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def init_dir(tmp_path_factory):
    """A random SMALL checkpoint both trainers start from (``init_from``)."""
    d = str(tmp_path_factory.mktemp("init") / "ck")
    ckpt.save_params(d, L.create_state(SMALL, TrainConfig(), seed=5,
                                       device="cpu").params, SMALL)
    return d


LOOP_OPTIONS = {
    "ema": dict(ema_decay=0.9),
    "plateau+clip+accum+ema": dict(
        lr_plateau_factor=0.5, lr_plateau_patience=1, grad_clip_norm=0.5,
        grad_accum=2, ema_decay=0.8),
    "cosine+clip+accum+ema": dict(
        lr_schedule="cosine", warmup_steps=2, total_steps=12,
        grad_clip_norm=0.5, grad_accum=3, ema_decay=0.8),
}


@pytest.mark.parametrize("name", list(LOOP_OPTIONS))
def test_train_matches_jax_trainer(init_dir, tmp_path, name):
    """Four epochs of both trainers from one checkpoint on the same
    molecules: every row's losses and MAEs (and ``lr``) within rtol 1e-4,
    ``best/`` (the EMA weights) within 1e-4·(max|w| + 1) of JAX's."""
    port, ref = toy_mols(count=16, hi=10)
    kw = dict(epochs=4, batch_size=4, seed=1, learning_rate=3e-3,
              init_from=init_dir, **LOOP_OPTIONS[name])
    res = train(port, SMALL, TrainConfig(
        checkpoint_dir=str(tmp_path / "port"), **kw), progress=False,
        device="cpu")
    jax.clear_caches()
    jres = jax_train(ref, jax_ckpt.load_config(init_dir), JaxTrainConfig(
        checkpoint_dir=str(tmp_path / "jax"), **kw), progress=False)
    assert len(res.history) == len(jres.history) == 4
    for a, b in zip(res.history, jres.history):
        assert set(a) == set(b)
        for key in a:
            if key not in ("epoch", "seconds"):
                np.testing.assert_allclose(a[key], b[key], rtol=1e-4,
                                           err_msg=key)
    best = ckpt.load_params(str(tmp_path / "port" / "best"), SMALL)
    jbest = ckpt.load_params(str(tmp_path / "jax" / "best"), SMALL)
    for a, b in zip(tree_leaves(best), tree_leaves(jbest)):
        assert float((a - b).abs().max()) <= 1e-4 * (
            float(b.abs().max()) + 1.0)
    # best/ holds the EMA, not the live weights: the last epoch's EMA is
    # saved in ema/, and it is what the best epoch validated
    ema = ckpt.load_params(str(tmp_path / "port" / "ema"), SMALL)
    if res.history[-1]["val_masked_mae"] == res.best_val_masked_mae:
        for a, b in zip(tree_leaves(best), tree_leaves(ema)):
            assert torch.equal(a, b)
    assert any(not torch.equal(a, b.detach()) for a, b in zip(
        tree_leaves(ema), tree_leaves(res.state.params)))


@pytest.mark.parametrize("decay", [0.0, 1.0])
def test_ema_end_points(init_dir, tmp_path, decay):
    """``d·e + (1 − d)·p`` after every step call: with d = 0 the EMA is the
    live weights (the validation of a run without it, bit for bit); with
    d = 1 it stays at the start, so ``best/`` holds the initial weights
    while the train loss falls."""
    port, _ = toy_mols(count=12, hi=10)
    kw = dict(epochs=3, batch_size=4, seed=1, learning_rate=3e-3,
              init_from=init_dir)
    run = str(tmp_path / "run")
    res = train(port, SMALL, TrainConfig(ema_decay=decay, checkpoint_dir=run,
                                         **kw), progress=False, device="cpu")
    if decay == 0.0:
        plain = train(port, SMALL, TrainConfig(**kw), progress=False,
                      device="cpu")
        assert ([r["val_masked_mae"] for r in res.history]
                == [r["val_masked_mae"] for r in plain.history])
    else:
        maes = [r["val_masked_mae"] for r in res.history]
        assert maes == [maes[0]] * 3
        assert res.history[-1]["train_loss"] < res.history[0]["train_loss"]
        start = ckpt.load_params(init_dir, SMALL)
        for a, b in zip(tree_leaves(ckpt.load_params(
                os.path.join(run, "best"), SMALL)), tree_leaves(start)):
            assert torch.equal(a, b)


def test_plateau_drops_and_resumes(tmp_path):
    """A rate that cannot improve validation (1e-30) is halved at every
    evaluated epoch after the first with patience 1, as JAX's; the rows
    carry it, and a run resumed after two epochs — the halved rate and
    the counter restored from the checkpoint — continues as the
    uninterrupted run does, to the bit."""
    port, _ = toy_mols(count=12, hi=10)
    base = dict(batch_size=4, seed=0, learning_rate=1e-30,
                lr_plateau_factor=0.5, lr_plateau_patience=1,
                grad_clip_norm=1.0)
    full = train(port, SMALL, TrainConfig(epochs=4, checkpoint_dir=str(
        tmp_path / "a"), **base), progress=False, device="cpu")
    assert [r["lr"] for r in full.history] == pytest.approx(
        [1e-30, 1e-30, 0.5e-30, 0.25e-30])
    assert float(full.state.opt.lr) == pytest.approx(0.125e-30, rel=1e-6)
    train(port, SMALL, TrainConfig(epochs=2, checkpoint_dir=str(
        tmp_path / "b"), **base), progress=False, device="cpu")
    meta = ckpt.load_meta(str(tmp_path / "b"))
    assert meta["lr_now"] == pytest.approx(0.5e-30) and meta["lr_stale"] == 0
    resumed = train(port, SMALL, TrainConfig(epochs=4, checkpoint_dir=str(
        tmp_path / "b"), resume=True, **base), progress=False, device="cpu")
    for a, b in zip(full.history[2:], resumed.history, strict=True):
        assert {k: v for k, v in a.items() if k != "seconds"} == {
            k: v for k, v in b.items() if k != "seconds"}
    assert float(resumed.state.opt.lr) == float(full.state.opt.lr)


def test_grad_accum_resume(tmp_path):
    """The accumulator is optimizer state: a resume with another
    ``grad_accum`` raises (JAX's message), and one with the same value —
    with a window left open at the epoch's end (three minibatches an
    epoch, windows of two) — continues as the uninterrupted run, to the
    bit."""
    port, _ = toy_mols(count=15, hi=10)
    base = dict(batch_size=4, seed=1, grad_accum=2, val_fraction=0.2)
    full = train(port, SMALL, TrainConfig(epochs=3, checkpoint_dir=str(
        tmp_path / "a"), **base), progress=False, device="cpu")
    run = str(tmp_path / "b")
    train(port, SMALL, TrainConfig(epochs=1, checkpoint_dir=run, **base),
          progress=False, device="cpu")
    assert ckpt.load_train_state(run)[4]["mini_step"] == 1
    with pytest.raises(ValueError, match="grad_accum=1.*grad_accum=2"):
        train(port, SMALL, TrainConfig(epochs=3, checkpoint_dir=run,
                                       resume=True, batch_size=4, seed=1),
              progress=False, device="cpu")
    resumed = train(port, SMALL, TrainConfig(epochs=3, checkpoint_dir=run,
                                             resume=True, **base),
                    progress=False, device="cpu")
    for a, b in zip(full.history[1:], resumed.history, strict=True):
        assert {k: v for k, v in a.items() if k != "seconds"} == {
            k: v for k, v in b.items() if k != "seconds"}
    for a, b in zip(tree_leaves(full.state.params),
                    tree_leaves(resumed.state.params)):
        assert torch.equal(a, b)
    assert resumed.state.opt.count == full.state.opt.count


def test_plateau_with_cosine_raises():
    with pytest.raises(ValueError, match="constant"):
        L.make_optimizer(TrainConfig(lr_schedule="cosine",
                                     lr_plateau_factor=0.5), {})


def test_only_the_mesh_raises():
    """Every single-device option runs; a ``mesh`` that is not a device
    mesh raises (training on one: ``tests/test_torch_parallel_train.py``)."""
    port, _ = toy_mols(count=4)
    with pytest.raises(TypeError, match="DeviceMesh"):
        train(port, SMALL, TrainConfig(epochs=1), mesh=object(),
              progress=False, device="cpu")


def test_debug_nans_names_the_step(mixed, water_batch):  # noqa: F811
    """``debug_nans`` raises ``FloatingPointError`` naming the step: at a
    NaN coordinate before the step that reads it (where JAX's
    ``jax_debug_nans`` stops at the first operation on it; the port's
    envelope would take a NaN distance as 0 and train on), and at a
    non-finite loss before the update.  Without it the run goes on."""
    port, _ = toy_mols(count=8, hi=8)
    port[3].xyz[0, 1] = np.nan
    tc = TrainConfig(epochs=1, batch_size=2, seed=0, val_fraction=0.25)
    with pytest.raises(FloatingPointError,
                       match=r"non-finite xyz at step \d+"):
        train(port, SMALL, dataclasses.replace(tc, debug_nans=True),
              progress=False, device="cpu")
    res = train(port, SMALL, tc, progress=False, device="cpu")
    assert res.state.step > 0
    cfg, _, _ = mixed
    state = port_state(mixed, TrainConfig(debug_nans=True))
    loss, _ = L._loss_dense(state.params, cfg, "masked_mse",
                            *(_t(a) for a in water_batch[0]))
    L._apply(state, loss)
    p1 = [p.detach().clone() for p in tree_leaves(state.params)]
    with pytest.raises(FloatingPointError, match="non-finite loss at step 1"):
        L._apply(state, loss.detach().requires_grad_() * float("nan"))
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(state.params), p1))


def test_tensorboard_writes_the_rows(tmp_path):
    """One event file with every scalar of each row, as JAX's writer."""
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)

    port, _ = toy_mols(count=10)
    tb = str(tmp_path / "tb")
    res = train(port, SMALL, TrainConfig(epochs=2, batch_size=4,
                                         tensorboard_dir=tb),
                progress=False, device="cpu")
    assert [f for f in os.listdir(tb) if "tfevents" in f]
    ev = EventAccumulator(tb)
    ev.Reload()
    tags = set(ev.Tags()["scalars"])
    assert tags == {"train_loss", "train_masked_mae", "train_padded_mae",
                    "val_loss", "val_masked_mae", "val_padded_mae",
                    "seconds"}
    got = [e.value for e in ev.Scalars("train_loss")]
    np.testing.assert_allclose(got, [r["train_loss"] for r in res.history],
                               rtol=1e-6)


def test_tensorboard_without_a_writer_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    with pytest.raises(RuntimeError, match="SummaryWriter"):
        L._make_tb_writer("tb")


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    data = tmp_path_factory.mktemp("cli_data")
    port, _ = toy_mols(count=8, hi=9)
    for m in port:
        write_xyz(str(data), m)
    return data


@pytest.mark.parametrize("flags", [
    ["--lr-schedule", "cosine", "--warmup-steps", "1"],
    ["--lr-plateau-factor", "0.5"], ["--ema-decay", "0.99"],
    ["--grad-clip-norm", "1.0"], ["--grad-accum", "2"], ["--debug-nans"],
    ["--tensorboard"]])
def test_cli_train_flags_run(cli_data, tmp_path, flags):
    """The flags that raised naming items 9.2 / 9.5 now train (two epochs
    of a small model, ``metrics.jsonl`` with both rows)."""
    out = tmp_path / "run"
    cli.main(["train", "--data", str(cli_data), "--out", str(out),
              "--epochs", "2", "--batch-size", "4", "--rounds", "1",
              "--h-dim", "8", "--e-dim", "8", "--msg-dim", "8", "--layers",
              "8", *flags])
    rows = [json.loads(ln) for ln in open(out / "metrics.jsonl")]
    assert len(rows) == 2 and all(np.isfinite(r["train_loss"])
                                  for r in rows)
    if "--tensorboard" in flags:
        assert [f for f in os.listdir(out / "tb") if "tfevents" in f]
    if "--ema-decay" in flags:
        assert (out / "ema" / "params.msgpack").exists()
