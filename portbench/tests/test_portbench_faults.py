"""A run on the CPU (the harness's look for a card skipped), whole but for
the card: sound it is ``correct``; with the timed path broken underneath
``correct`` comes out false, once for each fault a serving cell can have:
its pass step returning the charges unchanged, half of the batch (of a
one-graph batch: half of its atoms) left out and the mean of the rest in
its place, an answer altered where it is produced, and, in the MD cell, a
frame answered with the state of an earlier one; and the pass gate's
threshold moved by 5%, which the comparison's gate ties may not absorb.
The cells run on one card, so there is no exchange between chips to leave
out.  The control of the 3xTF32 cell, the program at one TF32 pass, is
emulated here by the kernels' own ``*_tf32_plain`` twins
(``portbench.control.one_pass_on_cpu``); that of the one-pass far field,
the reference with its far field in bfloat16, runs as it is."""

import contextlib

import numpy as np
import pytest
import torch

from portbench import control, run
from portbench.tests import small

SEED = 2**35 + 17


def _run(workload, fault=None, emulate=False, seconds=1.0, low=None,
         molecules=100, seed=SEED):
    torch.manual_seed(0)
    s = small.spec(workload, molecules)
    ctx = control.one_pass_on_cpu() if emulate else contextlib.nullcontext()
    with ctx:
        return run.run_cell(s, seed, seconds, False, "cpu", fault=fault,
                            control=low)


def _patch(monkeypatch, obj, name, wrap):
    monkeypatch.setattr(obj, name, wrap(getattr(obj, name)))


@pytest.mark.parametrize("workload", small.CELLS)
def test_sound_run_is_correct(workload):
    r = _run(workload)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    want = {"decay_model.frames-35520": {"call_ms", "call_p95_ms",
                                         "setup_s"},
            small.MD: {"frame_ms", "setup_s"}}[workload]
    assert set(r["metrics"]) == want
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("workload", small.CELLS)
def test_pass_step_returning_its_state(workload, monkeypatch):
    from epnn_tpu_torch.ops import fused

    _patch(monkeypatch, fused, "near_pass_rowsum",
           lambda f: lambda rs, *a, **k: torch.zeros(
               (rs.shape[0], a[-2].shape[0]), dtype=rs.dtype))
    r = _run(workload)
    assert not r["correct"]
    assert r["checks"]["q_gap"]["value"] > r["checks"]["q_gap"]["limit"]


@pytest.mark.parametrize("workload", small.CELLS)
def test_half_the_batch_left_out(workload, monkeypatch):
    """The graph's second half of atoms left out of the forward (masked as
    padding), their charges the mean of the first half's."""
    from epnn_tpu_torch import infer

    def half(f):
        def forward(fused, x, q0, xyz, mask, *a, **k):
            keep = mask.clone()
            cut = int(mask[0].sum()) // 2
            keep[:, cut:] = 0
            q = f(fused, x, q0, xyz, keep, *a, **k)
            q[:, cut:] = q[:, :cut].mean(-1, keepdim=True) * mask[:, cut:]
            return q
        return forward

    _patch(monkeypatch, infer, "forward_blocked", half)
    r = _run(workload)
    assert not r["correct"]


@pytest.mark.parametrize("workload", small.CELLS)
def test_an_answer_altered(workload, monkeypatch):
    from epnn_tpu_torch.infer import Predictor

    def alter(f):
        def inner(self, batch):
            q = f(self, batch)
            q[0, 7] += 1e-3 * (np.abs(q[0]).max() + 1.0)
            return q
        return inner

    _patch(monkeypatch, Predictor, "_predict_batch_inner", alter)
    r = _run(workload)
    assert not r["correct"]


def test_md_frame_answered_with_an_earlier_state(monkeypatch):
    """Every frame of the window answered with the charges of the warm-up
    frame: the walk's steps move the atoms far enough for the reference
    to see it."""
    from epnn_tpu_torch.infer import Predictor

    held = {}

    def stale(f):
        def inner(self, batch):
            q = f(self, batch)
            held.setdefault("n", 0)
            held["n"] += 1
            if held["n"] == 1:
                held["q"] = q.copy()
                return q
            return held["q"].copy()
        return inner

    _patch(monkeypatch, Predictor, "_predict_batch_inner", stale)
    r = _run(small.MD, seconds=2.0)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("workload", small.CELLS)
def test_control(workload):
    """The cell's control (``control.of``): the one-pass tier emulated for
    the 3xTF32 cell, the reference with a bfloat16 far field in the
    program's place for the one-pass far field."""
    low = control.of(small.spec(workload)["config"])
    r = _run(workload, emulate=low["precision"] == "default",
             low=low["control"])
    assert not r["correct"]
    assert r["checks"]["q_gap"]["value"] > r["checks"]["q_gap"]["limit"]


@pytest.mark.parametrize("workload", small.CELLS)
@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_gate_threshold_moved(workload, seed):
    """The program's gate at 1.05 × ``is_near_tol``: the pairs within 5%
    above the threshold, which the reference gates on, gated off.  Those
    beyond ``compare.TIE_BAND`` are no ties, so no gate the reference may
    set the other way brings it back; 1,000 waters hold a few of them."""
    from portbench import compare

    assert compare.TIE_BAND < 0.05

    def fault(pred):
        pred.cfg = pred.cfg.replace(is_near_tol=pred.cfg.is_near_tol * 1.05)

    r = _run(workload, fault=fault, molecules=1000, seconds=0.5, seed=seed)
    assert not r["correct"], r["checks"]


@pytest.mark.card
@pytest.mark.parametrize("workload", small.CELLS)
def test_control_on_the_card(workload, card):
    """On the card, at the cell's own size and load for a 3 s window, on
    three seeds: the stated precision is correct, the control
    (``control.of``) is not, nor is the gate at 1.05 × ``is_near_tol``."""
    s = run.load_cell(workload)
    low = control.of(s["config"])

    def fault(pred):
        pred.cfg = pred.cfg.replace(is_near_tol=pred.cfg.is_near_tol * 1.05)

    for seed in (2**33 + 1, 2**33 + 2, 2**33 + 3):
        sound = run.run_cell(s, seed, 3.0, False, card)
        assert sound["correct"], sound["checks"]
        bad = run.run_cell(s, seed, 3.0, False, card, **low)
        assert not bad["correct"], bad["checks"]
        gate = run.run_cell(s, seed, 3.0, False, card, fault=fault)
        assert not gate["correct"], gate["checks"]


@pytest.mark.parametrize("workload", small.CELLS)
def test_every_call_failing(workload, monkeypatch):
    """A program whose every window call raises: the run ends, counts the
    failures and is not correct."""
    from epnn_tpu_torch.infer import Predictor

    def broken(f):
        calls = {"n": 0}

        def inner(self, batch):
            calls["n"] += 1
            if calls["n"] > 1:
                raise RuntimeError("broken")
            return f(self, batch)
        return inner

    _patch(monkeypatch, Predictor, "_predict_batch_inner", broken)
    r = _run(workload, seconds=0.3)
    assert not r["correct"]
    assert r["failed"] == r["attempted"] > 0
