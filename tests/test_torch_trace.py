"""The port's spans and counters (``epnn_tpu_torch.utils.timing.span``,
``Predictor.counters``) on the CPU: under ``torch.profiler`` each call is
one ``epnn.predict_batch`` span with the host's, the selection's and the
forward's spans nested in it; with no profiler a call enters no
``record_function``; the charges are the same bits either way; the
counters rise by the host syncs each kind of call makes; and a serving
export and a flop count trace what they traced before while a profiler
records.  Small water boxes through the cell builder and the spatial
sort, so every span fires."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from epnn_tpu_torch import infer
from epnn_tpu_torch.data import pad_molecules
from epnn_tpu_torch.elements import table_for_n_elems
from epnn_tpu_torch.infer import Predictor
from epnn_tpu_torch.io import export_predictor, load_serving
from epnn_tpu_torch.testing import water_box
from epnn_tpu_torch.utils import timing

torch.set_num_threads(1)

CKPT = "trained/mixed_b16"
ROOT = "epnn.predict_batch"
#: the spans of a cold blocked call through the cell builder and the sort
COLD = {"epnn.predictor.sort_view", "epnn.predictor.fingerprint",
        "epnn.predictor.inputs", "epnn.predictor.cell_grid",
        "epnn.predictor.collapse_check", "epnn.predictor.readback",
        "epnn.select.count", "epnn.select.build", "epnn.forward.features",
        "epnn.forward.message", "epnn.forward.pass"}
#: a skin frame that reuses its tables: no count, no grid; the drift checks
REUSE = COLD - {"epnn.select.count", "epnn.predictor.cell_grid"} | {
    "epnn.predictor.skin_check"}
#: host syncs a call: four input copies and the readback (a dense call, a
#: repeated geometry); a cold call adds count_only's two copies and its
#: read; a skin rebuild adds those and its own two copies
SYNCS = {"dense": 5, "cold": 8, "reuse": 5, "rebuild": 10}


@pytest.fixture(autouse=True)
def grid_below_small_boxes(monkeypatch):
    """The skin's selection through the cell builder at these sizes."""
    monkeypatch.setattr(infer, "CELL_GRID_MIN_ATOMS", 16)


def _ckpt():
    import os

    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), CKPT)


def _pred(**kw):
    kw = dict(dict(device="cpu", neighbor_method="cell", spatial_sort="on"),
              **kw)
    return Predictor.from_checkpoint(_ckpt(), **kw)


def _batch(n_mol=100, seed=1, charge=1.0):
    return pad_molecules([water_box(n_mol, seed=seed, charge=charge)],
                         table_for_n_elems(10))


def _spans(prof):
    """[(start, end, name)] of the profile's ``epnn.*`` spans."""
    return sorted(((ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                    ev.name())
                   for ev in prof.profiler.kineto_results.events()
                   if ev.name().startswith("epnn.")),
                  key=lambda s: (s[0], -s[1]))


def _calls(spans):
    """{root: [names of the spans nested in it]}, every span checked to
    lie in exactly one root and every root in none."""
    roots = [s for s in spans if s[2] == ROOT]
    out = {r: [] for r in roots}
    for s in spans:
        if s[2] == ROOT:
            assert not any(r != s and r[0] <= s[0] and s[1] <= r[1]
                           for r in roots)
            continue
        holders = [r for r in roots if r[0] <= s[0] and s[1] <= r[1]]
        assert len(holders) == 1, s
        out[holders[0]].append(s[2])
    return out


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def test_cold_blocked_call_spans():
    pred = _pred()
    batch = _batch()
    _, spans = _profiled(lambda: pred.predict_batch(batch))
    (names,) = _calls(spans).values()
    assert set(names) == COLD
    t = len(pred._fused.messages)
    assert t > 1
    assert names.count("epnn.forward.message") == t
    assert names.count("epnn.forward.pass") == len(pred._fused.passes)
    # the count's own copies nest in its span; the fingerprint in the sort
    count = next(s for s in spans if s[2] == "epnn.select.count")
    assert sum(count[0] <= s[0] and s[1] <= count[1]
               for s in spans if s[2] == "epnn.predictor.inputs") == 2
    view = next(s for s in spans if s[2] == "epnn.predictor.sort_view")
    assert any(view[0] <= s[0] and s[1] <= view[1]
               for s in spans if s[2] == "epnn.predictor.fingerprint")


def test_skin_frames_spans():
    """Three frames in one profile, the first selecting: one root each,
    the selection's spans in the first only, the drift checks after."""
    pred = _pred(reuse_neighbors=True, neighbor_skin=0.5)
    batch = _batch()

    def frames():
        for _ in range(3):
            pred.predict_batch(batch)
            batch.xyz[0, :300] += 0.01

    _, spans = _profiled(frames)
    calls = sorted(_calls(spans).items())
    assert len(calls) == 3
    first, *rest = [set(names) for _, names in calls]
    assert first == COLD
    assert all(names == REUSE for names in rest)
    assert pred.skin_rebuilds == 1


def test_renormalize_and_far_cluster_spans():
    pred = _pred(renormalize=True, far_cluster=4)
    _, spans = _profiled(lambda: pred.predict_batch(_batch()))
    (names,) = _calls(spans).values()
    assert "epnn.predictor.renormalize" in names
    # the fit of every message round but the collapsed first
    assert names.count("epnn.forward.far_cluster_fit") == len(
        pred._fused.messages) - 1


def test_no_record_function_without_a_profiler(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    cold, skin = _pred(renormalize=True), _pred(reuse_neighbors=True,
                                                neighbor_skin=0.5)
    batch = _batch()
    cold.predict_batch(batch)
    for _ in range(2):
        skin.predict_batch(batch)
    t = timing.Timer()
    with t.span("a"):
        pass
    assert len(t.spans["a"]) == 1


@pytest.mark.parametrize("kind", ["cold", "skin"])
def test_charges_bit_identical_under_the_profiler(kind):
    kw = dict(reuse_neighbors=True, neighbor_skin=0.5) if kind == "skin" \
        else {}
    off, on = _pred(**kw), _pred(**kw)
    b_off, b_on = _batch(), _batch()
    for _ in range(2):
        q_off = off.predict_batch(b_off)
        q_on, spans = _profiled(lambda: on.predict_batch(b_on))
        assert spans
        np.testing.assert_array_equal(q_on, q_off)
        b_off.xyz[0, :300] += 0.01
        b_on.xyz[0, :300] += 0.01


def _delta(pred, fn):
    before = pred.counters
    fn()
    return {k: v - before[k] for k, v in pred.counters.items()}


def test_counters_rise_by_each_calls_syncs():
    cold = _pred()
    batch = _batch()
    # a new geometry each call counts anew; the same one takes its cached k
    for kind, step in (("cold", 0.01), ("cold", 0.0), ("dense", 0.0)):
        assert _delta(cold, lambda: cold.predict_batch(batch)) == dict(
            calls=1, host_syncs=SYNCS[kind], skin_rebuilds=0), kind
        batch.xyz[0, :300] += step
    small = pad_molecules([water_box(4, seed=2)], table_for_n_elems(10))
    assert _delta(cold, lambda: cold.predict_batch(small)) == dict(
        calls=1, host_syncs=SYNCS["dense"], skin_rebuilds=0)

    skin = _pred(reuse_neighbors=True, neighbor_skin=0.5)
    steps = [("rebuild", 0.01), ("reuse", 0.01), ("reuse", 0.0),
             ("rebuild", None)]
    for kind, step in steps:
        if step is None:        # one atom past skin/2: a new selection
            batch.xyz[0, 0] += 0.3
        got = _delta(skin, lambda: skin.predict_batch(batch))
        assert got == dict(calls=1, host_syncs=SYNCS[kind],
                           skin_rebuilds=int(kind == "rebuild")), kind
        if step:
            batch.xyz[0, :300] += step
    assert skin.counters["skin_rebuilds"] == skin.skin_rebuilds == 2
    # the counters are a snapshot: editing one changes nothing
    skin.counters["calls"] = 0
    assert skin.counters["calls"] == len(steps)


def test_export_and_flop_count_under_the_profiler(tmp_path):
    """While a profiler records, a serving export traces the graph it
    traces without one (no profiler operator in it) and serves the live
    charges, and ``count_flops`` counts the same products."""
    pred = _pred()
    batch = _batch(n_mol=90, seed=3)

    def graph(path):
        art = load_serving(str(path))
        return art, [str(n.target) for n in art._program.graph.nodes]

    export_predictor(pred, batch, str(tmp_path / "off"), mode="blocked")
    with profile(activities=[ProfilerActivity.CPU]):
        export_predictor(pred, batch, str(tmp_path / "on"), mode="blocked")
        flops_on = pred.benchmark_batch(batch, iters=1, warmup_loops=1,
                                        cost_analysis=True)["flops"]
    (art, on), (_, off) = graph(tmp_path / "on"), graph(tmp_path / "off")
    assert on == off
    assert not any("profiler" in t for t in on)
    np.testing.assert_array_equal(
        art(batch.x, batch.q0, batch.xyz, batch.node_mask),
        pred.predict_batch(batch))
    flops_off = pred.benchmark_batch(batch, iters=1, warmup_loops=1,
                                     cost_analysis=True)["flops"]
    assert flops_on == flops_off > 0


def test_span_records_only_under_a_profiler():
    def names(fn):
        return [s[2] for s in _profiled(fn)[1]]

    def body():
        with timing.span("epnn.a", 3):
            with timing.span("epnn.b"):
                pass

    assert timing.span("epnn.a") is timing.span("epnn.b")   # the null one
    assert names(body) == ["epnn.a", "epnn.b"]

    @timing.spanned("epnn.c")
    def f(x):
        return x + 1

    assert f(1) == 2
    assert names(lambda: f(1)) == ["epnn.c"]

    def timed():
        t = timing.Timer()
        with t.span("epnn.timer"):
            pass
        return t

    t, spans = _profiled(timed)
    assert [s[2] for s in spans] == ["epnn.timer"]
    assert len(t.spans["epnn.timer"]) == 1


def test_span_is_null_where_a_mode_traces():
    """Under a dispatch mode (export's proxy and fake modes, a
    ``FlopCounterMode``) a span records nothing, profiler or not."""
    from torch.utils.flop_counter import FlopCounterMode

    null = timing.span("epnn.a")
    with profile(activities=[ProfilerActivity.CPU]):
        assert timing.span("epnn.a") is not null
        with FlopCounterMode(display=False):
            assert timing.span("epnn.a") is null
