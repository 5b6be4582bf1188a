"""``portbench.spans`` and the readers of the program's spans and
counters: on a synthetic profile, each idle gap goes to the innermost
``epnn.*`` span over its middle (found however many operators the root
span holds), each device record to the span over its launch (matched by
the CUDA runtime's correlation id, not an operator's), and a gap outside
every span to none; the spans leave ``trace.read``'s kernels and busy
time, which the device's readers take, as they are.  A traced CPU run of each cell reports ``host_syncs.*``
as the program counts a call, and nothing from the device trace, and the
metrics it reported before; a program without the spans and counter
reports none of the new metrics and does not fail."""

import types

import pytest
from torch.autograd import DeviceType

from portbench import run, spans, trace
from portbench.tests import small

SEED = 2**34 + 5
ROOT = spans.ROOT
NEW = ("predictor_idle_ms", "forward_idle_ms", "selection_ms", "host_syncs")


class Ev:
    """A kineto event as ``spans.read`` and ``trace.read`` see one."""

    def __init__(self, name, start, end, kind="cpu_op", corr=0, tid=1):
        self._name, self._s, self._e = name, start, end
        self._kind, self._corr, self._tid = kind, corr, tid

    def name(self):
        return self._name

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        return (DeviceType.CUDA if self._kind in ("kernel", "gpu_memcpy")
                else DeviceType.CPU)

    def is_user_annotation(self):
        return self._kind == "user_annotation"

    def correlation_id(self):
        return self._corr

    def start_thread_id(self):
        return self._tid


class _Prof:
    """A finished profile holding ``events``."""

    def __init__(self, events):
        results = types.SimpleNamespace(events=lambda: list(events))
        self.profiler = types.SimpleNamespace(kineto_results=results)


_prof = _Prof


def _span(name, s, e):
    return Ev(name, s, e, "user_annotation")


def _kernel(s, e, corr, launch=None):
    """A kernel and, at ``launch``, its runtime record."""
    out = [Ev(f"k{corr}", s, e, "kernel", corr)]
    if launch is not None:
        out.append(Ev("cudaLaunchKernel", launch, launch + 1_000,
                      "cuda_runtime", corr))
    return out


def _events(with_spans=True):
    """One call, 0–10 ms: 500 operators after its start (their own
    correlation ids 1–500 collide with the kernels'); ``sort_view`` 2–3 ms
    with ``fingerprint`` 2.1–2.3 ms in it; ``select.count`` 4–5 ms."""
    evs = [Ev(f"aten::op{i}", 30_000 + i * 1_000, 30_400 + i * 1_000,
              corr=i + 1) for i in range(500)]
    if with_spans:
        evs += [_span(ROOT, 0, 10_000_000),
                _span("epnn.predictor.sort_view", 2_000_000, 3_000_000),
                _span("epnn.predictor.fingerprint", 2_100_000, 2_300_000),
                _span("epnn.select.count", 4_000_000, 5_000_000)]
    evs += (_kernel(10_000, 21_000, 101, 5_000)
            + _kernel(1_020_000, 2_050_000, 102, 1_010_000)
            + _kernel(2_350_000, 2_400_000, 103, 2_150_000)
            + _kernel(2_600_000, 4_500_000, 104, 2_550_000)
            + _kernel(4_600_000, 9_000_000, 105, 4_500_000)
            + _kernel(10_800_000, 10_900_000, 106, 10_100_000)
            + _kernel(11_000_000, 11_100_000, 107, 10_950_000)
            + _kernel(11_100_000, 11_200_000, 999))
    return evs


def _close(a, b):
    assert set(a) == set(b)
    for k in b:
        assert a[k] == pytest.approx(b[k], abs=1e-12), k


def test_gaps_go_to_the_innermost_span():
    s = spans.read(_prof(_events()))
    assert s["calls"] == 1 and s["device_records"] == 8
    _close(s["idle_s"], {
        ROOT: 0.999e-3 + 1.8e-3,        # 21 us - 1.02 ms, 9 - 10.8 ms
        "epnn.predictor.fingerprint": 0.3e-3,
        "epnn.predictor.sort_view": 0.2e-3,
        "epnn.select.count": 0.1e-3,
        None: 0.1e-3})                   # 10.9 - 11 ms: after the call
    _close(s["self_s"], {ROOT: 8e-3, "epnn.predictor.sort_view": 0.8e-3,
                         "epnn.predictor.fingerprint": 0.2e-3,
                         "epnn.select.count": 1e-3})


def test_a_gap_under_a_root_far_back():
    """Over the middles of the two gaps in the root alone (520.5 us, 9.9
    ms) more than 400 operators have started since the root did:
    ``trace.read``'s look-back misses the root, the interval search finds
    it."""
    evs = _events()
    named = trace.read(_prof(evs))["gaps"]
    assert named[trace.NO_OP] == pytest.approx(2.799e-3, abs=1e-12)
    assert spans.read(_prof(evs))["idle_s"][ROOT] == pytest.approx(
        2.799e-3, abs=1e-12)


def test_kernels_go_to_their_launching_span():
    s = spans.read(_prof(_events()))
    _close(s["device_s"], {ROOT: 11e-6 + 1.03e-3,
                           "epnn.predictor.fingerprint": 50e-6,
                           "epnn.predictor.sort_view": 1.9e-3,
                           "epnn.select.count": 4.4e-3,
                           None: 0.2e-3})
    assert s["unmatched_s"] == pytest.approx(0.1e-3, abs=1e-12)
    assert spans.under(s["device_s"], "epnn.select.") == pytest.approx(4.4e-3)
    assert spans.under(s["idle_s"], "epnn.predictor.") == pytest.approx(
        0.5e-3)


def test_spans_leave_the_device_table_as_it_was():
    with_, without = (trace.read(_prof(_events(w))) for w in (True, False))
    assert with_["kernels"] == without["kernels"]
    assert with_["busy_s"] == without["busy_s"]


def test_no_span_no_call():
    s = spans.read(_prof(_events(with_spans=False)))
    assert s["calls"] == 0 and s["idle_s"] == {None: pytest.approx(
        sum(spans.read(_prof(_events()))["idle_s"].values()))}


def test_segments_nest_and_cut():
    assert spans.segments([(0, 10, "a"), (2, 4, "b"), (3, 12, "c"),
                           (20, 30, "d")]) == [
        (0, 2, "a"), (2, 3, "b"), (3, 4, "c"), (4, 10, "a"),
        (20, 30, "d")]


def _capture(monkeypatch) -> list:
    """The ``Context``s the harness makes, as it makes them."""
    made = []

    class Seen(run.Context):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(run, "Context", Seen)
    return made


def _existing(r, ctx) -> dict:
    """The metrics of ``r`` that the cell had before these, each checked
    to be what its reader, unchanged, reads from the run's ``Context``:
    the harness feeds the readers as it did."""
    got = {k: v["value"] for k, v in r["metrics"].items()
           if not k.startswith(NEW)}
    names = [m["name"] for m in run.load_cell(r["cell"])["per_layer"]
             if not m["name"].startswith(NEW)]
    want = {n: run.reader(n).read(ctx) for n in names}
    assert got == {n: v for n, v in want.items() if v is not None}
    return got


def _traced(workload, monkeypatch, seconds=2.0):
    """A traced CPU run; its Context, the run's Predictor and, a call, its
    counters before and after and the selections so far."""
    from epnn_tpu_torch import infer

    made, calls = [], []

    class Spy(infer.Predictor):
        def __post_init__(self):
            super().__post_init__()
            made.append(self)

        def predict_batch(self, batch):
            before = getattr(self, "counters", None)
            q = super().predict_batch(batch)
            calls.append((before, getattr(self, "counters", None),
                          self.skin_rebuilds))
            return q

    monkeypatch.setattr(infer, "Predictor", Spy)
    ctxs = _capture(monkeypatch)
    r = run.run_cell(small.spec(workload, 100), SEED, seconds, True, "cpu")
    assert r["correct"], r["checks"]
    r["cell"] = workload
    return r, ctxs[0], made[0], calls


@pytest.mark.parametrize("workload", small.CELLS)
def test_traced_cpu_run_reads_the_counter(workload, monkeypatch):
    r, ctx, pred, calls = _traced(workload, monkeypatch)
    suffix = ".cold" if workload == small.CELLS[0] else ".md"
    got = {k: v["value"] for k, v in r["metrics"].items()}
    # the device trace's readers find no device on the CPU
    assert not any(k.startswith(NEW[:3]) for k in got)
    # a call's syncs as the program tests count them: 8 a cold call; 5 a
    # reused skin frame, 10 a rebuilt one
    per = [a["host_syncs"] - b["host_syncs"] for b, a, _ in calls]
    rebuilt = [calls[0][2]] + [c[2] - p[2] for p, c in zip(calls, calls[1:])]
    if suffix == ".cold":
        assert set(per) == {8}
    else:
        assert per == [10 if n else 5 for n in rebuilt]
    c = pred.counters
    assert got["host_syncs" + suffix] == c["host_syncs"] / c["calls"]
    assert c["calls"] == len(calls)
    # the metrics the cell reported before, read as before
    before = _existing(r, ctx)
    if suffix == ".md":
        window = rebuilt[-r["attempted"]:]
        assert before["rebuild_share.md"] == pytest.approx(
            100.0 * sum(window) / r["attempted"])


@pytest.mark.parametrize("workload", small.CELLS)
def test_a_program_without_spans_reports_none_of_them(workload,
                                                       monkeypatch):
    """The parent's program: no span recorded, no ``counters``."""
    import contextlib

    from epnn_tpu_torch import infer
    from epnn_tpu_torch.ops import fused
    from epnn_tpu_torch.utils import timing

    for mod in (timing, infer, fused):
        monkeypatch.setattr(mod, "span",
                            lambda *a, **k: contextlib.nullcontext())
    monkeypatch.delattr(infer.Predictor, "counters")
    ctxs = _capture(monkeypatch)
    r = run.run_cell(small.spec(workload, 100), SEED, 1.0, True, "cpu")
    assert r["correct"]
    assert not any(k.startswith(NEW) for k in r["metrics"])
    r["cell"] = workload
    _existing(r, ctxs[0])
