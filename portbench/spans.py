"""The program's own spans in a traced run's profile: the port records a
``torch.profiler`` span ``epnn.predict_batch`` around each call, and
``epnn.predictor.*``, ``epnn.select.*`` and ``epnn.forward.*`` spans
inside it, on the calling thread (``epnn_tpu_torch.utils.timing.span``).
:func:`read` names each idle gap of the card by the innermost ``epnn.*``
span at its middle, and each device record (kernel, copy, fill) by the
innermost span at its launch, found by correlation id.  A program that
records no such span gives no call and nothing by span."""

from __future__ import annotations

import bisect
import sys
import weakref
from typing import Dict, List, Optional, Tuple

from portbench.trace import SHORT_GAP_NS, _merge

PREFIX = "epnn."
ROOT = "epnn.predict_batch"
#: the names of the host's CUDA runtime and driver records, the launches
#: (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ``cuLaunchKernel``, ...):
#: PyTorch 2.11's events carry no activity type to tell them by
LAUNCH_PREFIX = "cu"

_last: list = [None, None]       # (weak reference to a profile, its reading)


def segments(spans: List[Tuple[int, int, str]]) -> list:
    """``[(start, end, name)]`` in time order: the innermost of the nested
    ``spans`` (each ``(start, end, name)``, one thread's) over each stretch
    that some span covers.  A child that outlasts its parent is cut at the
    parent's end."""
    out: list = []
    stack: list = []                 # open spans: (end, name)
    t = 0

    def close_to(upto):
        nonlocal t
        if upto > t:
            out.append((t, upto, stack[-1][1]))
        t = max(t, upto)

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            close_to(stack[-1][0])
            stack.pop()
        if stack:
            close_to(s)
            e = min(e, stack[-1][0])
        t = s
        stack.append((e, name))
    while stack:
        close_to(stack[-1][0])
        stack.pop()
    return out


class Innermost:
    """The innermost span at a time, by interval search over each thread's
    :func:`segments`."""

    def __init__(self, by_thread: Dict[int, list]):
        self.segs = {tid: segments(sp) for tid, sp in by_thread.items()}
        self.starts = {tid: [s for s, _, _ in seg]
                       for tid, seg in self.segs.items()}

    def at(self, t: int, thread: Optional[int] = None) -> Optional[str]:
        """The innermost span over time ``t`` on ``thread`` (on any thread
        where ``thread`` holds no span), or None."""
        tids = [thread] if thread in self.segs else list(self.segs)
        for tid in tids:
            i = bisect.bisect_right(self.starts[tid], t) - 1
            if i >= 0:
                s, e, name = self.segs[tid][i]
                if s <= t < e:
                    return name
        return None


def _add(table: dict, key, value: float) -> None:
    table[key] = table.get(key, 0.0) + value


def read(prof) -> Dict:
    """The ``epnn.*`` spans of a finished ``torch.profiler`` profile:

    - ``calls``: the ``epnn.predict_batch`` spans;
    - ``device_records``: the device's kernels, copies and fills;
    - ``idle_s``: {innermost span at the gap's middle, None outside every
      span: seconds} of the idle gaps of at least ``SHORT_GAP_NS`` between
      the first and the last record (``trace.read``'s gaps);
    - ``device_s``: {innermost span at the launch, None outside every
      span: seconds} of the device records, each matched to its CUDA
      runtime or driver record by correlation id; ``unmatched_s``, those
      without one;
    - ``self_s``: {span: seconds} of host time under a span and under
      none of its child spans.

    Read once a profile."""
    if _last[0] is not None and _last[0]() is prof:
        return _last[1]
    from torch.autograd import DeviceType

    spans: Dict[int, list] = {}
    launches: Dict[int, Tuple[int, int]] = {}
    device, ends = [], []
    for ev in prof.profiler.kineto_results.events():
        start = int(ev.start_ns())
        end = start + int(ev.duration_ns())
        if ev.device_type() != DeviceType.CPU:
            if not ev.is_user_annotation() and end > start:
                device.append((start, end, int(ev.correlation_id())))
                ends.append((start, end))
            continue
        if end > start:
            ends.append((start, end))
        name = ev.name()
        if ev.is_user_annotation():
            if name.startswith(PREFIX):
                spans.setdefault(int(ev.start_thread_id()), []).append(
                    (start, end, name))
        elif name.startswith(LAUNCH_PREFIX):
            launches[int(ev.correlation_id())] = (start,
                                                   int(ev.start_thread_id()))
    inner = Innermost(spans)
    out = {"calls": sum(name == ROOT for sp in spans.values()
                        for _, _, name in sp),
           "device_records": len(device), "idle_s": {}, "device_s": {},
           "unmatched_s": 0.0, "self_s": {}}

    # idle gaps, as trace.read finds them, by the innermost span
    if ends:
        t0 = min(s for s, _ in ends)
        t1 = max(e for _, e in ends)
        edges = ([(t0, t0)] + _merge([(s, e) for s, e, _ in device])
                 + [(t1, t1)])
        for (_, a), (b, _) in zip(edges[:-1], edges[1:]):
            if b - a >= SHORT_GAP_NS:
                _add(out["idle_s"], inner.at((a + b) // 2), (b - a) * 1e-9)

    # device records by the span that launched them
    for s, e, corr in device:
        launch = launches.get(corr)
        if launch is None:
            out["unmatched_s"] += (e - s) * 1e-9
        else:
            _add(out["device_s"], inner.at(*launch), (e - s) * 1e-9)

    # host self time: each stretch's innermost span
    for seg in inner.segs.values():
        for s, e, name in seg:
            _add(out["self_s"], name, (e - s) * 1e-9)

    _last[0], _last[1] = weakref.ref(prof), out
    return out


def under(table: dict, *prefixes: str) -> float:
    """The sum of ``table``'s entries whose span name starts with one of
    ``prefixes``."""
    return sum(v for k, v in table.items()
               if k is not None and k.startswith(prefixes))


def harness() -> Optional[dict]:
    """The locals of the harness's run (``portbench.run.run_cell``) that
    a reader of the program's spans and counters needs and its
    ``Context`` does not carry: the finished profile (``prof_done``) and
    the ``Predictor`` (``pred``); None outside such a run."""
    f = sys._getframe(1)
    while f is not None:
        if "prof_done" in f.f_locals and "pred" in f.f_locals:
            return f.f_locals
        f = f.f_back
    return None


def of_run() -> Optional[Dict]:
    """:func:`read` of the harness's traced profile, or None."""
    loc = harness()
    if loc is None or loc["prof_done"] is None:
        return None
    return read(loc["prof_done"])
