"""The traced run's reading of ``torch.profiler``: device time by kernel
name, the device's busy time (the union of its kernels and copies) in the
traced window, and the idle gaps named by the host operation in flight
at their middle."""

from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

#: gaps shorter than this are summed under one name
SHORT_GAP_NS = 20_000
SHORT_GAP = "gaps under 20 us"
NO_OP = "host Python between operators"


def profiler(device):
    """A ``torch.profiler.profile`` of the host and, on a card, of the
    device."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts, record_shapes=False, with_stack=False)


def _events(prof):
    """[(is_device, name, start_ns, end_ns)] of the profile's kineto
    events, without the device-side shadows of host spans."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.profiler.kineto_results.events():
        dev = ev.device_type() != DeviceType.CPU
        if dev and ev.is_user_annotation():
            continue
        start = int(ev.start_ns())
        out.append((dev, ev.name(), start, start + int(ev.duration_ns())))
    return out


def _merge(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def read(prof) -> Dict:
    """``{"kernels": {name: s}, "busy_s", "gaps": {what: s}}`` of a
    finished profile, from its first event to its last."""
    evs = _events(prof)
    dev = [(n, s, e) for d, n, s, e in evs if d and e > s]
    host = [(s, e, n) for d, n, s, e in evs if not d and e > s]
    t0_ns = min([s for _, s, _ in dev] + [s for s, _, _ in host] or [0])
    t1_ns = max([e for _, _, e in dev] + [e for _, e, _ in host] or [0])
    kernels: Dict[str, float] = {}
    spans = []
    for name, s, e in dev:
        kernels[name] = kernels.get(name, 0.0) + (e - s) * 1e-9
        spans.append((s, e))
    busy = _merge(spans)
    busy_s = sum(e - s for s, e in busy) * 1e-9
    # idle gaps, each named by the innermost host operation at its middle
    host.sort()
    starts = [s for s, _, _ in host]
    gaps: Dict[str, float] = {}
    edges = [(t0_ns, t0_ns)] + busy + [(t1_ns, t1_ns)]
    for (_, a), (b, _) in zip(edges[:-1], edges[1:]):
        if b <= a:
            continue
        if b - a < SHORT_GAP_NS:
            what = SHORT_GAP
        else:
            mid = (a + b) // 2
            what = NO_OP
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 400, -1), -1):
                s, e, name = host[j]
                if e >= mid:
                    what = name
                    break
        gaps[what] = gaps.get(what, 0.0) + (b - a) * 1e-9
    return {"kernels": kernels, "busy_s": busy_s, "gaps": gaps}


#: longer kernel names (C++ signatures) are cut to this many characters
NAME_CHARS = 120


def top(table: Dict[str, float], n: int = 10) -> list:
    """The ``n`` largest entries, ``[[name, seconds], ...]``."""
    return [[k[:NAME_CHARS], v] for k, v in sorted(
        table.items(), key=lambda kv: -kv[1])[:n]]


