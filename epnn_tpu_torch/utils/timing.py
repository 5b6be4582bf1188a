"""Benchmark and timing helpers (counterpart of
``epnn_tpu/utils/timing.py``), in the torch idiom.

PyTorch returns from a CUDA call before the device finishes, so every
measured call ends in a synchronization: :func:`benchmark_fn` synchronizes
the device after each call, and :func:`benchmark_chained` ends its loop in
one device→host readback.  Warm-up calls run first (they load the kernel
libraries and fill the caches).  ``profile_dir`` writes a
``torch.profiler`` chrome trace of the measured loop.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import numpy as np
import torch


class Timer:
    def __init__(self):
        self.spans = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        yield
        self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def total(self, name: str) -> float:
        return sum(self.spans.get(name, []))


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for item in out:
            yield from _tensors(item)
    elif isinstance(out, dict):
        for item in out.values():
            yield from _tensors(item)


def block_until_ready(out):
    """Wait for the CUDA devices that hold any tensor of ``out`` (a
    tensor, or tuples, lists and dicts of them); other values, such as
    NumPy arrays already copied to the host, need no wait.  Returns
    ``out``."""
    for dev in {t.device for t in _tensors(out) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return out


def _trace(profile_dir: Optional[str]):
    """A ``torch.profiler`` context that writes ``profile_dir/trace.json``
    (CUDA activity too where a card is present), or a null context."""
    if not profile_dir:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    return profile(activities=activities,
                   on_trace_ready=lambda prof: prof.export_chrome_trace(path))


@torch.no_grad()
def benchmark_chained(
    fn: Callable,
    q0,
    iters: int = 20,
    warmup_loops: int = 2,
    profile_dir: Optional[str] = None,
    operands=None,
    cost_analysis: bool = False,
):
    """Serialized-chain latency, as the JAX package measures it: ``iters``
    calls issued back to back, each call's ``q0`` carrying a zero-weighted
    dependency on the previous output (``q0 + 0.0 * prev.reshape(-1)[:1]``,
    so the chain serializes on the device), and one synchronizing
    device→host readback ending the loop; total / iters is the per-call
    latency with the host's launches pipelined behind the device.

    ``fn(q0) -> out`` (or ``fn(q0, operands)`` when ``operands`` is given)
    takes the chained tensor as its first argument and returns a tensor.
    ``warmup_loops`` full loops run first.  ``cost_analysis`` adds no
    ``flops`` key: PyTorch has no counterpart of XLA's cost model (the JAX
    package also leaves the key out when its analysis fails).  Returns
    ``{"mean_s", "iters", "method": "chained", "warmup_loops"}``."""
    del cost_analysis

    def call(prev):
        q0_in = q0 + 0.0 * prev.reshape(-1)[:1]
        return fn(q0_in) if operands is None else fn(q0_in, operands)

    def loop():
        prev = q0
        for _ in range(iters):
            prev = call(prev)
        prev.cpu()  # the terminal readback: a true sync

    for _ in range(max(warmup_loops, 1)):
        loop()
    with _trace(profile_dir):
        t0 = time.perf_counter()
        loop()
        dt = time.perf_counter() - t0
    return {
        "mean_s": dt / iters,
        "iters": iters,
        "method": "chained",
        "warmup_loops": warmup_loops,
    }


def benchmark_fn(
    fn: Callable,
    *args,
    warmup: int = 2,
    iters: int = 10,
    profile_dir: Optional[str] = None,
):
    """Time ``fn(*args)`` call by call, the device synchronized after each
    (:func:`block_until_ready`).  Returns mean/median/min/std seconds over
    ``iters`` calls.  Each call pays its host-side launches in full; the
    steady-state serving latency is :func:`benchmark_chained`'s."""
    for _ in range(warmup):
        block_until_ready(fn(*args))
    times = []
    with _trace(profile_dir):
        for _ in range(iters):
            t0 = time.perf_counter()
            block_until_ready(fn(*args))
            times.append(time.perf_counter() - t0)
    t = np.asarray(times)
    return {
        "mean_s": float(t.mean()),
        "median_s": float(np.median(t)),
        "min_s": float(t.min()),
        "std_s": float(t.std()),
        "iters": iters,
    }
