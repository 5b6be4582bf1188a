"""Benchmark and timing helpers (counterpart of
``epnn_tpu/utils/timing.py``), in the torch idiom.

PyTorch returns from a CUDA call before the device finishes, so every
measured call ends in a synchronization: :func:`benchmark_fn` synchronizes
the device after each call, and :func:`benchmark_chained` ends its loop in
one device→host readback.  Warm-up calls run first (they load the kernel
libraries and fill the caches).  ``profile_dir`` writes a
``torch.profiler`` chrome trace of the measured loop; ``cost_analysis``
counts the measured call's products (:func:`count_flops`).

:func:`span` is the port's one span primitive: a ``record_function`` in
the profiler's own trace while a ``torch.profiler`` session records, and
nothing else (one flag check) while none does.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Callable, Optional

import numpy as np
import torch


_NULL_SPAN = contextlib.nullcontext()


def tracing() -> bool:
    """Whether ``torch.export``, ``torch.compile`` or a dispatch mode (a
    ``FlopCounterMode``, export's proxy mode) traces the calling code: a
    ``record_function`` there would become an operator of the graph, and
    a kernel call goes through its registered operator
    (``ops.kernels._traced``)."""
    return (torch._C._len_torch_dispatch_stack() > 0
            or torch.compiler.is_compiling())


def span(name: str, args=None):
    """A span named ``name`` around a ``with`` block: while a
    ``torch.profiler`` session records, ``torch.profiler.record_function(
    name, str(args))``, a host annotation in the same trace as the
    device's kernels and copies, on its clock, nested in the spans open
    on the calling thread; otherwise, and wherever :func:`tracing`, a
    shared null context, after one check of the profiler's state."""
    if not torch._C._autograd._profiler_enabled() or tracing():
        return _NULL_SPAN
    return torch.profiler.record_function(
        name, None if args is None else str(args))


def spanned(name: str):
    """A decorator: every call of the function runs in :func:`span`
    ``(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


class Timer:
    """Named host-clock spans (``perf_counter`` seconds, every span kept),
    the JAX package's ``Timer``; each is also a :func:`span` of the same
    name, so it shows in a profiler trace."""

    def __init__(self):
        self.spans = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        with span(name):
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


def count_flops(fn: Callable, *args, **kwargs) -> int:
    """The products of one call ``fn(*args, **kwargs)``, 2 FLOP a
    multiply-add, as ``torch.utils.flop_counter.FlopCounterMode`` counts
    them: matrix products and contractions only, no elementwise work (XLA's
    ``cost_analysis`` counts that too, so the JAX package's ``flops`` of
    the same graph reads higher).  The port's CUDA kernels are
    ``epnn_torch::`` operators whose flop formulas give the model's count
    (``ops.kernels.work``: what their float32 plain versions' products are
    on the whole pair grid, not the live pairs a kernel visits, and one
    product where 3xTF32 runs three), and under the counter a call goes
    through them (``kernels._traced``): the same count on the CPU and on
    the card, through a kernel or its plain version."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    return counter.get_total_flops()


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
    ``warmup_loops`` full loops run first.  ``cost_analysis`` adds
    ``flops``, the products of one more call after the timing
    (:func:`count_flops`; left out where it counts none, as the JAX
    package leaves it out where its count is 0).  Returns ``{"mean_s",
    "iters", "method": "chained", "warmup_loops"}`` (and ``"flops"``)."""

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
    out = {
        "mean_s": dt / iters,
        "iters": iters,
        "method": "chained",
        "warmup_loops": warmup_loops,
    }
    if cost_analysis:
        flops = count_flops(call, q0)
        if flops > 0:
            out["flops"] = float(flops)
    return out


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
