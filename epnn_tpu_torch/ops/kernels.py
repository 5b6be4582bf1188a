"""The hand-written CUDA kernels of the blocked forwards and of neighbor
selection, each with its plain PyTorch version (counterpart of
``epnn_tpu/ops/pallas_kernels.py``).

* ``dense_message_rowsum`` — ``csrc/dense_message_rowsum.cu``, replaces
  ``epnn_tpu/ops/pallas_kernels.py:98``;
* ``dense_message_rowsum_int8`` — ``csrc/dense_message_rowsum_int8.cu``,
  the same far field in the int8 serving tier, replaces the int8 body of
  ``_msg_kernel`` (``pallas_kernels.py:59-75``);
* ``near_message_corr`` — ``csrc/near_message_corr.cu``, replaces
  ``pallas_kernels.py:1286``;
* ``near_pass_rowsum`` — ``csrc/near_pass_rowsum.cu``, replaces
  ``pallas_kernels.py:1410``;
* ``dense_message_rowsum_bwd`` — ``csrc/dense_message_rowsum_bwd.cu``, the
  backward of the far field, replaces ``_dmr_bwd`` (``pallas_kernels.py:1079``);
* ``fused_message_rowsum`` — ``csrc/fused_message_rowsum.cu``, a dense
  message round with the featurization in the tile, replaces
  ``pallas_kernels.py:490``;
* ``fused_epn_rowsum`` — ``csrc/fused_epn_rowsum.cu``, a dense
  electron-passing round, replaces ``pallas_kernels.py:368``;
* ``neighbor_compact`` — ``csrc/neighbor_compact.cu``, the within-cutoff
  neighbor list in one pass, replaces ``pallas_kernels.py:685``.

Every kernel but ``neighbor_compact`` (which has no products) is a
registered operator ``epnn_torch::<name>`` (``torch.library.custom_op``,
:data:`_OPS`): each has a shape function, one body for CPU and CUDA
tensors (the plain version, or the launch), its VJP registered on the
operator, and a flop formula (:func:`work`: the products of its float32
plain version on the whole grid, what ``FlopCounterMode`` counts of an
operator).  ``torch.export``, ``torch.compile`` and a dispatch mode such
as ``FlopCounterMode`` see the operators; eager calls, serving and
training, run the same bodies and VJPs without the dispatcher's host
cost (:func:`_call`).  The far field's backward, in both tiers (int8
straight through), is the ``dense_message_rowsum_bwd`` kernel; the two
near kernels' backwards recompute through their plain versions, as the
JAX package's custom VJPs recompute through their XLA twins.  An
exported program names the operators, so a loaded artifact launches (and
counts) the kernels as an eager call does.  The two fused dense kernels
are inference-only, as in the JAX package: their backward raises.  They
take the JAX kernels' ``rbf_method``: "direct" (an exp a channel) or
"doubling" (two exps a pair, :func:`envelope_rbf_doubling`), a run-time
argument of one library.

Each wrapper takes tensors on one device.  On the CPU it runs the plain
version (``*_plain``); on a CUDA tensor it launches the kernel on the
current stream or raises — there is no fallback.  The kernels take one
mid layer at any mid width H and RBF width E; where a padded width passes
:data:`NARROW_WIDTH` a library takes the wide path (``csrc/wide.cuh``:
output columns in chunks, every contraction streamed).  The three plain
versions of the neighbor split also take any number of mid layers, which
is how ``ops.fused`` runs rounds of another depth (JAX's XLA branches).
Every launch adds one to :data:`LAUNCHES`, so a run can show which kernels
it went through.

The kernels are CUDA C++ for ``sm_90a`` with a plain C interface, built by
``nvcc`` into shared libraries under ``build/epnn_tpu_torch/`` of the
checkout on first use and loaded with ``ctypes``: one library per kernel
and width (H, and E where the kernel takes one), compiled with the widths
as constants (``EPNN_H``, ``EPNN_E``; ``csrc/common.cuh``), so the shipped
H = 32, E = 48 build has no tail test.  The products run at the widths
padded to the tensor cores' granularity (:func:`padded_width`), on weights
zero-padded once per set of weights (:func:`pad_weights`, or per call
where the caller keeps none); activations are read at their real width.
:func:`build` compiles all of them in parallel.  Nothing is built when
this module is imported.
The six tensor-core kernels (the far field, its backward, the two near
kernels and the two fused dense kernels) take the JAX kernels' ``precision``
keyword, with JAX's default ``"default"``.  On the card it selects the
library's TF32 tier (:data:`TIERED`, :func:`tf32_passes`): ``"high"`` and
``"highest"`` run 3xTF32 (each operand split into two TF32 parts, three
products, fp32 accumulation: float32-grade; ``*_3xtf32_plain`` repeat
that arithmetic on any device), ``"default"`` one TF32 product a k-step
of operands rounded to nearest (~2^-11 relative; ``*_tf32_plain`` repeat
it), from a library compiled with ``-DEPNN_TF32_PASSES=1`` — each tier
its own library, built at first use like the others, and no tier falls
back to the other.  On the CPU every precision runs the float32 plain
version, as XLA:CPU runs ``"default"``.  The int8 far field, the JAX
package's fast serving tier, is the exception: its plain version repeats
its quantization exactly (the integer products are exact in float32).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

# the featurization the plain versions share with the dense model (both
# RBF methods' channels importable from here, beside the kernels)
from epnn_tpu_torch.featurize import (  # noqa: F401
    check_rbf_method, doubling_u_scale, envelope_rbf, envelope_rbf_doubling,
    envelope_rbf_method, hard_gate, pair_d2, rbf_table)
from epnn_tpu_torch.utils.timing import tracing

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "epnn_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: kernel name -> its CUDA source (and its C entry point ``epnn_<name>``)
SOURCES = {
    "dense_message_rowsum": "dense_message_rowsum.cu",
    "dense_message_rowsum_int8": "dense_message_rowsum_int8.cu",
    "near_message_corr": "near_message_corr.cu",
    "near_pass_rowsum": "near_pass_rowsum.cu",
    "dense_message_rowsum_bwd": "dense_message_rowsum_bwd.cu",
    "fused_message_rowsum": "fused_message_rowsum.cu",
    "fused_epn_rowsum": "fused_epn_rowsum.cu",
    "neighbor_compact": "neighbor_compact.cu",
}

#: kernel launches since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}

#: the tensor-core kernels, which take a ``precision``: each has a library
#: per TF32 tier
TIERED = ("dense_message_rowsum", "dense_message_rowsum_bwd",
          "near_message_corr", "near_pass_rowsum", "fused_message_rowsum",
          "fused_epn_rowsum")
#: JAX's precision names -> TF32 products a k-step (``EPNN_TF32_PASSES``)
_PASSES = {"default": 1, "high": 3, "highest": 3}

#: the shipped model's widths (mid width H, RBF width E): the libraries
#: :func:`build` makes by default
KERNEL_H = 32
KERNEL_E = 48
#: the widest padded H and E of the narrow designs; past it a library is
#: compiled for the wide path (``csrc/common.cuh``'s ``EPNN_WIDE``)
NARROW_WIDTH = 64
#: which widths each kernel's library is compiled for: H and E, H only,
#: or none
_WIDTHS_OF = {
    "dense_message_rowsum": "h", "dense_message_rowsum_int8": "h",
    "dense_message_rowsum_bwd": "h", "near_message_corr": "he",
    "near_pass_rowsum": "he", "fused_message_rowsum": "he",
    "fused_epn_rowsum": "he", "neighbor_compact": "",
}

_LIBS: Dict[tuple, ctypes.CDLL] = {}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {
    "dense_message_rowsum": [_P] * 7 + [_I] * 5 + [_P],
    "dense_message_rowsum_int8": [_P] * 11 + [_I] * 5 + [_P],
    "near_message_corr": [_P] * 9 + [_I] * 4 + [_P],
    "near_pass_rowsum": [_P] * 9 + [_I] * 4 + [_P],
    "dense_message_rowsum_bwd": [_P] * 11 + [_I] * 7 + [_P],
    "fused_message_rowsum": [_P] * 12 + [_I] * 7 + [_F] * 4 + [_P],
    "fused_epn_rowsum": [_P] * 10 + [_I] * 5 + [_F] * 5 + [_P],
    "neighbor_compact": [_P] * 5 + [_I] * 4 + [_F] + [_P],
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def tf32_passes(precision: str) -> int:
    """The TF32 tier of a tensor-core kernel at JAX's ``precision``: 1
    product a k-step for ``"default"``, 3 (3xTF32) for ``"high"`` and
    ``"highest"`` (JAX's ``_dmr_bwd`` runs ``"high"`` as HIGHEST,
    ``pallas_kernels.py:1091-1095``)."""
    try:
        return _PASSES[precision]
    except KeyError:
        raise ValueError(f"precision {precision!r}: one of "
                         f"{tuple(_PASSES)}") from None


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ on first use")


def lib_widths(name: str, h: Optional[int] = KERNEL_H,
               e: Optional[int] = KERNEL_E) -> tuple:
    """The widths ``name``'s library is compiled for, given the call's H
    and E: ``(h, e)``, ``(h,)`` or ``()``."""
    return tuple(w for w, k in ((h, "h"), (e, "e")) if k in _WIDTHS_OF[name])


def _lib_path(name: str, widths: tuple, passes: int = 3) -> Path:
    flags = _flags(name, widths, passes)
    h = hashlib.sha256(" ".join(flags).encode())
    for src in (SOURCES[name], "common.cuh", "far_field.cuh", "wide.cuh"):
        h.update((CSRC / src).read_bytes())
    tag = "".join(f"-{k}{w}" for k, w in zip(_WIDTHS_OF[name], widths))
    if passes != 3:
        tag += f"-tf32x{passes}"
    return BUILD_DIR / f"lib{name}{tag}-{h.hexdigest()[:12]}.so"


def _flags(name: str, widths: tuple, passes: int = 3) -> list:
    """``nvcc``'s flags for ``name``'s library: the widths, and the TF32
    tier where it is not 3xTF32 (``common.cuh``'s default)."""
    if passes != 3 and name not in TIERED:
        raise ValueError(f"{name} has no TF32 tier")
    tier = [] if passes == 3 else [f"-DEPNN_TF32_PASSES={passes}"]
    return NVCC_FLAGS + [f"-DEPNN_{k.upper()}={w}" for k, w in
                         zip(_WIDTHS_OF[name], widths)] + tier


def build(names: Optional[Iterable[str]] = None,
          widths: Iterable[Tuple[int, int]] = ((KERNEL_H, KERNEL_E),),
          precisions: Iterable[str] = ("highest",)) -> float:
    """Compile the named kernels (default: all) at each (H, E) of
    ``widths`` (default: the shipped model's) and at the TF32 tier of each
    of ``precisions`` (default: 3xTF32; a kernel of no tier builds once),
    one ``nvcc`` per library, all started together; libraries already
    built from the same sources, widths and tier are kept.  Returns the
    wall seconds taken.  Compiler output (with ``-Xptxas -v`` register and
    spill counts) goes to ``<lib>.log``."""
    t0 = time.perf_counter()
    names = list(SOURCES if names is None else names)
    tiers = sorted({tf32_passes(p) for p in precisions}, reverse=True)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs, seen = [], set()
    for name in names:
        for h, e in widths:
            for passes in tiers if name in TIERED else (3,):
                key = lib_widths(name, h, e)
                lib = _lib_path(name, key, passes)
                if (name, key, passes) in seen or lib.exists():
                    continue
                seen.add((name, key, passes))
                tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
                log = open(lib.with_suffix(".log"), "w")
                cmd = [_nvcc(), *_flags(name, key, passes), "-o", str(tmp),
                       str(CSRC / SOURCES[name])]
                jobs.append((name, key, lib, tmp, log,
                             subprocess.Popen(cmd, stdout=log,
                                              stderr=subprocess.STDOUT)))
    failed = []
    for name, key, lib, tmp, log, proc in jobs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, lib)
        else:
            tail = Path(log.name).read_text()[-4000:]
            failed.append(f"{name} {key} (nvcc rc={rc}):\n{tail}")
    if failed:
        raise RuntimeError("kernel build failed: " + ", ".join(failed))
    return time.perf_counter() - t0


def build_log(name: str, h: int = KERNEL_H, e: int = KERNEL_E,
              precision: str = "highest") -> str:
    path = _lib_path(name, lib_widths(name, h, e),
                     tf32_passes(precision)).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def _lib(name: str, h: Optional[int] = KERNEL_H,
         e: Optional[int] = KERNEL_E, passes: int = 3) -> ctypes.CDLL:
    widths = lib_widths(name, h, e)
    lib = _LIBS.get((name, widths, passes))
    if lib is None:
        path = _lib_path(name, widths, passes)
        if not path.exists():
            build([name], [(h, e)],
                  ["default" if passes == 1 else "highest"])
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, f"epnn_{name}")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _LIBS[(name, widths, passes)] = lib
    return lib


def _check(name: str, tensors: dict, shapes: dict) -> torch.device:
    """One device, float32, contiguous, the given shapes (None = free)."""
    device = None
    for key, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {key} must be a tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, not {device}")
        want = shapes[key]
        if t.dim() != len(want) or any(
                w is not None and w != s for w, s in zip(want, t.shape)):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {want}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")
    return device


def _launch(name: str, device: torch.device, tensors, scalars,
            vector_read, h: Optional[int] = None,
            e: Optional[int] = None, passes: int = 3) -> None:
    """``tensors``: the C entry's pointers, in order (None: a null
    pointer).  ``scalars``: its int and float arguments, in order.
    ``vector_read``: the tensors the kernel reads as float4, which must
    start on a 16-byte boundary; the others are read one float at a time
    and may be any view (a row of a batch, for one).  ``h``, ``e``: the
    widths of the library to launch; ``passes``: its TF32 tier."""
    for key, t in vector_read.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} is read as float4 and must "
                             "start on a 16-byte boundary")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(_lib(name, h, e, passes), f"epnn_{name}")(
            *[None if t is None else t.data_ptr() for t in tensors],
            *scalars, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[name] += 1


def padded_width(n: int, step: int = 8) -> int:
    """``n`` rounded up to a multiple of ``step``: the width a kernel's
    products run at (8: the TF32 tensor cores' N and K; 32: the int8
    product's K)."""
    return -(-n // step) * step


def wide(h: int, e: int = KERNEL_E) -> bool:
    """Whether the library of widths (h, e) takes the wide path: a padded
    width past :data:`NARROW_WIDTH` (the far-field kernels' libraries are
    compiled at the default E)."""
    return max(padded_width(h), padded_width(e)) > NARROW_WIDTH


def _wide_scratch(name: str, like, n: int, h: int, e: int,
                  passes: int = 3):
    """The wide path's scratch of the near kernels and the fused kernels'
    near blocks (``csrc/wide.cuh``: a tile's epart, 16 × Hp floats for
    each warp of the launch of the tier's library), or None below it."""
    if not wide(h, e):
        return None
    return like.new_empty(near_warps(name, n, h, e, passes) * NEAR_TILE
                          * padded_width(h))


def _vector(width: int, h: int, e: int) -> bool:
    """Whether a near kernel at widths (h, e) reads rows of ``width``
    floats as float4 (each thread's share of a row is then whole float4s;
    the wide path reads one float at a time)."""
    return width % 16 == 0 and not wide(h, e)


class KernelWeights(NamedTuple):
    """A round's mid-layer weights as the kernels take them, zero-padded
    to the padded widths: ``w1e`` (Ep, Hp) (None for the far field), ``w2``
    (Hp, Hp), ``b2`` (Hp,).  :func:`pad_weights` makes them."""

    w1e: Optional[torch.Tensor]
    w2: torch.Tensor
    b2: torch.Tensor


def _pad_to(t, shape):
    if tuple(t.shape) == tuple(shape):
        return t
    out = t.new_zeros(shape)
    out[tuple(slice(0, n) for n in t.shape)] = t
    return out


def pad_weights(w2, b2, w1e=None) -> KernelWeights:
    """``w2`` (H, H), ``b2`` (H,), ``w1e`` (E, H) zero-padded to H and E
    rounded up to 8 (:func:`padded_width`): the kernels' products at the
    padded widths give the real ones' results exactly (a padded hidden
    unit is relu(0 + 0) = 0, a padded channel adds 0).  At the shipped
    widths (multiples of 8) the tensors come back as they are, no copy.
    They depend on the weights only: ``ops.fused.pad_kernel_weights`` makes them
    once per set of weights."""
    hp = padded_width(w2.shape[0])
    if w1e is not None:
        w1e = _pad_to(w1e, (padded_width(w1e.shape[0]), hp)).contiguous()
    return KernelWeights(w1e, _pad_to(w2, (hp, hp)).contiguous(),
                         _pad_to(b2, (hp,)).contiguous())


def _kernel_weights(name: str, padded: Optional[KernelWeights], w2, b2,
                    w1e=None) -> KernelWeights:
    """The caller's padded weights (checked against the real ones'
    shapes and device), or made here."""
    if padded is None:
        return pad_weights(w2, b2, w1e)
    h = w2.shape[0]
    hp = padded_width(h)
    want = {"w2": (hp, hp), "b2": (hp,)}
    if w1e is not None:
        want["w1e"] = (padded_width(w1e.shape[0]), hp)
    for key, shape in want.items():
        t = getattr(padded, key)
        if (not isinstance(t, torch.Tensor) or tuple(t.shape) != shape
                or t.dtype != torch.float32 or t.device != w2.device
                or not t.is_contiguous()):
            raise ValueError(f"{name}: padded.{key} must be pad_weights(...)"
                             f".{key}, {shape} float32 on {w2.device}")
    return padded


def _given(w1e, w2, b2) -> Optional[KernelWeights]:
    """The padded weights an operator was given as tensors (None: none)."""
    return None if w2 is None else KernelWeights(w1e, w2, b2)


def _padded_args(padded: Optional[KernelWeights], with_w1e: bool) -> tuple:
    """``padded`` as an operator's explicit tensor arguments: ``(w1ep,)``
    where the kernel takes W1e, then ``w2p, b2p`` (Nones for none)."""
    keys = ("w1e", "w2", "b2") if with_w1e else ("w2", "b2")
    return tuple(None if padded is None else getattr(padded, k)
                 for k in keys)


def _plain_rows(r: int, n: int, width: int) -> int:
    """Rows a plain version takes at once, so that no (rows, N, width)
    tensor exceeds 2^24 floats."""
    return max(1, min(r, (1 << 24) // max(1, n * width)))


def _layers(mids):
    """``(W2, b2, W3, b3, ...)`` → ``((W2, b2), (W3, b3), ...)``: the mid
    layers a plain version takes, one pair for the kernels' MLP."""
    if len(mids) % 2:
        raise ValueError("mid layers come as (W, b) pairs")
    return tuple(zip(mids[0::2], mids[1::2]))


def _mid_layers(z, layers, mm):
    """relu(z) through the mid layers: relu(mm(·, W, b)) each."""
    z = torch.relu(z)
    for w, b in layers:
        z = torch.relu(mm(z, w, b))
    return z


# ---------------------------------------------------------------------------
# 1. dense_message_rowsum — the far-field reduction
# ---------------------------------------------------------------------------

#: CUDA block geometry of the far-field kernels (csrc: kRowsPerBlock or
#: kOwnPerBlock, and kChunk): a block owns 64 rows (columns), 16 a warp,
#: and streams the other side in chunks of 32
_DMR_ROWS = 64
_DMR_TILE = 32
#: blocks to aim for: 132 SMs, a few resident blocks each, several waves —
#: the forward (three 4-warp blocks an SM; four at one pass to H = 32) in
#: many short waves, so the last, partly filled one idles little; the
#: backward's passes (two blocks an SM) in fewer, longer blocks, as each
#: block also writes a dW2 partial
_DMR_TARGET_BLOCKS = 16 * 132
_DMR_BWD_TARGET_BLOCKS = 4 * 132


def _mm_fp32(a, b, c=None):
    """``c + a @ b`` in float32 (TF32 off)."""
    return a @ b if c is None else a @ b + c


def tf32_round(x):
    """``x`` (float32) rounded to TF32: nearest, ties away from zero, on the
    low 13 bits of the significand — ``cvt.rna.tf32.f32``, and the same
    integer expression as ``tf32_round`` in ``csrc/common.cuh``.  Values
    already in TF32 come back unchanged; inf and NaN pass through."""
    bits = x.view(torch.int32)
    r = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


def _mm_3xtf32(a, b, c=None):
    """``c + a @ b`` in the far-field kernels' 3xTF32 arithmetic: each
    operand split into hi = tf32(x) and lo = tf32(x − hi), then
    lo·hi + hi·lo + hi·hi, small terms first.  Products of TF32 values are
    exact in float32, so only the summation order differs from the
    tensor cores'."""
    ah = tf32_round(a)
    al = tf32_round(a - ah)
    bh = tf32_round(b)
    bl = tf32_round(b - bh)
    out = al @ bh if c is None else c + al @ bh
    return (out + ah @ bl) + ah @ bh


def _mm_tf32(a, b, c=None):
    """``c + a @ b`` in the kernels' one-pass tier (precision
    ``"default"``): each operand rounded to TF32 (:func:`tf32_round`, as
    the kernels round it before the tensor cores) and one product, whose
    terms are exact in float32, so only the summation order differs from
    the tensor cores'."""
    out = tf32_round(a) @ tf32_round(b)
    return out if c is None else c + out


def _far_rows(pi, pj, col_vec, layers, mm):
    """Σ_j col_vec_j · mids(relu(pi_i + pj_j)) through the mid ``layers``
    with the product ``mm``, row-blocked so no (rows, N, width) tensor
    exceeds 2^24 floats."""
    r, h = pi.shape
    n = pj.shape[0]
    rb = _plain_rows(r, n, max([h] + [w.shape[1] for w, _ in layers]))
    out = pi.new_empty((r, layers[-1][0].shape[1] if layers else h))
    for s in range(0, r, rb):
        hid = _mid_layers(pi[s:s + rb, None, :] + pj[None, :, :], layers, mm)
        out[s:s + rb] = torch.einsum("n,bnh->bh", col_vec, hid)
    return out


def dense_message_rowsum_plain(pi, pj, col_vec, *mids):
    """Σ_j col_vec_j · relu(relu(pi_i + pj_j) @ W2 + b2) as (R, H) in
    float32, row-blocked (the CPU path and the reference).  ``mids`` is
    ``W2, b2``, or any number of mid layers as ``W, b`` pairs (the
    neighbor split's rounds at another depth, JAX's ``dense_scan``,
    ``epnn_tpu/ops/fused.py:1256-1272``)."""
    return _far_rows(pi, pj, col_vec, _layers(mids), _mm_fp32)


def dense_message_rowsum_3xtf32_plain(pi, pj, col_vec, w2, b2):
    """:func:`dense_message_rowsum_plain` with the kernel's arithmetic:
    the mid-layer product in 3xTF32 (``_mm_3xtf32``).  Not on any path:
    the tests and ``chip_smoke.py`` hold the kernel to it (the two may
    differ only by summation order)."""
    return _far_rows(pi, pj, col_vec, ((w2, b2),), _mm_3xtf32)


def dense_message_rowsum_tf32_plain(pi, pj, col_vec, w2, b2):
    """:func:`dense_message_rowsum_plain` with the one-pass kernel's
    arithmetic (``precision="default"``): the mid-layer product of TF32
    operands (``_mm_tf32``).  Not on any path: the tests and
    ``chip_smoke.py`` hold the kernel to it."""
    return _far_rows(pi, pj, col_vec, ((w2, b2),), _mm_tf32)


def _dense_message_splits(r: int, n: int, target: int = _DMR_TARGET_BLOCKS,
                          rows: int = _DMR_ROWS,
                          tile: int = _DMR_TILE) -> tuple:
    """(splits, cols_per_split): the fixed column split of a pair-grid
    kernel's first pass — about ``target`` blocks of ``rows`` rows, whole
    ``tile``-column chunks."""
    row_blocks = -(-r // rows)
    want = max(1, -(-target // row_blocks))
    cols = -(-n // want)
    cols = -(-cols // tile) * tile
    return -(-n // cols), cols


def _dense_message_rowsum_fwd(pi, pj, col_vec, w2, b2, w2p=None, b2p=None,
                              precision="default"):
    """The body of ``epnn_torch::dense_message_rowsum`` (see
    :func:`dense_message_rowsum`): on the CPU the plain version, on the
    card the kernel."""
    name = "dense_message_rowsum"
    passes = tf32_passes(precision)
    r, h = pi.shape
    n = pj.shape[0]
    device = _check(name, dict(pi=pi, pj=pj, col_vec=col_vec, w2=w2, b2=b2),
                    dict(pi=(r, h), pj=(n, h), col_vec=(n,), w2=(h, h),
                         b2=(h,)))
    if device.type == "cpu":
        return dense_message_rowsum_plain(pi, pj, col_vec, w2, b2)
    kw = _kernel_weights(name, _given(None, w2p, b2p), w2, b2)
    out = pi.new_empty((r, h))
    if r == 0:
        return out
    if n == 0:
        return out.zero_()
    splits, cols = _dense_message_splits(r, n)
    part = pi.new_empty((splits, r, h))
    _launch(name, device, (pi, pj, col_vec, kw.w2, kw.b2, part, out),
            (r, n, h, splits, cols), {}, h, passes=passes)
    return out


def _far_bwd_rows(pi, pj, col_vec, w2, b2, g, mm):
    """The four gradients of :func:`_far_rows` with the product ``mm`` for
    the cotangent ``g`` (R, H), written out (no autograd) and row-blocked:

        e2 = col_vec_j · g_i ⊙ 1[z2 > 0]     z̄1 = (e2 @ W2ᵀ) ⊙ 1[z1 > 0]
        dpi = Σ_j z̄1   dpj = Σ_i z̄1   dW2 = Σ relu(z1)ᵀ e2   db2 = Σ e2

    Returns ``(dpi, dpj, dw2, db2)``; col_vec gets no gradient."""
    r, h = pi.shape
    n = pj.shape[0]
    rb = _plain_rows(r, n, h)
    dpi = pi.new_empty((r, h))
    dpj = pj.new_zeros((n, h))
    dw2 = w2.new_zeros((h, h))
    db2 = b2.new_zeros((h,))
    for s in range(0, r, rb):
        z1 = pi[s:s + rb, None, :] + pj[None, :, :]
        a1 = torch.relu(z1)
        z2 = mm(a1, w2, b2)
        e2 = torch.where(z2 > 0, g[s:s + rb, None, :] * col_vec[None, :, None],
                         0.0)
        z1bar = torch.where(z1 > 0, mm(e2, w2.T), 0.0)
        dpi[s:s + rb] = z1bar.sum(1)
        dpj += z1bar.sum(0)
        dw2 += mm(a1.reshape(-1, h).T, e2.reshape(-1, h))
        db2 += e2.sum((0, 1))
    return dpi, dpj, dw2, db2


def dense_message_rowsum_bwd_plain(pi, pj, col_vec, w2, b2, g):
    """``(dpi, dpj, dw2, db2)`` of :func:`dense_message_rowsum_plain` for
    the cotangent ``g`` (R, H), in float32 (see ``_far_bwd_rows``)."""
    return _far_bwd_rows(pi, pj, col_vec, w2, b2, g, _mm_fp32)


def dense_message_rowsum_bwd_3xtf32_plain(pi, pj, col_vec, w2, b2, g):
    """:func:`dense_message_rowsum_bwd_plain` with the backward kernel's
    arithmetic: its three contractions (z2, e2 @ W2ᵀ and the dW2 outer
    product) in 3xTF32 (``_mm_3xtf32``).  Not on any path: the tests and
    ``chip_smoke.py`` hold the kernel to it."""
    return _far_bwd_rows(pi, pj, col_vec, w2, b2, g, _mm_3xtf32)


def dense_message_rowsum_bwd_tf32_plain(pi, pj, col_vec, w2, b2, g):
    """:func:`dense_message_rowsum_bwd_plain` with the one-pass backward
    kernel's arithmetic: its three contractions of TF32 operands
    (``_mm_tf32``).  Not on any path: the tests and ``chip_smoke.py`` hold
    the kernel to it."""
    return _far_bwd_rows(pi, pj, col_vec, w2, b2, g, _mm_tf32)


def _dense_message_rowsum_bwd(pi, pj, col_vec, w2, b2, g, w2p=None,
                              b2p=None, precision="default"):
    """The body of ``epnn_torch::dense_message_rowsum_bwd`` (see
    :func:`dense_message_rowsum_bwd`)."""
    name = "dense_message_rowsum_bwd"
    passes = tf32_passes(precision)
    r, h = pi.shape
    n = pj.shape[0]
    device = _check(name, dict(pi=pi, pj=pj, col_vec=col_vec, w2=w2, b2=b2,
                               g=g),
                    dict(pi=(r, h), pj=(n, h), col_vec=(n,), w2=(h, h),
                         b2=(h,), g=(r, h)))
    if device.type == "cpu":
        return dense_message_rowsum_bwd_plain(pi, pj, col_vec, w2, b2, g)
    kw = _kernel_weights(name, _given(None, w2p, b2p), w2, b2)
    dpi, dpj = pi.new_empty((r, h)), pj.new_empty((n, h))
    dw2, db2 = w2.new_empty((h, h)), b2.new_empty((h,))
    if r == 0 or n == 0:
        return dpi.zero_(), dpj.zero_(), dw2.zero_(), db2.zero_()
    splits_r, cols = _dense_message_splits(r, n, _DMR_BWD_TARGET_BLOCKS)
    splits_c, rows = _dense_message_splits(n, r, _DMR_BWD_TARGET_BLOCKS)
    blocks_r = -(-r // _DMR_ROWS) * splits_r
    work = pi.new_empty(splits_r * r * h + splits_c * n * h
                        + blocks_r * (h * h + h))
    _launch(name, device, (pi, pj, col_vec, kw.w2, kw.b2, g, work, dpi, dpj,
                           dw2, db2),
            (r, n, h, splits_r, cols, splits_c, rows), {}, h, passes=passes)
    return dpi, dpj, dw2, db2


def dense_message_rowsum_bwd(pi, pj, col_vec, w2, b2, g, padded=None,
                             precision="default"):
    """Backward of the far-field reduction (see
    ``csrc/dense_message_rowsum_bwd.cu``): ``(dpi, dpj, dw2, db2)`` for the
    cotangent ``g`` (R, H) of ``out``, with z1 and z2 recomputed in the
    tile.  Deterministic: partial sums are added in a fixed order.
    ``padded``: :func:`pad_weights` of (w2, b2) where the caller keeps it;
    else it is made here.  ``precision``: JAX's ``_dmr_bwd``'s, the TF32
    tier on the card.  The operator
    ``epnn_torch::dense_message_rowsum_bwd``."""
    return tuple(_call("dense_message_rowsum_bwd", pi, pj, col_vec, w2, b2,
                       g, *_padded_args(padded, False), precision))


def dense_message_rowsum(pi, pj, col_vec, w2, b2, padded=None,
                         precision="default"):
    """Far-field message row sums (see ``csrc/dense_message_rowsum.cu``):

        out_i = Σ_j col_vec_j · relu(relu(pi_i + pj_j) @ W2 + b2)

    pi (R, H) carries the first-layer bias; pj (N, H); col_vec (N,) is the
    node mask (clean mode) or ones (reference-compat mode); W2 (H, H);
    b2 (H,).  Rectangular: R need not equal N.  ``padded``:
    :func:`pad_weights` of (w2, b2) where the caller keeps it (made per
    call otherwise; no copy at widths that are multiples of 8).
    ``precision``: JAX's name, the TF32 tier on the card (module
    docstring; float32 on the CPU).  Differentiable in pi, pj, W2 and b2
    through :func:`dense_message_rowsum_bwd` at the same precision, as
    JAX's custom VJP carries it to ``_dmr_bwd`` (``pallas_kernels.py:
    1079``), saving only the inputs.  The operator
    ``epnn_torch::dense_message_rowsum``."""
    return _call("dense_message_rowsum", pi, pj, col_vec, w2, b2,
                 *_padded_args(padded, False), precision)


# ---------------------------------------------------------------------------
# 1b. dense_message_rowsum_int8 — the far field's int8 serving tier
# ---------------------------------------------------------------------------

def _div127(x):
    """x / 127 by true division on every device: PyTorch's CUDA division
    by a Python scalar multiplies by its reciprocal, which can miss by an
    ulp and move a quantization level; JAX and the int8 kernel divide."""
    return x / torch.full((), 127.0, dtype=x.dtype, device=x.device)


def int8_weights(w2):
    """``(w2q, sw)`` of the int8 tier: W2 quantized per output column, as
    the JAX package does outside its kernel (``pallas_kernels.py:1023-
    1026``): sw = max(max|W2[:, c]|, 1e-30) / 127 (H,) float32, w2q =
    clip(round(W2 / sw), ±127) (round half to even) as int8.  They depend
    on the weights only, so ``ops.fused.quantize_far_field`` makes them
    once per set of weights."""
    sw = _div127(torch.clamp(w2.abs().amax(0), min=1e-30))
    w2q = torch.clamp(torch.round(w2 / sw), -127.0, 127.0).to(torch.int8)
    return w2q, sw


def _int8_maxima(pi, pj, pad_pi=None, pad_pj=None):
    """(max(pi), max(pj)) over the real rows and the padding rows JAX's
    operands carry: pi rows of ``pad_pi`` (0-dim) where it is given, pj
    zero rows where ``pad_pj`` says so (default: with pi's, as the exact
    far field pads both operands to one row count)."""
    pi_max, pj_max = pi.amax(), pj.amax()
    if pad_pi is not None:
        pi_max = torch.maximum(pi_max, pad_pi)
    if pad_pj is None:
        pad_pj = pad_pi is not None
    if pad_pj:
        pj_max = torch.clamp(pj_max, min=0.0)
    return pi_max, pj_max


def int8_activation_scale(pi, pj, pad_pi=None, pad_pj=None):
    """The int8 tier's per-tensor activation scale, s_in = max(relu(max(pi)
    + max(pj)), 1e-30) / 127 (``pallas_kernels.py:1029-1030``): relu(pi_i +
    pj_j) ≤ 127·s_in for every pair.  With ``pad_pi`` (0-dim) the maxima
    also take the padding rows JAX's operands carry, whose pi is ``pad_pi``
    and pj 0; ``pad_pj`` (bool) says apart from ``pad_pi`` whether pj has
    zero padding rows (the clustered far field pads its centroid rows on
    their own, ``epnn_tpu/ops/fused.py:1216-1222``).  The int8 kernel
    computes the same from the two maxima."""
    pi_max, pj_max = _int8_maxima(pi, pj, pad_pi, pad_pj)
    return _div127(torch.clamp(torch.relu(pi_max + pj_max), min=1e-30))


def int8_kernel_weights(w2p):
    """``(w2q, sw)`` in the int8 kernel's layout from W2 padded to Hp
    (:func:`pad_weights`): :func:`int8_weights` of it, w2q's rows padded
    with zeros to H rounded up to 32 (the int8 product's K) — (Hq, Hp)
    int8 and (Hp,).  A padded column gets sw = 1e-30 / 127 from the clamp
    and w2q 0 (no division by zero)."""
    w2q, sw = int8_weights(w2p)
    return _pad_to(w2q, (padded_width(w2p.shape[0], 32), w2p.shape[1])
                   ).contiguous(), sw


def int8_scales(s_in, sw):
    """``(dq, inv)``: the dequantization scale s_in·sw (H,) and the
    quantization scale 1 / s_in, as JAX computes them (``pallas_kernels.py:
    1031-1033``) and the int8 kernel does in its prologue."""
    return s_in * sw, torch.ones_like(s_in) / s_in


def dense_message_rowsum_int8_plain(pi, pj, col_vec, w2, b2, pad_pi=None,
                                    pad_pj=None):
    """The far field in the int8 tier, as (R, H) float32, row-blocked:

        s_in = int8_activation_scale(pi, pj, pad_pi);  (w2q, sw) of W2
        q_ij = trunc(clip(relu(pi_i + pj_j) · (1 / s_in), 0, 127) + 0.5)
        out_i = Σ_j col_vec_j · relu((q_ij @ w2q) · (s_in · sw) + b2)

    (``_msg_kernel``'s int8 body, ``pallas_kernels.py:59-75``: rounding
    half up by a float32 add and a truncation).  JAX's kernel on operands
    padded with rows (pi = ``pad_pi``, pj = 0, col_vec = 0) gives the same:
    such rows change only s_in.  The integer product runs as a float32
    matmul of integer-valued tensors, which is exact: every |q|, |w2q| ≤
    127 and a row of H = 32 products sums to at most 516,128 < 2^24 in
    magnitude (H ≤ 64: 1,032,256).  So only the order of the sum over j
    differs from the kernel's or the JAX package's.  ``pad_pj``: see
    :func:`int8_activation_scale`."""
    s_in = int8_activation_scale(pi, pj, pad_pi, pad_pj)
    w2q, sw = int8_weights(w2)
    w2q = w2q.to(pi.dtype)
    dq, inv = int8_scales(s_in, sw)
    r, h = pi.shape
    n = pj.shape[0]
    rb = _plain_rows(r, n, h)
    out = pi.new_empty((r, h))
    for s in range(0, r, rb):
        hid = torch.relu(pi[s:s + rb, None, :] + pj[None, :, :])
        q = torch.trunc(torch.clamp(hid * inv, 0.0, 127.0) + 0.5)
        z2 = torch.relu((q @ w2q) * dq + b2)
        out[s:s + rb] = torch.einsum("n,bnh->bh", col_vec, z2)
    return out


def _dense_message_rowsum_int8_fwd(pi, pj, col_vec, w2, b2, pad_pi=None,
                                   w2q=None, sw=None, w2p=None, b2p=None,
                                   pad_pj=None, precision="default"):
    """The body of ``epnn_torch::dense_message_rowsum_int8`` (see
    :func:`dense_message_rowsum_int8`; ``precision`` is the backward's)."""
    name = "dense_message_rowsum_int8"
    r, h = pi.shape
    n = pj.shape[0]
    tensors = dict(pi=pi, pj=pj, col_vec=col_vec, w2=w2, b2=b2)
    shapes = dict(pi=(r, h), pj=(n, h), col_vec=(n,), w2=(h, h), b2=(h,))
    if pad_pi is not None:
        tensors["pad_pi"], shapes["pad_pi"] = pad_pi, ()
    device = _check(name, tensors, shapes)
    if device.type == "cpu":
        return dense_message_rowsum_int8_plain(pi, pj, col_vec, w2, b2,
                                               pad_pi, pad_pj)
    kw = _kernel_weights(name, _given(None, w2p, b2p), w2, b2)
    out = pi.new_empty((r, h))
    if r == 0:
        return out
    if n == 0:
        return out.zero_()
    hp, hq = padded_width(h), padded_width(h, 32)
    if w2q is None:
        w2q, sw = int8_kernel_weights(kw.w2)
    elif tuple(w2q.shape) == (h, h) and (h, h) != (hq, hp):
        w2q, sw = _pad_to(w2q, (hq, hp)), _pad_to(sw, (hp,))
    _check(name, dict(sw=sw), dict(sw=(hp,)))
    if (w2q.dtype != torch.int8 or tuple(w2q.shape) != (hq, hp)
            or not w2q.is_contiguous() or w2q.device != pi.device
            or sw.device != pi.device):
        raise ValueError(f"{name}: w2_int8 must be int8_weights(w2) or "
                         f"int8_kernel_weights(pad_weights(w2, b2).w2) on "
                         f"{device}")
    splits, cols = _dense_message_splits(r, n)
    part = pi.new_empty((splits, r, h))
    # the maxima run over the real columns only, as JAX's do: a zero
    # padding column would raise a negative maximum to 0.  Operands padded
    # apart (pad_pj given) take their padding rows here, the kernel none
    if pad_pj is None:
        pi_max, pj_max = pi.amax(), pj.amax()
    else:
        pi_max, pj_max = _int8_maxima(pi, pj, pad_pi, pad_pj)
        pad_pi = None
    _launch(name, device, (pi, pj, col_vec, w2q, sw, kw.b2, pi_max, pj_max,
                           pad_pi, part, out),
            (r, n, h, splits, cols), {}, h)
    return out


def dense_message_rowsum_int8(pi, pj, col_vec, w2, b2, pad_pi=None,
                              w2_int8=None, padded=None, pad_pj=None,
                              precision="default"):
    """The far field in the JAX package's int8 serving tier (see
    ``csrc/dense_message_rowsum_int8.cu`` and
    :func:`dense_message_rowsum_int8_plain`): relu(pi_i + pj_j) quantized
    per tensor with the scale of :func:`int8_activation_scale` (``pad_pi``:
    the pi of the padding rows JAX's operands would carry, or None), W2 per
    output column, int32 products, dequantized, + b2.  Arguments otherwise
    as :func:`dense_message_rowsum`.  ``pad_pj``: whether pj has zero
    padding rows apart from ``pad_pi`` (:func:`int8_activation_scale`).
    ``w2_int8`` — ``int8_weights(w2)``
    or, at the kernel's padded widths, :func:`int8_kernel_weights`, where
    the caller keeps it; else it is made here.  On the card a call adds
    two reductions (the maxima, over the real columns) to the kernel,
    which forms the scales itself.  Differentiable straight through, by
    the float32 backward kernel at ``precision`` (JAX's call passes
    ``"default"``, ``epnn_tpu/ops/fused.py:1098-1102``; its ``_dmr_bwd``,
    ``pallas_kernels.py:1079``, ignores ``mid_dtype``); ``pad_pi`` gets no
    gradient, the scale being internal to JAX's kernel.  The operator
    ``epnn_torch::dense_message_rowsum_int8``."""
    w2q, sw = (None, None) if w2_int8 is None else w2_int8
    return _call("dense_message_rowsum_int8", pi, pj, col_vec, w2, b2,
                 pad_pi, w2q, sw, *_padded_args(padded, False), pad_pj,
                 precision)


# ---------------------------------------------------------------------------
# 2. near_message_corr — the gathered near-field message correction
# ---------------------------------------------------------------------------

def _near_msg_rows(pi, pjn, rbf, mask, w1e, layers, mm):
    n, h = pi.shape
    k = mask.shape[1]
    epart = mm(rbf, w1e)
    base = (pi[:, None, :] + pjn.reshape(n, k, h)).reshape(n * k, h)
    diff = (_mid_layers(base + epart, layers, mm)
            - _mid_layers(base, layers, mm))
    return torch.sum(diff.reshape(n, k, -1) * mask[:, :, None], dim=1)


def near_message_corr_plain(pi, pjn, rbf, mask, w1e, *mids):
    """Σ_s mask_is · [mlp(pi_i + pjn_is + rbf_is @ W1e) − mlp(pi_i + pjn_is)]
    with mlp(z) = relu(relu(z) @ W2 + b2), as (N, H).  ``mids`` as in
    :func:`dense_message_rowsum_plain` (any depth: JAX's XLA branch,
    ``epnn_tpu/ops/fused.py:1306-1315``)."""
    return _near_msg_rows(pi, pjn, rbf, mask, w1e, _layers(mids), _mm_fp32)


def near_message_corr_3xtf32_plain(pi, pjn, rbf, mask, w1e, w2, b2):
    """:func:`near_message_corr_plain` with the kernel's arithmetic: rbf @
    W1e and both mid-layer products in 3xTF32 (``_mm_3xtf32``).  Not on any
    path: the tests and ``chip_smoke.py`` hold the kernel to it (the two
    may differ only by summation order)."""
    return _near_msg_rows(pi, pjn, rbf, mask, w1e, ((w2, b2),), _mm_3xtf32)


def near_message_corr_tf32_plain(pi, pjn, rbf, mask, w1e, w2, b2):
    """:func:`near_message_corr_plain` with the one-pass kernel's
    arithmetic: rbf @ W1e and both mid-layer products of TF32 operands
    (``_mm_tf32``).  Not on any path: the tests and ``chip_smoke.py`` hold
    the kernel to it."""
    return _near_msg_rows(pi, pjn, rbf, mask, w1e, ((w2, b2),), _mm_tf32)


def _near_message_corr_fwd(pi, pjn, rbf, mask, w1e, w2, b2, w1ep=None,
                           w2p=None, b2p=None, precision="default"):
    """The body of ``epnn_torch::near_message_corr`` (see
    :func:`near_message_corr`)."""
    name = "near_message_corr"
    passes = tf32_passes(precision)
    n, h = pi.shape
    k = mask.shape[1] if mask.dim() == 2 else 0
    e = w1e.shape[0]
    device = _check(name, dict(pi=pi, pjn=pjn, rbf=rbf, mask=mask, w1e=w1e,
                               w2=w2, b2=b2),
                    dict(pi=(n, h), pjn=(n * k, h), rbf=(n * k, e),
                         mask=(n, k), w1e=(e, h), w2=(h, h), b2=(h,)))
    if device.type == "cpu":
        return near_message_corr_plain(pi, pjn, rbf, mask, w1e, w2, b2)
    kw = _kernel_weights(name, _given(w1ep, w2p, b2p), w2, b2, w1e)
    out = pi.new_empty((n, h))
    if n == 0:
        return out
    if k == 0:
        return out.zero_()
    vec = dict(pjn=pjn) if _vector(h, h, e) else {}
    if _vector(e, h, e):
        vec["rbf"] = rbf
    _launch(name, device, (pi, pjn, rbf, mask, kw.w1e, kw.w2, kw.b2, out,
                           _wide_scratch(name, pi, n, h, e, passes)),
            (n, k, h, e), vec, h, e, passes)
    return out


def near_message_corr(pi, pjn, rbf, mask, w1e, w2, b2, padded=None,
                      precision="default"):
    """Near-field message correction (see ``csrc/near_message_corr.cu``).

    pi (N, H) row projections with b1 folded in; pjn (N·K, H) gathered
    column projections ``pj[idx.ravel()]``; rbf (N·K, E) gathered-pair RBF
    features; mask (N, K) slot validity; W1e (E, H); W2 (H, H); b2 (H,);
    ``padded``: :func:`pad_weights` of (w2, b2, w1e) where the caller keeps
    it; ``precision``: JAX's name, the TF32 tier on the card.
    Differentiable: the backward recomputes through
    :func:`near_message_corr_plain` (as the JAX custom VJP does through its
    XLA twin).  The operator ``epnn_torch::near_message_corr``."""
    return _call("near_message_corr", pi, pjn, rbf, mask, w1e, w2, b2,
                 *_padded_args(padded, True), precision)


# ---------------------------------------------------------------------------
# 3. near_pass_rowsum — the antisymmetric electron-passing row sums
# ---------------------------------------------------------------------------

def _near_pass_rows(rs, ppn, rbf, gh, w1e, layers, mm):
    n, h2 = rs.shape
    h = h2 // 2
    k = gh.shape[1]
    pi_r, pj_r = rs[:, :h], rs[:, h:]
    pin = ppn[:, :h].reshape(n, k, h)
    pjn = ppn[:, h:].reshape(n, k, h)
    epart = mm(rbf, w1e).reshape(n, k, h)
    zn = (pi_r[:, None, :] + pjn) + epart
    zt = (pin + pj_r[:, None, :]) + epart
    return torch.sum(gh[:, :, None] * (_mid_layers(zn, layers, mm)
                                       - _mid_layers(zt, layers, mm)), dim=1)


def near_pass_rowsum_plain(rs, ppn, rbf, gh, w1e, *mids):
    """Σ_s gh_is · (mlp(pi_i + pj_j + e_s) − mlp(pi_j + pj_i + e_s)), j =
    idx_is, e_s = rbf_s @ W1e, from rs = [pi | pj] and ppn = rs[idx].
    ``mids`` as in :func:`dense_message_rowsum_plain` (any depth: JAX's
    XLA branch, ``epnn_tpu/ops/fused.py:1402-1414``)."""
    return _near_pass_rows(rs, ppn, rbf, gh, w1e, _layers(mids), _mm_fp32)


def near_pass_rowsum_3xtf32_plain(rs, ppn, rbf, gh, w1e, w2, b2):
    """:func:`near_pass_rowsum_plain` with the kernel's arithmetic: rbf @
    W1e and both mid-layer products in 3xTF32 (``_mm_3xtf32``).  Not on any
    path: the tests and ``chip_smoke.py`` hold the kernel to it.  Its pairs
    stay exact negations: both orderings see the same products."""
    return _near_pass_rows(rs, ppn, rbf, gh, w1e, ((w2, b2),), _mm_3xtf32)


def near_pass_rowsum_tf32_plain(rs, ppn, rbf, gh, w1e, w2, b2):
    """:func:`near_pass_rowsum_plain` with the one-pass kernel's
    arithmetic: rbf @ W1e and both mid-layer products of TF32 operands
    (``_mm_tf32``).  Not on any path: the tests and ``chip_smoke.py`` hold
    the kernel to it.  Its pairs stay exact negations: both orderings see
    the same products."""
    return _near_pass_rows(rs, ppn, rbf, gh, w1e, ((w2, b2),), _mm_tf32)


def _near_pass_rowsum_fwd(rs, ppn, rbf, gh, w1e, w2, b2, w1ep=None,
                          w2p=None, b2p=None, precision="default"):
    """The body of ``epnn_torch::near_pass_rowsum`` (see
    :func:`near_pass_rowsum`)."""
    name = "near_pass_rowsum"
    passes = tf32_passes(precision)
    n, h2 = rs.shape
    h = h2 // 2
    k = gh.shape[1] if gh.dim() == 2 else 0
    e = w1e.shape[0]
    device = _check(name, dict(rs=rs, ppn=ppn, rbf=rbf, gh=gh, w1e=w1e,
                               w2=w2, b2=b2),
                    dict(rs=(n, 2 * h), ppn=(n * k, 2 * h), rbf=(n * k, e),
                         gh=(n, k), w1e=(e, h), w2=(h, h), b2=(h,)))
    if device.type == "cpu":
        return near_pass_rowsum_plain(rs, ppn, rbf, gh, w1e, w2, b2)
    kw = _kernel_weights(name, _given(w1ep, w2p, b2p), w2, b2, w1e)
    out = rs.new_empty((n, h))
    if n == 0:
        return out
    if k == 0:
        return out.zero_()
    vec = dict(ppn=ppn) if _vector(h, h, e) else {}
    if _vector(e, h, e):
        vec["rbf"] = rbf
    _launch(name, device, (rs, ppn, rbf, gh, kw.w1e, kw.w2, kw.b2, out,
                           _wide_scratch(name, rs, n, h, e, passes)),
            (n, k, h, e), vec, h, e, passes)
    return out


def near_pass_rowsum(rs, ppn, rbf, gh, w1e, w2, b2, padded=None,
                     precision="default"):
    """Electron-passing near-pair row sums (see
    ``csrc/near_pass_rowsum.cu``).

    rs (N, 2H) = [pi | pj] with b1 in pi; ppn (N·K, 2H) = rs[idx.ravel()];
    rbf (N·K, E); gh (N, K) = 0.5 · gate with the slot mask folded in;
    W1e (E, H); W2 (H, H); b2 (H,); ``padded`` and ``precision`` as in
    :func:`near_message_corr`.  Each pair's two terms are exact negations
    at either tier, so Σ_i out_i @ W_out conserves charge to f32
    summation.  Differentiable: the backward recomputes through
    :func:`near_pass_rowsum_plain` (as the JAX custom VJP does through its
    XLA twin).  The operator ``epnn_torch::near_pass_rowsum``."""
    return _call("near_pass_rowsum", rs, ppn, rbf, gh, w1e, w2, b2,
                 *_padded_args(padded, True), precision)


#: the near kernels' tile: live slots a tensor-core product (its M rows)
NEAR_TILE = 16


def near_warps(name: str, n: int, h: int = KERNEL_H, e: int = KERNEL_E,
               passes: int = 3) -> int:
    """The warps a launch of the near kernel ``name`` (or the near blocks
    of a fused kernel) at widths (h, e) and TF32 tier ``passes`` runs for
    ``n`` rows on the current card (its occupancy; csrc
    ``epnn::near_warps``)."""
    fn = getattr(_lib(name, h, e, passes), f"epnn_{name}_warps")
    fn.argtypes = [_I]
    fn.restype = ctypes.c_int
    w = fn(n)
    if w <= 0:
        raise RuntimeError(f"{name}: could not size the grid for N={n}")
    return w


def near_tile_positions(wgt, n_warps: int):
    """Where a near kernel's walk puts each slot: (N, K) int64, the M row
    (0 … ``NEAR_TILE`` − 1) of its tensor-core tile for a live slot
    (``wgt != 0``), −1 for a dead one.  Warp w owns rows
    [N·w // n_warps, N·(w + 1) // n_warps) and takes its live slots in
    ascending flat order, 16 a tile."""
    n, k = wgt.shape
    live = (wgt != 0).reshape(-1)
    starts = (n * torch.arange(n_warps + 1, device=wgt.device)) // n_warps
    rows = torch.arange(n * k, device=wgt.device) // k
    warp = torch.searchsorted(starts, rows, right=True) - 1
    seen = torch.cumsum(live, 0) - live.to(torch.int64)  # live slots before
    pos = (seen - seen[starts[warp] * k]) % NEAR_TILE
    return torch.where(live, pos, -1).reshape(n, k)


# ---------------------------------------------------------------------------
# the fused dense kernels' shared pieces
# ---------------------------------------------------------------------------

def _tile_features(xyz_rows, xyz, mask_rows, mask, start: int, cutoff: float,
                   eta: float, table, method: str = "direct"):
    """Rows [start, start + R) against all atoms: ``(rbf, c, pairm)`` with
    the envelope cleared on self pairs and masked atoms; ``pairm`` is the
    pair mask with its diagonal kept.  ``table``: :func:`rbf_table` of
    ``method``."""
    rows = start + torch.arange(xyz_rows.shape[0], device=xyz.device)
    cols = torch.arange(xyz.shape[0], device=xyz.device)
    pairm = mask_rows[:, None] * mask[None, :]
    cmask = pairm * (rows[:, None] != cols[None, :])
    rbf, c = envelope_rbf_method(pair_d2(xyz_rows[:, None], xyz[None]),
                                 cmask, cutoff, eta, table, method)
    return rbf, c, pairm


class _InferenceOnly(torch.autograd.Function):
    """A fused dense kernel's forward, whose backward raises: the JAX
    package's grid-accumulator kernels have no VJP either
    (``forward_blocked``'s docstring, ``ops/fused.py:1730``), and a
    gradient must never come back silently as zero."""

    @staticmethod
    def forward(ctx, fwd, name, *args):
        ctx.name = name
        return fwd(*args)

    @staticmethod
    def backward(ctx, g):
        raise _inference_only(ctx.name)


def _inference_only(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{name} is inference-only (as in the JAX package): differentiate "
        "forward_blocked without use_pallas, or with neighbor_k")


def _cut2(cutoff: float) -> float:
    """The fused kernels' scan threshold: the float32 cutoff squared,
    rounded up by 1e-6 relative, so that every pair whose envelope is not
    0 (d = sqrt(d²) < cutoff) has d² below it; pairs above it have an
    envelope of exactly 0."""
    c = float(np.float32(cutoff))
    return c * c * (1.0 + 1e-6)


@functools.lru_cache(maxsize=16)
def _kernel_table(e: int, cutoff: float, eta: float, method: str,
                  device: torch.device) -> torch.Tensor:
    """:func:`rbf_table` for the fused kernels, made once per (E, cutoff,
    eta, method, device) and only read: a few small launches a call
    otherwise."""
    return rbf_table(e, cutoff, eta, method, device)


def _rbf_args(e: int, cutoff: float, eta: float, method: str,
              device: torch.device) -> tuple:
    """A fused kernel's RBF arguments: its channel table (the centers, or
    the doubling's gains), the method flag and the doubling's scale 2ηΔ
    (0 for "direct")."""
    doubling = check_rbf_method(method, e) == "doubling"
    return (_kernel_table(e, float(cutoff), float(eta), method, device),
            int(doubling),
            doubling_u_scale(e, float(cutoff), float(eta)) if doubling
            else 0.0)


def _fused_checks(name: str, n: int) -> None:
    if n * n > 0x7FFFFFFF:
        raise ValueError(f"{name}: N = {n} is too large for the kernel's "
                         "int pair index (N² < 2^31)")


# ---------------------------------------------------------------------------
# 4. fused_message_rowsum — a dense message round, featurization in the tile
# ---------------------------------------------------------------------------

def _row_range(n: int, rows: Optional[slice]) -> range:
    return range(n) if rows is None else range(n)[rows]


def fused_message_rowsum_plain(pi, pj, xyz, node_mask, col_vec, w1e, w2, b2,
                               cutoff: float = 3.0, eta: float = 2.0,
                               tol: float = 1e-5, masked: bool = True,
                               rows: Optional[slice] = None,
                               rbf_method: str = "direct"):
    """Σ_j w_ij · relu(relu(pi_i + pj_j + rbf_ij @ W1e) @ W2 + b2) as
    (N, H), with w_ij the pair mask (diagonal kept) when ``masked``, else
    ``col_vec_j``; row-blocked so no (N, N, E) tensor exists.  ``tol`` is
    unused (the message round has no gate), as in the JAX kernel.
    ``rows``: only those rows (a slice of step 1), as (len, H).
    ``rbf_method``: how the channels are built, "direct" (an exp a
    channel) or "doubling" (:func:`envelope_rbf_doubling`)."""
    n, h = pi.shape
    table = rbf_table(w1e.shape[0], cutoff, eta, rbf_method, pi.device)
    rr = _row_range(n, rows)
    rb = _plain_rows(len(rr), n, max(w1e.shape[0], h))
    out = pi.new_empty((len(rr), h))
    for s in range(rr.start, rr.stop, rb):
        sl = slice(s, min(s + rb, rr.stop))
        rbf, _, pairm = _tile_features(xyz[sl], xyz, node_mask[sl], node_mask,
                                       s, cutoff, eta, table, rbf_method)
        hid = torch.relu((pi[sl, None, :] + pj[None, :, :]) + rbf @ w1e)
        hid = torch.relu(hid @ w2 + b2)
        w = pairm if masked else col_vec[None, :].expand_as(pairm)
        out[s - rr.start:sl.stop - rr.start] = torch.einsum("bn,bnh->bh", w,
                                                            hid)
    return out


def _fused_message_split(pi, pj, xyz, node_mask, col_vec, w1e, w2, b2,
                         cutoff, eta, masked, mm, rows=None,
                         method="direct"):
    """:func:`fused_message_rowsum_plain` as the kernel splits it, with the
    products ``mm``: the far field over every pair (weights cv_j, and rows
    times m_i when ``masked``), plus w_ij (mlp(base + rbf @ W1e) −
    mlp(base)), base = pi_i + pj_j, over the pairs whose rbf is not 0
    (elsewhere the difference is exactly 0)."""
    n, h = pi.shape
    rr = _row_range(n, rows)
    cv = node_mask if masked else col_vec
    far = _far_rows(pi[rr.start:rr.stop], pj, cv, ((w2, b2),), mm)
    if masked:
        far = far * node_mask[rr.start:rr.stop, None]
    table = rbf_table(w1e.shape[0], cutoff, eta, method, pi.device)
    rb = _plain_rows(len(rr), n, max(w1e.shape[0], h))
    corr = pi.new_empty((len(rr), h))
    for s in range(rr.start, rr.stop, rb):
        sl = slice(s, min(s + rb, rr.stop))
        rbf, _, pairm = _tile_features(xyz[sl], xyz, node_mask[sl], node_mask,
                                       s, cutoff, eta, table, method)
        base = pi[sl, None, :] + pj[None, :, :]
        diff = (_mid_layers(base + mm(rbf, w1e), ((w2, b2),), mm)
                - _mid_layers(base, ((w2, b2),), mm))
        w = pairm if masked else col_vec[None, :].expand_as(pairm)
        corr[s - rr.start:sl.stop - rr.start] = torch.einsum("bn,bnh->bh", w,
                                                             diff)
    return far + corr


def fused_message_rowsum_3xtf32_plain(pi, pj, xyz, node_mask, col_vec, w1e,
                                      w2, b2, cutoff: float = 3.0,
                                      eta: float = 2.0, tol: float = 1e-5,
                                      masked: bool = True,
                                      rows: Optional[slice] = None,
                                      rbf_method: str = "direct"):
    """:func:`fused_message_rowsum_plain` with the kernel's split (the far
    field over every pair, the live pairs' correction) and its arithmetic:
    every product in 3xTF32 (``_mm_3xtf32``).  Not on any path: the tests
    and ``chip_smoke.py`` hold the kernel to it (the two may differ only
    by summation order).  ``rows`` and ``rbf_method`` as in the plain
    version."""
    return _fused_message_split(pi, pj, xyz, node_mask, col_vec, w1e, w2, b2,
                                cutoff, eta, masked, _mm_3xtf32, rows,
                                rbf_method)


def fused_message_rowsum_tf32_plain(pi, pj, xyz, node_mask, col_vec, w1e,
                                    w2, b2, cutoff: float = 3.0,
                                    eta: float = 2.0, tol: float = 1e-5,
                                    masked: bool = True,
                                    rows: Optional[slice] = None,
                                    rbf_method: str = "direct"):
    """:func:`fused_message_rowsum_3xtf32_plain` with the one-pass
    kernel's arithmetic: every product of TF32 operands (``_mm_tf32``).
    Not on any path: the tests and ``chip_smoke.py`` hold the kernel to
    it."""
    return _fused_message_split(pi, pj, xyz, node_mask, col_vec, w1e, w2, b2,
                                cutoff, eta, masked, _mm_tf32, rows,
                                rbf_method)


def _fused_message_rowsum_fwd(pi, pj, xyz, node_mask, col_vec, w1e, w2, b2,
                              cutoff, eta, tol, masked, w1ep=None, w2p=None,
                              b2p=None, precision="default",
                              rbf_method="direct"):
    """The body of ``epnn_torch::fused_message_rowsum`` (see
    :func:`fused_message_rowsum`)."""
    name = "fused_message_rowsum"
    passes = tf32_passes(precision)
    n, h = pi.shape
    e = w1e.shape[0]
    device = _check(name, dict(pi=pi, pj=pj, xyz=xyz, node_mask=node_mask,
                               col_vec=col_vec, w1e=w1e, w2=w2, b2=b2),
                    dict(pi=(n, h), pj=(n, h), xyz=(n, 3), node_mask=(n,),
                         col_vec=(n,), w1e=(e, h), w2=(h, h), b2=(h,)))
    rbf_method = check_rbf_method(rbf_method, e)
    if device.type == "cpu":
        return fused_message_rowsum_plain(pi, pj, xyz, node_mask, col_vec,
                                          w1e, w2, b2, cutoff, eta, tol,
                                          masked, rbf_method=rbf_method)
    _fused_checks(name, n)
    kw = _kernel_weights(name, _given(w1ep, w2p, b2p), w2, b2, w1e)
    out = pi.new_empty((n, h))
    if n == 0:
        return out
    table, doubling, u_scale = _rbf_args(e, cutoff, eta, rbf_method,
                                         xyz.device)
    splits, cols = _dense_message_splits(n, n)
    part = pi.new_empty((splits + 1, n, h))
    _launch(name, device, (pi, pj, xyz, node_mask, col_vec, kw.w1e, kw.w2,
                           kw.b2, table, part, out,
                           _wide_scratch(name, pi, n, h, e, passes)),
            (n, h, e, splits, cols, int(bool(masked)), doubling,
             float(cutoff), float(eta), _cut2(cutoff), u_scale), {}, h, e,
            passes)
    return out


def fused_message_rowsum(pi, pj, xyz, node_mask, col_vec, w1e, w2, b2,
                         cutoff: float = 3.0, eta: float = 2.0,
                         tol: float = 1e-5, masked: bool = True,
                         padded: Optional[KernelWeights] = None,
                         precision: str = "default",
                         rbf_method: str = "direct"):
    """One dense message round's row sums with the featurization in the
    tile (see ``csrc/fused_message_rowsum.cu``):

        out_i = Σ_j w_ij · relu(relu(pi_i + pj_j + rbf_ij @ W1e) @ W2 + b2)

    pi, pj (N, H), pi carrying b1; xyz (N, 3); node_mask, col_vec (N,);
    W1e (E, H); W2 (H, H); b2 (H,).  ``masked`` weights by the pair mask
    (diagonal kept), else by ``col_vec``; ``padded``: :func:`pad_weights`
    of (w2, b2, w1e) where the caller keeps it; ``precision``: JAX's name,
    the TF32 tier on the card; ``rbf_method``: JAX's, "direct" (an exp a
    channel) or "doubling" (two exps a pair, :func:`envelope_rbf_doubling`;
    any other value raises).  The caller applies W_out and the Σ_j b_out
    term.  On the card: the far field over every pair plus the live
    pairs' correction, one launch (and the ordered sum of its parts).
    Inference-only: a backward raises.  The operator
    ``epnn_torch::fused_message_rowsum``."""
    return _fused_call("fused_message_rowsum", pi, pj, xyz, node_mask,
                       col_vec, w1e, w2, b2, float(cutoff), float(eta),
                       float(tol), bool(masked), *_padded_args(padded, True),
                       precision, rbf_method)


# ---------------------------------------------------------------------------
# 5. fused_epn_rowsum — a dense electron-passing round
# ---------------------------------------------------------------------------

def _fused_epn_rows(pi, pj, xyz, node_mask, w1e, w2, b2, cutoff, eta, tol,
                    soft_gate, mm, rows=None, method="direct"):
    n, h = pi.shape
    table = rbf_table(w1e.shape[0], cutoff, eta, method, pi.device)
    rr = _row_range(n, rows)
    rb = _plain_rows(len(rr), n, max(w1e.shape[0], h))
    out = pi.new_empty((len(rr), h))
    for s in range(rr.start, rr.stop, rb):
        sl = slice(s, min(s + rb, rr.stop))
        rbf, c, _ = _tile_features(xyz[sl], xyz, node_mask[sl], node_mask,
                                   s, cutoff, eta, table, method)
        epart = mm(rbf, w1e)
        hid_n = _mid_layers((pi[sl, None, :] + pj[None, :, :]) + epart,
                            ((w2, b2),), mm)
        hid_t = _mid_layers((pj[sl, None, :] + pi[None, :, :]) + epart,
                            ((w2, b2),), mm)
        gate = c if soft_gate else hard_gate(rbf, tol)
        out[s - rr.start:sl.stop - rr.start] = torch.sum(
            (0.5 * gate)[:, :, None] * (hid_n - hid_t), dim=1)
    return out


def fused_epn_rowsum_plain(pi, pj, xyz, node_mask, w1e, w2, b2,
                           cutoff: float = 3.0, eta: float = 2.0,
                           tol: float = 1e-5, soft_gate: bool = False,
                           rows: Optional[slice] = None,
                           rbf_method: str = "direct"):
    """Σ_j 0.5 · gate_ij · (hid(i, j) − hid(j, i)) as (N, H), both
    orderings from one epart, gate the hard is-near gate or (``soft_gate``)
    the masked envelope; row-blocked so no (N, N, E) tensor exists.
    ``rows``: only those rows (a slice of step 1), as (len, H).
    ``rbf_method`` as in :func:`fused_message_rowsum_plain`; the hard gate
    reads the same channels."""
    return _fused_epn_rows(pi, pj, xyz, node_mask, w1e, w2, b2, cutoff, eta,
                           tol, soft_gate, _mm_fp32, rows, rbf_method)


def fused_epn_rowsum_3xtf32_plain(pi, pj, xyz, node_mask, w1e, w2, b2,
                                  cutoff: float = 3.0, eta: float = 2.0,
                                  tol: float = 1e-5, soft_gate: bool = False,
                                  rows: Optional[slice] = None,
                                  rbf_method: str = "direct"):
    """:func:`fused_epn_rowsum_plain` with the kernel's arithmetic: rbf @
    W1e and both orderings' mid layers in 3xTF32 (``_mm_3xtf32``).  Not on
    any path: the tests and ``chip_smoke.py`` hold the kernel to it.  A
    pair's two transfers stay exact negations: both orderings see the same
    products.  ``rows`` and ``rbf_method`` as in the plain version."""
    return _fused_epn_rows(pi, pj, xyz, node_mask, w1e, w2, b2, cutoff, eta,
                           tol, soft_gate, _mm_3xtf32, rows, rbf_method)


def fused_epn_rowsum_tf32_plain(pi, pj, xyz, node_mask, w1e, w2, b2,
                                cutoff: float = 3.0, eta: float = 2.0,
                                tol: float = 1e-5, soft_gate: bool = False,
                                rows: Optional[slice] = None,
                                rbf_method: str = "direct"):
    """:func:`fused_epn_rowsum_plain` with the one-pass kernel's
    arithmetic: rbf @ W1e and both orderings' mid layers of TF32 operands
    (``_mm_tf32``).  Not on any path: the tests and ``chip_smoke.py`` hold
    the kernel to it.  A pair's two transfers stay exact negations."""
    return _fused_epn_rows(pi, pj, xyz, node_mask, w1e, w2, b2, cutoff, eta,
                           tol, soft_gate, _mm_tf32, rows, rbf_method)


def _fused_epn_rowsum_fwd(pi, pj, xyz, node_mask, w1e, w2, b2, cutoff, eta,
                          tol, soft_gate, w1ep=None, w2p=None, b2p=None,
                          precision="default", rbf_method="direct"):
    """The body of ``epnn_torch::fused_epn_rowsum`` (see
    :func:`fused_epn_rowsum`)."""
    name = "fused_epn_rowsum"
    passes = tf32_passes(precision)
    n, h = pi.shape
    e = w1e.shape[0]
    device = _check(name, dict(pi=pi, pj=pj, xyz=xyz, node_mask=node_mask,
                               w1e=w1e, w2=w2, b2=b2),
                    dict(pi=(n, h), pj=(n, h), xyz=(n, 3), node_mask=(n,),
                         w1e=(e, h), w2=(h, h), b2=(h,)))
    rbf_method = check_rbf_method(rbf_method, e)
    if device.type == "cpu":
        return fused_epn_rowsum_plain(pi, pj, xyz, node_mask, w1e, w2, b2,
                                      cutoff, eta, tol, soft_gate,
                                      rbf_method=rbf_method)
    _fused_checks(name, n)
    kw = _kernel_weights(name, _given(w1ep, w2p, b2p), w2, b2, w1e)
    out = pi.new_empty((n, h))
    if n == 0:
        return out
    table, doubling, u_scale = _rbf_args(e, cutoff, eta, rbf_method,
                                         xyz.device)
    _launch(name, device, (pi, pj, xyz, node_mask, kw.w1e, kw.w2, kw.b2,
                           table, out,
                           _wide_scratch(name, pi, n, h, e, passes)),
            (n, h, e, int(bool(soft_gate)), doubling, float(cutoff),
             float(eta), float(tol), _cut2(cutoff), u_scale), {}, h, e,
            passes)
    return out


def fused_epn_rowsum(pi, pj, xyz, node_mask, w1e, w2, b2,
                     cutoff: float = 3.0, eta: float = 2.0, tol: float = 1e-5,
                     soft_gate: bool = False,
                     padded: Optional[KernelWeights] = None,
                     precision: str = "default", rbf_method: str = "direct"):
    """One dense electron-passing round's antisymmetric row sums (see
    ``csrc/fused_epn_rowsum.cu``):

        out_i = Σ_j 0.5 · gate_ij · (hid(i, j) − hid(j, i))

    with the RBF, the gate and both orderings built in the tile; arguments
    as :func:`fused_message_rowsum` without ``col_vec``.  A pair's two
    transfers are exact negations (under either ``rbf_method``: a pair's
    channels are a function of its d², which has the same bits both ways),
    so Σ_i out_i @ W_out conserves charge to f32 summation.  The caller
    applies W_out (b_out cancels).  On the card only the pairs within the
    cutoff pay (a d² scan finds them).  Inference-only: a backward raises.
    The operator ``epnn_torch::fused_epn_rowsum``."""
    return _fused_call("fused_epn_rowsum", pi, pj, xyz, node_mask, w1e, w2,
                       b2, float(cutoff), float(eta), float(tol),
                       bool(soft_gate), *_padded_args(padded, True),
                       precision, rbf_method)


# ---------------------------------------------------------------------------
# the registered operators
# ---------------------------------------------------------------------------

#: the operators' namespace: ``torch.ops.epnn_torch.<kernel>``
NAMESPACE = "epnn_torch"

_FUSED_TAIL = ("Tensor? w1ep, Tensor? w2p, Tensor? b2p, str precision, "
               "str rbf_method) -> Tensor")
_SCHEMAS = {
    "dense_message_rowsum":
        "(Tensor pi, Tensor pj, Tensor col_vec, Tensor w2, Tensor b2, "
        "Tensor? w2p, Tensor? b2p, str precision) -> Tensor",
    "dense_message_rowsum_bwd":
        "(Tensor pi, Tensor pj, Tensor col_vec, Tensor w2, Tensor b2, "
        "Tensor g, Tensor? w2p, Tensor? b2p, str precision) "
        "-> (Tensor, Tensor, Tensor, Tensor)",
    "dense_message_rowsum_int8":
        "(Tensor pi, Tensor pj, Tensor col_vec, Tensor w2, Tensor b2, "
        "Tensor? pad_pi, Tensor? w2q, Tensor? sw, Tensor? w2p, Tensor? b2p, "
        "bool? pad_pj, str precision) -> Tensor",
    "near_message_corr":
        "(Tensor pi, Tensor pjn, Tensor rbf, Tensor mask, Tensor w1e, "
        "Tensor w2, Tensor b2, Tensor? w1ep, Tensor? w2p, Tensor? b2p, "
        "str precision) -> Tensor",
    "near_pass_rowsum":
        "(Tensor rs, Tensor ppn, Tensor rbf, Tensor gh, Tensor w1e, "
        "Tensor w2, Tensor b2, Tensor? w1ep, Tensor? w2p, Tensor? b2p, "
        "str precision) -> Tensor",
    "fused_message_rowsum":
        "(Tensor pi, Tensor pj, Tensor xyz, Tensor node_mask, "
        "Tensor col_vec, Tensor w1e, Tensor w2, Tensor b2, float cutoff, "
        "float eta, float tol, bool masked, " + _FUSED_TAIL,
    "fused_epn_rowsum":
        "(Tensor pi, Tensor pj, Tensor xyz, Tensor node_mask, Tensor w1e, "
        "Tensor w2, Tensor b2, float cutoff, float eta, float tol, "
        "bool soft_gate, " + _FUSED_TAIL,
}

_BODIES = {
    "dense_message_rowsum": _dense_message_rowsum_fwd,
    "dense_message_rowsum_bwd": _dense_message_rowsum_bwd,
    "dense_message_rowsum_int8": _dense_message_rowsum_int8_fwd,
    "near_message_corr": _near_message_corr_fwd,
    "near_pass_rowsum": _near_pass_rowsum_fwd,
    "fused_message_rowsum": _fused_message_rowsum_fwd,
    "fused_epn_rowsum": _fused_epn_rowsum_fwd,
}

#: the fused dense kernels, inference-only (:class:`_InferenceOnly`)
_FUSED = ("fused_message_rowsum", "fused_epn_rowsum")


def _fake(name):
    """The shape function of operator ``name``: its outputs' shapes from
    its inputs'."""
    if name == "dense_message_rowsum_bwd":
        def fake(pi, pj, col_vec, w2, b2, *rest):
            return tuple(t.new_empty(t.shape) for t in (pi, pj, w2, b2))
    elif name == "near_pass_rowsum":
        def fake(rs, *rest):
            return rs.new_empty((rs.shape[0], rs.shape[1] // 2))
    else:
        def fake(pi, *rest):
            return pi.new_empty(pi.shape)
    return fake


def _far_setup(ctx, inputs, output):
    # (w2p, b2p) follow (pi, pj, col_vec, w2, b2) in the float32 operator
    # and (..., pad_pi, w2q, sw) in the int8 one
    at = 5 if len(inputs) == 8 else 8
    ctx.save_for_backward(*inputs[:5], *inputs[at:at + 2])
    ctx.precision = inputs[-1]
    ctx.n_inputs = len(inputs)


def _far_backward(ctx, g):
    """The far field's VJP, in both tiers: the backward kernel at the
    forward's precision (int8 straight through, as JAX's ``_dmr_bwd``)."""
    pi, pj, col_vec, w2, b2, w2p, b2p = ctx.saved_tensors
    dpi, dpj, dw2, db2 = dense_message_rowsum_bwd(
        pi, pj, col_vec, w2, b2, g.contiguous(), _given(None, w2p, b2p),
        ctx.precision)
    return (dpi, dpj, None, dw2, db2) + (None,) * (ctx.n_inputs - 5)


def _near_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:7])


def _recompute_backward(plain):
    """A near kernel's VJP: a recompute through its plain version under
    autograd, the counterpart of ``_near_msg_bwd`` / ``_near_pass_bwd``
    (``pallas_kernels.py:1271``, ``:1395``), which are ``jax.vjp`` of XLA
    code, not Pallas kernels.  This is the backward itself, not a
    fallback: the forward on a CUDA tensor is always the kernel.  The
    recompute is float32 at any precision (JAX's recomputes at it: a
    departure, ROADMAP)."""
    def backward(ctx, g):
        args = ctx.saved_tensors
        want = ctx.needs_input_grad[:7]
        grads = iter(())
        with torch.enable_grad():
            leaves = [a.detach().requires_grad_(w)
                      for a, w in zip(args, want)]
            wrt = [a for a, w in zip(leaves, want) if w]
            if wrt:
                grads = iter(torch.autograd.grad(
                    plain(*leaves), wrt, g.contiguous(), allow_unused=True))
        return (*[next(grads) if w else None for w in want],
                None, None, None, None)
    return backward


def _no_backward(name):
    """A fused kernel's registered VJP: it raises, as
    :class:`_InferenceOnly`'s does."""
    def setup(ctx, inputs, output):
        pass

    def backward(ctx, g):
        raise _inference_only(name)
    return setup, backward


def _vjp(name):
    """``(setup_context, backward)`` of operator ``name`` (None: the
    backward operator, which is not differentiated)."""
    if name in ("dense_message_rowsum", "dense_message_rowsum_int8"):
        return _far_setup, _far_backward
    if name in _FUSED:
        return _no_backward(name)
    if name != "dense_message_rowsum_bwd":
        return _near_setup, _recompute_backward(globals()[name + "_plain"])
    return None


def _register(name):
    """``epnn_torch::<name>``: the body for CPU and CUDA tensors (it runs
    the plain version or launches the kernel on the device ``_check``
    reports), the shape function, the VJP and the flop formula
    (:func:`work`); and, where it is differentiable, the same body and VJP
    as an ``autograd.Function`` for eager calls (:data:`_EAGER`)."""
    op = torch.library.custom_op(f"{NAMESPACE}::{name}", _BODIES[name],
                                 mutates_args=(),
                                 device_types=("cpu", "cuda"),
                                 schema=_SCHEMAS[name])
    op.register_fake(_fake(name))
    vjp = _vjp(name)
    if vjp is not None:
        op.register_autograd(vjp[1], setup_context=vjp[0])
        if name not in _FUSED:
            _EAGER[name] = type(f"_{name}", (torch.autograd.Function,), dict(
                forward=staticmethod(_BODIES[name]),
                setup_context=staticmethod(vjp[0]),
                backward=staticmethod(vjp[1])))
    register_flop_formula(getattr(getattr(torch.ops, NAMESPACE), name))(
        functools.partial(_flop_formula, name))
    return op


#: the differentiable operators' bodies and VJPs as ``autograd.Function``s
_EAGER: dict = {}


def _traced() -> bool:
    """Whether a kernel call goes through its registered operator: where
    ``torch.export`` or ``torch.compile`` traces, and under a dispatch
    mode (a ``FlopCounterMode`` counts an operator, and sees nothing of a
    body's launch).  Eager calls otherwise skip the dispatcher, which
    costs ~40 µs of host time a call, more than a 2 × 2,220 serving call's
    spread (``chip_smoke.py`` ``[export]``; PERF.md)."""
    return tracing()


def _call(name, *args):
    """Operator ``name`` on ``args``: the registered operator where
    :func:`_traced`, else its body directly (through its :data:`_EAGER`
    Function where autograd records)."""
    if _traced():
        return _OPS[name](*args)
    if name in _EAGER and torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return _EAGER[name].apply(*args)
    return _BODIES[name](*args)


def _fused_call(name, *args):
    """Fused kernel ``name`` on ``args``: its operator where
    :func:`_traced`, else its body through :class:`_InferenceOnly`."""
    if _traced():
        return _OPS[name](*args)
    return _InferenceOnly.apply(_BODIES[name], name, *args)


# ---------------------------------------------------------------------------
# the work of each kernel: the model's flop count and the kernels' bounds
# ---------------------------------------------------------------------------

#: the fused kernels' d² scan: CUDA-core instructions a valid pair (3
#: coordinate loads and the mask's, 3 subtracts, 3 multiplies, 2 adds, the
#: compare)
SCAN_INSTR = 13
#: the int8 far field's CUDA-core instructions per pair element: an
#: activation takes add, relu, scale, clip, + 0.5 and the round down by
#: 2^23, and 3 byte permutes pack 4; an output takes the unbias, the
#: dequantizing multiply, + b2, relu and the cv-weighted add
INT8_INSTR_IN = 6.75
INT8_INSTR_OUT = 5
#: neighbor_compact's work a valid pair: FLOP (3 subtractions, 3 products,
#: 2 additions, the compare) and CUDA-core instructions (the same, issued
#: one a lane)
COMPACT_FLOP = 9
COMPACT_INSTR = 9


class Work(NamedTuple):
    """The work of one call of a kernel's function.

    ``flops``: the model's products, 2 FLOP a multiply-add, over the whole
    grid the function defines — what ``FlopCounterMode`` counts when it
    runs the float32 plain version (matrix products and the weighted row
    sums the plain version writes as a contraction; no elementwise work),
    whatever kernel computes it, and the count an ``epnn_torch::``
    operator reports (its flop formula).  The rest is the kernel's own
    work on the data it is given, which its bound reads: ``products``,
    FLOP of products on the tensor cores (TF32, or int8 operations for
    the int8 tier; one product, before the 3xTF32 split's three);
    ``elementwise``, FLOP on the CUDA cores; ``instructions``, CUDA-core
    instructions counted apart (the d² scan, the int8 tier's packing);
    ``special``, special-function operations (exp, cos, sqrt); ``bytes``,
    each input read once and each output written once."""

    flops: int
    products: float = 0
    elementwise: float = 0
    instructions: float = 0
    special: float = 0
    bytes: int = 0


def _far_work(rows: int, cols: int, h: int, live: Optional[int] = None):
    """``dense_message_rowsum`` on R × N pairs: per live pair (cv_j ≠ 0;
    default every column) the H × H product and ~4H elementwise; pi, cv
    and out whole, pj where cv is live, W2, b2 once."""
    live = cols if live is None else live
    pairs = rows * live
    return Work(2 * rows * cols * h * (h + 1), pairs * 2 * h * h,
                pairs * 4 * h, 0, 0,
                4 * (2 * rows * h + cols + live * h + h * h + h))


def _int8_work(rows: int, cols: int, h: int, live: Optional[int] = None):
    """``dense_message_rowsum_int8``: the far field's FLOP and bytes; its
    products are int8 operations, its elementwise work
    :data:`INT8_INSTR_IN` + :data:`INT8_INSTR_OUT` instructions a pair
    element."""
    pairs = rows * (cols if live is None else live)
    return _far_work(rows, cols, h, live)._replace(
        elementwise=0, instructions=pairs * h * (INT8_INSTR_IN
                                                 + INT8_INSTR_OUT))


def _far_bwd_work(rows: int, cols: int, h: int, live: Optional[int] = None):
    """``dense_message_rowsum_bwd``: z2, e2 @ W2ᵀ and the dW2 outer
    product (three H × H contractions) and ~9H elementwise a live pair;
    pi, g, dpi, cv, pj and dpj whole, pj where cv is live, W2, b2, dW2,
    db2 once."""
    live = cols if live is None else live
    pairs = rows * live
    return Work(6 * rows * cols * h * h, pairs * 6 * h * h, pairs * 9 * h,
                0, 0, 4 * (3 * rows * h + cols * h + cols + live * h
                           + 2 * (h * h + h)))


def _near_work(elem_per_h: int, row_factor: int):
    def near(n: int, k: int, h: int, e: int, live: Optional[int] = None,
             live_rows: Optional[int] = None):
        """A near kernel on N rows of K slots: per live slot (default
        every slot) rbf @ W1e and two H × H products and the elementwise
        work; a live slot's gathered row and RBF row in, the row inputs of
        rows with a live slot, the whole (N, K) weights, the weights once
        and the output."""
        live = n * k if live is None else live
        live_rows = n if live_rows is None else live_rows
        width = row_factor * h
        return Work(n * k * (2 * e * h + 4 * h * h),
                    live * (2 * e * h + 4 * h * h), live * elem_per_h * h,
                    0, 0, 4 * (live * (width + e) + live_rows * width
                               + n * k + n * h) + 4 * (e * h + h * h + h))
    return near


def rbf_channel_work(e: int, method: str = "direct") -> tuple:
    """(CUDA-core FLOP, special-function ops) a live pair's featurization
    takes in a fused kernel: "direct", E channels of ~6 FLOP and an exp
    each, ~15 FLOP and a sqrt and a cos a pair; "doubling", a channel
    a·g_ch, its set bits' multiplies and the gate's compare, the
    squarings u², u⁴, … and ~23 FLOP a pair (d² … the envelope, dc and
    the two exps' arguments), and two exps, a sqrt and a cos a pair."""
    if check_rbf_method(method, e) == "direct":
        return 6 * e + 15, e + 2
    nbits = max(1, (e - 1).bit_length())
    return (sum(2 + bin(ch).count("1") for ch in range(e)) + 22 + nbits,
            4)


def _fused_work(pass_round: bool):
    def fused(n: int, h: int, e: int, valid: Optional[int] = None,
              near: Optional[int] = None, gated: Optional[int] = None,
              masked: bool = True, soft_gate: bool = False,
              rbf_method: str = "direct"):
        """A fused dense kernel on N atoms (``valid`` of them, default
        all): every valid pair's d² scan; per live pair (within the
        cutoff, both valid, i ≠ j; default every valid pair) its channels
        (:func:`rbf_channel_work`), rbf @ W1e and two mid layers (the pass
        kernel: only its ``gated`` pairs' products under the hard gate —
        the others add exactly 0), ~12H (message) or ~14H (pass)
        elementwise; the message kernel's far field over every weighted
        pair (the valid pairs when ``masked``, else all), 2H² and ~5H;
        pi, pj, xyz, the mask (and col_vec) in, the row sums out, the
        weights once."""
        valid = n if valid is None else valid
        near = valid * valid if near is None else near
        gated = near if gated is None else gated
        chan, sfu = rbf_channel_work(e, rbf_method)
        live = 2 * e * h + 4 * h * h
        w_bytes = 4 * (e * h + h * h + h)
        if pass_round:
            paying = near if soft_gate else gated
            return Work(2 * n * n * h * (e + 2 * h), paying * live,
                        near * chan + paying * 14 * h,
                        valid * valid * SCAN_INSTR, near * sfu,
                        4 * (3 * h + 4) * n + w_bytes)
        weighted = valid * valid if masked else n * n
        return Work(2 * n * n * h * (e + h + 1),
                    weighted * 2 * h * h + near * live,
                    weighted * 5 * h + near * (chan + 12 * h),
                    valid * valid * SCAN_INSTR, near * sfu,
                    4 * (3 * h + 5) * n + w_bytes)
    return fused


def _compact_work(n: int, k: int, valid: Optional[int] = None):
    """``neighbor_compact``: every valid pair's d² and compare
    (:data:`COMPACT_FLOP`, :data:`COMPACT_INSTR`); xyz and the mask in,
    idx (int64) and the mask out.  No products."""
    valid = n if valid is None else valid
    return Work(0, 0, valid * valid * COMPACT_FLOP,
                valid * valid * COMPACT_INSTR, 0, 16 * n + 12 * n * k)


_WORK = {
    "dense_message_rowsum": _far_work,
    "dense_message_rowsum_int8": _int8_work,
    "dense_message_rowsum_bwd": _far_bwd_work,
    "near_message_corr": _near_work(8, 1),
    "near_pass_rowsum": _near_work(10, 2),
    "fused_message_rowsum": _fused_work(False),
    "fused_epn_rowsum": _fused_work(True),
    "neighbor_compact": _compact_work,
}


def work(name: str, **sizes) -> Work:
    """The :class:`Work` of one call of kernel ``name`` at ``sizes``:

    * far field, its int8 tier and backward: ``rows``, ``cols``, ``h``,
      ``live`` (columns with cv ≠ 0);
    * near kernels: ``n``, ``k``, ``h``, ``e``, ``live`` (slots of weight
      ≠ 0), ``live_rows`` (rows with one);
    * fused kernels: ``n``, ``h``, ``e``, ``valid`` atoms, ``near`` (live
      pairs), ``gated`` (of those, hard-gated), ``masked`` / ``soft_gate``,
      ``rbf_method``;
    * ``neighbor_compact``: ``n``, ``k``, ``valid``.

    The data's counts default to the whole grid.  One source of the work
    counts: the operators' flop formulas read ``flops``, ``chip_smoke.py``'s
    bounds the rest."""
    return _WORK[name](**sizes)


def _flop_formula(name, *args, out_shape=None, **kwargs):
    """The flop formula of operator ``name`` (the argument tensors come as
    shapes): :func:`work`'s ``flops`` at them, which equals what
    ``FlopCounterMode`` counts of the float32 plain version."""
    a = args
    if name in ("dense_message_rowsum", "dense_message_rowsum_int8",
                "dense_message_rowsum_bwd"):
        return work(name, rows=a[0][0], cols=a[1][0], h=a[0][1]).flops
    if name in ("near_message_corr", "near_pass_rowsum"):
        k = a[3][1] if len(a[3]) == 2 else 0
        return work(name, n=a[0][0], k=k, h=a[4][1], e=a[4][0]).flops
    w1e = a[5] if name == "fused_message_rowsum" else a[4]
    return work(name, n=a[0][0], h=a[0][1], e=w1e[0]).flops


#: the kernels, as registered operators.  Registering compiles nothing; a
#: library is built at its first launch.
_OPS = {name: _register(name) for name in _SCHEMAS}


# ---------------------------------------------------------------------------
# 6. neighbor_compact — the within-cutoff neighbor list in one pass
# ---------------------------------------------------------------------------

def neighbor_compact_plain(xyz, node_mask, cutoff: float, k: int):
    """(idx int64, mask float32), each (N, k): for each atom the columns
    with d² < cutoff² (not self, both atoms valid) in ascending order, the
    first k of them; unused slots hold idx 0 and mask 0."""
    n = xyz.shape[0]
    idx = torch.zeros((n, k), dtype=torch.int64, device=xyz.device)
    mask = xyz.new_zeros((n, k))
    cols = torch.arange(n, device=xyz.device)
    rb = _plain_rows(n, n, 1)
    for s in range(0, n, rb):
        d2 = pair_d2(xyz[s:s + rb, None], xyz[None])
        rows = s + torch.arange(d2.shape[0], device=xyz.device)
        hit = ((d2 < cutoff * cutoff) & (rows[:, None] != cols[None, :])
               & (node_mask[s:s + rb, None] > 0) & (node_mask[None, :] > 0))
        slot = torch.cumsum(hit, dim=1) - 1
        r, c = (hit & (slot < k)).nonzero(as_tuple=True)
        idx[s + r, slot[r, c]] = c
        mask[s + r, slot[r, c]] = 1.0
    return idx, mask


#: ``neighbor_compact``'s geometry (csrc: kRows, kStage): a scan block owns
#: 128 rows, one a thread, and stages its columns 128 at a time; the column
#: range splits so that about ``_NC_TARGET_BLOCKS`` blocks run
_NC_ROWS = 128
_NC_STAGE = 128
_NC_TARGET_BLOCKS = 16 * 132


def neighbor_compact_splits(n: int) -> tuple:
    """(splits, cols_per_split): ``neighbor_compact``'s fixed column split
    for ``n`` atoms — about ``_NC_TARGET_BLOCKS`` scan blocks of 128 rows,
    whole stages of 128 columns a split."""
    return _dense_message_splits(n, n, _NC_TARGET_BLOCKS, _NC_ROWS,
                                 _NC_STAGE)


def neighbor_compact(xyz, node_mask, cutoff: float, k: int):
    """Kernel-built neighbor list (see ``csrc/neighbor_compact.cu``):
    ``(idx, nbr_mask)``, each (N, k), the pairs within the cutoff in
    ascending column order.  The same contract as
    :func:`epnn_tpu_torch.ops.fused.build_neighbors`: k must be at least
    the true max neighbor count, or pairs are dropped; the set is the one
    top-k selects, only the order differs.  idx is int64 (its values equal
    the JAX kernel's int32).  On the card: a scan over the columns split
    into :func:`neighbor_compact_splits` ranges, each range's hits per row
    in int32 scratch, then a merge of the ranges in order."""
    name = "neighbor_compact"
    n = xyz.shape[0]
    device = _check(name, dict(xyz=xyz, node_mask=node_mask),
                    dict(xyz=(n, 3), node_mask=(n,)))
    if device.type == "cpu":
        return neighbor_compact_plain(xyz, node_mask, cutoff, k)
    idx = torch.empty((n, k), dtype=torch.int64, device=xyz.device)
    mask = xyz.new_empty((n, k))
    if n == 0 or k == 0:
        return idx, mask
    splits, cols = neighbor_compact_splits(n)
    work = torch.empty(splits * n * (k + 1), dtype=torch.int32,
                       device=xyz.device)
    _launch(name, device, (xyz, node_mask, work, idx, mask),
            (n, k, splits, cols, float(cutoff * cutoff)), {})
    return idx, mask
