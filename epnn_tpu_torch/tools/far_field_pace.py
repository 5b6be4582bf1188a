"""What sets the pace of the far-field forward kernel on the card.

``python3 -m epnn_tpu_torch.tools.far_field_pace`` (from the repository
root, with a CUDA card and ``nvcc``) builds ``csrc/dense_message_rowsum.cu``
as it is and two timing-only variants, each against a text-substituted copy
of ``csrc/common.cuh``:

* ``one_mma`` — one TF32 product a k-step (hi·hi) instead of 3xTF32's three:
  ``common.cuh``'s default tier set to one pass, which is the kernel's
  ``precision="default"`` tier;
* ``no_split`` — the operands go to the tensor cores unsplit and unrounded
  (no split ALU work), still three products.

``no_split``'s results are wrong by construction; only the variants'
device times are kept, at 2,224 and 17,760 rows and columns (seeded inputs, cv = 1, the
wrapper's grid).  When ``one_mma`` runs far faster than the kernel and
``no_split`` barely faster, the tensor-core products set the pace.  Prints
a line a size and a JSON line with the times and the card's name and power
limit; exits 2 without a card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from epnn_tpu_torch.ops import kernels

#: variant -> [(text of common.cuh, its replacement)]
VARIANTS = {
    "kernel": [],
    "one_mma": [("#define EPNN_TF32_PASSES 3\n", "#define EPNN_TF32_PASSES 1\n")],
    "no_split": [("  const float h = tf32_round(x);\n"
                  "  hi = __float_as_uint(h);\n"
                  "  lo = kSplit ? __float_as_uint(tf32_round(x - h)) : 0u;",
                  "  hi = __float_as_uint(x);\n  lo = hi;")],
}
SIZES = (2224, 17760)


def build() -> dict:
    """Compile the variants in parallel into ``build/.../pace/<name>``;
    returns {name: the C entry}."""
    common = (kernels.CSRC / "common.cuh").read_text()
    source = (kernels.CSRC / "dense_message_rowsum.cu").read_text()
    jobs = {}
    for name, subs in VARIANTS.items():
        text = common
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: common.cuh no longer holds the "
                                   "text this variant replaces")
            text = text.replace(old, new)
        d = kernels.BUILD_DIR / "pace" / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "common.cuh").write_text(text)
        (d / "far_field.cuh").write_text(
            (kernels.CSRC / "far_field.cuh").read_text())
        (d / "kernel.cu").write_text(source)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / "kernel.cu")]
        jobs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT))
    fns = {}
    for name, (d, proc) in jobs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{log[-3000:]}")
        fn = ctypes.CDLL(str(d / "lib.so")).epnn_dense_message_rowsum
        fn.argtypes = kernels._ARGTYPES["dense_message_rowsum"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def device_ms(fn, iters: int) -> float:
    """Device ms a call: a sleep kernel holds the stream while ``iters``
    calls are enqueued between two events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("far_field_pace: no CUDA card", file=sys.stderr)
        return 2
    fns = build()
    g = np.random.default_rng(0)
    h = kernels.KERNEL_H
    times = {name: {} for name in fns}
    for n in SIZES:
        pi, pj = (torch.from_numpy(g.normal(size=(n, h)).astype(np.float32))
                  .cuda() for _ in range(2))
        cv = torch.ones(n, device="cuda")
        w2 = torch.from_numpy((g.normal(size=(h, h)) * 0.3).astype(
            np.float32)).cuda()
        b2 = torch.from_numpy(g.normal(size=h).astype(np.float32)).cuda()
        splits, cols = kernels._dense_message_splits(n, n)
        part = torch.empty((splits, n, h), device="cuda")
        out = torch.empty((n, h), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        for name, fn in fns.items():
            def call(fn=fn):
                err = fn(pi.data_ptr(), pj.data_ptr(), cv.data_ptr(),
                         w2.data_ptr(), b2.data_ptr(), part.data_ptr(),
                         out.data_ptr(), n, n, h, splits, cols, stream)
                if err:
                    raise RuntimeError(f"{name}: launch failed ({err})")
            times[name][n] = device_ms(call, 20 if n < 5000 else 5)
        print(f"[pace] N={n}: " + ", ".join(
            f"{name} {t[n]:.4f} ms" for name, t in times.items()))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"far_field_pace_ms": times, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
