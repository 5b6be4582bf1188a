"""What sets the pace of ``neighbor_compact`` on the card.

``python3 -m epnn_tpu_torch.tools.compact_pace`` (from the repository root,
with a CUDA card and ``nvcc``) builds ``csrc/neighbor_compact.cu`` as it is
and as timing-only variants, each a text substitution in its source:

* ``no_cull`` — every stage is scanned (the bounding-box cull off);
* ``no_hits`` — a group's hits are counted but not taken one by one (no
  list, no self test): the cost of taking them;
* ``scan_only`` — the merge is not launched: the scan's time;
* ``merge_only`` — the scan is not launched: the merge's time (on the
  scratch of the call before);
* ``empty`` — neither kernel does any work (each returns at once): two
  launches' floor.

The variants' results are wrong by construction; only their device times
are kept.  Each runs at the wrapper's column split and, as it is, also at
one split (``splits_1``) and at twice the wrapper's (``splits_x2``), on
the 2,220-atom and 17,760-atom water boxes of ``chip_smoke.py`` in lattice
order and in a seeded shuffle, k = 24.  Prints a line a box and a JSON
line with the times and the card's name and power limit; exits 2 without
a card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from epnn_tpu_torch.ops import kernels

NAME = "neighbor_compact"
#: variant -> [(text, its replacement)] in the kernel's source
VARIANTS = {
    "kernel": [],
    "no_cull": [("if (live && !apart(rbox, cbox, cutoff2)) {",
                 "if (live) {")],
    "no_hits": [("        while (m) {  // ascending columns",
                 "        c += __popc(m);\n        m = 0;\n"
                 "        while (m) {  // ascending columns")],
    "scan_only": [("  nc_merge<<<", "  if (0) nc_merge<<<")],
    "merge_only": [("  nc_scan<<<", "  if (0) nc_scan<<<")],
    "empty": [("  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n"
               "  const int i = blockIdx.x * kRows + threadIdx.x;",
               "  if (N > 0) return;\n"
               "  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n"
               "  const int i = blockIdx.x * kRows + threadIdx.x;"),
              ("  const int i = blockIdx.x * kMergeWarps + (threadIdx.x >> 5);\n"
               "  if (i >= N) return;",
               "  const int i = blockIdx.x * kMergeWarps + (threadIdx.x >> 5);\n"
               "  if (i >= 0) return;")],
}
K = 24


def build() -> dict:
    """Compile every variant in parallel into ``build/.../compact_pace/``;
    returns {variant: the C entry}."""
    source = (kernels.CSRC / kernels.SOURCES[NAME]).read_text()
    common = (kernels.CSRC / "common.cuh").read_text()
    jobs, fns = {}, {}
    for variant, subs in VARIANTS.items():
        text = source
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{variant}: {old!r} is not in the source")
            text = text.replace(old, new)
        d = kernels.BUILD_DIR / "compact_pace" / variant
        d.mkdir(parents=True, exist_ok=True)
        (d / "common.cuh").write_text(common)
        (d / f"{NAME}.cu").write_text(text)
        lib = d / f"lib{NAME}.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib),
               str(d / f"{NAME}.cu")]
        jobs[variant] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    for variant, (lib, proc) in jobs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"{variant}: nvcc failed:\n{log[-3000:]}")
        if variant == "kernel":
            for ln in log.splitlines():
                if "registers" in ln or "spill" in ln:
                    print(f"[pace] {variant}: {ln.strip()}")
        fn = getattr(ctypes.CDLL(str(lib)), f"epnn_{NAME}")
        fn.argtypes = kernels._ARGTYPES[NAME]
        fn.restype = ctypes.c_int
        fns[variant] = fn
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
        print("compact_pace: no CUDA card", file=sys.stderr)
        return 2
    from epnn_tpu_torch.data import pad_molecules
    from epnn_tpu_torch.elements import table_for_n_elems
    from epnn_tpu_torch.testing import (SCALING_SIZE_MOLECULES, golden_boxes,
                                        water_box)

    fns = build()
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    table = table_for_n_elems(10)
    cutoff2 = 3.0 * 3.0
    times = {}
    for mol in (golden_boxes()[0], water_box(SCALING_SIZE_MOLECULES, seed=2)):
        batch = pad_molecules([mol], table)
        n = batch.padded_atoms
        xyz0 = torch.from_numpy(batch.xyz[0]).to(dev)
        mask0 = torch.from_numpy(batch.node_mask[0]).to(dev)
        perm = torch.from_numpy(np.random.default_rng(7).permutation(n)).to(
            dev)
        splits, cols = kernels.neighbor_compact_splits(n)
        for order, xyz, mask in (("ordered", xyz0, mask0),
                                 ("shuffled", xyz0[perm].contiguous(),
                                  mask0[perm].contiguous())):
            label = f"{n} {order}"
            idx = torch.empty((n, K), dtype=torch.int64, device=dev)
            nmask = torch.empty((n, K), device=dev)
            runs = [(v, fn, splits, cols) for v, fn in fns.items()]
            runs += [("splits_1", fns["kernel"], 1, n)]
            s2 = min(-(-n // kernels._NC_STAGE), 2 * splits)
            c2 = -(-n // s2)
            runs += [("splits_x2", fns["kernel"], -(-n // c2), c2)]
            for variant, fn, sp, cp in runs:
                work = torch.empty(sp * n * (K + 1), dtype=torch.int32,
                                   device=dev)

                def call(fn=fn, sp=sp, cp=cp, work=work, variant=variant):
                    err = fn(xyz.data_ptr(), mask.data_ptr(), work.data_ptr(),
                             idx.data_ptr(), nmask.data_ptr(), n, K, sp, cp,
                             cutoff2, stream)
                    if err:
                        raise RuntimeError(f"{variant}: launch failed ({err})")
                times.setdefault(variant, {})[label] = dict(
                    ms=device_ms(call, 50 if n < 4096 else 10), splits=sp)
            print(f"[pace] N={n} {order} (splits {splits}): " + ", ".join(
                f"{v} {t[label]['ms']:.4f} ms" for v, t in times.items()))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"compact_pace_ms": times, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
