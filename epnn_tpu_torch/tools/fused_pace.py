"""What sets the pace of the two fused dense kernels on the card.

``python3 -m epnn_tpu_torch.tools.fused_pace [--csrc LABEL=DIR ...]``
(from the repository root, with a CUDA card and ``nvcc``) builds
``fused_message_rowsum.cu`` and ``fused_epn_rowsum.cu`` from each source
directory (default: this package's ``csrc``; another checkout's, such as
a parent commit's, is timed beside it in the same call, the two in turns)
as they are and as timing-only variants, each a text substitution in the
kernel's source or in ``common.cuh``:

* ``scan_only`` — the d² scan runs and the live pairs are found, but no
  tile runs (the ring is emptied as it fills): the scan's time;
* ``blocks_4`` — the registers budgeted for four resident blocks an SM
  instead of three (128 a thread instead of 168);
* ``no_far`` — ``fused_message_rowsum``'s far-field blocks return at once:
  the live correction's time (the scan and the tiles);
* ``no_channels`` — a live pair's E channels are 0 (no exps): their cost;
* ``one_tf32`` — one TF32 product a k-step (hi·hi) instead of 3xTF32's
  three, in every tensor-core helper.

The kernels as they are run under ``rbf_method`` "direct" and, where the
source takes it (an ``int doubling`` argument), "doubling"; a source
without it (a tree from before the method) runs direct alone, with its
own entry's arguments.  The variants' results are wrong by construction;
only their device times are kept, at the shipped widths on the 2,220-atom
and 17,760-atom water boxes of ``chip_smoke.py`` (seeded pi and pj,
random weights; the masked message mode and the hard gate).  Prints a
line a size and a JSON line with the times and the card's name and power
limit; exits 2 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from epnn_tpu_torch.featurize import doubling_u_scale, rbf_table
from epnn_tpu_torch.ops import kernels

NAMES = ("fused_message_rowsum", "fused_epn_rowsum")
#: variant -> [(text, its replacement)], in the kernel source or
#: common.cuh; a variant whose text neither holds is not built
VARIANTS = {
    "kernel": [],
    "scan_only": [("    while (tail - head >= 16) run(16);\n  }\n"
                   "  if (tail > head) run(tail - head);\n",
                   "    head = tail;\n  }\n")],
    "blocks_4": [("constexpr int kMinBlocks = 3;",
                  "constexpr int kMinBlocks = 4;"),
                 ("__launch_bounds__(epnn::kNearThreads, 3)",
                  "__launch_bounds__(epnn::kNearThreads, 4)")],
    "no_far": [("    if (masked)\n      epnn::far::rows<true>(fs, pi, pj, mask, "
                "w2, b2, mask, part, N, N,\n                            "
                "cols_per_split, bx, by);\n    else\n      "
                "epnn::far::rows<false>(fs, pi, pj, cv, w2, b2, nullptr, part, "
                "N, N,\n                             cols_per_split, bx, by);\n",
                "    (void)fs;\n    (void)bx;\n    (void)by;\n")],
    "no_channels": [("? rbf_channel(c, d, mu[e], neg_eta)", "? 0.0f * mu[e]"),
                    ("? channel<dbl>(c, d, a, u, tab[e], e, neg_eta)",
                     "? 0.0f * tab[e]")],
    "one_tf32": [("#define EPNN_TF32_PASSES 3\n", "#define EPNN_TF32_PASSES 1\n"),
                 ("  mma_tf32(d, al, b.x, b.y);\n  mma_tf32(d, ah, b.z, b.w);\n",
                  ""),
                 ("  Mma<N>::run(d, al, b_hi);\n  Mma<N>::run(d, ah, b_lo);\n",
                  "")],
}
ITERS = {2224: 20, 17760: 5}
#: the C entries' argument types before the RBF method's two arguments
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
DIRECT_ONLY_ARGTYPES = {
    "fused_message_rowsum": [_P] * 12 + [_I] * 6 + [_F] * 3 + [_P],
    "fused_epn_rowsum": [_P] * 10 + [_I] * 4 + [_F] * 4 + [_P],
}


def build(csrc: Path, label: str) -> dict:
    """Compile every variant of both kernels from ``csrc`` in parallel
    into ``build/.../fused_pace/<label>/<variant>/``; returns {(kernel,
    variant): (the C entry, whether it takes the RBF method), or None
    where the variant's text is in neither file}."""
    files = {f: (csrc / f).read_text() for f in ("common.cuh",
                                                 "far_field.cuh",
                                                 "wide.cuh")
             if (csrc / f).exists()}
    jobs, fns, methods = {}, {}, {}
    for name in NAMES:
        source = (csrc / kernels.SOURCES[name]).read_text()
        methods[name] = "int doubling" in source
        for variant, subs in VARIANTS.items():
            texts = dict(files, kernel=source)
            held = 0
            for old, new in subs:
                for key, text in texts.items():
                    if old in text:
                        texts[key] = text.replace(old, new)
                        held += 1
            if subs and not held:
                fns[(name, variant)] = None
                continue
            d = kernels.BUILD_DIR / "fused_pace" / label / variant
            d.mkdir(parents=True, exist_ok=True)
            for f in files:
                (d / f).write_text(texts[f])
            (d / f"{name}.cu").write_text(texts["kernel"])
            lib = d / f"lib{name}.so"
            cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib),
                   str(d / f"{name}.cu")]
            jobs[(name, variant)] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    for key, (lib, proc) in jobs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"{key}: nvcc failed:\n{log[-3000:]}")
        if key[1] in ("kernel", "blocks_4"):
            for ln in log.splitlines():
                if "registers" in ln or "spill" in ln:
                    print(f"[pace] {label} {key[0]} {key[1]}: {ln.strip()}")
        fn = getattr(ctypes.CDLL(str(lib)), f"epnn_{key[0]}")
        fn.argtypes = (kernels._ARGTYPES if methods[key[0]]
                       else DIRECT_ONLY_ARGTYPES)[key[0]]
        fn.restype = ctypes.c_int
        fns[key] = (fn, methods[key[0]])
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", action="append", default=[],
                    metavar="LABEL=DIR",
                    help="another source directory to time (repeatable)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fused_pace: no CUDA card", file=sys.stderr)
        return 2
    from epnn_tpu_torch.data import pad_molecules
    from epnn_tpu_torch.elements import table_for_n_elems
    from epnn_tpu_torch.testing import (SCALING_SIZE_MOLECULES, golden_boxes,
                                        water_box)

    torch.backends.cuda.matmul.allow_tf32 = False
    dirs = {"change": kernels.CSRC}
    for item in args.csrc:
        label, _, path = item.partition("=")
        dirs[label] = Path(path)
    libs = {label: build(d, label) for label, d in dirs.items()}
    # in turns: each other tree, this one, this one again, the other again
    order = ["change"]
    for label in dirs:
        if label != "change":
            order = [label, "change", "change", label]
    fns = {}
    for turn, label in enumerate(order):
        for (name, variant), fn in libs[label].items():
            fns[(name, f"{label}#{turn} {variant}" if len(order) > 1
                 else variant)] = fn
    h, e, cutoff, eta, tol = kernels.KERNEL_H, kernels.KERNEL_E, 3.0, 2.0, 1e-5
    g = np.random.default_rng(0)
    dev = torch.device("cuda")
    rand = lambda *s, sc=1.0: torch.from_numpy(  # noqa: E731
        (g.normal(size=s) * sc).astype(np.float32)).to(dev)
    w1e, w2, b2 = rand(e, h, sc=0.3), rand(h, h, sc=0.3), rand(h, sc=0.3)
    tables = {m: rbf_table(e, cutoff, eta, m, dev) for m in
              ("direct", "doubling")}
    u_scale = doubling_u_scale(e, cutoff, eta)
    table = table_for_n_elems(10)
    times = {}
    stream = torch.cuda.current_stream().cuda_stream
    for mol in (golden_boxes()[0], water_box(SCALING_SIZE_MOLECULES, seed=2)):
        batch = pad_molecules([mol], table)
        n = batch.padded_atoms
        xyz = torch.from_numpy(batch.xyz[0]).to(dev)
        mask = torch.from_numpy(batch.node_mask[0]).to(dev)
        pi, pj = rand(n, h), rand(n, h)
        ones = torch.ones(n, device=dev)
        out = torch.empty((n, h), device=dev)
        splits, cols = kernels._dense_message_splits(n, n)
        part = torch.empty((splits + 1, n, h), device=dev)
        cut2 = kernels._cut2(cutoff)
        for (name, variant), entry in fns.items():
            if entry is None:
                times.setdefault(f"{name} {variant}", {})[n] = None
                continue
            fn, takes = entry
            for method in (("direct", "doubling")
                           if takes and variant.endswith("kernel")
                           else ("direct",)):
                key = f"{name} {variant}" + (f" {method}" if takes else "")
                dbl = int(method == "doubling")
                tab = tables[method]
                if name == "fused_message_rowsum":
                    ptrs = (pi, pj, xyz, mask, ones, w1e, w2, b2, tab, part,
                            out, None)
                    scal = ((n, h, e, splits, cols, 1, dbl, cutoff, eta,
                             cut2, u_scale * dbl) if takes else
                            (n, h, e, splits, cols, 1, cutoff, eta, cut2))
                else:
                    ptrs = (pi, pj, xyz, mask, w1e, w2, b2, tab, out, None)
                    scal = ((n, h, e, 0, dbl, cutoff, eta, tol, cut2,
                             u_scale * dbl) if takes else
                            (n, h, e, 0, cutoff, eta, tol, cut2))

                def call(fn=fn, ptrs=ptrs, scal=scal, key=key):
                    err = fn(*[None if t is None else t.data_ptr()
                               for t in ptrs], *scal, stream)
                    if err:
                        raise RuntimeError(f"{key}: launch failed ({err})")
                times.setdefault(key, {})[n] = device_ms(call,
                                                         ITERS.get(n, 5))
        print(f"[pace] N={n}: " + ", ".join(
            f"{key} " + ("n/a" if t[n] is None else f"{t[n]:.4f} ms")
            for key, t in times.items()))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"fused_pace_ms": times, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
