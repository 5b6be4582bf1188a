"""What sets the pace of the two near-field kernels on the card.

``python3 -m epnn_tpu_torch.tools.near_field_pace [--csrc LABEL=DIR ...]``
(from the repository root, with a CUDA card and ``nvcc``) builds
``near_message_corr.cu`` and ``near_pass_rowsum.cu`` from each source
directory (default: this package's ``csrc``; another checkout's, such as
a parent commit's, can be timed beside it in the same call) as they are,
and as timing-only variants, each a text substitution in the kernel's
source or in ``common.cuh``:

* ``one_tf32`` — one TF32 product a k-step (hi·hi) instead of 3xTF32's
  three (tensor-core design): the kernels' ``precision="default"`` tier
  (``EPNN_TF32_PASSES=1``), or on an older tree the same by substitution;
* ``no_compaction`` — every slot counts as live, so dead slots take MMA
  rows as well (tensor-core design; the result is unchanged, as a dead
  slot's weight is 0);
* ``no_rowsum`` — the tiles' terms are not added into the row sums
  (tensor-core design);
* ``other_blocks`` — the registers budgeted for three resident blocks an
  SM instead of four (up to 168 a thread instead of 128), or the reverse
  (``kMinBlocks``);
* ``min_rows_4`` — a warp owns 4 rows at the least instead of 2 (fewer
  warps at small N, fewer partly filled tiles);
* ``no_restage`` — the per-block copy of W1e and W2 into shared memory
  left out (the earlier design: a warp a row, a lane a slot, the products
  on the CUDA cores);
* ``no_mid`` — the two mid-layer products left out (the earlier design).

A variant whose text a source does not hold, or that does not build, is
reported as ``n/a``.  ``one_tf32``, ``no_rowsum``, ``no_restage`` and
``no_mid`` give wrong results by construction; only the device times of
all are kept, on the neighbor tables of the 2,220-atom and 17,760-atom
water boxes (:func:`near_inputs`: the boxes of ``chip_smoke.py``,
``trained/mixed_b16``'s round weights, seeded h).  Prints the registers
and spills of each kernel (and of ``other_blocks``), a line a size, and a
JSON line with the times and the card's name and power limit; exits 2
without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from epnn_tpu_torch.ops import kernels

CKPT = "trained/mixed_b16"
NAMES = ("near_message_corr", "near_pass_rowsum")

#: variant -> [(text, its replacement)], alternatives: the first that the
#: kernel source or common.cuh holds is made; one in common.cuh counts only
#: for a kernel that calls a function it changes (NEEDS: any of these names
#: in the kernel source)
VARIANTS = {
    "kernel": [],
    "one_tf32": [("#define EPNN_TF32_PASSES 3\n", "#define EPNN_TF32_PASSES 1\n"),
                 ("  mma_tf32(d, al, b.x, b.y);\n  mma_tf32(d, ah, b.z, b.w);\n",
                  "")],
    "no_compaction": [("const bool live = in && w != 0.0f;",
                       "const bool live = in;")],
    "no_rowsum": [("    for (int e = 0; e < n; ++e) {\n      const int row = rows[",
                   "    for (int e = 0; e < 0; ++e) {\n      const int row = rows[")],
    "other_blocks": [("constexpr int kMinBlocks = 4;",
                      "constexpr int kMinBlocks = 3;"),
                     ("constexpr int kMinBlocks = 3;",
                      "constexpr int kMinBlocks = 4;")],
    "min_rows_4": [("constexpr int kNearMinRows = 2;",
                    "constexpr int kNearMinRows = 4;")],
    "no_restage": [("  epnn::stage(s_w1e, w1e, E * H);\n"
                    "  epnn::stage(s_w2, w2, H * H);\n", "")],
    "no_mid": [("epnn::matvec2_bias<H, H>(zf, zn, s_w2, s_b2, yf, yn);",
                "for (int o = 0; o < H; ++o) { yf[o] = zf[o]; yn[o] = zn[o]; }"),
               ("epnn::matvec2_bias<H, H>(zn, zt, s_w2, s_b2, yn, yt);",
                "for (int o = 0; o < H; ++o) { yn[o] = zn[o]; yt[o] = zt[o]; }")],
}
NEAR_TILE_FNS = ("near_walk", "near_epart")
NEEDS = {"one_tf32": ("mma_tier", "mma_3xtf32") + NEAR_TILE_FNS,
         "no_compaction": NEAR_TILE_FNS, "no_rowsum": NEAR_TILE_FNS,
         "min_rows_4": NEAR_TILE_FNS}
ITERS = 50


def near_inputs(pred, batch, g):
    """The two near kernels' arguments on graph 0 of ``batch``, as the
    neighbor split builds them: the box's own top-k table (k from
    ``pred``), its RBF and gate, the message weights of round 2 and the
    pass weights of round 1, projections of seeded random h (``g``).
    Returns ``{kernel name: args}`` and the table ``(idx, mask)``."""
    from epnn_tpu_torch.ops.fused import build_neighbors, rbf_and_gate

    cfg, dev = pred.cfg, pred.device
    n = batch.padded_atoms
    k = pred._neighbor_k(batch)
    x, xyz, mask, q0 = (torch.from_numpy(np.ascontiguousarray(a[0])).to(dev)
                        for a in (batch.x, batch.xyz, batch.node_mask,
                                  batch.q0))
    h = torch.from_numpy(g.normal(size=(n, cfg.h_dim)).astype(np.float32)
                         ).to(dev) * mask[:, None]
    idx, nbr_mask, d2 = build_neighbors(xyz, mask, cfg.cutoff, k, with_d2=True)
    rbf, gate = rbf_and_gate(d2, nbr_mask, cfg)
    rbf_flat = rbf.reshape(n * k, -1).contiguous()
    idx_flat = idx.reshape(-1)
    a = torch.cat([x, h, q0[:, None]], dim=-1)
    wm, wp = pred._fused.messages[1], pred._fused.passes[0]
    pi = (a @ wm.w1_i + wm.b1).contiguous()
    pj = (a @ wm.w1_j).contiguous()
    rs = torch.cat([a @ wp.w1_i + wp.b1, a @ wp.w1_j], dim=-1).contiguous()
    gh = (0.5 * gate * nbr_mask).contiguous()
    return {
        "near_message_corr": (pi, pj[idx_flat].contiguous(), rbf_flat,
                              nbr_mask.contiguous(), wm.w1_e, *wm.mids[0]),
        "near_pass_rowsum": (rs, rs[idx_flat].contiguous(), rbf_flat, gh,
                             wp.w1_e, *wp.mids[0]),
    }, (idx, nbr_mask)


def _substituted(text: str, subs) -> tuple:
    """(text with the first of the substitutions that it holds, 1), or
    (text, 0): a variant's substitutions are alternatives, one for each
    kind of source."""
    for old, new in subs:
        if old in text:
            return text.replace(old, new), 1
    return text, 0


def build(csrc: Path, label: str) -> dict:
    """Compile every variant of both kernels from ``csrc`` in parallel into
    ``build/.../near_pace/<label>/<variant>/``; returns
    {(kernel, variant): C entry, or None where the variant does not apply
    or does not build} and prints each built kernel's registers and
    spills."""
    common = (csrc / "common.cuh").read_text()
    jobs, fns = {}, {}
    for name in NAMES:
        source = (csrc / kernels.SOURCES[name]).read_text()
        for variant, subs in VARIANTS.items():
            src, held_src = _substituted(source, subs)
            com, held_com = _substituted(common, subs)
            if variant in NEEDS and not any(fn in source
                                            for fn in NEEDS[variant]):
                held_com = 0
            if subs and held_src + held_com == 0:
                fns[(name, variant)] = None
                continue
            d = kernels.BUILD_DIR / "near_pace" / label / variant
            d.mkdir(parents=True, exist_ok=True)
            (d / "common.cuh").write_text(com)
            (d / f"{name}.cu").write_text(src)
            lib = d / f"lib{name}.so"
            cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib),
                   str(d / f"{name}.cu")]
            jobs[(name, variant)] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    for (name, variant), (lib, proc) in jobs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            print(f"[pace] {label} {name} {variant}: nvcc failed, not timed:"
                  f"\n{log[-3000:]}")
            fns[(name, variant)] = None
            continue
        if variant in ("kernel", "other_blocks"):
            for ln in log.splitlines():
                if re.search(r"registers|spill", ln):
                    print(f"[pace] {label} {name} {variant}: {ln.strip()}")
        fn = getattr(ctypes.CDLL(str(lib)), f"epnn_{name}")
        fn.argtypes = kernels._ARGTYPES[name]
        fn.restype = ctypes.c_int
        fns[(name, variant)] = fn
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
        print("near_field_pace: no CUDA card", file=sys.stderr)
        return 2
    from epnn_tpu_torch.data import pad_molecules
    from epnn_tpu_torch.elements import table_for_n_elems
    from epnn_tpu_torch.infer import Predictor
    from epnn_tpu_torch.testing import (SCALING_SIZE_MOLECULES, golden_boxes,
                                        water_box)

    torch.backends.cuda.matmul.allow_tf32 = False
    dirs = {"change": kernels.CSRC}
    for item in args.csrc:
        label, _, path = item.partition("=")
        dirs[label] = Path(path)
    fns = {label: build(d, label) for label, d in dirs.items()}

    pred = Predictor.from_checkpoint(CKPT)
    table = table_for_n_elems(pred.cfg.n_elems)
    boxes = {"2220": golden_boxes()[0],
             "17760": water_box(SCALING_SIZE_MOLECULES, seed=2)}
    times, live = {}, {}
    stream = torch.cuda.current_stream().cuda_stream
    for size, mol in boxes.items():
        batch = pad_molecules([mol], table)
        cases, _ = near_inputs(pred, batch, np.random.default_rng(0))
        for name, targs in cases.items():
            n, k = targs[3].shape
            live[f"{name} {size}"] = int(torch.count_nonzero(targs[3]))
            out = torch.empty((n, kernels.KERNEL_H), device="cuda")
            for label, lib in fns.items():
                for variant in VARIANTS:
                    fn = lib[(name, variant)]
                    key = f"{label} {name} {variant}"
                    if fn is None:
                        times.setdefault(key, {})[size] = None
                        continue

                    def call(fn=fn, key=key):
                        err = fn(*[t.data_ptr() for t in targs],
                                 out.data_ptr(), None, n, k,
                                 kernels.KERNEL_H,
                                 kernels.KERNEL_E, stream)
                        if err:
                            raise RuntimeError(f"{key}: launch failed ({err})")
                    times.setdefault(key, {})[size] = device_ms(call, ITERS)
            print(f"[pace] {name} at {size} atoms (N={n}, K={k}, "
                  f"{live[f'{name} {size}']:,} live slots): " + ", ".join(
                      f"{key.replace(name + ' ', '')} "
                      + ("n/a" if t[size] is None else f"{t[size]:.4f} ms")
                      for key, t in times.items() if f" {name} " in key))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"near_field_pace_ms": times, "live_slots": live,
                      "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
