"""What sets the pace of the far-field forward kernel on the card.

``python3 -m epnn_tpu_torch.tools.far_field_pace`` (from the repository
root, with a CUDA card and ``nvcc``) builds ``csrc/dense_message_rowsum.cu``
as it is and three timing-only variants, each at both TF32 tiers (3xTF32
and one pass, ``EPNN_TF32_PASSES``) against text-substituted copies of
``csrc/far_field.cuh`` (and ``csrc/common.cuh``, which the build copies):

* ``no_split`` — A goes to the tensor cores unsplit and unrounded (no
  split ALU work), still the tier's products;
* ``products_only`` — A a constant fragment: no build of A from pi and pj
  and no fold of relu(z2) into the sums (one add a column reads the
  products, so that ``ptxas`` keeps them); the products, and the
  accumulators' start from b2, remain;
* ``elementwise_only`` — A built and the sums folded, with the products
  left out: each k-step's A fragment is xor-ed into an accumulator
  instead (~5 instructions a k-step, against the build's ~28 in 3xTF32),
  so that ``ptxas`` keeps the build.

An ``asm`` statement with no instruction keeps nothing alive: ``ptxas``
removes what no instruction reads, so each variant reads what it keeps.

The variants' results are wrong by construction; only their device times
are kept, at 2,224, 17,760 and 35,520 rows and columns (seeded inputs,
cv = 1, the wrapper's grid).  The overlap share, (products_only +
elementwise_only − kernel) / min(products_only, elementwise_only), is 1
where the shorter of the two parts hides wholly behind the longer and 0
where the kernel pays for both in turn.  Prints a line a tier and size,
each library's registers, spills and any ``ptxas`` note on wgmma, and a
JSON line with the times and the card's name and power limit; exits 2
without a card.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys

import numpy as np
import torch

from epnn_tpu_torch.ops import kernels

#: variant -> [(file, text, its replacement)]: every occurrence of the
#: text is replaced (the two-column walk's, and the one-column loop's,
#: which runs above H = 32 and not at the width timed here); whitespace in
#: the text matches any run of whitespace
#: the call that builds a column's A in the two-column walk
BUILD_A = "far_a<true>(xa, xb, xs, ks, ah[ks], al[ks]);"
VARIANTS = {
    "kernel": [],
    "no_split": [("far_field.cuh", BUILD_A,
                  "{ const float v[4] = {relu(xa[2 * ks] + xs[2 * ks]), "
                  "relu(xb[2 * ks] + xs[2 * ks]), "
                  "relu(xa[2 * ks + 1] + xs[2 * ks + 1]), "
                  "relu(xb[2 * ks + 1] + xs[2 * ks + 1])}; "
                  "for (int r = 0; r < 4; ++r) "
                  "ah[ks][r] = al[ks][r] = __float_as_uint(v[r]); }")],
    "products_only": [
        ("far_field.cuh", BUILD_A,
         "{ ah[ks][0] = ah[ks][1] = ah[ks][2] = ah[ks][3] = 0x3f800000u; "
         "al[ks][0] = al[ks][1] = al[ks][2] = al[ks][3] = 0u; }"),
        ("far_field.cuh", "acc[i] = fmaf(cj, relu(z), acc[i]);",
         "if (i == 0) acc[0] += z;")],
    "elementwise_only": [
        ("far_field.cuh",
         "wg::mma_tier<kHp>(d[chain_of(ks, kNT)], ah[ks], al[ks], b_hi[ks], "
         "b_lo[ks]);",
         "d[chain_of(ks, kNT)][ks] += __uint_as_float("
         "ah[ks][0] ^ ah[ks][1] ^ ah[ks][2] ^ ah[ks][3] ^ "
         "al[ks][0] ^ al[ks][1] ^ al[ks][2] ^ al[ks][3]);")],
}
#: TF32 products a k-step: 3xTF32, one pass
TIERS = (3, 1)
SIZES = (2224, 17760, 35520)


def substitute(text: str, old: str, new: str, where: str) -> str:
    """``text`` with every occurrence of ``old`` (any whitespace between
    its words) replaced by ``new``."""
    pattern = r"\s+".join(re.escape(w) for w in old.split())
    out, count = re.subn(pattern, lambda _: new, text)
    if not count:
        raise RuntimeError(f"{where}: does not hold the text a variant "
                           f"replaces: {old!r}")
    return out


def usage(log: str) -> dict:
    """dmr_partial's registers and spill bytes in an ``-Xptxas -v`` log,
    and its lines about wgmma."""
    out, entry = {}, False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = "dmr_partial" in ln
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if entry and m:
            out["spill_stores"], out["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if entry and m:
            out["registers"] = int(m.group(1))
    out["wgmma_notes"] = [ln.strip() for ln in log.splitlines()
                          if "wgmma" in ln]
    return out


def variant_texts(name: str) -> dict:
    """{header: its text} of variant ``name``."""
    texts = {f: (kernels.CSRC / f).read_text()
             for f in ("common.cuh", "far_field.cuh")}
    for f, old, new in VARIANTS[name]:
        texts[f] = substitute(texts[f], old, new, f"{name}: {f}")
    return texts


def build() -> tuple:
    """Compile the variants at both tiers in parallel into
    ``build/.../pace/<name>-tf32x<passes>``; returns ({(name, passes): the
    C entry}, {(name, passes): :func:`usage`})."""
    source = (kernels.CSRC / "dense_message_rowsum.cu").read_text()
    jobs = {}
    for name in VARIANTS:
        texts = variant_texts(name)
        for passes in TIERS:
            d = kernels.BUILD_DIR / "pace" / f"{name}-tf32x{passes}"
            d.mkdir(parents=True, exist_ok=True)
            for f, text in texts.items():
                (d / f).write_text(text)
            (d / "kernel.cu").write_text(source)
            cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS,
                   f"-DEPNN_TF32_PASSES={passes}", "-o", str(d / "lib.so"),
                   str(d / "kernel.cu")]
            jobs[name, passes] = (d, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    fns, logs = {}, {}
    for key, (d, proc) in jobs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"{key}: nvcc failed:\n{log[-3000:]}")
        fn = ctypes.CDLL(str(d / "lib.so")).epnn_dense_message_rowsum
        fn.argtypes = kernels._ARGTYPES["dense_message_rowsum"]
        fn.restype = ctypes.c_int
        fns[key] = fn
        logs[key] = usage(log)
    return fns, logs


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


def overlap_share(t: dict) -> float:
    """(products_only + elementwise_only − kernel) / the shorter part."""
    p, e = t["products_only"], t["elementwise_only"]
    return (p + e - t["kernel"]) / min(p, e)


def main() -> int:
    if not torch.cuda.is_available():
        print("far_field_pace: no CUDA card", file=sys.stderr)
        return 2
    fns, logs = build()
    for (name, passes), u in logs.items():
        print(f"[pace] {name} tf32x{passes}: {u.get('registers')} registers, "
              f"{u.get('spill_stores')} / {u.get('spill_loads')} B spill "
              f"stores / loads; wgmma notes: {u['wgmma_notes'] or 'none'}")
    g = np.random.default_rng(0)
    h = kernels.KERNEL_H
    times = {f"tf32x{p}": {name: {} for name in VARIANTS} for p in TIERS}
    overlap = {f"tf32x{p}": {} for p in TIERS}
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
        for (name, passes), fn in fns.items():
            def call(fn=fn, key=(name, passes)):
                err = fn(pi.data_ptr(), pj.data_ptr(), cv.data_ptr(),
                         w2.data_ptr(), b2.data_ptr(), part.data_ptr(),
                         out.data_ptr(), n, n, h, splits, cols, stream)
                if err:
                    raise RuntimeError(f"{key}: launch failed ({err})")
            times[f"tf32x{passes}"][name][n] = device_ms(
                call, 20 if n < 5000 else 5)
        for tier, t in times.items():
            at_n = {name: v[n] for name, v in t.items()}
            overlap[tier][n] = overlap_share(at_n)
            print(f"[pace] N={n} {tier}: " + ", ".join(
                f"{name} {v:.4f} ms" for name, v in at_n.items())
                + f"; overlap share {overlap[tier][n]:.3f}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"far_field_pace_ms": times, "overlap_share": overlap,
                      "ptxas": {f"{k[0]}-tf32x{k[1]}": v
                                for k, v in logs.items()},
                      "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
