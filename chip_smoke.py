#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``epnn_tpu_torch``) on one NVIDIA
card: ``python3 chip_smoke.py`` from the repository root.

1. Device: the card's name and power limit; TF32 is switched off (the
   port's precision is float32 throughout).
2. Build: the three CUDA kernels from ``epnn_tpu_torch/csrc``, one
   ``nvcc`` per source, in parallel.
3. Kernels: each kernel against its plain PyTorch version on the card, at
   the shapes of the 2,220-atom water box (the checkpoint's round weights,
   the box's own neighbor table), and again with the inputs it reads one
   float at a time moved off the 16-byte boundary; kernel, plain and bound
   times, the bound counting only what this data needs (live slots); the
   ``near_pass_rowsum`` antisymmetry probe on that table.
4. Slice: ``Predictor.from_checkpoint("trained/mixed_b16")`` serving
   (a) small molecules on the dense path (no kernel may launch),
   (b) the two 2,220-atom boxes (Q = 0, +1) against the committed JAX
   golden charges, and padded to a width that is no multiple of 4,
   (c) the 17,760-atom box; launch counts per graph
   forward, conservation, and the median ``predict_batch`` latency.
5. The kernels' JSON line, the card line, and last the result line.

Any failure raises and exits non-zero; without a CUDA card it exits 2
before printing any result.  Imports nothing of JAX.
"""

import json
import subprocess
import sys
import time

import numpy as np

#: published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
#: cores, and HBM3 bandwidth — the bound of a kernel is the larger of its
#: FLOP and byte times at these rates
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

GOLDEN = "epnn_tpu_torch/testdata/water2220_mixed_b16.npz"
CKPT = "trained/mixed_b16"
KERNEL_ROWS = {
    # name -> (TPU kernel it replaces, CUDA source)
    "dense_message_rowsum": ("epnn_tpu/ops/pallas_kernels.py:98",
                             "epnn_tpu_torch/csrc/dense_message_rowsum.cu"),
    "near_message_corr": ("epnn_tpu/ops/pallas_kernels.py:1286",
                          "epnn_tpu_torch/csrc/near_message_corr.cu"),
    "near_pass_rowsum": ("epnn_tpu/ops/pallas_kernels.py:1410",
                         "epnn_tpu_torch/csrc/near_pass_rowsum.cu"),
}
#: launches of each kernel per graph forward with the round-1 collapse (T=5)
PER_GRAPH = {"dense_message_rowsum": 4, "near_message_corr": 5,
             "near_pass_rowsum": 5}


def require(ok, detail) -> None:
    """A check that stays under ``python -O`` (unlike ``assert``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {detail}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def device_ms(torch, fn, iters):
    """Device ms per call: a sleep kernel holds the stream while ``iters``
    calls are enqueued between two events, so the host's launch cost does
    not show in the interval."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # ~0.1 s of GPU cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from epnn_tpu_torch.data import pad_molecules
    from epnn_tpu_torch.elements import table_for_n_elems
    from epnn_tpu_torch.infer import Predictor
    from epnn_tpu_torch.ops import kernels
    from epnn_tpu_torch.ops.fused import build_neighbors, rbf_and_gate
    from epnn_tpu_torch.testing import (
        SCALING_SIZE_MOLECULES,
        disjoint_pair_gh,
        golden_boxes,
        water_box,
    )

    # ---- 1. device --------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")
    print(f"[device] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}"
          f" cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # ---- 2. build ---------------------------------------------------------
    secs = kernels.build()
    print(f"[build] {len(kernels.SOURCES)} kernels in {secs:.1f} s "
          f"({kernels.BUILD_DIR})")
    for name in kernels.SOURCES:
        for ln in kernels.build_log(name).splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"[build] {name}: {ln.strip()}")

    # ---- 3. kernels against their plain versions --------------------------
    dev = torch.device("cuda")
    pred = Predictor.from_checkpoint(CKPT)
    cfg = pred.cfg
    table = table_for_n_elems(cfg.n_elems)
    batch2 = pad_molecules(golden_boxes(), table)
    n = batch2.padded_atoms
    k = pred._neighbor_k(batch2)
    g = np.random.default_rng(0)
    x = torch.from_numpy(batch2.x[0]).to(dev)
    xyz = torch.from_numpy(batch2.xyz[0]).to(dev)
    mask = torch.from_numpy(batch2.node_mask[0]).to(dev)
    q0 = torch.from_numpy(batch2.q0[0]).to(dev)
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
    f = 4  # bytes per float32
    hh, ee = cfg.mlp_hidden[0], cfg.e_dim
    n_valid = int(mask.sum())
    w_bytes = f * (ee * hh + hh * hh + hh)  # W1e, W2, b2

    def near_need(live, row_w, slot_w, flop_per_slot):
        """(FLOP, bytes) a near kernel needs on this data: the live slots'
        gathered rows and RBF rows, the row inputs of rows with a live
        slot, the whole (N, K) mask, the weights once, the output."""
        n_live, rows = int(live.sum()), int(live.any(1).sum())
        return (n_live * flop_per_slot,
                f * (n_live * (slot_w + ee) + rows * row_w + n * k + n * hh)
                + w_bytes)

    m_flop, m_bytes = near_need(nbr_mask != 0, hh, hh,
                                2 * ee * hh + 4 * hh * hh + 8 * hh)
    p_flop, p_bytes = near_need(gh != 0, 2 * hh, 2 * hh,
                                2 * ee * hh + 4 * hh * hh + 10 * hh)
    # each case: args, FLOP and bytes the function needs, and the positions
    # of the inputs the kernel reads one float at a time (any view will do)
    cases = {
        "dense_message_rowsum": dict(
            args=(pi, pj, mask.contiguous(), *wm.mids[0]),
            flop=n * n_valid * (2 * hh * hh + 4 * hh),
            # all of pi, col_vec and out; pj only where col_vec is live
            bytes=f * (2 * n * hh + n + n_valid * hh + hh * hh + hh),
            scalar_read=(0, 1, 2, 4)),
        "near_message_corr": dict(
            args=(pi, pj[idx_flat].contiguous(), rbf_flat,
                  nbr_mask.contiguous(), wm.w1_e, *wm.mids[0]),
            flop=m_flop, bytes=m_bytes, scalar_read=(0, 3, 6)),
        "near_pass_rowsum": dict(
            args=(rs, rs[idx_flat].contiguous(), rbf_flat, gh, wp.w1_e,
                  *wp.mids[0]),
            flop=p_flop, bytes=p_bytes, scalar_read=(0, 3, 6)),
    }

    def off_boundary(t):
        """t's values in a view 4 bytes past a 16-byte boundary."""
        return t.new_empty(t.numel() + 1)[1:].view(t.shape).copy_(t)

    rows = {}
    for name, case in cases.items():
        wrapper = getattr(kernels, name)
        plain = getattr(kernels, name + "_plain")
        args = case["args"]
        out = wrapper(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        tol = 1e-5 * (float(ref.abs().max()) + 1.0)
        require(np.isfinite(err) and err <= tol, (name, err, tol))
        off_args = [off_boundary(t) if i in case["scalar_read"] else t
                    for i, t in enumerate(args)]
        require(torch.equal(wrapper(*off_args), out),
                (name, "inputs off the 16-byte boundary"))
        ms = device_ms(torch, lambda: wrapper(*args), 50)
        plain_ms = device_ms(torch, lambda: plain(*args), 5)
        nbytes = case["bytes"]
        t_flop = case["flop"] / PEAK_FP32_FLOPS * 1e3
        t_byte = nbytes / PEAK_BYTES * 1e3
        rows[name] = dict(
            name=name, route="cuda", source=KERNEL_ROWS[name][1],
            replaces=KERNEL_ROWS[name][0], launches=0,
            max_abs_err=err, max_abs_diff=err, tol=tol, ms=ms,
            plain_ms=plain_ms, bound_ms=max(t_flop, t_byte),
            bound_by="operations" if t_flop >= t_byte else "bytes",
            library_ms=None, flop=case["flop"], bytes=nbytes)
        print(f"[kernel] {name}: max|d|={err:.3e} (tol {tol:.3e}), same "
              f"bits with the scalar-read inputs off the 16-byte boundary; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{rows[name]['bound_ms']:.5f} ms ({rows[name]['bound_by']}: "
              f"{case['flop']:,} FLOP, {nbytes:,} B) at N={n} K={k} on "
              f"{card}")

    # antisymmetry probe: disjoint near pairs of the box, one slot each
    gh_probe, pairs = disjoint_pair_gh(idx.cpu().numpy(),
                                       nbr_mask.cpu().numpy())
    probe_args = list(cases["near_pass_rowsum"]["args"])
    probe_args[3] = torch.from_numpy(gh_probe).to(dev)
    out = kernels.near_pass_rowsum(*probe_args)
    torch.cuda.synchronize()
    pi_t = torch.from_numpy(pairs).to(dev)
    require(len(pairs) > n_valid // 4, len(pairs))
    require(torch.equal(out[pi_t[:, 0]], -out[pi_t[:, 1]]), "antisymmetry")
    require(int(torch.count_nonzero(out[pi_t[:, 0]])) > 0, "probe all zero")
    print(f"[kernel] near_pass_rowsum antisymmetry probe: {len(pairs)} "
          "disjoint pairs, every pair's rows exact negations")

    # ---- 4. the slice through Predictor ----------------------------------
    def timed(fn, reps):
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    # (a) small molecules: the dense path launches no kernel
    small = [water_box(m, seed=20 + m, charge=c)
             for m, c in ((1, 0.0), (3, -1.0), (8, 1.0), (20, 0.0))]
    kernels.reset_launch_counts()
    qs = pred.predict_molecules(small)
    launched = dict(kernels.LAUNCHES)
    require(sum(launched.values()) == 0, launched)
    qs_cpu = Predictor(pred.params, cfg, device="cpu").predict_molecules(small)
    for q, qc, m in zip(qs, qs_cpu, small):
        require(np.all(np.isfinite(q)) and q.shape == (m.natoms,), m.name)
        cons = abs(float(q.astype(np.float64).sum()) - m.total_charge)
        require(cons <= 1e-4, (m.name, cons))
        dq = float(np.abs(q - qc).max())
        require(dq < 1e-5 * (np.abs(qc).max() + 1.0), (m.name, dq))
    print(f"[slice a] dense path, {len(small)} molecules of "
          f"{[m.natoms for m in small]} atoms: launches {launched}; "
          "card vs CPU within 1e-5*(max|q|+1), |sum q - Q| <= 1e-4")

    # (b) the 2,220-atom boxes, B = 2, against the JAX golden
    kernels.reset_launch_counts()
    q2 = pred.predict_batch(batch2)
    main_launches = dict(kernels.LAUNCHES)
    want = {kn: 2 * c for kn, c in PER_GRAPH.items()}
    require(main_launches == want, (main_launches, want))
    with np.load(GOLDEN) as gf:
        golden, total_q = gf["charges"], gf["total_q"]
    q2v = q2[:, :golden.shape[1]]
    dq = float(np.abs(q2v - golden).max())
    tol_q = 1e-5 * (float(np.abs(golden).max()) + 1.0)
    cons2 = np.abs(q2.astype(np.float64).sum(1) - total_q)
    require(np.all(np.isfinite(q2)) and dq < tol_q, (dq, tol_q))
    require(np.all(cons2 <= 1e-4), cons2)
    # a padded width that is no multiple of 4 starts graph 1's node mask
    # off the 16-byte boundary: the card takes it as the CPU does
    q_odd = pred.predict_molecules(golden_boxes(), pad_to=n + 1)
    dq_odd = max(float(np.abs(qo - qb[:len(qo)]).max())
                 for qo, qb in zip(q_odd, q2))
    require(dq_odd < tol_q, ("pad_to", n + 1, dq_odd))
    ms2 = timed(lambda: pred.predict_batch(batch2), 7)
    print(f"[slice b] 2 x 2,220 atoms (Q=0,+1), k={k}: launches "
          f"{main_launches} (per graph {PER_GRAPH}); max|dq| vs JAX golden "
          f"{dq:.3e} (tol {tol_q:.3e}); |sum q - Q| = {cons2.tolist()}; "
          f"padded to {n + 1}: max|dq| {dq_odd:.3e}; "
          f"predict_batch median {ms2:.3f} ms on {card}")

    # (c) the 17,760-atom box, B = 1
    big = pad_molecules([water_box(SCALING_SIZE_MOLECULES, seed=2)], table)
    kernels.reset_launch_counts()
    q3 = pred.predict_batch(big)
    big_launches = dict(kernels.LAUNCHES)
    require(big_launches == PER_GRAPH, big_launches)
    cons3 = abs(float(q3.astype(np.float64).sum()))
    require(np.all(np.isfinite(q3)) and cons3 <= 1e-4, cons3)
    nat = big.natoms[0]
    o_mean, h_mean = float(q3[0, 0:nat:3].mean()), float(q3[0, 1:nat:3].mean())
    require(o_mean < -0.5 < 0.2 < h_mean, (o_mean, h_mean))
    ms3 = timed(lambda: pred.predict_batch(big), 3)
    print(f"[slice c] 1 x {nat:,} atoms, k={pred._neighbor_k(big)}: launches "
          f"{big_launches}; |sum q - Q| = {cons3:.3e}; mean q O {o_mean:.4f} "
          f"H {h_mean:.4f}; predict_batch median {ms3:.3f} ms on {card}")
    # the far-field kernel at this size, the O(N²) term of every round
    nb = big.padded_atoms
    mb = torch.from_numpy(big.node_mask[0]).to(dev)
    ab = torch.cat([torch.from_numpy(big.x[0]).to(dev),
                    torch.from_numpy(g.normal(size=(nb, cfg.h_dim)).astype(
                        np.float32)).to(dev) * mb[:, None],
                    torch.from_numpy(big.q0[0]).to(dev)[:, None]], dim=-1)
    big_args = ((ab @ wm.w1_i + wm.b1).contiguous(),
                (ab @ wm.w1_j).contiguous(), mb.contiguous(), *wm.mids[0])
    out = kernels.dense_message_rowsum(*big_args)
    ref = kernels.dense_message_rowsum_plain(*big_args)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    tol = 1e-5 * (float(ref.abs().max()) + 1.0)
    require(np.isfinite(err) and err <= tol, (err, tol))
    ms_big = device_ms(torch, lambda: kernels.dense_message_rowsum(*big_args),
                       5)
    plain_big = device_ms(
        torch, lambda: kernels.dense_message_rowsum_plain(*big_args), 2)
    bound_big = nb * int(mb.sum()) * (2 * hh * hh + 4 * hh) / PEAK_FP32_FLOPS
    print(f"[slice c] dense_message_rowsum at N={nb}: max|d|={err:.3e} (tol "
          f"{tol:.3e}) kernel {ms_big:.3f} ms, plain {plain_big:.3f} ms, bound "
          f"{bound_big * 1e3:.3f} ms (operations) on {card}")

    # ---- 5. result lines --------------------------------------------------
    for name in rows:
        rows[name]["launches"] = main_launches[name]
    print(json.dumps({"kernels": list(rows.values()),
                      "predict_batch_ms": {"2x2220": ms2, "1x17760": ms3},
                      "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
