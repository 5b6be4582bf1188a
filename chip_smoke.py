#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``epnn_tpu_torch``) on one NVIDIA
card: ``python3 chip_smoke.py`` from the repository root.

1. Device: the card's name and power limit; TF32 is switched off (the
   port's precision is float32 throughout).
2. Build: the four CUDA kernels from ``epnn_tpu_torch/csrc``, one
   ``nvcc`` per source, in parallel.
3. Kernels: each kernel against its plain PyTorch version on the card, at
   the shapes of the 2,220-atom water box (the checkpoint's round weights,
   the box's own neighbor table), and again with the inputs it reads one
   float at a time moved off the 16-byte boundary; kernel, plain and bound
   times, the bound counting only what this data needs (live slots); the
   ``near_pass_rowsum`` antisymmetry probe on that table.
   The far field's backward kernel at the same shapes (a seeded
   cotangent): each of its four outputs against the plain version, the
   same bits on a second launch and with its scalar-read inputs off the
   boundary, and its times.
4. Slice: ``Predictor.from_checkpoint("trained/mixed_b16")`` serving
   (a) small molecules on the dense path (no kernel may launch),
   (b) the two 2,220-atom boxes (Q = 0, +1) against the committed JAX
   golden charges, and padded to a width that is no multiple of 4,
   (c) the 17,760-atom box; launch counts per graph
   forward, conservation, and the median ``predict_batch`` latency.
5. Training: (a) the gradients of one fused train step on two 900-atom
   boxes, card against the port on the CPU, leaf by leaf; (b) ``train()``
   fine-tuning the checkpoint for a few epochs on the 2,220-atom boxes and
   the small molecules (noisy labels around the model's own charges): the
   fused bucket's loss falls, launches per fused step, none in dense
   steps, the median fused step, and ``best/`` served with conservation.
6. The kernels' JSON line, the card line, and last the result line.

Any failure raises and exits non-zero; without a CUDA card it exits 2
before printing any result.  Imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import tempfile
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
    "dense_message_rowsum_bwd": (
        "epnn_tpu/ops/pallas_kernels.py:1079",
        "epnn_tpu_torch/csrc/dense_message_rowsum_bwd.cu"),
}
#: launches of each kernel per graph forward with the round-1 collapse (T=5)
PER_GRAPH = {"dense_message_rowsum": 4, "near_message_corr": 5,
             "near_pass_rowsum": 5}
#: per graph in a fused train step: the forward's, and one far-field
#: backward per far-field forward (the near backwards recompute through
#: their plain versions and launch nothing)
PER_GRAPH_TRAIN = {**PER_GRAPH, "dense_message_rowsum_bwd": 4}
#: the [train] phase: gradient-check box size (waters), train() epochs,
#: and the label noise (e) around the checkpoint's own charges
TRAIN_BOX_MOLECULES = 300
TRAIN_EPOCHS = 5
LABEL_NOISE = 0.05


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


def noisy_labels(g, q):
    """``q`` plus seeded noise of :data:`LABEL_NOISE` e that sums to zero,
    so the labels keep the molecule's net charge."""
    noise = g.normal(0.0, LABEL_NOISE, size=q.shape)
    return (q + noise - noise.mean()).astype(np.float32)


def train_phase(torch, pred, card, small, small_q, batch2, golden):
    """[train] (a) one fused train step's gradients, card against CPU;
    (b) ``train()`` from the checkpoint.  Returns the kernels' launches in
    the ``train()`` run and the median fused train step (ms)."""
    from epnn_tpu_torch.data import pad_molecules, uniform_q0_contract
    from epnn_tpu_torch.elements import table_for_n_elems
    from epnn_tpu_torch.infer import Predictor
    from epnn_tpu_torch.models import tree_leaves
    from epnn_tpu_torch.ops import kernels
    from epnn_tpu_torch.testing import golden_boxes, water_box
    from epnn_tpu_torch.train import TrainConfig, loop, train

    cfg = pred.cfg
    g = np.random.default_rng(5)
    per_step = {kn: 2 * c for kn, c in PER_GRAPH_TRAIN.items()}

    # (a) gradients of one fused step (B = 2), the card against the CPU
    boxes = [water_box(TRAIN_BOX_MOLECULES, seed=30, charge=0.0),
             water_box(TRAIN_BOX_MOLECULES, seed=31, charge=-1.0)]
    batch = pad_molecules(boxes, table_for_n_elems(cfg.n_elems))
    y = (batch.node_mask * g.normal(0.0, 0.3, size=batch.node_mask.shape)
         ).astype(np.float32)
    arrays = (batch.x, batch.q0, batch.xyz, batch.node_mask, y,
              np.ones(2, np.float32))
    k = pred._neighbor_k(batch)
    uq0 = uniform_q0_contract(batch.x, batch.q0, batch.node_mask)
    grads, losses = {}, {}
    for side, device in (("card", "cuda"), ("host", "cpu")):
        state = loop.create_state(cfg, TrainConfig(), device=device,
                                  params=pred.params)
        args = [torch.from_numpy(a).to(device) for a in arrays]
        kernels.reset_launch_counts()
        _, loss, _, _ = loop.train_step_fused(state, cfg, "masked_mse", k,
                                              *args, uniform_q0=uq0)
        if side == "card":
            torch.cuda.synchronize()
            step_launches = dict(kernels.LAUNCHES)
        losses[side] = float(loss)
        grads[side] = [p.grad.cpu() for p in
                       tree_leaves(state.params)]
    require(step_launches == per_step, (step_launches, per_step))
    # per leaf: relative Frobenius error ≤ 1e-3 — summation order, and the
    # relu-indicator ties of the far-field backward (above), which move
    # single entries; a wrong or missing gradient term is O(1)
    worst_fro = worst_max = 0.0
    for gc, gr in zip(grads["card"], grads["host"]):
        fro = float(torch.linalg.norm(gc - gr)
                    / max(float(torch.linalg.norm(gr)), 1e-30))
        require(np.isfinite(fro) and fro <= 1e-3, ("gradient", fro))
        worst_fro = max(worst_fro, fro)
        worst_max = max(worst_max, float((gc - gr).abs().max())
                        / (float(gr.abs().max()) + 1.0))
    dl = abs(losses["card"] - losses["host"])
    require(dl <= 1e-5 * (abs(losses["host"]) + 1.0), ("loss", losses))
    print(f"[train a] first fused step, 2 x {batch.natoms[0]:,} atoms, k={k}:"
          f" loss card {losses['card']:.6e} CPU {losses['host']:.6e}; "
          f"{len(grads['host'])} gradient leaves, card vs CPU relative "
          f"Frobenius error <= 1e-3 (worst {worst_fro:.3e}; worst "
          f"max|d|/(max|g|+1) {worst_max:.3e}); launches "
          f"{step_launches}")

    # (b) train(): fine-tune the checkpoint on the golden boxes and the
    # small molecules, labels = their charges plus seeded noise
    big = golden_boxes()
    for m, q in zip(big, golden):
        m.labels = noisy_labels(g, q[:m.natoms])
    for m, q in zip(small, small_q):
        m.labels = noisy_labels(g, q)
    steps = {"train_step": [], "train_step_fused": []}
    originals = {name: getattr(loop, name) for name in steps}

    def spy(name):
        def step(*a, **kw):
            before = dict(kernels.LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = originals[name](*a, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launched = {kn: kernels.LAUNCHES[kn] - before[kn]
                        for kn in before}
            steps[name].append((float(out[1]), launched, ms))
            return out
        return step

    with tempfile.TemporaryDirectory() as tmp:
        run = os.path.join(tmp, "run")
        tc = TrainConfig(epochs=TRAIN_EPOCHS, checkpoint_dir=run,
                         log_path=os.path.join(tmp, "log.jsonl"),
                         init_from=CKPT)
        for name in steps:
            setattr(loop, name, spy(name))
        try:
            kernels.reset_launch_counts()
            res = train(big + small, cfg, tc, val_mols=small)
            train_launches = dict(kernels.LAUNCHES)
        finally:
            for name, fn in originals.items():
                setattr(loop, name, fn)
        fused = steps["train_step_fused"]
        require(len(fused) == TRAIN_EPOCHS, len(fused))
        for _, launched, _ in fused:
            require(launched == per_step, (launched, per_step))
        for _, launched, _ in steps["train_step"]:
            require(sum(launched.values()) == 0, launched)
        f_loss = [s[0] for s in fused]
        require(np.all(np.isfinite(f_loss)) and f_loss[-1] < f_loss[0],
                f_loss)
        step_ms = float(np.median([s[2] for s in fused]))
        require(len(res.history) == TRAIN_EPOCHS
                and np.isfinite(res.best_val_masked_mae), res.history)
        served = Predictor.from_checkpoint(os.path.join(run, "best"))
        q_best = served.predict_batch(batch2)
        cons = np.abs(q_best.astype(np.float64).sum(1) - batch2.total_q)
        require(np.all(np.isfinite(q_best)) and np.all(cons <= 1e-4), cons)
    print(f"[train b] train(): {TRAIN_EPOCHS} epochs from {CKPT} on 2 x "
          f"2,220 atoms + {len(small)} small molecules: fused-bucket loss "
          f"{' -> '.join(f'{v:.6e}' for v in f_loss)}; launches per fused "
          f"step {fused[0][1]}, none in {len(steps['train_step'])} dense "
          f"steps; fused train step median {step_ms:.3f} ms; best/ served: "
          f"|sum q - Q| = {cons.tolist()} on {card}")
    return train_launches, step_ms


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

    # the far field's backward: round-2 inputs, a seeded cotangent
    name = "dense_message_rowsum_bwd"
    gbar = torch.from_numpy(g.normal(size=(n, hh)).astype(np.float32)).to(dev)
    bwd_args = (*cases["dense_message_rowsum"]["args"], gbar)
    outs = kernels.dense_message_rowsum_bwd(*bwd_args)
    refs = kernels.dense_message_rowsum_bwd_plain(*bwd_args)
    exact = kernels.dense_message_rowsum_bwd_plain(
        *(t.double() for t in bwd_args))
    torch.cuda.synchronize()
    # The gradient steps where z1 or z2 crosses 0 (relu's indicator): a pair
    # whose z lies within float32 rounding of 0 flips between any two
    # float32 evaluations, moving one entry by ~|g_i|·|W2 row|.  So the bar
    # is the float64 plain version: the kernel may be at most twice as far
    # from it as the float32 plain version is, plus 1e-5·(max|ref| + 1).
    errs = {}
    for part, o, r, r64 in zip(("dpi", "dpj", "dw2", "db2"), outs, refs,
                               exact):
        err = float((o - r).abs().max())
        err64 = float((o.double() - r64).abs().max())
        plain64 = float((r.double() - r64).abs().max())
        tol = 2.0 * plain64 + 1e-5 * (float(r64.abs().max()) + 1.0)
        require(np.isfinite(err64) and err64 <= tol,
                (name, part, err64, tol))
        errs[part] = (err, err64, plain64, tol)
    again = kernels.dense_message_rowsum_bwd(*bwd_args)
    require(all(torch.equal(a, b) for a, b in zip(again, outs)),
            (name, "not the same bits on a second launch"))
    off_args = [off_boundary(t) if i in (0, 1, 2, 4, 5) else t
                for i, t in enumerate(bwd_args)]
    require(all(torch.equal(a, b) for a, b in
                zip(kernels.dense_message_rowsum_bwd(*off_args), outs)),
            (name, "inputs off the 16-byte boundary"))
    ms = device_ms(torch, lambda: kernels.dense_message_rowsum_bwd(*bwd_args),
                   20)
    plain_ms = device_ms(
        torch, lambda: kernels.dense_message_rowsum_bwd_plain(*bwd_args), 3)
    # per live pair: z2, e2 @ W2ᵀ and the dW2 outer product (3 H×H
    # contractions) + ~9H elementwise; pi, g, col_vec, dpi and dpj whole,
    # pj where col_vec is live, W2, b2, dW2, db2 once
    flop = n * n_valid * (6 * hh * hh + 9 * hh)
    nbytes = f * (4 * n * hh + n + n_valid * hh + 2 * (hh * hh + hh))
    t_flop, t_byte = flop / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    rows[name] = dict(
        name=name, route="cuda", source=KERNEL_ROWS[name][1],
        replaces=KERNEL_ROWS[name][0], launches=0,
        max_abs_err=max(e[0] for e in errs.values()),
        max_abs_diff={p: e[0] for p, e in errs.items()},
        max_abs_diff_f64={p: e[1] for p, e in errs.items()},
        plain_f32_diff_f64={p: e[2] for p, e in errs.items()},
        tol_f64={p: e[3] for p, e in errs.items()}, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_flop, t_byte),
        bound_by="operations" if t_flop >= t_byte else "bytes",
        library_ms=None, flop=flop, bytes=nbytes)
    print(f"[kernel] {name}: max|d| vs plain f32 / vs plain f64 (f32 plain "
          "vs f64; tol) " + ", ".join(
              f"{p} {e:.3e} / {e64:.3e} ({p64:.3e}; {t:.3e})"
              for p, (e, e64, p64, t) in errs.items())
        + f"; same bits on a second launch and off the 16-byte boundary; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{rows[name]['bound_ms']:.5f} ms ({rows[name]['bound_by']}: "
        f"{flop:,} FLOP, {nbytes:,} B) at N={n} on {card}")

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
    want = {kn: 2 * PER_GRAPH.get(kn, 0) for kn in kernels.SOURCES}
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
    require(big_launches == {kn: PER_GRAPH.get(kn, 0)
                             for kn in kernels.SOURCES}, big_launches)
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

    # ---- 5. training ------------------------------------------------------
    small_labels = [q.copy() for q in qs]
    train_launches, step_ms = train_phase(torch, pred, card, small,
                                          small_labels, batch2, golden)

    # ---- 6. result lines --------------------------------------------------
    # launches: each kernel's count in the main path of its slice
    # (serving: the 2 x 2,220 predict_batch; training: the train() run)
    for name in rows:
        path_launches = {"serve": main_launches.get(name, 0),
                         "train": train_launches[name]}
        rows[name]["launches_by_path"] = path_launches
        rows[name]["launches"] = (path_launches["train"]
                                  if name == "dense_message_rowsum_bwd"
                                  else path_launches["serve"])
    print(json.dumps({"kernels": list(rows.values()),
                      "predict_batch_ms": {"2x2220": ms2, "1x17760": ms3},
                      "fused_train_step_ms": {"2x2220": step_ms},
                      "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
