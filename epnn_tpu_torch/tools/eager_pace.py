"""The host cost of the kernels' binding on the eager paths, one checkout
against another.

``python3 -m epnn_tpu_torch.tools.eager_pace [--tree LABEL=DIR ...]
[--calls N]`` (from the repository root, with a CUDA card and ``nvcc``)
times, in a fresh process for each checkout in turns (the first, the
second, the second, the first; with one checkout, twice), the two eager
paths that call the kernels' wrappers most:

* ``predict`` — the warm ``Predictor.predict_batch`` of the 2 × 2,220-atom
  water boxes of ``chip_smoke.py`` (``[slice b]``: ``trained/mixed_b16``,
  3xTF32, the cell builder; 8 / 10 / 10 launches of the far-field and
  near kernels a call);
* ``train_step`` — one fused train step on the same batch
  (``train.loop.train_step_fused``, masked MSE against seeded labels,
  remat off, the state's Adam; the far field's backward kernel as well),
  on the host clock between two ``torch.cuda.synchronize``.

Each is the median and the spread (max − min) of ``--calls`` calls after
two warm-up calls (the libraries of that checkout built before).  A
checkout whose wrappers route through ``kernels._call`` also times both
again call by call in the same process, its eager route (the operators'
bodies) against the registered operators (``kernels._OPS``), in pairs
of alternating order, and prints the median of the pairs' differences:
the dispatcher's end-to-end cost, free of the drift between processes.
The default checkout is this one; another (a parent commit unpacked with
``git archive``) runs the same child code with its own package first on
``PYTHONPATH``, so the two differ only in their package.  Prints a line a
run and a JSON line with every run and the card's name and power limit;
exits 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

CKPT = "trained/mixed_b16"

#: the child: ``argv[1]`` the checkpoint, ``argv[2]`` the calls; prints
#: one JSON line of host-clock times (ms)
CHILD = r"""
import json, sys, time
import numpy as np
import torch
from epnn_tpu_torch.data import pad_molecules, uniform_q0_contract
from epnn_tpu_torch.elements import table_for_n_elems
from epnn_tpu_torch.infer import Predictor
from epnn_tpu_torch.ops import kernels
from epnn_tpu_torch.testing import golden_boxes
from epnn_tpu_torch.train import TrainConfig, loop

calls = int(sys.argv[2])
kernels.build()  # every library at the shipped widths, untimed
pred = Predictor.from_checkpoint(sys.argv[1])
cfg = pred.cfg
batch = pad_molecules(golden_boxes(), table_for_n_elems(cfg.n_elems))


def one(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def clock(fn):
    return [one(fn) for _ in range(calls + 2)][2:]


def predict():
    pred.predict_batch(batch)


y = (batch.node_mask * np.random.default_rng(5).normal(
    0.0, 0.3, size=batch.node_mask.shape)).astype(np.float32)
args = [torch.from_numpy(a).cuda() for a in (
    batch.x, batch.q0, batch.xyz, batch.node_mask, y,
    np.ones(batch.batch_size, np.float32))]
k = pred._neighbor_k(batch)
uq0 = uniform_q0_contract(batch.x, batch.q0, batch.node_mask)
state = loop.create_state(cfg, TrainConfig(), device="cuda",
                          params=pred.params)


def train_step():
    loop.train_step_fused(state, cfg, "masked_mse", None, 256, k, *args,
                          uniform_q0=uq0, remat=False)


out = {"predict": clock(predict)}
kernels.reset_launch_counts()
out["train_step"] = clock(train_step)
out["train_launches"] = {n: c // (calls + 2)
                         for n, c in kernels.LAUNCHES.items() if c}
if hasattr(kernels, "_call"):
    # this binding's eager route against the registered operators', call
    # by call in one process (ABBA pairs)
    direct = kernels._call

    def via_ops(name, *a):
        return kernels._OPS[name](*a)

    for key, fn in (("predict", predict), ("train_step", train_step)):
        paired = {"ops": [], "direct": []}
        for i in range(calls):
            for route in ((via_ops, direct) if i % 2 else (direct, via_ops)):
                kernels._call = route
                paired["ops" if route is via_ops else "direct"].append(
                    one(fn))
        kernels._call = direct
        out[key + "_paired"] = paired
print(json.dumps(out))
"""


def run_child(tree: str, calls: int) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, os.path.join(tree, CKPT), str(calls)],
        cwd=tree, env=dict(os.environ, PYTHONPATH=tree), capture_output=True,
        text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: {proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    metavar="LABEL=DIR",
                    help="a checkout to time (default: this one)")
    ap.add_argument("--calls", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("eager_pace: no CUDA card", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    trees = dict(t.split("=", 1) for t in args.tree) or {"this": root}
    trees = {label: os.path.abspath(d) for label, d in trees.items()}
    order = list(trees) + list(trees)[::-1]
    card = card_line()
    runs = []
    def stats(ts):
        return {"median_ms": float(np.median(ts)),
                "spread_ms": float(max(ts) - min(ts)),
                "min_ms": float(min(ts))}

    for label in order:
        r = run_child(trees[label], args.calls)
        row = {"tree": label, "train_launches": r["train_launches"]}
        for key in ("predict", "train_step"):
            row[key] = stats(r[key])
            if key + "_paired" in r:
                p = r[key + "_paired"]
                row[key + "_paired"] = {
                    "ops": stats(p["ops"]), "direct": stats(p["direct"]),
                    "ops_minus_direct_median_ms": float(np.median(
                        np.subtract(p["ops"], p["direct"])))}
        runs.append(row)
        print(f"[eager] {label}: predict_batch 2 x 2,220 median "
              f"{row['predict']['median_ms']:.3f} ms (spread "
              f"{row['predict']['spread_ms']:.3f}), fused train step "
              f"median {row['train_step']['median_ms']:.3f} ms (spread "
              f"{row['train_step']['spread_ms']:.3f}), launches a step "
              f"{row['train_launches']} on {card}")
        for key in ("predict", "train_step"):
            p = row.get(key + "_paired")
            if p:
                print(f"[eager] {label} {key}, paired in one process: "
                      f"operators median {p['ops']['median_ms']:.3f} ms "
                      f"(spread {p['ops']['spread_ms']:.3f}), bodies "
                      f"{p['direct']['median_ms']:.3f} ms (spread "
                      f"{p['direct']['spread_ms']:.3f}), median of the "
                      f"pairs' differences "
                      f"{p['ops_minus_direct_median_ms']:.3f} ms")
    print(json.dumps({"card": card, "calls": args.calls, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
