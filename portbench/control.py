"""The readings the limits of ``portbench/limits/`` are set from: a cell's
compared numbers over many seeds in one process, for the program as the
configuration states it and for the control at the nearest precision
below.  Where the configuration states 3xTF32 (``highest``), the control
is the program's own one-pass tier (``--precision default``: every
tensor-core kernel at one TF32 product a k-step).  Where it states the far
field at one TF32 pass (``parity``), the program has no bfloat16 far
field, so the control is the reference with its far-field products in
bfloat16, judged in the program's place (``--control bf16_far``).

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \\
        --seconds 3 [--precision default | --control bf16_far] \\
        [--tie-limit 1e-9]

Each seed is a whole run (``portbench.run.run_cell``) with a short window;
``--tie-limit`` stands for the limit while the readings are taken; gate
ties are resolved above a tenth of it (``compare.TIE_SHARE``), so that
the readings are those of resolved gates.  On a CPU (``--device cpu``) the
control is the program's own emulation of the one-pass tier (the
kernels' ``*_tf32_plain`` twins), as :func:`one_pass_on_cpu` switches it
on."""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@contextlib.contextmanager
def one_pass_on_cpu():
    """The port's neighbor split with its three tensor-core kernels
    replaced by their one-TF32-pass emulations (the card's
    ``precision="default"`` arithmetic) while the context lasts."""
    from epnn_tpu_torch.ops import fused, kernels

    names = ("dense_message_rowsum", "near_message_corr", "near_pass_rowsum")
    saved = {n: getattr(fused, n) for n in names}

    def twin(name):
        plain = getattr(kernels, f"{name}_tf32_plain")
        return lambda *args, padded=None, precision=None: plain(*args)

    try:
        for n in names:
            setattr(fused, n, twin(n))
        yield
    finally:
        for n, f in saved.items():
            setattr(fused, n, f)


def of(cfg_spec: dict) -> dict:
    """The control of a configuration, as ``run_cell``'s keywords: one TF32
    pass for a configuration stated at ``highest``, the reference with a
    bfloat16 far field for one stated at ``parity``."""
    return {"highest": dict(precision="default", control=None),
            "parity": dict(precision=None, control="bf16_far")}[
        cfg_spec["precision"]]


def readings(spec: dict, seeds, seconds: float, precision: str = None,
             tie_limit: float = 1e-9, device: str = "cuda",
             emulate: bool = False, control: str = None) -> list:
    """[{seed, q_gap, q_gap_raw, sum_gap, gate_ties, ties_set, calls}]."""
    from portbench.run import run_cell

    spec = dict(spec, limits={"q_gap": tie_limit})
    out = []
    for seed in seeds:
        ctx = one_pass_on_cpu() if emulate else contextlib.nullcontext()
        with ctx:
            r = run_cell(spec, seed, seconds, False, device,
                         precision=precision, control=control)
        j = r["judged"]
        row = dict(seed=seed, q_gap=r["checks"]["q_gap"]["value"],
                   **{k: j[k] for k in ("q_gap_raw", "q_rms", "q_max",
                                        "sum_gap", "gate_ties", "ties_set")},
                   calls=r["attempted"], failed=r["failed"])
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def main(argv=None) -> int:
    from portbench.run import load_cell

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--precision", default=None)
    ap.add_argument("--control", default=None, choices=("bf16_far",))
    ap.add_argument("--tie-limit", type=float, default=1e-9)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = readings(load_cell(args.workload), seeds, args.seconds,
                    args.precision, args.tie_limit, args.device,
                    emulate=args.device == "cpu"
                    and args.precision == "default", control=args.control)
    for key in ("q_gap", "q_rms", "sum_gap"):
        vals = [r[key] for r in rows]
        print(f"{args.workload} "
              f"{args.control or 'precision=' + (args.precision or 'stated')} "
              f"{key}: max {max(vals)!r} min {min(vals)!r} over "
              f"{len(vals)} seeds", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
