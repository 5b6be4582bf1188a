"""How far float32 moves the pass gate's margin on a cell's own graphs: the
reading ``compare.TIE_BAND`` is set from.

    python3 portbench/tie_band.py --workload <cell> --seed <n> \\
        [--calls 0,1,2,3] [--device cuda]

The gate is 1 where some RBF channel of a pair exceeds ``is_near_tol``.
For each graph of the given calls (the coordinates the program is sent,
made again from the seed) it takes every pair within the cutoff and
reads the margin max_k rbf / tol − 1 twice: in float64, as the reference
computes it, and in float32 through the port's own featurization
(``featurize.pair_d2`` and ``featurize.envelope_rbf``, the expressions of
the serving path's d² and RBF).  It prints, a graph a line, the largest
|margin32 − margin64| over pairs within half the threshold of it, the
pairs whose two gates differ and the largest float64 margin among them,
and how many pairs lie within a few candidate bands."""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

BANDS = (0.005, 0.01, 0.02, 0.05, 0.1)


def margins(xyz, n: int, model: dict, device) -> dict:
    """The readings of one graph: ``xyz`` (≥ n, 3) float32, real atoms
    first."""
    import torch

    from epnn_tpu_torch import featurize

    cut, tol = model["cutoff"], model["is_near_tol"]
    x32 = torch.as_tensor(xyz[:n], device=device, dtype=torch.float32)
    x64 = x32.double()
    rows = max(1, (1 << 24) // n)
    ii, jj, dd = [], [], []
    for s in range(0, n, rows):
        d = torch.cdist(x64[s:s + rows], x64,
                        compute_mode="donot_use_mm_for_euclid_dist")
        r = s + torch.arange(d.shape[0], device=device)
        hit = (d < cut) & (r[:, None] != torch.arange(n, device=device))
        a, b = hit.nonzero(as_tuple=True)
        ii.append(s + a)
        jj.append(b)
        dd.append(d[a, b])
    pi, pj, d = torch.cat(ii), torch.cat(jj), torch.cat(dd)
    mu64 = torch.linspace(0.1, cut, model["e_dim"], dtype=torch.float64,
                          device=device)
    c = (torch.cos(math.pi * d / cut) + 1.0) / 2.0
    top64 = (c[:, None] * torch.exp(
        -model["eta"] * (d[:, None] - mu64) ** 2)).amax(-1)
    d2 = featurize.pair_d2(x32[pi], x32[pj])
    rbf, _ = featurize.envelope_rbf(
        d2, torch.ones_like(d2), cut, model["eta"],
        featurize.rbf_centers(model["e_dim"], cut, device))
    top32 = rbf.amax(-1).double()
    m64 = top64 / tol - 1.0
    m32 = top32 / tol - 1.0
    near = m64.abs() < 0.5
    differ = (m64 > 0) != (m32 > 0)
    return dict(
        pairs=int(len(pi)) // 2,
        max_shift=float((m32 - m64)[near].abs().max()) if near.any()
        else 0.0,
        gates_differ=int(differ.sum()) // 2,
        max_margin_differ=float(m64[differ].abs().max()) if differ.any()
        else 0.0,
        within={str(b): int((m64.abs() < b).sum()) // 2 for b in BANDS})


def main(argv=None) -> int:
    import torch

    from epnn_tpu_torch.data.dataset import pad_molecules
    from epnn_tpu_torch.data.xyz import Molecule
    from epnn_tpu_torch.elements import table_for_n_elems
    from portbench import generator
    from portbench.run import load_cell

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", default="0,1,2,3")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = load_cell(args.workload)
    model = spec["config"]["model"]
    dev = torch.device(args.device)
    traffic = generator.Traffic(spec["traffic"], model["n_elems"], args.seed,
                                dev, pad_molecules, Molecule,
                                table_for_n_elems(model["n_elems"]))
    calls = [int(c) for c in args.calls.split(",")]
    worst = dict(max_shift=0.0, max_margin_differ=0.0)
    for c, xyz in traffic.coordinates(calls).items():
        for g in range(traffic.b):
            r = margins(xyz[g], traffic.n, model, dev)
            print(json.dumps(dict(workload=args.workload, seed=args.seed,
                                  call=c, graph=g, **r)), flush=True)
            for k in worst:
                worst[k] = max(worst[k], r[k])
    print(f"{args.workload} seed {args.seed}: largest float32 shift of the "
          f"margin {worst['max_shift']!r}, largest float64 margin of a "
          f"pair whose gates differ {worst['max_margin_differ']!r}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
