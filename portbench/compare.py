"""The comparison that decides ``correct``.

Each sampled graph is worked out again by the float64 reference
(:mod:`portbench.reference.epnn64`) from the inputs the benchmark made,
and the program's charges are judged against it.  The number compared:

* ``q_gap``: max_i |q_i − q_ref,i| in e, the widest over the sampled
  graphs: the widest, and not an RMS, so that one atom's wrong charge is
  seen.  How far a rounding moves these charges depends on the draw of
  weights far more than on the geometry (over seeds that drew both,
  3xTF32 read 2.7e-5 to 5.9e-4 e and one TF32 pass 1.7e-3 to 7.5e-3 e),
  so the configurations fix their draw (``weights.seed``) as a served
  checkpoint is fixed, and the run's seed draws the traffic.

Printed beside it, not compared: ``q_rms`` (the RMS gap in e),
``sum_gap`` (the widest |Σq − Q| of the program's charges), ``gate_ties``
and ``ties_set``.

Gate ties: the pass gate is a threshold (some RBF channel above
``is_near_tol``) on a value that float32 moves by up to 1.64e-3 of the
threshold near the cutoff (``portbench/tie_band.py`` on the cells' own
graphs), where the envelope is a difference of cos(·) and 1.  A pair
whose float64 value lies within :data:`TIE_BAND` of the threshold, three
times that, is a tie: either gate is the model's answer.  Where the gap
passes :data:`TIE_SHARE` of the limit, the reference sets the gate of each
tied pair near an atom that misses it the other way in turn (greedily,
smallest margin first) and keeps a setting where it brings the reference
nearer the program's charges, then judges the nearest.  Only tied pairs
move; ``gate_ties`` and ``ties_set`` are printed beside the numbers.
Setting ties from a tenth of the limit, not from the limit, makes the gap
a run reports that of its resolved gates whatever the limit is, so the
readings the limit is set from (``portbench.control``) read the same
number."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.reference.epnn64 import Graph, to_bfloat16

#: the relative margin to the gate's threshold within which a pair is a
#: tie: three times float32's largest shift of it on the cells' graphs
TIE_BAND = 0.005
#: sweeps of the greedy tie setting
TIE_SWEEPS = 2
#: ties are set where the number exceeds this share of the limit
TIE_SHARE = 0.1


def _gap(q: torch.Tensor, ref: torch.Tensor) -> float:
    return float((q - ref).abs().max())


def _rms(q: torch.Tensor, ref: torch.Tensor) -> float:
    return float((q - ref).pow(2).mean().sqrt())


def _near_region(graph: Graph, atoms: torch.Tensor, hops: int):
    """(N,) bool: ``atoms`` and every atom within ``hops`` near pairs."""
    region = torch.zeros(graph.n, dtype=torch.bool, device=graph.device)
    region[atoms] = True
    for _ in range(hops):
        grow = region.clone()
        grow[graph.pj[region[graph.pi]]] = True
        region = grow
    return region


def judge_graph(graph: Graph, q_prog: np.ndarray, n_real: int,
                limit: float) -> Dict[str, float]:
    """{"q_gap", "q_gap_raw", "q_rms", "q_max", "gate_ties", "ties_set"}
    of one graph: the program's charges ``q_prog`` (real atoms first)
    against the reference; where the gap passes ``TIE_SHARE · limit``,
    the gate ties within T near pairs of an atom that misses it are set
    greedily."""
    dev = graph.device
    q = torch.as_tensor(np.asarray(q_prog[:n_real], np.float64), device=dev)
    gate = graph.gate.clone()
    ref = graph.charges(gate)[:n_real]
    raw = gap = _gap(q, ref)
    tied = torch.nonzero(graph.margin < TIE_BAND).flatten()
    n_set = 0
    floor = TIE_SHARE * limit
    if gap > floor and len(tied):
        bad = torch.nonzero((q - ref).abs() > floor).flatten()
        region = _near_region(graph, bad, graph.model["T"])
        partner = graph.flip_partner()
        # each unordered pair once, near a miss, smallest margin first
        tied = tied[(graph.pi[tied] < graph.pj[tied])
                    & (region[graph.pi[tied]] | region[graph.pj[tied]])]
        tied = tied[torch.argsort(graph.margin[tied])]
        dist = float(((q - ref) ** 2).sum())
        for _ in range(TIE_SWEEPS):
            moved = False
            for p in tied.tolist():
                trial = gate.clone()
                val = 1.0 - float(trial[p])
                trial[p] = val
                trial[partner[p]] = val
                r2 = graph.charges(trial)[:n_real]
                d2 = float(((q - r2) ** 2).sum())
                if d2 < dist:
                    gate, ref, dist, moved = trial, r2, d2, True
                    n_set += 1 if val != float(graph.gate[p]) else -1
            if not moved:
                break
        gap = _gap(q, ref)
    return {"q_gap": gap, "q_gap_raw": raw, "q_rms": _rms(q, ref),
            "q_max": float(ref.abs().max()),
            "gate_ties": float(int((graph.margin < TIE_BAND).sum()) // 2),
            "ties_set": float(n_set)}


def control_charges(control: str, g: dict, params: dict, model: dict,
                    device) -> np.ndarray:
    """(N_pad,) float32 charges of graph ``g`` (``judge``'s inputs) from
    the reference at a lower precision: ``"bf16_far"``, the far field's
    products in bfloat16 (:func:`~portbench.reference.epnn64.to_bfloat16`
    on both operands of every message round's middle product)."""
    if control != "bf16_far":
        raise ValueError(f"control {control!r}")
    low = Graph(params, model, g["x"], g["q0"], g["xyz"], g["mask"], device,
                mid_round=to_bfloat16)
    q = np.zeros(len(g["mask"]), np.float32)
    q[:g["n"]] = low.charges()[:g["n"]].cpu().numpy()
    return q


#: the numbers of a run that are the widest over its graphs
WIDEST = ("q_gap", "q_gap_raw", "q_rms", "q_max")


def judge(graphs: List[dict], params: dict, model: dict, limit: float,
          device) -> Dict[str, float]:
    """The numbers of a run over its sampled graphs, each a dict of the
    reference's inputs (``x``, ``q0``, ``xyz``, ``mask``, ``n``, the net
    charge ``total``) and the program's charges ``q``; ``limit`` is
    ``q_gap``'s."""
    out = dict.fromkeys(WIDEST + ("gate_ties", "ties_set", "sum_gap"), 0.0)
    for g in graphs:
        ref = Graph(params, model, g["x"], g["q0"], g["xyz"], g["mask"],
                    device)
        r = judge_graph(ref, g["q"], g["n"], limit)
        for k in WIDEST:
            out[k] = max(out[k], r[k])
        q = np.asarray(g["q"][:g["n"]], np.float64)
        out["sum_gap"] = max(out["sum_gap"],
                             float(abs(q.sum() - g["total"])))
        out["gate_ties"] += r["gate_ties"]
        out["ties_set"] += r["ties_set"]
        del ref
    return out
