"""The float64 reference against the port's CPU path, and the comparison's
gate-tie setting."""

import numpy as np
import pytest
import torch

from epnn_tpu_torch.data.dataset import pad_molecules
from epnn_tpu_torch.data.xyz import Molecule
from epnn_tpu_torch.elements import table_for_n_elems
from epnn_tpu_torch.infer import Predictor
from portbench import compare, run, weights
from portbench.frozen import elements
from portbench.frozen.water_box import water_box
from portbench.reference.epnn64 import Graph
from portbench.tests import small


def _graph_inputs(n_mol, n_elems, seed, charge):
    xyz, symbols = water_box(n_mol, seed=seed)
    n = len(symbols)
    n_pad = -(-n // 8) * 8
    x = np.zeros((n_pad, n_elems), np.float32)
    x[:n] = elements.features(symbols, n_elems)
    pad_xyz = np.zeros((n_pad, 3), np.float32)
    pad_xyz[:n] = xyz
    mask = np.zeros(n_pad, np.float32)
    mask[:n] = 1
    q0 = np.zeros(n_pad)
    q0[:n] = charge / n
    mol = Molecule(name="w", symbols=symbols, xyz=xyz, total_charge=charge)
    return mol, x, q0, pad_xyz, mask, n


@pytest.mark.parametrize("workload", small.CELLS)
@pytest.mark.parametrize("charge", [0.0, 1.0])
def test_reference_agrees_with_the_port_at_300_atoms(workload, charge):
    torch.manual_seed(0)
    s = small.spec(workload)
    model = s["config"]["model"]
    tree = weights.load(s["config"], "cpu")
    pred = Predictor(tree, run.model_config(s["config"]), device="cpu",
                     **s["traffic"]["predictor"])
    mol, x, q0, xyz, mask, n = _graph_inputs(100, model["n_elems"], 4,
                                             charge)
    batch = pad_molecules([mol], table_for_n_elems(model["n_elems"]))
    q = pred.predict_batch(batch)[0]
    ref = Graph(tree, model, x, q0, xyz, mask)
    r = compare.judge_graph(ref, q, n, 1e-5)
    assert r["q_gap"] < 1e-5
    assert abs(float(ref.charges()[:n].sum()) - charge) < 1e-9
    # the program's charges sum to Q to float32 rounding
    assert abs(float(np.asarray(q[:n], np.float64).sum()) - charge) < 1e-4


def test_reference_dense_model_equations():
    """At 39 atoms (40 padded) the blocked float64 reference equals the
    dense model of the port's ``EPNN`` run in float64 on the whole padded
    pair grid (the decay model's unmasked sums read the padding row)."""
    from epnn_tpu_torch.featurize import rbf_edges
    from epnn_tpu_torch.models.epnn import dense_apply

    s = small.spec("decay_model.frames-35520")
    model = s["config"]["model"]
    tree = weights.load(s["config"], "cpu")
    _, x, q0, xyz, mask, n = _graph_inputs(13, model["n_elems"], 6, 1.0)
    ref = Graph(tree, model, x, q0, xyz, mask)
    cfg = run.model_config(s["config"])
    m = torch.tensor(mask[None])
    e = rbf_edges(torch.tensor(xyz[None]), m, cfg.e_dim, cfg.cutoff,
                  cfg.eta).double()
    p64 = {k: {d: {kk: vv.double() for kk, vv in leaf.items()}
               for d, leaf in v.items()} for k, v in tree.items()}
    with torch.no_grad():
        q = dense_apply(p64, cfg, torch.tensor(x[None]).double(),
                        torch.tensor(q0[None]), e, m.double())
    ours = ref.charges()[:n]
    assert float((ours - q[0, :n]).abs().max()) < 1e-6 * (
        float(ours.abs().max()) + 1)


def test_a_gate_tie_set_the_other_way_is_found():
    """A program that decides one tied pair's gate the other way is
    judged by the reference with that gate: the gap before is large, the
    gap after is float64 noise.  300 atoms seldom hold a pair within
    ``TIE_BAND`` of the threshold, so the threshold is put a thousandth
    below the pair nearest it."""
    s = small.spec("decay_model.frames-35520")
    model = s["config"]["model"]
    tree = weights.load(s["config"], "cpu")
    _, x, q0, xyz, mask, n = _graph_inputs(100, model["n_elems"], 9, 0.0)
    top = Graph(tree, model, x, q0, xyz, mask).e.amax(-1)
    nearest = top[(top / model["is_near_tol"] - 1.0).abs().argmin()]
    model = dict(model, is_near_tol=float(nearest) / 1.001)
    ref = Graph(tree, model, x, q0, xyz, mask)
    tied = torch.nonzero(ref.margin < compare.TIE_BAND).flatten()
    assert len(tied) > 0
    p = int(tied[0])
    gate = ref.gate.clone()
    gate[p] = gate[ref.flip_partner()[p]] = 1.0 - gate[p]
    q_prog = ref.charges(gate).numpy()
    r = compare.judge_graph(ref, q_prog, n, 1e-6)
    assert r["q_gap_raw"] > 1e-4
    assert r["q_gap"] < 1e-12 and r["ties_set"] == 1
