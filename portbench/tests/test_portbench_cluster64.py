"""The clustered far-field tier in the harness: the float64 clustered
reference (``portbench.reference.cluster64``) against the exact one and
against the port's CPU path, the frozen counts at the tier, and the
judge's verdict on a program that drops the far field and on the
clustered control.

The cell here is the MD traffic at 300–1,200 atoms with ``far_cluster``
in its ``predictor`` options, serving the architecture of the reference
training driver's model (the repository's ``trained/mixed_b16``: width
10, masked message sums, h 48, e 48, msg 32, MLP [32, 32], T 5, 3 Å) at
a seeded draw whose charges read the far field."""

import numpy as np
import pytest
import torch

from epnn_tpu_torch.ops.fused import forward_blocked, fuse_params
from portbench import compare, run, weights
from portbench.frozen import work
from portbench.reference import cluster64, epnn64
from portbench.tests import small
from portbench.tests.test_portbench_reference import _graph_inputs

SEED = 2**34 + 5
#: the model of the repository's ``trained/mixed_b16/config.json``
MIXED = {"n_elems": 10, "h_dim": 48, "e_dim": 48, "msg_dim": 32,
         "mlp_hidden": [32, 32], "T": 5, "cutoff": 3.0, "eta": 2.0,
         "mask_messages": True, "pass_weighting": "hard_gate",
         "is_near_tol": 1e-05}
C = 32
F64 = torch.float64


def clustered_spec(molecules: int = 100, far_cluster: int = C,
                   model: dict = None) -> dict:
    """The MD cell cut to ``molecules`` waters, serving ``model`` (the
    mixed architecture) at the ``parity`` tier with ``far_cluster``."""
    s = small.spec(small.MD, molecules)
    t = dict(s["traffic"], predictor=dict(s["traffic"]["predictor"],
                                          far_cluster=far_cluster))
    cfg = dict(s["config"], model=dict(model or MIXED))
    return dict(s, traffic=t, config=cfg)


def _tree_and_inputs(model, n_mol, seed, charge=1.0):
    spec = clustered_spec(n_mol, model=model)
    tree = weights.load(spec["config"], "cpu")
    return spec, tree, _graph_inputs(n_mol, model["n_elems"], seed, charge)


@pytest.mark.parametrize("model", [
    MIXED, small.spec(small.MD)["config"]["model"]],
    ids=["masked", "unmasked"])
def test_singleton_clusters_are_the_exact_reference(model):
    """With one cluster a valid row (C = the rows of non-zero weight),
    the clustered reference's charges are the exact reference's within
    float64 rounding: round 1's grid is an identity, and every later
    centroid is one row with its own weight."""
    torch.set_num_threads(1)
    _, tree, (_, x, q0, xyz, mask, n) = _tree_and_inputs(model, 200, 3)
    exact = epnn64.Graph(tree, model, x, q0, xyz, mask)
    cols = n if model["mask_messages"] else len(mask)
    ours = cluster64.Graph(tree, model, x, q0, xyz, mask, far_cluster=cols)
    assert torch.equal(ours.pi, exact.pi) and torch.equal(ours.pj, exact.pj)
    qe, qc = exact.charges()[:n], ours.charges()[:n]
    assert float((qe - qc).abs().max()) < 1e-10 * (
        float(qe.abs().max()) + 1.0)


def test_the_tier_moves_the_charges():
    """The fit is no identity: at a draw whose j-side rows spread (the
    message heads at gain 0.02, where the near field moves the hidden
    state far more than at 2.2 / N), C = 32 of 600 rows moves the charges
    by far more than float64 rounding; the sum of charges is Q either way
    (the pass rounds are exact).  At the cells' gain of 2.2 / N the rows
    after round 1 are two tight blobs (O and H), and the tier's charges
    lie within about 1e-6 e of the exact ones."""
    torch.set_num_threads(1)
    spec, _, (_, x, q0, xyz, mask, n) = _tree_and_inputs(MIXED, 200, 4)
    spec["config"]["weights"] = dict(spec["config"]["weights"],
                                     message_out_gain=0.02)
    tree = weights.load(spec["config"], "cpu")
    qe = epnn64.Graph(tree, MIXED, x, q0, xyz, mask).charges()[:n]
    qc = cluster64.Graph(tree, MIXED, x, q0, xyz, mask,
                         far_cluster=C).charges()[:n]
    assert float((qe - qc).abs().max()) > 1e-6 * (float(qe.abs().max()) + 1)
    assert abs(float(qc.sum()) - 1.0) < 1e-9


def test_the_stated_c_is_below_the_judge_at_the_cells_gain():
    """At the cells' gain of 2.2 / N the j-side rows after round 1 are two
    tight blobs, so a fit of 16 centroids where 32 are stated moves the
    charges by about 1e-6 e at 600 atoms: far under any limit, and no
    fault the judge can see (it sees the far field dropped and the
    bfloat16 control, below).  The tier's C is checked by passing it,
    not by the charges."""
    torch.set_num_threads(1)
    _, tree, (_, x, q0, xyz, mask, n) = _tree_and_inputs(MIXED, 200, 4)
    q16, q32 = (cluster64.Graph(tree, MIXED, x, q0, xyz, mask,
                                far_cluster=c).charges()[:n]
                for c in (16, 32))
    assert 0.0 < float((q16 - q32).abs().max()) < small.LIMITS["q_gap"] / 30


def test_kmeans_keeps_every_weight():
    """The fit's weights sum to the rows' weights, zero-weight rows take
    no part, and C beyond the valid rows leaves the repeats empty."""
    g = torch.Generator().manual_seed(0)
    rows = torch.randn(50, 4, generator=g, dtype=torch.float64)
    w = torch.ones(50, dtype=torch.float64)
    w[40:] = 0
    cent, wts = cluster64.weighted_kmeans(rows, w, 8)
    assert cent.shape == (8, 4) and float(wts.sum()) == 40.0
    cent, wts = cluster64.weighted_kmeans(rows, w, 45)
    assert float(wts.sum()) == 40.0 and int((wts == 0).sum()) >= 5


def test_kmeans_is_the_tiers_fit():
    """On float32 rows the float64 fit lands where the port's fit does
    (the same seeds, assignments and weights), on a cloud and on two
    tight blobs, the rows' shape after round 1 at the cells' gain."""
    from epnn_tpu_torch.ops.cluster import weighted_kmeans

    g = torch.Generator().manual_seed(1)
    cloud = torch.randn(600, 32, generator=g)
    blobs = torch.cat([torch.randn(400, 32, generator=g) * 0.1 + 1.0,
                       torch.randn(200, 32, generator=g) * 0.1 - 1.0])
    w = torch.ones(600)
    w[-10:] = 0
    for rows in (cloud, blobs):
        cent, wts, _ = weighted_kmeans(rows, w, C)
        ours, ours_w = cluster64.weighted_kmeans(rows, w, C)
        assert torch.equal(ours_w, wts.double())
        assert float((ours - cent.double()).abs().max()) < 1e-5


def test_cell_pairs_are_every_pair_within_the_cutoff():
    xyz = torch.as_tensor(_graph_inputs(150, 9, 8, 0.0)[3], dtype=F64)
    real = torch.ones(len(xyz), dtype=torch.bool)
    real[-3:] = False
    i, j, d = cluster64.cell_pairs(xyz, real, 3.0)
    full = torch.cdist(xyz, xyz)
    hit = (full < 3.0) & real[:, None] & real[None, :]
    hit.fill_diagonal_(False)
    a, b = hit.nonzero(as_tuple=True)
    assert torch.equal(i, a) and torch.equal(j, b)
    assert float((d - full[a, b]).abs().max()) < 1e-12


@pytest.mark.parametrize("seed", [4, 11])
def test_the_ports_clustered_forward_agrees(seed):
    """The port's ``forward_blocked(..., neighbor_k=k, far_cluster=32)``
    in float32 on the CPU against the clustered reference, at 600 atoms.
    The two fits start from the same norm seeds (600 rows' norms lie far
    further apart than float32's rounding of them) and follow the same
    assignments, so the charges agree to float32 noise carried through
    five rounds: 2e-5 · (max|q| + 1) holds them with room (the exact
    reference against the port reads ≤ 1e-5 e at 300 atoms,
    ``test_portbench_reference``)."""
    torch.set_num_threads(1)
    spec, tree, (_, x, q0, xyz, mask, n) = _tree_and_inputs(MIXED, 200,
                                                            seed)
    cfg = run.model_config(spec["config"])
    fused = fuse_params(tree, cfg, "cpu")
    args = [torch.as_tensor(np.asarray(a, np.float32))[None]
            for a in (x, q0, xyz, mask)]
    top = max(int(((torch.cdist(args[2][0][:n], args[2][0][:n]) < 3.0)
                   .sum(1) - 1).max()), 1)
    with torch.no_grad():
        q = forward_blocked(fused, *args, cfg, neighbor_k=work.safe_k(
            top, len(mask)), far_cluster=C, uniform_q0=True)[0, :n]
    ref = cluster64.Graph(tree, MIXED, x, q0, xyz, mask, far_cluster=C)
    r = compare.judge_graph(ref, q.numpy(), n, 1e-5)
    assert r["q_gap"] < 2e-5 * (r["q_max"] + 1.0), r


# -- the counts ------------------------------------------------------------
#: the parent's integers of ``graph_flops`` for the two cells' model
#: (decay_model, width 9, unmasked) at 35,520 atoms and k slots
PARENT_FLOPS = {24: {"far": 10_658_591_539_200, "rest": 66_612_252_288},
                32: {"far": 10_658_591_539_200, "rest": 86_980_841_088},
                40: {"far": 10_658_591_539_200, "rest": 107_349_429_888}}


@pytest.mark.parametrize("k", sorted(PARENT_FLOPS))
def test_counts_without_the_tier_are_the_parents(k):
    model = small.spec(small.MD)["config"]["model"]
    assert work.graph_flops(model, 35520, k) == PARENT_FLOPS[k]
    assert work.graph_flops(model, 35520, k, far_cluster=0) == \
        PARENT_FLOPS[k]
    assert work.call_flops(model, [35520], [k]) == PARENT_FLOPS[k]


@pytest.mark.parametrize("model", [MIXED, small.spec(small.MD)["config"][
    "model"]], ids=["masked", "unmasked"])
def test_counts_at_the_tier_are_r_by_c(model):
    n, k = 568320, 40
    exact = work.graph_flops(model, n, k)
    tier = work.graph_flops(model, n, k, far_cluster=C)
    h = model["mlp_hidden"][0]
    assert tier["far"] == (model["T"] - 1) * work.far_field(n, C, h).flops
    assert tier["far"] * (n // C) == exact["far"]
    assert tier["rest"] == exact["rest"]
    two = work.call_flops(model, [n, n], [k, k], far_cluster=C)
    assert two == {key: 2 * v for key, v in tier.items()}


def test_counts_at_the_tier_are_the_ports_less_the_fit():
    """``count_flops`` of the port's clustered forward holds the fit's
    products (its assignment scores and one-hot sums, 2·N·C·D each, nine
    and eight a round); the frozen count leaves them out, and equals the
    rest."""
    from epnn_tpu_torch.utils.timing import count_flops

    spec, tree, (_, x, q0, xyz, mask, n) = _tree_and_inputs(MIXED, 100, 5)
    cfg = run.model_config(spec["config"])
    fused = fuse_params(tree, cfg, "cpu")
    args = [torch.as_tensor(np.asarray(a, np.float32))[None]
            for a in (x, q0, xyz, mask)]
    k = 24
    got = count_flops(forward_blocked, fused, *args, cfg, neighbor_k=k,
                      far_cluster=C, uniform_q0=True)
    want = work.graph_flops(MIXED, len(mask), k, far_cluster=C)
    h = MIXED["mlp_hidden"][0]
    fit = (MIXED["T"] - 1) * (9 + 8) * 2 * len(mask) * C * h
    assert got == want["far"] + want["rest"] + fit


# -- the judge -------------------------------------------------------------
def _run(fault=None, far_cluster=C, control=None, seed=SEED):
    torch.manual_seed(0)
    torch.set_num_threads(1)
    return run.run_cell(clustered_spec(100, far_cluster), seed, 1.0, False,
                        "cpu", fault=fault, control=control)


def test_a_sound_clustered_run_is_correct():
    r = _run()
    assert r["correct"], r["checks"]
    assert r["checks"]["q_gap"]["value"] < 0.1 * small.LIMITS["q_gap"]


def test_the_far_field_dropped(monkeypatch):
    from epnn_tpu_torch.ops import fused

    def dropped(f):
        def inner(*a, **k):
            s, rad = f(*a, **k)
            return torch.zeros_like(s), rad
        return inner

    monkeypatch.setattr(fused, "_clustered_far_field",
                        dropped(fused._clustered_far_field))
    r = _run()
    assert not r["correct"], r["checks"]


def test_the_clustered_control():
    """The clustered reference with a bfloat16 far field, in the
    program's place."""
    r = _run(control="bf16_far")
    assert not r["correct"], r["checks"]


def test_a_clustered_judge_loads_nothing_of_the_port():
    from portbench.tests.test_portbench_imports import _loaded

    names = _loaded("import portbench.reference.cluster64")
    assert not names & (set(run.FORBIDDEN) | {"epnn_tpu_torch"})
