"""The ring-sharded forwards of the port (``epnn_tpu_torch.parallel.
ring_shard``) and ``weighted_kmeans_sharded`` on two gloo ranks on the
CPU, against the JAX package's on two virtual CPU devices, at D = 2: the
serving cases of ``tests/test_sharding.py``'s ``TestRingSharding``,
``TestRingNbrSharding`` and the ring cases of
``TestShardedUniformQ0Collapse``, ``TestShardedFarCluster`` and
``TestShardedNeighborReuse``, and the pass rounds' pair terms across
ranks with the blocks circulating.

Bars: charges within 1e-5·(max|q| + 1) of JAX's ring forward at the same
D, Σq equal to the net charge to float32 grade, and every cross-rank near
pair's two pass-round rows exact negations.  The distributed k-means:
the same assignments, centroids within rtol 1e-6 / atol 1e-6, weights
exactly equal (0/1 weights) or within rtol 1e-6, the radius as
``tests/test_torch_cluster.py`` bars it, at C ≤ 4 or C ≥ 32 and only on
data whose fit, run in float64, keeps every row's two best centroids
apart by 1e-4·(|best| + 1) (the seeds tie in between; ROADMAP).
"""

import numpy as np
import pytest

import torch_mesh as M
from test_torch_cluster import fit_margin, seeded_rows
from torch_mesh import (
    Case,
    assert_close,
    assert_conserves,
    contract_batch,
    probe_case,
    result,
    system,
    tables,
)

SMALL = M.SMALL
MARGIN = 1e-4

#: (n, d, centres, C, weights, data seed): the fits of the k-means cases
KMEANS = {
    "c3_binary": (48, 8, 3, 3, True, 0),
    "c4_real": (96, 16, 4, 4, False, 1),
    "c32_binary": (96, 8, 40, 32, True, 2),
    "c48_real": (120, 16, 60, 48, False, 3),
}


def kmeans_data(n, d, centres, c, binary, seed):
    """The case's rows and weights, with the first data seed from
    ``seed`` on whose float64 fit keeps the margin."""
    for s in range(seed, seed + 50):
        rows, w = seeded_rows(n, d, centres, s, binary)
        if fit_margin(rows, w, c)[0] > MARGIN:
            return rows, w
    raise AssertionError("no tie-free data")


def cases():
    sys0 = system()
    cb = contract_batch()
    cfg10 = dict(SMALL, n_elems=10)
    nbrs16 = tables(sys0[2], sys0[3], 5.0, 16)
    cb_nbrs = tables(cb[2], cb[3], 5.0, 16)
    d1 = system(seed=6, b=1, n=32, pad=0, span=8.0)
    dense = (d1[0][0], np.full((32,), -2.0 / 32, np.float32), d1[2][0],
             d1[3][0])
    p = system(seed=7, b=1, n=40, pad=7, span=8.0)
    x, xyz, mask = p[0][0].copy(), p[2][0].copy(), p[3][0]
    x[33:] = 0.0
    xyz[33:] = 0.0
    padded = (x, mask / 33.0, xyz, mask)
    atom_ref = system(seed=8, b=1, n=64, pad=0, span=9.0)
    out = {
        "dense": Case("ring_dense", dense, bias=0.0),
        "dense_padded_compat": Case(
            "ring_dense", padded, cfg=dict(SMALL, mask_messages=False),
            seed=2, bias=0.0),
        "nbr": Case("ring_nbr", sys0, dict(k_blk=16)),
        "nbr_pallas": Case("ring_nbr", sys0, dict(k_blk=16,
                                                  use_pallas=True)),
        "nbr_data_axis": Case("ring_nbr", sys0, dict(k_blk=16),
                              mesh=(2, 1)),
        "int8": Case("ring_nbr", sys0, dict(k_blk=16, use_pallas=True),
                     cfg=dict(SMALL, dense_matmul_precision="int8")),
        "bfloat16": Case("ring_nbr", sys0, dict(k_blk=16),
                         cfg=dict(SMALL, compute_dtype="bfloat16")),
        "ring_vs_atom_ring": Case("ring_nbr", atom_ref, dict(k_blk=24),
                                  seed=1, bias=0.0),
        "ring_vs_atom_atom": Case("atom_nbr", atom_ref, dict(k=24), seed=1,
                                  bias=0.0),
        "collapse_base": Case("ring_nbr", cb, dict(k_blk=16), cfg=cfg10,
                              bias=0.3),
        "collapse": Case("ring_nbr", cb, dict(k_blk=16, uniform_q0=True),
                         cfg=cfg10, bias=0.3),
        "cluster4": Case("ring_nbr", sys0, dict(k_blk=16, far_cluster=4)),
        "cluster4_pallas": Case("ring_nbr", sys0, dict(
            k_blk=16, far_cluster=4, use_pallas=True)),
        "cluster_n": Case("ring_nbr", sys0, dict(k_blk=16, far_cluster=48)),
        "composed": Case("ring_nbr", cb, dict(
            k_blk=16, neighbors=cb_nbrs, uniform_q0=True, far_cluster=4),
            cfg=cfg10, bias=0.3),
        "reuse": Case("ring_nbr", sys0, dict(k_blk=16, neighbors=nbrs16),
                      seed=1),
        "reuse_skin": Case("ring_nbr", sys0, dict(k_blk=16,
                                                  neighbors=nbrs16[:2]),
                           seed=1),
        "cold_seed1": Case("ring_nbr", sys0, dict(k_blk=16), seed=1),
        "k_blk_too_small": Case("ring_nbr", sys0, dict(
            k_blk=14, neighbors=nbrs16), jax=False),
        "cluster_grad": Case("ring_nbr", sys0, dict(
            k_blk=16, far_cluster=4, far_cluster_grad=True)),
        "pass_probe": Case("pass_probe", PROBE[0], dict(mode="ring"),
                           bias=0.0, jax=False),
    }
    for name, spec in KMEANS.items():
        out["kmeans_" + name] = Case("kmeans", kmeans_data(*spec),
                                     dict(c=spec[3]))
    out["kmeans_submesh"] = Case("kmeans", kmeans_data(*KMEANS["c3_binary"]),
                                 dict(c=3, submesh=True), jax=False)
    return out


PROBE = probe_case()
CASES = cases()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return M.run(CASES, str(tmp_path_factory.mktemp("ring")))


FORWARDS = ["dense", "dense_padded_compat", "nbr", "nbr_pallas",
            "nbr_data_axis", "int8", "ring_vs_atom_ring", "collapse_base",
            "collapse", "cluster4", "cluster4_pallas", "cluster_n",
            "cluster_grad", "composed", "reuse", "reuse_skin", "cold_seed1"]


@pytest.mark.parametrize("name", FORWARDS)
def test_charges_match_jax_ring(runs, name):
    port, ref, _ = runs
    assert_close(result(port, name), ref[name], what=name)


@pytest.mark.parametrize("name", [n for n in FORWARDS
                                  if n != "dense_padded_compat"])
def test_conserves_charge(runs, name):
    case = CASES[name]
    assert_conserves(result(runs[0], name), case.args[1], case.args[3])


def test_padding_rows_stay_zero(runs):
    q = result(runs[0], "dense_padded_compat")
    assert np.all(q[33:] == 0.0)


def test_bfloat16_tier(runs):
    port, ref, _ = runs
    out = result(port, "bfloat16")
    assert_close(out, ref["bfloat16"], bar=2e-2)
    assert_conserves(out, CASES["bfloat16"].args[1],
                     CASES["bfloat16"].args[3], atol=5e-5)


def test_ring_matches_atom_sharded(runs):
    """``TestRingNbrSharding.test_matches_atom_sharded``'s bar: the two
    layouts' charges within 1e-4·(max|q| + 1) of each other."""
    port = runs[0]
    assert_close(result(port, "ring_vs_atom_ring"),
                 result(port, "ring_vs_atom_atom"), bar=1e-4)


def test_collapse_and_cluster_at_n(runs):
    port = runs[0]
    assert_close(result(port, "collapse"), result(port, "collapse_base"))
    assert_close(result(port, "cluster_n"), result(port, "nbr"), bar=2e-5)


def test_reuse_matches_cold_ring(runs):
    port = runs[0]
    for name in ("reuse", "reuse_skin"):
        assert_close(result(port, name), result(port, "cold_seed1"))


@pytest.mark.parametrize("name,match", [
    ("k_blk_too_small", "k_blk"),
])
def test_errors(runs, name, match):
    out = runs[0][name]
    assert out[0] == "error" and match in out[1], out


def test_pass_pairs_negate_across_ranks(runs):
    """The ring's pass round: each rank's block against the block passing
    by; every cross-rank near pair's two rows exact negations."""
    extras = runs[2]
    rows = np.concatenate([extras[r]["pass_probe"] for r in range(M.WORLD)])
    cross = PROBE[1]
    assert np.array_equal(rows[cross[:, 0]], -rows[cross[:, 1]])
    assert np.count_nonzero(rows[cross[:, 0]]) > 0


@pytest.mark.parametrize("name", sorted(KMEANS))
def test_kmeans_sharded_matches_jax(runs, name):
    port, ref, _ = runs
    cent, wts, rad, same = result(port, "kmeans_" + name)
    rcent, rwts, rrad = ref["kmeans_" + name]
    rows, w = CASES["kmeans_" + name].args
    assert same, "not the same bits on a second call"
    np.testing.assert_allclose(cent, rcent, rtol=1e-6, atol=1e-6)
    if KMEANS[name][4]:
        np.testing.assert_array_equal(wts, rwts)
    else:
        np.testing.assert_allclose(wts, rwts, rtol=1e-6)
    np.testing.assert_allclose(wts.sum(), w.sum(), rtol=1e-6)
    # the radius comes from the assignment scores by cancellation: within
    # 8 float32 ulps of max‖r‖² + max‖c‖² in d²
    scale = float((rows ** 2).sum(1).max() + (rcent ** 2).sum(1).max())
    assert abs(float(rad) ** 2 - float(rrad) ** 2) <= 8 * 2 ** -23 * scale


def test_kmeans_takes_the_submesh(runs):
    """``axis_name`` as the 1-D sub-mesh gives the process group's fit."""
    port = runs[0]
    for a, b in zip(result(port, "kmeans_submesh")[:3],
                    result(port, "kmeans_c3_binary")[:3]):
        np.testing.assert_array_equal(a, b)
