"""The atom-sharded forwards of the port (``epnn_tpu_torch.parallel.
atom_shard``) on two gloo ranks on the CPU, against the JAX package's
(``epnn_tpu.parallel.atom_shard``) on two virtual CPU devices, at D = 2:
the serving cases of ``tests/test_sharding.py``'s ``TestAtomSharding``,
``TestShardedUniformQ0Collapse``, ``TestShardedFarCluster`` and
``TestShardedNeighborReuse``, and the pass rounds' pair terms across
ranks.

Bars: charges within 1e-5·(max|q| + 1) of JAX's (``tests/test_fused.
py:105``; the bf16 tier JAX's own 2e-2 between its tiers), Σq equal to
the net charge to float32 grade (2e-5 e, 5e-5 under bf16, or 2e-6·(Σ|q|
+ 1) where that is larger: ``torch_mesh.assert_conserves``), chunked and
windowed forwards bit for bit the full-width one, and every cross-rank
near pair's two pass-round rows exact negations.  The clustered cases run
at C ≤ 4 and C ≥ 32 (the k-means seeds tie in between; ROADMAP) on a
system whose fits the single-rank tests hold apart.  Both sides run in
their own processes (``torch_mesh``), once for the file.
"""

import numpy as np
import pytest

import torch_mesh as M
from torch_mesh import (
    Case,
    assert_close,
    assert_conserves,
    contract_batch,
    probe_case,
    result,
    system,
    tables,
    window_case,
)

SMALL = M.SMALL


def cases():
    sys0 = system()
    cb = contract_batch()
    (wsys, wk, wnbrs, win) = window_case()
    nbrs16 = tables(sys0[2], sys0[3], 5.0, 16)
    cb_nbrs = tables(cb[2], cb[3], 5.0, 16)
    cfg10 = dict(SMALL, n_elems=10)
    out = {
        "nbr": Case("atom_nbr", sys0, dict(k=16)),
        "nbr_pallas": Case("atom_nbr", sys0, dict(k=16, use_pallas=True)),
        "nbr_data_axis": Case("atom_nbr", sys0, dict(k=16), mesh=(2, 1)),
        "bfloat16": Case("atom_nbr", sys0, dict(k=16),
                         cfg=dict(SMALL, compute_dtype="bfloat16")),
        "bf16x3": Case("atom_nbr", sys0, dict(k=16),
                       cfg=dict(SMALL, dense_matmul_precision="bf16x3")),
        "int8": Case("atom_nbr", sys0, dict(k=16, use_pallas=True),
                     cfg=dict(SMALL, dense_matmul_precision="int8")),
        "window_base": Case("atom_nbr", wsys, dict(k=wk, neighbors=wnbrs)),
        "chunk8": Case("atom_nbr", wsys, dict(k=wk, neighbors=wnbrs,
                                              near_row_chunk=8)),
        "chunk6": Case("atom_nbr", wsys, dict(k=wk, neighbors=wnbrs,
                                              near_row_chunk=6)),
        "window": Case("atom_nbr", wsys, dict(k=wk, neighbors=wnbrs,
                                              near_row_chunk=8,
                                              near_window=win)),
        "window_no_chunk": Case("atom_nbr", wsys, dict(
            k=wk, neighbors=wnbrs, near_window=16), jax=False),
        "dense": Case("atom_single", tuple(a[0] for a in system(
            seed=1, b=1, n=32, pad=0))),
        "dense_batch": Case("atom_dense", system(seed=2, n=32, pad=3),
                            mesh=(2, 1)),
        "conservation": Case("atom_single", (
            system(seed=5, b=1, n=64, pad=0, span=10.0)[0][0],
            np.full((64,), -2.0 / 64, np.float32),
            system(seed=5, b=1, n=64, pad=0, span=10.0)[2][0],
            np.ones((64,), np.float32)), seed=1, bias=0.0),
        "collapse_base": Case("atom_nbr", cb, dict(k=16), cfg=cfg10,
                              bias=0.3),
        "collapse": Case("atom_nbr", cb, dict(k=16, uniform_q0=True),
                         cfg=cfg10, bias=0.3),
        "collapse_compat_base": Case(
            "atom_nbr", cb, dict(k=16),
            cfg=dict(cfg10, mask_messages=False), bias=0.3),
        "collapse_compat": Case(
            "atom_nbr", cb, dict(k=16, uniform_q0=True),
            cfg=dict(cfg10, mask_messages=False), bias=0.3),
        "cluster4": Case("atom_nbr", sys0, dict(k=16, far_cluster=4)),
        "cluster_n": Case("atom_nbr", sys0, dict(k=16, far_cluster=48)),
        "cluster4_int8": Case("atom_nbr", sys0, dict(
            k=16, far_cluster=4, use_pallas=True),
            cfg=dict(SMALL, dense_matmul_precision="int8")),
        "reuse": Case("atom_nbr", sys0, dict(k=16, neighbors=nbrs16)),
        "reuse_skin": Case("atom_nbr", sys0, dict(k=16,
                                                  neighbors=nbrs16[:2])),
        "composed": Case("atom_nbr", cb, dict(
            k=16, neighbors=cb_nbrs, uniform_q0=True, far_cluster=4),
            cfg=cfg10, bias=0.3),
        "pass_probe": Case("pass_probe", PROBE[0], dict(mode="atom"),
                           bias=0.0, jax=False),
        # JAX's test_scaling_work_divides: 256 atoms in a 14 Å box, k 16
        "flops": Case("flops", system(seed=7, b=1, n=256, pad=0,
                                      span=14.0), dict(k=16), jax=False),
    }
    return out


PROBE = probe_case()
CASES = cases()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return M.run(CASES, str(tmp_path_factory.mktemp("atom")))


EXACT = ["nbr", "nbr_pallas", "nbr_data_axis", "bf16x3", "int8",
         "window_base", "chunk8", "chunk6", "window", "dense", "dense_batch",
         "conservation", "collapse_base", "collapse", "collapse_compat_base",
         "collapse_compat", "cluster4", "cluster_n", "cluster4_int8",
         "reuse", "reuse_skin", "composed"]


@pytest.mark.parametrize("name", EXACT)
def test_charges_match_jax_sharded(runs, name):
    port, ref, _ = runs
    assert_close(result(port, name), ref[name], what=name)


@pytest.mark.parametrize("name", ["nbr", "nbr_pallas", "nbr_data_axis",
                                  "bf16x3", "int8", "window", "collapse",
                                  "collapse_compat", "cluster4", "cluster_n",
                                  "reuse", "reuse_skin", "composed"])
def test_conserves_charge(runs, name):
    case = CASES[name]
    assert_conserves(result(runs[0], name), case.args[1], case.args[3])


def test_bfloat16_tier(runs):
    """compute_dtype='bfloat16' (bf16 messages, float32 pass rounds): JAX's
    bar between its tiers, 2e-2·(max|q| + 1), against JAX's sharded bf16
    forward, and conservation at float32 grade."""
    port, ref, _ = runs
    out = result(port, "bfloat16")
    assert_close(out, ref["bfloat16"], bar=2e-2)
    case = CASES["bfloat16"]
    assert_conserves(out, case.args[1], case.args[3], atol=5e-5)


@pytest.mark.parametrize("name", ["chunk8", "chunk6", "window"])
def test_chunks_and_window_bit_for_bit(runs, name):
    """Chunking each rank's rows (8 divides R = 32; 6 does not) and a
    window at least the largest per-rank spread give the full-width
    charges bit for bit, as in JAX."""
    port = runs[0]
    np.testing.assert_array_equal(result(port, name),
                                  result(port, "window_base"))


def test_window_requires_chunks(runs):
    out = runs[0]["window_no_chunk"]
    assert out[0] == "error" and "near_window requires" in out[1], out


def test_collapse_matches_uncollapsed(runs):
    """The round-1 collapse changes only the association of the far sum."""
    port = runs[0]
    for mm in ("", "_compat"):
        assert_close(result(port, f"collapse{mm}"),
                     result(port, f"collapse{mm}_base"))


def test_cluster_at_n_is_exact(runs):
    """C ≥ the valid atoms: every row its own centroid, the exact far
    field up to summation order."""
    port = runs[0]
    assert_close(result(port, "cluster_n"), result(port, "nbr"), bar=2e-5)


def test_reuse_matches_in_forward_selection(runs):
    port = runs[0]
    for name in ("reuse", "reuse_skin"):
        assert_close(result(port, name), result(port, "nbr"))


def test_scaling_work_divides(runs):
    """The counterpart of JAX's ``test_scaling_work_divides``
    (``tests/test_sharding.py:764``): a rank's products on the atom split
    (``cost_analysis``'s count) at D = 2 are at most 0.6 of the one-device
    forward's (ideal 0.5; the slack is the replicated O(N) work), the
    same on both ranks."""
    counts = [runs[2][r]["flops"] for r in range(M.WORLD)]
    assert all(c == counts[0] for c in counts), counts
    assert 0 < counts[0]["rank"] <= 0.6 * counts[0]["one"], counts[0]


def test_pass_pairs_negate_across_ranks(runs):
    """Each disjoint near pair (i, j) with i and j on different ranks:
    the two ranks' pass-round rows, computed at different row offsets of
    their launches, are exact negations."""
    extras = runs[2]
    rows = np.concatenate([extras[r]["pass_probe"] for r in range(M.WORLD)])
    cross = PROBE[1]
    assert np.array_equal(rows[cross[:, 0]], -rows[cross[:, 1]])
    assert np.count_nonzero(rows[cross[:, 0]]) > 0


# ---------------------------------------------------------------------------
# the kernel wrappers at a rank's shapes (R = N/2 rows of a graph)
# ---------------------------------------------------------------------------

def _rank_inputs(n=96, h=32, e=48, k=12, seed=0):
    import torch

    g = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        g.normal(size=s).astype(np.float32))
    idx = torch.from_numpy(g.integers(0, n, size=(n, k)))
    mask = torch.from_numpy((g.uniform(size=(n, k)) < 0.7).astype(
        np.float32))
    return dict(pi=t(n, h), pj=t(n, h), cv=torch.ones(n), w2=t(h, h) * 0.2,
                b2=t(h) * 0.1, w1e=t(e, h) * 0.2, rbf=t(n * k, e), idx=idx,
                mask=mask, rs=t(n, 2 * h))


@pytest.mark.parametrize("name", ["dense_message_rowsum",
                                  "dense_message_rowsum_int8",
                                  "near_message_corr", "near_pass_rowsum"])
def test_wrappers_take_a_ranks_rows(monkeypatch, name):
    """Each kernel the sharded forwards launch, through its wrapper's card
    path (the launch emulated, ``test_torch_widths.arm_card``), on the
    second half of a graph's rows (R = N/2, at row offset N/2) against all
    N columns or their gathered neighbors: the launch takes R rows and N
    columns as given (no R == N anywhere), and its rows equal the
    full-grid call's rows [N/2, N) within 1e-5·(max|ref| + 1)."""
    import torch

    from epnn_tpu_torch.ops import kernels
    from test_torch_widths import arm_card

    calls = arm_card(monkeypatch)
    a = _rank_inputs()
    n = a["pi"].shape[0]
    r = n // 2
    rows = slice(r, n)
    k = a["idx"].shape[1]
    hi = dict(precision="highest")
    if name == "dense_message_rowsum":
        fn = lambda pi: kernels.dense_message_rowsum(  # noqa: E731
            pi, a["pj"], a["cv"], a["w2"], a["b2"], **hi)
        full, part = fn(a["pi"]), fn(a["pi"][rows].contiguous())
        splits, cols = kernels._dense_message_splits(r, n)
        assert calls[-1]["scalars"] == (r, n, 32, splits, cols)
        assert tuple(calls[-1]["tensors"][5].shape) == (splits, r, 32)
    elif name == "dense_message_rowsum_int8":
        fn = lambda pi: kernels.dense_message_rowsum_int8(  # noqa: E731
            pi, a["pj"], a["cv"], a["w2"], a["b2"],
            pad_pi=torch.zeros(()), pad_pj=True)
        full, part = fn(a["pi"]), fn(a["pi"][rows].contiguous())
        assert calls[-1]["scalars"][:2] == (r, n)
        # the scale is per call: R rows see their own max(pi), as JAX's
        # kernel does on a rank's padded operands
        ref = kernels.dense_message_rowsum_int8_plain(
            a["pi"][rows].contiguous(), a["pj"], a["cv"], a["w2"], a["b2"],
            torch.zeros(()), True)
        assert_close(part.numpy(), ref.numpy())
        return
    elif name == "near_message_corr":
        fn = lambda sl: kernels.near_message_corr(  # noqa: E731
            a["pi"][sl].contiguous(), a["pj"][a["idx"][sl].reshape(-1)],
            a["rbf"][sl.start * k:sl.stop * k].contiguous(),
            a["mask"][sl].contiguous(), a["w1e"], a["w2"], a["b2"], **hi)
        full, part = fn(slice(0, n)), fn(rows)
        assert calls[-1]["scalars"][:2] == (r, k)
    else:
        gh = 0.5 * a["mask"]
        fn = lambda sl: kernels.near_pass_rowsum(  # noqa: E731
            a["rs"][sl].contiguous(), a["rs"][a["idx"][sl].reshape(-1)],
            a["rbf"][sl.start * k:sl.stop * k].contiguous(),
            gh[sl].contiguous(), a["w1e"], a["w2"], a["b2"], **hi)
        full, part = fn(slice(0, n)), fn(rows)
        assert calls[-1]["scalars"][:2] == (r, k)
    assert part.shape == (r, 32)
    assert_close(part.numpy(), full[rows].numpy())
