"""``neighbor_compact``'s split scan, on the CPU.

The CUDA kernel (``csrc/neighbor_compact.cu``) scans the column range in
fixed splits (``kernels.neighbor_compact_splits``): a block's thread owns a
row and walks its split's columns in order, staged with the column mask
folded into the coordinates (a masked column sits 1e18 away), skips a
stage whose bounding box lies beyond the cutoff from its block's rows'
(:func:`culled`), and appends
each hit (d² < cutoff², j ≠ i) to the row's list for the split (at most k)
beside the split's count; a merge then takes each row's first k hits over
the splits in order.  :func:`emulate` is that contract in NumPy and
PyTorch, pass by pass.  It is held to ``kernels.neighbor_compact_plain``,
to JAX's ``neighbor_compact`` (interpret mode, as
``tests/test_torch_kernels_fused.py`` runs it) and to top-k's set, bit for
bit: on a shuffled water box, with rows exactly at k and over k, masked
atoms, N no multiple of a block or a split, and N below one block.  The
wrapper's card path (``_launch`` emulated) passes the kernel the split and
scratch it expects.
"""

import numpy as np
import pytest
import torch

from epnn_tpu.ops.pallas_kernels import neighbor_compact as jax_neighbor_compact
from epnn_tpu_torch.featurize import pair_d2
from epnn_tpu_torch.ops import fused, kernels
from epnn_tpu_torch.testing import water_box
from test_torch_fused import _t

torch.set_num_threads(1)

CUTOFF = 3.0
CUT2 = CUTOFF * CUTOFF
FAR = np.float32(1e18)


def emulate(xyz, mask, cutoff2, k, splits, cols):
    """The kernel's two passes for the squared cutoff ``cutoff2`` (float32,
    as the wrapper hands it): ``(cnt, hits)`` of the scan — cnt (splits,
    N), the hits of each split a row has; hits (splits, k, N), its first k
    columns — and the merge's ``(idx, mask)`` (N, k)."""
    xyz = torch.as_tensor(xyz)
    mask = torch.as_tensor(mask)
    n = xyz.shape[0]
    staged = torch.where(mask[:, None] > 0, xyz, torch.full_like(xyz, FAR))
    live = mask > 0
    rows = torch.arange(n)
    cnt = np.zeros((splits, n), np.int64)
    hits = np.full((splits, k, n), -1, np.int64)
    for s in range(splits):
        j0, j1 = s * cols, min(n, (s + 1) * cols)
        cj = torch.arange(j0, j1)
        d2 = pair_d2(xyz[:, None], staged[None, j0:j1])
        hit = ((d2 < np.float32(cutoff2)) & (rows[:, None] != cj[None, :])
               & live[:, None]).numpy()
        cnt[s] = hit.sum(1)
        for i in range(n):
            found = cj.numpy()[hit[i]][:k]
            hits[s, :len(found), i] = found
    idx = np.zeros((n, k), np.int64)
    out_mask = np.zeros((n, k), np.float32)
    for i in range(n):
        merged = [hits[s, c, i] for s in range(splits)
                  for c in range(min(cnt[s, i], k))][:k]
        idx[i, :len(merged)] = merged
        out_mask[i, :len(merged)] = 1.0
    return (cnt, hits), (idx, out_mask)


def culled(xyz, mask, cutoff2, splits, cols, rows=128, stage=128):
    """The kernel's cull, (row block, stage) → skipped: the boxes of the
    block's valid rows and of the stage's valid columns, in float32, their
    gap squared above 1.001 · cutoff²; and the hits among the skipped
    pairs (there must be none)."""
    x = np.asarray(xyz, np.float32)
    valid = np.asarray(mask) > 0
    n = len(x)
    d2 = pair_d2(torch.from_numpy(x)[:, None],
                 torch.from_numpy(x)[None]).numpy()
    hit = (d2 < np.float32(cutoff2)) & valid[:, None] & valid[None, :]
    np.fill_diagonal(hit, False)

    def box(sel):
        if not sel.any():
            return np.full(3, np.inf, np.float32), np.full(3, -np.inf,
                                                           np.float32)
        return x[sel].min(0), x[sel].max(0)

    skipped, missed = {}, 0
    for r0 in range(0, n, rows):
        rsel = np.zeros(n, bool)
        rsel[r0:r0 + rows] = True
        rlo, rhi = box(rsel & valid)
        for s in range(splits):
            j0, j1 = s * cols, min(n, (s + 1) * cols)
            for c0 in range(j0, j1, stage):
                csel = np.zeros(n, bool)
                csel[c0:min(c0 + stage, j1)] = True
                clo, chi = box(csel & valid)
                with np.errstate(invalid="ignore"):
                    g = np.maximum(0.0, np.maximum(clo - rhi, rlo - chi))
                gap2 = np.float32(np.sum(g.astype(np.float32) ** 2))
                cut = bool(gap2 > np.float32(1.001) * np.float32(cutoff2))
                skipped[(r0, c0)] = cut
                if cut:
                    missed += int(hit[r0:r0 + rows, c0:min(c0 + stage,
                                                            j1)].sum())
    return skipped, missed


def shuffled_box(n_molecules, seed=0, n_masked=0):
    """A water box in a seeded random atom order, the last ``n_masked``
    atoms and one in the middle masked (if ``n_masked``)."""
    xyz = water_box(n_molecules, seed=seed).xyz
    perm = np.random.default_rng(seed + 1).permutation(len(xyz))
    xyz = np.ascontiguousarray(xyz[perm])
    mask = np.ones(len(xyz), np.float32)
    if n_masked:
        mask[-n_masked:] = 0.0
        mask[len(xyz) // 2] = 0.0
    return xyz, mask


def _counts(xyz, mask):
    return emulate(xyz, mask, CUT2, len(xyz), 1, len(xyz))[0][0][0]


def _all_refs(xyz, mask, k):
    plain = [a.numpy() for a in kernels.neighbor_compact_plain(
        _t(xyz), _t(mask), CUTOFF, k)]
    jax_out = [np.asarray(a) for a in jax_neighbor_compact(xyz, mask, CUTOFF,
                                                          k)]
    return plain, (jax_out[0].astype(np.int64), jax_out[1])


@pytest.mark.parametrize("n_molecules,n_masked", [(100, 0), (100, 7),
                                                   (86, 3), (17, 0)])
def test_emulation_matches_plain_jax_and_topk(n_molecules, n_masked):
    """300, 258 and 51 atoms (N no multiple of the 128-row block or of a
    split; 51 below one block), at k the fullest row's count: the
    emulated split scan gives the plain version's and JAX's table bit for
    bit, and top-k's set on every row."""
    xyz, mask = shuffled_box(n_molecules, seed=n_molecules, n_masked=n_masked)
    n = len(xyz)
    k = int(_counts(xyz, mask).max())
    splits, cols = kernels.neighbor_compact_splits(n)
    assert (splits - 1) * cols < n <= splits * cols
    _, (idx, m) = emulate(xyz, mask, CUT2, k, splits, cols)
    (ip, mp), (ij, mj) = _all_refs(xyz, mask, k)
    np.testing.assert_array_equal(idx, ip)
    np.testing.assert_array_equal(m, mp)
    np.testing.assert_array_equal(idx, ij)
    np.testing.assert_array_equal(m, mj)
    assert m.sum(1).max() == k  # the fullest row exactly at k
    it, mt = fused.build_neighbors(_t(xyz), _t(mask), CUTOFF, k)
    for r in range(n):
        assert (set(idx[r][m[r] > 0].tolist())
                == set(it[r][mt[r] > 0].tolist()))
    assert not m[mask == 0].any()


@pytest.mark.parametrize("splits", [1, 2, 3, 7])
def test_split_count_does_not_change_the_table(splits):
    """Any split of the columns gives the same table: the merge takes the
    splits in order, each split's hits ascending."""
    xyz, mask = shuffled_box(60, seed=3, n_masked=2)
    n = len(xyz)
    k = int(_counts(xyz, mask).max())
    cols = -(-n // splits)
    (cnt, hits), (idx, m) = emulate(xyz, mask, CUT2, k, splits, cols)
    ip, mp = (a.numpy() for a in kernels.neighbor_compact_plain(
        _t(xyz), _t(mask), CUTOFF, k))
    np.testing.assert_array_equal(idx, ip)
    np.testing.assert_array_equal(m, mp)
    np.testing.assert_array_equal(cnt.sum(0), m.sum(1))


@pytest.mark.parametrize("k", [1, 3, 5])
def test_rows_over_k_drop_what_jax_drops(k):
    """k below the fullest rows' counts: every row keeps its first k
    columns in ascending order, as the plain version and JAX do; a split's
    count goes on past k (the merge caps it)."""
    xyz, mask = shuffled_box(100, seed=5, n_masked=4)
    n = len(xyz)
    splits, cols = kernels.neighbor_compact_splits(n)
    (cnt, _), (idx, m) = emulate(xyz, mask, CUT2, k, splits, cols)
    (ip, mp), (ij, mj) = _all_refs(xyz, mask, k)
    np.testing.assert_array_equal(idx, ip)
    np.testing.assert_array_equal(m, mp)
    np.testing.assert_array_equal(idx, ij)
    np.testing.assert_array_equal(m, mj)
    assert (_counts(xyz, mask) > k).any() and cnt.max() > 0


@pytest.mark.parametrize("order", ["ordered", "shuffled"])
def test_cull_skips_no_hit(order):
    """On a 1,800-atom water box, lattice-ordered or shuffled, with masked
    atoms: no culled (row block, stage) holds a hit.  Ordered, most stages
    are culled; shuffled, every box spans the system and none is."""
    if order == "ordered":
        xyz = water_box(600, seed=2).xyz
        mask = np.ones(len(xyz), np.float32)
        mask[-4:] = 0.0
    else:
        xyz, mask = shuffled_box(600, seed=2, n_masked=4)
    splits, cols = kernels.neighbor_compact_splits(len(xyz))
    skipped, missed = culled(xyz, mask, CUT2, splits, cols)
    assert missed == 0
    share = np.mean(list(skipped.values()))
    if order == "ordered":
        assert share > 0.5, share
    else:
        assert share == 0.0, share


def test_masked_column_stays_out_and_valid_d2_keeps_its_bits():
    """Folding the mask into the staged coordinates: a masked atom 1e18
    away gives a finite d² far above any cutoff, and a valid pair's d² is
    the selection's own, bit for bit."""
    xyz, mask = shuffled_box(30, seed=7, n_masked=5)
    x = _t(xyz)
    staged = torch.where(_t(mask)[:, None] > 0, x, torch.full_like(x, FAR))
    d2 = pair_d2(x[:, None], staged[None])
    valid = _t(mask) > 0
    assert torch.isfinite(d2).all()
    assert (d2[:, ~valid] > 1e30).all()
    assert torch.equal(d2[:, valid], pair_d2(x[:, None], x[None])[:, valid])


@pytest.mark.parametrize("n_molecules", [100, 17])
def test_wrapper_launches_with_its_split_on_the_card(monkeypatch,
                                                     n_molecules):
    """On a CUDA tensor (``_check`` patched to report one) the wrapper
    launches once with its split and int32 scratch of splits·N·(k + 1);
    the launch, emulated, gives the plain table."""
    xyz, mask = shuffled_box(n_molecules, seed=11, n_masked=2)
    n, k = len(xyz), 16
    calls = []
    real_check = kernels._check

    def launch(name, device, tensors, scalars, vector_read, h=None, e=None):
        calls.append((name, tensors, scalars))
        x, msk, work, idx, out_mask = tensors
        nn, kk, splits, cols, cutoff2 = scalars
        assert work.dtype == torch.int32
        assert work.numel() == splits * nn * (kk + 1)
        _, (i_e, m_e) = emulate(x, msk, cutoff2, kk, splits, cols)
        idx.copy_(torch.from_numpy(i_e))
        out_mask.copy_(torch.from_numpy(m_e))

    monkeypatch.setattr(kernels, "_check", lambda *a: (
        real_check(*a), torch.device("cuda"))[1])
    monkeypatch.setattr(kernels, "_launch", launch)
    idx, m = kernels.neighbor_compact(_t(xyz), _t(mask), CUTOFF, k)
    assert len(calls) == 1 and calls[0][0] == "neighbor_compact"
    assert calls[0][2][2:4] == kernels.neighbor_compact_splits(n)
    ip, mp = kernels.neighbor_compact_plain(_t(xyz), _t(mask), CUTOFF, k)
    assert torch.equal(idx, ip) and torch.equal(m, mp)
