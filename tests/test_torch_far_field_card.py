"""The far field's block body on the card (``csrc/far_field.cuh`` ``rows``):
its walk over the column range, at the walk's edges, in
``dense_message_rowsum`` and in ``fused_message_rowsum``'s masked
all-pairs term, at both TF32 tiers.

Each test is marked ``card`` and skips without a CUDA device (the ``card``
fixture decides when the test runs).  The file imports no JAX, so the
machine with the card runs it on its own:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_far_field_card.py

Two bars.  The exact one: a row's sum over a split is the fold, in
column order, of cv_j · relu(z2_ij), and with cv in {0, 1} that fold is
float32 adds of relu(z2_ij), which the kernel itself gives for each
column alone (a launch of one column: 0 + 1 · relu(z2) is exact); the
parts then add in order.  So the kernel must give those bits, whatever
its schedule.  The loose one: within 1e-5·(max|ref| + 1) of the tier's
emulation, as ``chip_smoke.py`` holds it."""

import ctypes

import numpy as np
import pytest
import torch

from epnn_tpu_torch.ops import kernels

EMULATION = {"highest": kernels.dense_message_rowsum_3xtf32_plain,
             "default": kernels.dense_message_rowsum_tf32_plain}
FUSED_EMULATION = {"highest": kernels.fused_message_rowsum_3xtf32_plain,
                   "default": kernels.fused_message_rowsum_tf32_plain}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def inputs(seed, rows, cols, h=kernels.KERNEL_H):
    """pi (rows, h), pj (cols, h), cv in {0, 1} with about a tenth 0, W2,
    b2: seeded, on the card."""
    g = np.random.default_rng(seed)
    pi = g.normal(size=(rows, h))
    pj = g.normal(size=(cols, h))
    cv = (g.random(cols) > 0.1).astype(np.float64)
    w2 = g.normal(size=(h, h)) * 0.3
    b2 = g.normal(size=h)
    return tuple(torch.tensor(a, dtype=torch.float32, device="cuda")
                 for a in (pi, pj, cv, w2, b2))


def launch(pi, pj, cv, w2, b2, splits, cols, precision):
    """``epnn_dense_message_rowsum`` with the column split given (W2 and b2
    at a width that is a multiple of 8, so unpadded): (out, part)."""
    (r, h), n = pi.shape, pj.shape[0]
    lib = kernels._lib("dense_message_rowsum", h,
                       passes=kernels.tf32_passes(precision))
    part = pi.new_empty((splits, r, h))
    out = pi.new_empty((r, h))
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    err = lib.epnn_dense_message_rowsum(
        ptr(pi), ptr(pj), ptr(cv), ptr(w2), ptr(b2), ptr(part), ptr(out), r,
        n, h, splits, cols, torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"launch failed ({err})"
    torch.cuda.synchronize()
    return out, part


def folded(pi, pj, cv, w2, b2, splits, cols, precision):
    """The exact bits (module docstring): relu(z2) of each column from a
    launch of that column alone, folded in column order a split, the
    parts added in order."""
    ones = cv.new_ones(1)
    relu_z2 = [launch(pi, pj[j:j + 1], ones, w2, b2, 1, 1, precision)[0]
               for j in range(pj.shape[0])]
    out = None
    for s in range(splits):
        acc = torch.zeros_like(pi)
        for j in range(s * cols, min(pj.shape[0], (s + 1) * cols)):
            if cv[j] != 0:
                acc = acc + relu_z2[j]
        out = acc if out is None else out + acc
    return out


def within(out, ref):
    err = float((out - ref).abs().max())
    tol = 1e-5 * (float(ref.abs().max()) + 1.0)
    return err <= tol, err, tol


#: (rows, columns, columns a split, H) at the edges of the column walk (at
#: H = 32 two columns in flight, 32 columns a staged chunk, 16 a block of
#: the walk; at 48 one in flight, chunks of 16; 64 rows a block)
EDGES = [
    pytest.param(64, 100, 45, 32, id="split-not-a-whole-chunk"),
    pytest.param(130, 200, 20, 32, id="splits-shorter-than-a-chunk"),
    pytest.param(2224, 32, 32, 32, id="one-chunk-clustered-2224x32"),
    pytest.param(100, 97, 97, 32, id="odd-columns-rows-not-64"),
    pytest.param(192, 300, 160, 32, id="five-chunks-carried"),
    pytest.param(1, 1, 1, 32, id="one-pair"),
    pytest.param(100, 97, 45, 48, id="one-in-flight-h48"),
]


@pytest.mark.card
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("rows,cols,per_split,h", EDGES)
def test_far_field_column_walk_edges(card, rows, cols, per_split, h,
                                     precision):
    """Every split's fold is the column-order fold of its columns, bit for
    bit, and the sum is within the bar of the tier's emulation."""
    args = inputs(rows * 1000 + cols, rows, cols, h)
    splits = -(-cols // per_split)
    out, _ = launch(*args, splits, per_split, precision)
    assert torch.equal(out, folded(*args, splits, per_split, precision))
    ok, err, tol = within(out.cpu(), EMULATION[precision](
        *(a.cpu() for a in args)))
    assert ok, (err, tol)


@pytest.mark.card
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("rows,cols", [(2224, 2224), (2224, 32), (100, 97)])
def test_far_field_wrapper_split_is_exact(card, rows, cols, precision):
    """The wrapper's own split (``_dense_message_splits``) through
    ``dense_message_rowsum``: the exact bits, and the same bits on a
    second launch."""
    args = inputs(rows + 7 * cols, rows, cols)
    out = kernels.dense_message_rowsum(*args, precision=precision)
    splits, per_split = kernels._dense_message_splits(rows, cols)
    assert torch.equal(out, folded(*args, splits, per_split, precision))
    assert torch.equal(kernels.dense_message_rowsum(*args,
                                                    precision=precision), out)


@pytest.mark.card
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_fused_masked_all_pairs_term(card, precision):
    """``fused_message_rowsum`` with ``masked``: atoms 4 Å apart on a grid
    (no pair within the 3 Å cutoff, so the live pairs' correction adds
    exactly zero) give m_i times the far field with cv = the mask, bit for
    bit, on 150 rows (not a whole block) with padded atoms; and the sums
    are within the bar of the tier's fused emulation."""
    n, e, h = 150, 48, kernels.KERNEL_H
    g = np.random.default_rng(150)
    grid = np.stack(np.meshgrid(*(np.arange(6),) * 3, indexing="ij"),
                    -1).reshape(-1, 3)[:n] * 4.0
    pi, pj, _, w2, b2 = inputs(151, n, n)
    xyz = torch.tensor(grid, dtype=torch.float32, device="cuda")
    mask = torch.ones(n, device="cuda")
    mask[g.choice(n, 12, replace=False)] = 0.0
    w1e = torch.tensor(g.normal(size=(e, h)) * 0.3, dtype=torch.float32,
                       device="cuda")
    out = kernels.fused_message_rowsum(pi, pj, xyz, mask, torch.ones_like(
        mask), w1e, w2, b2, masked=True, precision=precision)
    far = kernels.dense_message_rowsum(pi, pj, mask, w2, b2,
                                       precision=precision)
    assert torch.equal(out, mask[:, None] * far)
    ok, err, tol = within(out.cpu(), FUSED_EMULATION[precision](
        pi.cpu(), pj.cpu(), xyz.cpu(), mask.cpu(), torch.ones(n), w1e.cpu(),
        w2.cpu(), b2.cpu(), masked=True))
    assert ok, (err, tol)
