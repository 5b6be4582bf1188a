"""The redesigned fused dense kernels' arithmetic, on the CPU.

On the card ``fused_message_rowsum`` runs the far field over every pair
on the tensor cores plus a correction for the pairs within the cutoff, and
``fused_epn_rowsum`` only the pairs within the cutoff; both in 3xTF32.
Here their emulations (``kernels.fused_*_3xtf32_plain``) against the JAX
Pallas kernels in interpret mode at ``precision="highest"``, in both
message modes and both gates, at three widths; the split (far field +
live correction) in fp32 against the plain version; the emulated pass
kernel's exact negation on the dense dimer probe; and a hard-gate pair
inside the cutoff whose channels are all under tol adding exactly 0.

Tolerance: max|Δ| ≤ 1e-5·(max|ref| + 1), the JAX suite's bar between two
paths of the same math (tests/test_fused.py): 3xTF32 keeps fp32 grade, and
the split reorders the sum."""

import numpy as np
import pytest
import torch

from epnn_tpu.ops.pallas_kernels import (
    fused_epn_rowsum as jax_fused_epn_rowsum,
    fused_message_rowsum as jax_fused_message_rowsum,
)
from epnn_tpu_torch.ops import kernels
from epnn_tpu_torch.testing import dimer_probe
from test_torch_fused import _t
from test_torch_kernels_fused import pair_inputs

torch.set_num_threads(2)

#: (n, H, E): JAX's own test widths, the shipped widths, and a width that
#: is a multiple of neither 16 nor 8 (E) at an atom count no block divides
WIDTHS = [(24, 8, 16), (24, 32, 48), (57, 40, 20)]
MSG = ("pi", "pj", "xyz", "mask", "cv", "w1e", "w2", "b2")
EPN = ("pi", "pj", "xyz", "mask", "w1e", "w2", "b2")


def _err(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    return np.abs(out - ref).max(), 1e-5 * (np.abs(ref).max() + 1.0)


def _jax_padded(fn, a, keys, n, **kw):
    """JAX's kernel on the arrays padded to a multiple of its 8 x 8 block
    (padding atoms: mask 0, cv 0, far away), first n rows."""
    m = -(-n // 8) * 8
    pad = {}
    for key in keys:
        v = a[key]
        p = np.zeros((m, *v.shape[1:]), v.dtype) if key in (
            "pi", "pj", "xyz", "mask", "cv") else v
        if p is not v:
            p[:n] = v
            if key == "xyz":
                p[n:] = 1e3 + np.arange(m - n)[:, None]
        pad[key] = p
    return np.asarray(fn(*(pad[k] for k in keys), block_i=8, block_j=8,
                         precision="highest", packed=False, **kw))[:n]


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("n,h,e", WIDTHS)
def test_message_emulation_matches_jax(rng, n, h, e, masked):
    a = pair_inputs(rng, n, h, e)
    out = kernels.fused_message_rowsum_3xtf32_plain(
        *(_t(a[k]) for k in MSG), cutoff=3.0, eta=2.0, masked=masked)
    ref = _jax_padded(jax_fused_message_rowsum, a, MSG, n, masked=masked)
    err, tol = _err(out, ref)
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("soft_gate", [False, True])
@pytest.mark.parametrize("n,h,e", WIDTHS)
def test_pass_emulation_matches_jax(rng, n, h, e, soft_gate):
    a = pair_inputs(rng, n, h, e)
    out = kernels.fused_epn_rowsum_3xtf32_plain(
        *(_t(a[k]) for k in EPN), cutoff=3.0, eta=2.0, tol=1e-5,
        soft_gate=soft_gate)
    ref = _jax_padded(jax_fused_epn_rowsum, a, EPN, n, soft_gate=soft_gate)
    err, tol = _err(out, ref)
    assert err <= tol, (err, tol)
    assert np.all(out.numpy()[a["mask"] == 0] == 0.0)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("n,h,e", WIDTHS)
def test_far_plus_live_correction_is_the_plain_version(rng, n, h, e, masked):
    """The kernel's split in fp32 — the far field over every pair (rows
    times m_i when masked), plus w_ij (mlp(base + rbf @ W1e) − mlp(base))
    where rbf ≠ 0 — is the plain version up to summation order; the
    correction is not 0 (pairs sit within the cutoff)."""
    a = pair_inputs(rng, n, h, e)
    args = [_t(a[k]) for k in MSG]
    ref = kernels.fused_message_rowsum_plain(*args, masked=masked)
    got = kernels._fused_message_split(*args, 3.0, 2.0, masked,
                                       kernels._mm_fp32)
    err, tol = _err(got, ref)
    assert err <= tol, (err, tol)
    far = kernels.dense_message_rowsum_plain(
        args[0], args[1], args[3] if masked else args[4], args[6], args[7])
    if masked:
        far = far * args[3][:, None]
    assert np.abs((got - far).numpy()).max() > 100 * tol


@pytest.mark.parametrize("soft_gate", [False, True])
@pytest.mark.parametrize("h,e", [(32, 48), (40, 20)])
def test_emulated_pass_kernel_negates_exactly(rng, h, e, soft_gate):
    """The dense dimer probe (disjoint pairs, 1.0–2.5 Å apart, ≥ 4 Å from
    all else, most across two 16-row tiles): in the 3xTF32 emulation every
    pair's two rows are exact negations, at the shipped widths and at
    another."""
    xyz, pairs = dimer_probe(24, seed=3)
    a = pair_inputs(rng, len(xyz), h, e, n_real=len(xyz))
    a["xyz"] = xyz
    out = kernels.fused_epn_rowsum_3xtf32_plain(*(_t(a[k]) for k in EPN),
                                                soft_gate=soft_gate)
    i, j = torch.from_numpy(pairs[:, 0]), torch.from_numpy(pairs[:, 1])
    assert torch.count_nonzero(out[i]) > 0
    assert torch.equal(out[i], -out[j])


@pytest.mark.parametrize("fn", ["fused_epn_rowsum_plain",
                                "fused_epn_rowsum_3xtf32_plain"])
def test_hard_gate_pair_under_tol_adds_zero(rng, fn):
    """Two atoms 2.999 Å apart (cutoff 3): the envelope is ~3e-7, so every
    channel is under tol = 1e-5; the hard gate is 0 and both rows are
    exactly 0, while the soft gate (the envelope itself) moves them."""
    a = pair_inputs(rng, 2, 32, 48, n_real=2)
    a["xyz"] = np.array([[0.0, 0.0, 0.0], [2.999, 0.0, 0.0]], np.float32)
    args = [_t(a[k]) for k in EPN]
    hard = getattr(kernels, fn)(*args, tol=1e-5, soft_gate=False)
    soft = getattr(kernels, fn)(*args, tol=1e-5, soft_gate=True)
    assert torch.equal(hard, torch.zeros_like(hard))
    assert torch.count_nonzero(soft) > 0
    assert torch.equal(soft[0], -soft[1])


@pytest.mark.parametrize("name", ["fused_message_rowsum_plain",
                                  "fused_message_rowsum_3xtf32_plain",
                                  "fused_epn_rowsum_plain",
                                  "fused_epn_rowsum_3xtf32_plain"])
def test_row_slice_is_those_rows(rng, monkeypatch, name):
    """``rows=slice(a, b)`` (how the card's check at 17,760 atoms holds the
    kernels to a slice of the plain version) gives rows a .. b − 1 of the
    whole, row blocks straddling the slice's ends."""
    a = pair_inputs(rng, 40, 8, 16)
    keys = MSG if "message" in name else EPN
    args = [_t(a[k]) for k in keys]
    fn = getattr(kernels, name)
    full = fn(*args)
    monkeypatch.setattr(kernels, "_plain_rows", lambda r, n, w: 7)
    part = fn(*args, rows=slice(5, 31))
    err, tol = _err(part, full[5:31])
    assert err <= tol, (err, tol)
