"""The far-field kernels' tensor-core arithmetic (3xTF32) on the CPU: the
port's emulations ``dense_message_rowsum_3xtf32_plain`` and
``dense_message_rowsum_bwd_3xtf32_plain`` — what the CUDA kernels compute,
up to summation order — against the JAX Pallas kernel with
``precision="highest"`` (interpret mode off the TPU) and its VJP.

Tolerance: max|Δ| ≤ 1e-5·(max|ref| + 1), the bar of the fp32 plain
versions (``tests/test_torch_kernels.py``, ``test_torch_kernels_bwd.py``):
3xTF32 drops only lo·lo (~2^-22 relative).  One TF32 pass (~2^-11) misses
it, which is why the kernels keep both correction products."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epnn_tpu.io import checkpoint as jax_ckpt
from epnn_tpu.models import init_params as jax_init_params
from epnn_tpu.ops import forward_blocked as jax_forward_blocked
from epnn_tpu.ops import fuse_params as jax_fuse_params
from epnn_tpu.ops.fused import max_neighbor_count as jax_max_neighbor_count
from epnn_tpu.ops.pallas_kernels import (
    dense_message_rowsum as jax_dense_message_rowsum,
    dense_message_rowsum_reference,
)
from epnn_tpu_torch.data import pad_molecules
from epnn_tpu_torch.elements import table_for_n_elems
from epnn_tpu_torch.io import checkpoint as ckpt
from epnn_tpu_torch.ops import fused, kernels
from epnn_tpu_torch.testing import water_box
from test_torch_kernels_bwd import dmr_inputs, jax_dmr_vjp

torch.set_num_threads(2)

CKPT = "trained/mixed_b16"


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _err(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    return float(np.abs(out - ref).max()), 1e-5 * (float(np.abs(ref).max())
                                                   + 1.0)


def forward_inputs(rng, rows, cols, n_real):
    """The shapes of test_torch_kernels.py: junk pj beyond n_real, cv = 0
    there."""
    h = 32
    pi = rng.normal(size=(rows, h)).astype(np.float32)
    pj = rng.normal(size=(cols, h)).astype(np.float32)
    pj[n_real:] = rng.normal(size=(cols - n_real, h)) * 5.0
    cv = np.zeros((cols,), np.float32)
    cv[:n_real] = 1.0
    w2 = (rng.normal(size=(h, h)) * 0.3).astype(np.float32)
    b2 = rng.normal(size=(h,)).astype(np.float32)
    return pi, pj, cv, w2, b2


def jax_forward(pi, pj, cv, w2, b2):
    return np.asarray(jax_dense_message_rowsum(
        *(jnp.asarray(a) for a in (pi, pj, cv, w2, b2)), block_i=8,
        block_jp=8, precision="highest"))


SHAPES = [(64, 64, 64), (40, 128, 100), (24, 96, 61)]


@pytest.mark.parametrize("rows,cols,n_real", SHAPES)
def test_3xtf32_forward_matches_jax(rng, rows, cols, n_real):
    """(a) Square, rectangular R≠N, and padded columns with junk pj."""
    args = forward_inputs(rng, rows, cols, n_real)
    out = kernels.dense_message_rowsum_3xtf32_plain(
        *(_t(a) for a in args)).numpy()
    for ref in (jax_forward(*args), dense_message_rowsum_reference(*args)):
        err, tol = _err(out, ref)
        assert err <= tol, (err, tol)


@pytest.mark.parametrize("rows,cols,n_real", SHAPES)
def test_one_tf32_pass_misses_the_bar(rng, rows, cols, n_real):
    """(d) hi·hi alone — the TF32 tier's arithmetic — is ~2^-11 relative
    per product: it misses (a)'s bar by far, so both correction products
    of 3xTF32 must stay."""
    pi, pj, cv, w2, b2 = (_t(a) for a in forward_inputs(rng, rows, cols,
                                                        n_real))
    hid = torch.relu(pi[:, None, :] + pj[None, :, :])
    hid = torch.relu(kernels.tf32_round(hid) @ kernels.tf32_round(w2) + b2)
    one_pass = torch.einsum("n,bnh->bh", cv, hid).numpy()
    err, tol = _err(one_pass, jax_forward(*(a.numpy() for a in
                                            (pi, pj, cv, w2, b2))))
    assert err > 10 * tol, (err, tol)


@pytest.mark.parametrize("r,n,h", [(16, 16, 32), (8, 32, 32), (64, 64, 32),
                                   (40, 96, 32), (16, 32, 8)])
@pytest.mark.parametrize("cv_zeros", [False, True])
def test_3xtf32_backward_matches_jax(rng, r, n, h, cv_zeros):
    """(b) The backward kernel's arithmetic (all three contractions in
    3xTF32) against the Pallas VJP."""
    pi, pj, cv, w2, b2, g = dmr_inputs(rng, r, n, h, cv_zeros)
    refs = jax_dmr_vjp(pi, pj, cv, w2, b2, g)
    got = kernels.dense_message_rowsum_bwd_3xtf32_plain(
        *(_t(a) for a in (pi, pj, cv, w2, b2, g)))
    for out, ref in zip(got, (refs[0], refs[1], refs[3], refs[4])):
        err, tol = _err(out.numpy(), ref)
        assert err <= tol, (err, tol)


def test_3xtf32_far_field_in_the_forward_matches_jax(monkeypatch):
    """(c) ``_forward_single_nbr`` with the 3xTF32 far field in place of
    the fp32 one, on a 300-atom water box with trained/mixed_b16 (Q = −1),
    against JAX ``forward_blocked`` on the neighbor split: the charge bar
    and conservation."""
    jcfg = jax_ckpt.load_config(CKPT)
    jparams = jax.tree_util.tree_map(np.asarray, jax_ckpt.load_params(
        CKPT, jax_init_params(jcfg, jax.random.key(0))))
    batch = pad_molecules([water_box(100, seed=11, charge=-1.0)],
                          table_for_n_elems(jcfg.n_elems))
    arrays = (batch.x, batch.q0, batch.xyz, batch.node_mask)
    k = min(jax_max_neighbor_count(batch.xyz[0], batch.node_mask[0],
                                   jcfg.cutoff) + 4, batch.padded_atoms - 1)
    ref = np.asarray(jax_forward_blocked(
        jax_fuse_params(jparams, jcfg), *arrays, jcfg, neighbor_k=k,
        use_pallas=False, uniform_q0=True))

    calls = []

    def far(*args, precision):
        # the shipped config resolves to 'highest': the kernel's 3xTF32 tier
        assert precision == "highest"
        calls.append(args[0].shape)
        return kernels.dense_message_rowsum_3xtf32_plain(*args)

    monkeypatch.setattr(fused, "dense_message_rowsum", far)
    cfg = ckpt.load_config(CKPT)
    fp = fused.fuse_params(ckpt.from_jax_params(jparams, cfg), cfg)
    with torch.no_grad():
        q = fused.forward_blocked(fp, *(_t(a) for a in arrays), cfg,
                                  neighbor_k=k, uniform_q0=True).numpy()
    assert len(calls) == jcfg.T - 1  # rounds 2+ (round 1 collapses)
    err, tol = _err(q, ref)
    assert err < tol, (err, tol)
    cons = np.abs(q.astype(np.float64).sum(1) - batch.total_q)
    assert np.all(cons <= 1e-4), cons


def _tf32_values(rng, n):
    """Random finite float32 values already in TF32 (low 13 bits zero),
    both signs, magnitudes across ~40 binades."""
    x = (rng.normal(size=n) * np.exp2(rng.integers(-20, 20, size=n))).astype(
        np.float32)
    return (x.view(np.int32) & np.int32(-0x2000)).view(np.float32)


def test_tf32_round_is_exact_on_tf32_values(rng):
    """(e) Values already in TF32 come back unchanged; inf and NaN pass."""
    x = _tf32_values(rng, 4096)
    assert torch.equal(kernels.tf32_round(_t(x)), _t(x))
    special = _t([np.inf, -np.inf, np.nan, 0.0, -0.0])
    out = kernels.tf32_round(special)
    assert torch.equal(out[:2], special[:2]) and torch.isnan(out[2])
    assert torch.equal(out[3:].view(torch.int32), special[3:].view(
        torch.int32))


def test_tf32_round_is_nearest_with_ties_away_from_zero(rng):
    """(e) Between two neighbouring TF32 values a and b (|a| < |b|), the
    midpoint goes to b — away from zero, for either sign — and any point
    below (above) the midpoint to a (b): cvt.rna.tf32.f32."""
    a = _tf32_values(rng, 4096)
    a = a[np.isfinite(a) & (a != 0)]
    bits = a.view(np.int32)
    b = (bits + np.int32(0x2000)).view(np.float32)  # next TF32 from zero
    tie = (bits + np.int32(0x1000)).view(np.float32)  # exact midpoint
    below = (bits + np.int32(0x0fff)).view(np.float32)
    above = (bits + np.int32(0x1001)).view(np.float32)
    assert np.all(np.abs(b) > np.abs(a))
    np.testing.assert_array_equal((tie.astype(np.float64) - a) * 2,
                                  b.astype(np.float64) - a)
    for x, want in ((tie, b), (below, a), (above, b)):
        assert torch.equal(kernels.tf32_round(_t(x)), _t(want))
