"""Gradients of the port's kernel wrappers (on the CPU: their plain
versions inside the same autograd Functions the card runs) against
``jax.vjp`` of the JAX Pallas kernels in interpret mode.

Tolerance per gradient: max|Δ| ≤ 1e-5·(max|ref| + 1) — float32 summation
order only (the pair sums run in another order on each side)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epnn_tpu.ops.pallas_kernels import (
    dense_message_rowsum as jax_dense_message_rowsum,
    near_message_corr as jax_near_message_corr,
    near_pass_rowsum as jax_near_pass_rowsum,
)
from epnn_tpu_torch.ops import kernels

torch.set_num_threads(1)


def _close(out, ref):
    out = np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= 1e-5 * (np.abs(ref).max() + 1.0), err


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a, np.float32).copy()).requires_grad_(
        grad)


def dmr_inputs(rng, r, n, h, cv_zeros):
    pi = rng.normal(size=(r, h)).astype(np.float32)
    pj = rng.normal(size=(n, h)).astype(np.float32)
    cv = np.ones((n,), np.float32)
    if cv_zeros:
        cv[rng.uniform(size=n) < 0.3] = 0.0
        cv[-3:] = 0.0
    w2 = (rng.normal(size=(h, h)) * 0.3).astype(np.float32)
    b2 = rng.normal(size=(h,)).astype(np.float32)
    g = rng.normal(size=(r, h)).astype(np.float32)
    return pi, pj, cv, w2, b2, g


def jax_dmr_vjp(pi, pj, cv, w2, b2, g):
    """(dpi, dpj, dcv, dw2, db2) of the Pallas kernel (interpret mode)."""
    def f(pi, pj, cv, w2, b2):
        return jax_dense_message_rowsum(pi, pj, cv, w2, b2, block_i=8,
                                        block_jp=8, precision="highest",
                                        interpret=True)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (pi, pj, cv, w2, b2)))
    return [np.asarray(a) for a in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("r,n,h", [(16, 16, 32), (8, 32, 32), (64, 64, 32),
                                   (16, 32, 8), (24, 64, 8)])
@pytest.mark.parametrize("cv_zeros", [False, True])
def test_dense_message_rowsum_bwd_plain_matches_jax(rng, r, n, h, cv_zeros):
    """Square and rectangular R≠N, H = 8 and 32, cv with and without
    zeros: the explicit plain backward against the Pallas VJP."""
    pi, pj, cv, w2, b2, g = dmr_inputs(rng, r, n, h, cv_zeros)
    dpi, dpj, dcv, dw2, db2 = jax_dmr_vjp(pi, pj, cv, w2, b2, g)
    assert not np.any(dcv)
    got = kernels.dense_message_rowsum_bwd(*(_t(a) for a in (pi, pj, cv, w2,
                                                             b2, g)),
                                           precision="highest")
    for out, ref in zip(got, (dpi, dpj, dw2, db2)):
        _close(out.numpy(), ref)
    assert kernels.LAUNCHES["dense_message_rowsum_bwd"] == 0  # CPU: plain


@pytest.mark.parametrize("r,n,h", [(8, 32, 32), (16, 32, 8)])
def test_dense_message_rowsum_function_grads_match_jax(rng, r, n, h):
    """``loss.backward()`` through the public wrapper (the autograd
    Function): gradients for pi, pj, W2, b2 and none for col_vec."""
    pi, pj, cv, w2, b2, g = dmr_inputs(rng, r, n, h, True)
    dpi, dpj, _, dw2, db2 = jax_dmr_vjp(pi, pj, cv, w2, b2, g)
    args = [_t(pi, True), _t(pj, True), _t(cv, True), _t(w2, True),
            _t(b2, True)]
    out = kernels.dense_message_rowsum(*args, precision="highest")
    # a non-contiguous cotangent reaches the backward as a contiguous copy
    out.backward(_t(g.T.copy()).T)
    for a, ref in zip((args[0], args[1], args[3], args[4]),
                      (dpi, dpj, dw2, db2)):
        _close(a.grad.numpy(), ref)
    assert args[2].grad is None


def test_dense_message_rowsum_bwd_checks_inputs(rng):
    pi, pj, cv, w2, b2, g = (_t(a) for a in dmr_inputs(rng, 8, 16, 8, False))
    with pytest.raises(ValueError, match="shape"):
        kernels.dense_message_rowsum_bwd(pi, pj, cv, w2, b2, g[:4])
    with pytest.raises(TypeError, match="float32"):
        kernels.dense_message_rowsum_bwd(pi, pj, cv, w2, b2, g.double())


@pytest.fixture
def near_setup(rng):
    n, k, h, e = 48, 8, 32, 16
    pi = rng.normal(size=(n, h)).astype(np.float32)
    pj = rng.normal(size=(n, h)).astype(np.float32)
    idx = rng.integers(0, n, size=(n, k))
    mask = (rng.uniform(size=(n, k)) > 0.3).astype(np.float32)
    rbf = (rng.normal(size=(n * k, e)).astype(np.float32)
           * mask.reshape(-1, 1))
    w1e = (rng.normal(size=(e, h)) * 0.3).astype(np.float32)
    w2 = (rng.normal(size=(h, h)) * 0.3).astype(np.float32)
    b2 = rng.normal(size=(h,)).astype(np.float32)
    g = rng.normal(size=(n, h)).astype(np.float32)
    return pi, pj, idx, mask, rbf, w1e, w2, b2, g


def _grads_match(port_fn, jax_fn, inputs, g):
    _, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in inputs))
    refs = vjp(jnp.asarray(g))
    args = [_t(a, True) for a in inputs]
    port_fn(*args).backward(_t(g))
    for a, ref in zip(args, refs):
        _close(a.grad.numpy(), np.asarray(ref))


def test_near_message_corr_grads_match_jax(near_setup):
    pi, pj, idx, mask, rbf, w1e, w2, b2, g = near_setup
    _grads_match(
        kernels.near_message_corr,
        lambda *a: jax_near_message_corr(*a, block_i=16, precision="highest",
                                         interpret=True),
        (pi, pj[idx.reshape(-1)], rbf, mask, w1e, w2, b2), g)


def test_near_pass_rowsum_grads_match_jax(near_setup):
    pi, pj, idx, mask, rbf, w1e, w2, b2, g = near_setup
    rs = np.concatenate([pi, pj], axis=-1)
    _grads_match(
        kernels.near_pass_rowsum,
        lambda *a: jax_near_pass_rowsum(*a, block_i=16, precision="highest",
                                        interpret=True),
        (rs, rs[idx.reshape(-1)], rbf, 0.5 * mask, w1e, w2, b2), g)


def test_near_backward_skips_inputs_without_grad(near_setup):
    """Only inputs that ask for a gradient get one (the gathered RBF rows
    and the slot mask never do in training)."""
    pi, pj, idx, mask, rbf, w1e, w2, b2, g = near_setup
    args = [_t(pi, True), _t(pj[idx.reshape(-1)], True), _t(rbf), _t(mask),
            _t(w1e, True), _t(w2, True), _t(b2, True)]
    kernels.near_message_corr(*args, precision="highest").backward(_t(g))
    assert args[2].grad is None and args[3].grad is None
    assert all(a.grad is not None for i, a in enumerate(args) if i not in
               (2, 3))
