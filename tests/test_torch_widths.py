"""The kernels at every width, on the CPU.

The CUDA kernels are compiled for one mid width H and RBF width E each
(any width; past 64 padded, the wide path of ``csrc/wide.cuh``), run their
products at the widths padded to 8 (32 for the int8 product's K) on
zero-padded weights, and read the activations at their real width with
zeros past it.  Here, without a card:

* each of the seven width-carrying wrappers, on tensors that ``_check``
  reports as CUDA, reaches ``_launch`` with the real widths (the library's)
  and the padded weights; ``_launch`` is replaced by :func:`emulate`, the
  kernel's contract in plain PyTorch (activations zero-tailed to the padded
  widths, the padded weights as they come, outputs sliced back), and the
  result is the plain version's at the real widths;
* the padded weights with zero-tailed activations give each plain
  version's result (:func:`pad_weights` is exact);
* the int8 tier's scale comes from the maxima over the real columns, as
  JAX's interpret-mode kernel takes them (a zero padding column would
  raise a negative maximum to 0).

Tolerance 1e-6·(max|ref| + 1): the padded and the real computation differ
only by exact zeros, so only float32 summation order may move a result.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epnn_tpu.ops.pallas_kernels import dense_message_rowsum as jax_dmr
from epnn_tpu_torch.ops import fused, kernels
from test_torch_fused import _t

torch.set_num_threads(1)

#: (H, E): below the shipped widths, neither a multiple of 8 (E) nor of 16
#: (H), the widest narrow one, and the wide path's: multiples of 16, an H
#: no multiple of 16, 128 and 256 (four and eight output chunks, W2 past
#: any shared memory)
WIDTHS = [(16, 24), (40, 20), (64, 64), (96, 80), (136, 72), (128, 128),
          (256, 256)]
NAMES = ["dense_message_rowsum", "dense_message_rowsum_int8",
         "dense_message_rowsum_bwd", "near_message_corr", "near_pass_rowsum",
         "fused_message_rowsum", "fused_epn_rowsum"]
PAIR = dict(cutoff=3.0, eta=2.0, tol=1e-5)


def _close(out, ref, bar=1e-6):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max() if out.size else 0.0
    assert err <= bar * (np.abs(ref).max() + 1.0), err


def _tail(x, width):
    """x with its last axis zero-padded to ``width``."""
    out = x.new_zeros((*x.shape[:-1], width))
    out[..., :x.shape[-1]] = x
    return out


def _halves(x, h, hp):
    """[pi | pj] rows (…, 2h) as (…, 2hp), each half zero-tailed."""
    return torch.cat([_tail(x[..., :h], hp), _tail(x[..., h:], hp)], dim=-1)


def _int8_padded(pi, pj, cv, w2q, sw, b2, pi_max, pj_max, pad_pi):
    """The int8 kernel's arithmetic at its padded widths: s_in from the
    maxima it is handed, activations zero-tailed to the contraction's
    width (w2q's rows)."""
    pim, pjm = pi_max, pj_max
    if pad_pi is not None:
        pim, pjm = torch.maximum(pim, pad_pi), torch.clamp(pjm, min=0.0)
    s_in = kernels._div127(torch.clamp(torch.relu(pim + pjm), min=1e-30))
    dq, inv = kernels.int8_scales(s_in, sw)
    hq = w2q.shape[0]
    hid = torch.relu(_tail(pi, hq)[:, None, :] + _tail(pj, hq)[None, :, :])
    q = torch.trunc(torch.clamp(hid * inv, 0.0, 127.0) + 0.5)
    z2 = torch.relu((q @ w2q.to(torch.float32)) * dq + b2)
    return torch.einsum("n,bnh->bh", cv, z2)


def _warps(name, n, h, e, passes=3):
    """A stand-in for ``kernels.near_warps`` (a card's occupancy): a warp
    every two rows, at either TF32 tier."""
    return max(1, n // 2)


def _check_scratch(name, work, n, h, e):
    """The wide path's epart scratch: 16 × Hp floats a warp of the launch,
    none below it."""
    if kernels.wide(h, e):
        want = _warps(name, n, h, e) * 16 * kernels.padded_width(h)
        assert work is not None and work.numel() == want, name
    else:
        assert work is None, name


def _rbf_launch(tab, doubling, u_scale, e, cutoff, eta):
    """The RBF method a fused launch asks for, its table (the centers, or
    the doubling's gains) and scale 2ηΔ checked against it."""
    method = "doubling" if doubling else "direct"
    want = kernels.rbf_table(e, cutoff, eta, method)
    assert tab.shape == (e,) and torch.equal(tab, want), method
    assert u_scale == (kernels.doubling_u_scale(e, cutoff, eta) if doubling
                       else 0.0)
    return method


def emulate(name, tensors, scalars, h, e):
    """What kernel ``name`` computes from its launch arguments, written
    into the launch's output tensors."""
    hp = kernels.padded_width(h)
    if name == "dense_message_rowsum":
        pi, pj, cv, w2, b2, _, out = tensors
        out.copy_(kernels.dense_message_rowsum_plain(
            _tail(pi, hp), _tail(pj, hp), cv, w2, b2)[:, :h])
    elif name == "dense_message_rowsum_int8":
        *args, _, out = tensors
        out.copy_(_int8_padded(*args)[:, :h])
    elif name == "dense_message_rowsum_bwd":
        pi, pj, cv, w2, b2, g, _, *outs = tensors
        grads = kernels.dense_message_rowsum_bwd_plain(
            _tail(pi, hp), _tail(pj, hp), cv, w2, b2, _tail(g, hp))
        for o, gr in zip(outs, grads):
            o.copy_(gr[tuple(slice(0, n) for n in o.shape)])
    elif name == "near_message_corr":
        pi, pjn, rbf, mask, w1e, w2, b2, out, work = tensors
        _check_scratch(name, work, pi.shape[0], h, e)
        out.copy_(kernels.near_message_corr_plain(
            _tail(pi, hp), _tail(pjn, hp), _tail(rbf, w1e.shape[0]), mask,
            w1e, w2, b2)[:, :h])
    elif name == "near_pass_rowsum":
        rs, ppn, rbf, gh, w1e, w2, b2, out, work = tensors
        _check_scratch(name, work, rs.shape[0], h, e)
        out.copy_(kernels.near_pass_rowsum_plain(
            _halves(rs, h, hp), _halves(ppn, h, hp), _tail(rbf, w1e.shape[0]),
            gh, w1e, w2, b2)[:, :h])
    elif name == "fused_message_rowsum":
        pi, pj, xyz, mask, cv, w1e, w2, b2, tab, _, out, work = tensors
        _check_scratch(name, work, pi.shape[0], h, e)
        masked, doubling, cutoff, eta, _, u_scale = scalars[5:11]
        method = _rbf_launch(tab, doubling, u_scale, e, cutoff, eta)
        # channels past E are 0 in the kernel: they meet W1e's zero rows
        assert not w1e[e:].any()
        out.copy_(kernels.fused_message_rowsum_plain(
            _tail(pi, hp), _tail(pj, hp), xyz, mask, cv, w1e[:e], w2, b2,
            cutoff, eta, masked=bool(masked), rbf_method=method)[:, :h])
    elif name == "fused_epn_rowsum":
        pi, pj, xyz, mask, w1e, w2, b2, tab, out, work = tensors
        _check_scratch(name, work, pi.shape[0], h, e)
        soft, doubling, cutoff, eta, tol, _, u_scale = scalars[3:10]
        method = _rbf_launch(tab, doubling, u_scale, e, cutoff, eta)
        assert not w1e[e:].any()
        out.copy_(kernels.fused_epn_rowsum_plain(
            _tail(pi, hp), _tail(pj, hp), xyz, mask, w1e[:e], w2, b2, cutoff,
            eta, tol, soft_gate=bool(soft), rbf_method=method)[:, :h])
    else:
        raise AssertionError(name)


def arm_card(monkeypatch):
    """``_check`` reports a CUDA device and ``_launch`` records its call
    (with the TF32 tier it asks for, ``passes``) and runs :func:`emulate`:
    the wrappers' card path without a card.  Returns the list the calls go
    to."""
    calls = []
    real_check = kernels._check

    def launch(name, device, tensors, scalars, vector_read, h=None, e=None,
               passes=3):
        calls.append(dict(name=name, tensors=tensors, scalars=scalars,
                          vector_read=sorted(vector_read), h=h, e=e,
                          passes=passes))
        emulate(name, tensors, scalars, h, e)
        kernels.LAUNCHES[name] += 1

    monkeypatch.setattr(kernels, "_check", lambda *a: (
        real_check(*a), torch.device("cuda"))[1])
    monkeypatch.setattr(kernels, "_launch", launch)
    monkeypatch.setattr(kernels, "near_warps", _warps)
    # the emulated launches count in a dict of their own: the module's
    # counts, which other tests of the process read, stay as they were
    monkeypatch.setattr(kernels, "LAUNCHES", dict.fromkeys(kernels.LAUNCHES,
                                                           0))
    return calls


@pytest.fixture
def on_card(monkeypatch):
    return arm_card(monkeypatch)


def width_args(name, h, e, seed=0, n=40, k=6):
    """Seeded inputs of wrapper ``name`` at widths (h, e): a small pair
    grid (n atoms in an 8 Å box, so a few pairs sit within the cutoff) or
    neighbor table (k slots, a third of them dead)."""
    g = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: _t((g.normal(size=s) * sc).astype(np.float32))  # noqa: E731
    mask = _t((np.arange(n) < n - 3).astype(np.float32))
    cv = _t((g.uniform(size=n) > 0.2).astype(np.float32))
    w2, b2, w1e = f(h, h, sc=0.3), f(h, sc=0.3), f(e, h, sc=0.3)
    slots = _t((g.uniform(size=(n, k)) > 0.33).astype(np.float32))
    xyz = _t(g.uniform(0.0, 8.0, size=(n, 3)).astype(np.float32))
    return {
        "dense_message_rowsum": (f(n, h), f(n + 5, h), cv[:1].expand(n + 5)
                                 .contiguous(), w2, b2),
        "dense_message_rowsum_int8": (f(n, h) - 0.5, f(n + 5, h),
                                      _t(np.ones(n + 5, np.float32)), w2, b2),
        "dense_message_rowsum_bwd": (f(n, h), f(n + 5, h),
                                     _t(np.ones(n + 5, np.float32)), w2, b2,
                                     f(n, h)),
        "near_message_corr": (f(n, h), f(n * k, h), f(n * k, e).abs(), slots,
                              w1e, w2, b2),
        "near_pass_rowsum": (f(n, 2 * h), f(n * k, 2 * h), f(n * k, e).abs(),
                             0.5 * slots, w1e, w2, b2),
        "fused_message_rowsum": (f(n, h), f(n, h), xyz, mask, cv, w1e, w2,
                                 b2),
        "fused_epn_rowsum": (f(n, h), f(n, h), xyz, mask, w1e, w2, b2),
    }[name]


def _plain(name, args):
    if name == "dense_message_rowsum_int8":
        return kernels.dense_message_rowsum_int8_plain(*args)
    kw = PAIR if name.startswith("fused") else {}
    return getattr(kernels, name + "_plain")(*args, **kw)


def _call(name, args):
    kw = PAIR if name.startswith("fused") else {}
    return getattr(kernels, name)(*args, **kw)


@pytest.mark.parametrize("h,e", WIDTHS)
@pytest.mark.parametrize("name", NAMES)
def test_wrappers_reach_the_kernel_at_padded_widths(on_card, name, h, e):
    """One launch, of the library at the real widths, with the weights
    padded to H and E rounded up to 8 (the int8 product's rows to 32), the
    float4 reads only at widths that are multiples of 16 on the narrow
    path; the result is the plain version's."""
    args = width_args(name, h, e)
    out = _call(name, args)
    ref = _plain(name, args)
    assert len(on_card) == 1
    call = on_card[0]
    takes_e = "e" in kernels._WIDTHS_OF[name]
    assert (call["h"], call["e"]) == (h, e if takes_e else None)
    hp, ep = kernels.padded_width(h), kernels.padded_width(e)
    shapes = [tuple(t.shape) for t in call["tensors"] if t is not None]
    if name == "dense_message_rowsum_int8":
        assert (kernels.padded_width(h, 32), hp) in shapes  # w2q
        assert call["tensors"][3].dtype == torch.int8
        assert shapes.count((hp,)) == 2                      # sw, b2
    else:
        assert (hp, hp) in shapes and (hp,) in shapes
        if takes_e:
            assert (ep, hp) in shapes
    want_vec = {"near_message_corr": ["pjn", "rbf"],
                "near_pass_rowsum": ["ppn", "rbf"]}.get(name, [])
    want_vec = [v for v in want_vec
                if (e if v == "rbf" else h) % 16 == 0
                and not kernels.wide(h, e)]
    assert call["vector_read"] == sorted(want_vec)
    if name == "dense_message_rowsum_bwd":
        for o, r in zip(out, ref):
            _close(o, r)
    else:
        _close(out, ref)


@pytest.mark.parametrize("h,e", WIDTHS)
@pytest.mark.parametrize("name", NAMES)
def test_padded_weights_give_the_plain_result(name, h, e):
    """``pad_weights`` with zero-tailed activations, through the plain
    version at the padded widths and sliced back, against the plain
    version at the real widths: padding is exact."""
    args = width_args(name, h, e, seed=1)
    ref = _plain(name, args)
    hp = kernels.padded_width(h)
    if name in ("dense_message_rowsum", "dense_message_rowsum_bwd"):
        pi, pj, cv, w2, b2, *g = args
        kw = kernels.pad_weights(w2, b2)
        got = getattr(kernels, name + "_plain")(
            _tail(pi, hp), _tail(pj, hp), cv, kw.w2, kw.b2,
            *[_tail(x, hp) for x in g])
        if g:
            for o, r in zip(got, ref):
                _close(o[tuple(slice(0, n) for n in r.shape)], r)
            return
        got = got[:, :h]
    elif name == "dense_message_rowsum_int8":
        pi, pj, cv, w2, b2 = args
        kw = kernels.pad_weights(w2, b2)
        got = _int8_padded(pi, pj, cv, *kernels.int8_kernel_weights(kw.w2),
                           kw.b2, pi.amax(), pj.amax(), None)[:, :h]
    else:
        *acts, w1e, w2, b2 = args
        kw = kernels.pad_weights(w2, b2, w1e)
        ep = kw.w1e.shape[0]
        if name == "near_message_corr":
            pi, pjn, rbf, mask = acts
            acts = (_tail(pi, hp), _tail(pjn, hp), _tail(rbf, ep), mask)
        elif name == "near_pass_rowsum":
            rs, ppn, rbf, gh = acts
            acts = (_halves(rs, h, hp), _halves(ppn, h, hp), _tail(rbf, ep),
                    gh)
        else:
            acts = (_tail(acts[0], hp), _tail(acts[1], hp), *acts[2:])
        w1 = kw.w1e[:e] if name.startswith("fused") else kw.w1e
        kwargs = PAIR if name.startswith("fused") else {}
        got = getattr(kernels, name + "_plain")(*acts, w1, kw.w2, kw.b2,
                                                **kwargs)[:, :h]
    _close(got, ref)


def test_int8_scale_takes_the_real_columns(on_card):
    """Hazard of the int8 tier at H = 16: every pi negative (pj's maximum
    positive), so max(pi) < 0.  The scale the wrapper hands the kernel is
    JAX's, from the maxima over the real columns; JAX's interpret-mode
    kernel and the emulated padded kernel agree.  Maxima over zero-padded
    columns would take max(pi) = 0 and miss by far more than the bar."""
    g = np.random.default_rng(5)
    h, r, n = 16, 24, 40
    pi = -np.abs(g.normal(size=(r, h))).astype(np.float32) - 0.1
    pj = (g.normal(size=(n, h)) + 0.5).astype(np.float32)
    cv = np.ones(n, np.float32)
    w2 = (g.normal(size=(h, h)) * 0.3).astype(np.float32)
    b2 = (g.normal(size=h) * 0.1).astype(np.float32)
    ref = np.asarray(jax_dmr(pi, pj, cv, w2, b2, mid_dtype="int8"))
    args = [_t(a) for a in (pi, pj, cv, w2, b2)]
    out = kernels.dense_message_rowsum_int8(*args)
    bar = 1e-5 * (np.abs(ref).max() + 1.0)
    assert np.abs(out.numpy() - ref).max() <= bar
    tensors = on_card[0]["tensors"]
    s_in = kernels.int8_activation_scale(tensors[6], tensors[7])
    want = jnp.maximum(jnp.maximum(jnp.max(pi) + jnp.max(pj), 0.0),
                       1e-30) / 127.0
    assert float(s_in) == float(want)
    assert float(tensors[6]) < 0.0  # max(pi): no zero column raised it
    # the same kernel with the maxima over zero-padded columns
    hq = kernels.padded_width(h, 32)
    wrong = _int8_padded(*[t for t in tensors[:6]],
                         _tail(args[0], hq).amax(), _tail(args[1], hq).amax(),
                         None)[:, :h]
    assert np.abs(wrong.numpy() - ref).max() > 100 * bar


def test_pad_kernel_weights_once_per_set(rng):
    """``ops.fused.pad_kernel_weights`` pads every kernel round once; at
    widths that are multiples of 8 the padded weights are the weights
    themselves (no copy)."""
    from test_torch_fused import build, port_cfg
    from epnn_tpu.models import EPNNConfig
    from epnn_tpu_torch.io.checkpoint import from_jax_params

    for kw, same in ((dict(T=2), True),
                     (dict(h_dim=16, e_dim=20, msg_dim=8, mlp_hidden=(20, 20),
                           T=2), False)):
        cfg = EPNNConfig(**kw)
        params = build(rng, cfg, 1)[0]
        pcfg = port_cfg(cfg)
        fp = fused.pad_kernel_weights(
            fused.fuse_params(from_jax_params(params, pcfg), pcfg))
        for w in (*fp.messages, *fp.passes):
            (w2, b2), = w.mids
            h, e = w2.shape[0], w.w1_e.shape[0]
            hp, ep = kernels.padded_width(h), kernels.padded_width(e)
            assert w.padded.w2.shape == (hp, hp)
            assert w.padded.w1e.shape == (ep, hp)
            assert (w.padded.w2 is w2) == same
            assert torch.equal(w.padded.w2[:h, :h], w2)
            assert torch.equal(w.padded.w1e[:e, :h], w.w1_e)
            assert not w.padded.w2[h:].any() and not w.padded.b2[h:].any()
