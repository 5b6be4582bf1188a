"""The flop count behind ``cost_analysis=True``, on the CPU.

``utils.timing.benchmark_chained(cost_analysis=True)`` and
``Predictor.benchmark_batch(cost_analysis=True)`` return ``flops``, the
measured call's products as ``torch.utils.flop_counter.FlopCounterMode``
counts them.  Every ``epnn_torch::`` operator carries a flop formula
(``kernels.work``): here each formula equals the count of the operator's
float32 plain version at two shapes; a ``benchmark_batch`` call's
``flops`` equals a count written out from the model's config; and the
count is the same with the kernels routed through their operators (how a
counted call runs) and through their bodies (the plain versions counted
op by op), and with the card's launches emulated
(``test_torch_widths.arm_card``: the operators run the kernels' path, so
this is the count a call on the card gives).  The counterpart of JAX's
``test_scaling_work_divides`` (a rank's count on the atom split at most
0.6 of one device's) runs on ``tests/test_torch_parallel_atom.py``'s two
gloo ranks."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from epnn_tpu_torch.data import pad_molecules
from epnn_tpu_torch.elements import table_for_n_elems
from epnn_tpu_torch.infer import Predictor
from epnn_tpu_torch.models import EPNNConfig, init_params
from epnn_tpu_torch.ops import kernels
from epnn_tpu_torch.testing import water_box
from epnn_tpu_torch.utils.timing import count_flops
from test_torch_widths import arm_card

torch.set_num_threads(1)


def _count(fn, *args, **kw):
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kw)
    return counter.get_total_flops()


def _op_inputs(name, g, r, n, h, e, k):
    """Seeded inputs of kernel ``name``: R rows against N columns (the far
    field), N rows of K slots (the near kernels), N atoms (the fused
    kernels)."""
    def f(*s):
        return torch.from_numpy((g.normal(size=s) * 0.5).astype(np.float32))

    cv = torch.ones(n)
    slots = torch.from_numpy((g.uniform(size=(r, k)) > 0.3)
                             .astype(np.float32))
    xyz = torch.from_numpy(g.uniform(0.0, 5.0, (n, 3)).astype(np.float32))
    return {
        "dense_message_rowsum": (f(r, h), f(n, h), cv, f(h, h), f(h)),
        "dense_message_rowsum_int8": (f(r, h), f(n, h), cv, f(h, h), f(h)),
        "dense_message_rowsum_bwd": (f(r, h), f(n, h), cv, f(h, h), f(h),
                                     f(r, h)),
        "near_message_corr": (f(r, h), f(r * k, h), f(r * k, e).abs(), slots,
                              f(e, h), f(h, h), f(h)),
        "near_pass_rowsum": (f(r, 2 * h), f(r * k, 2 * h),
                             f(r * k, e).abs(), 0.5 * slots, f(e, h),
                             f(h, h), f(h)),
        "fused_message_rowsum": (f(n, h), f(n, h), xyz, cv, cv, f(e, h),
                                 f(h, h), f(h)),
        "fused_epn_rowsum": (f(n, h), f(n, h), xyz, cv, f(e, h), f(h, h),
                             f(h)),
    }[name]


#: (R, N, H, E, K): the widths the ops run at, and a ragged set
SHAPES = [(12, 17, 8, 6, 3), (9, 9, 32, 48, 5)]


@pytest.mark.parametrize("shape", SHAPES, ids=["ragged", "shipped"])
@pytest.mark.parametrize("name", sorted(kernels._OPS))
def test_formula_is_the_plain_versions_count(name, shape):
    """Operator ``name``'s formula (the count of a call through the
    operator, which ``FlopCounterMode`` takes from it) equals the count
    of the float32 plain version on the same inputs; the kernel's bound
    counts (``work``'s products) are another number (live work only)."""
    args = _op_inputs(name, np.random.default_rng(0), *shape)
    via_op = _count(getattr(kernels, name), *args)
    plain = _count(getattr(kernels, name + "_plain"), *args)
    assert via_op == plain > 0
    with FlopCounterMode(display=False) as counter:
        getattr(kernels, name)(*args)
    assert set(counter.get_flop_counts()["Global"]) == {
        getattr(torch.ops.epnn_torch, name)}


def _model_count(cfg: EPNNConfig, n: int, k: int) -> int:
    """The products of one blocked forward of one graph of ``n`` atoms with
    ``k`` neighbor slots, from the config: per message round the atom
    projections (w1_i, w1_j), the far field (round 1 collapsed to the
    element grid: the count of each element, jvec @ onehot, then n_elems
    rows), the near correction, W_out and the update MLP; per pass round
    the projections, the near pass sums and W_out."""
    a = cfg.n_elems + cfg.h_dim + 1     # an atom's input row [x | h | q]
    h1, h2 = cfg.mlp_hidden              # the pair MLP: one H × H mid layer
    e, m = cfg.e_dim, cfg.msg_dim
    grid = cfg.n_elems                   # the collapse's rows: elements + pad
    proj = 2 * (2 * n * a * h1)
    near = n * k * (2 * e * h1 + 4 * h1 * h2)
    update = 2 * n * ((cfg.h_dim + m) * h1 + h1 * h2 + h2 * cfg.h_dim)
    total = 0
    for t in range(cfg.T):
        if t == 0:
            far = (2 * n * (grid - 1) + 2 * grid * a * h1
                   + 2 * n * grid * h1 * h2 + 2 * n * grid * h2)
        else:
            far = 2 * n * n * h1 * (h2 + 1)
        total += proj + far + near + 2 * n * h2 * m + update
    for t in range(cfg.T):
        total += proj + near + 2 * n * h2 * 1
    return total


def _predictor():
    cfg = EPNNConfig(h_dim=16, e_dim=16, msg_dim=8, mlp_hidden=(8, 8), T=2)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    pred = Predictor(params, cfg, device="cpu", force_mode="blocked")
    batch = pad_molecules([water_box(30, seed=1)],
                          table_for_n_elems(cfg.n_elems))
    return pred, batch


def test_benchmark_batch_flops_from_the_config():
    """A 90-atom water box through the blocked forward (top-k, the round-1
    collapse): ``flops`` is the count written out from the config, and
    ``benchmark_chained`` per call carries none (as JAX's)."""
    pred, batch = _predictor()
    k = pred._blocked_kw(batch)["neighbor_k"]
    out = pred.benchmark_batch(batch, iters=2, warmup_loops=1,
                               cost_analysis=True)
    assert out["flops"] == _model_count(pred.cfg, batch.padded_atoms, k)
    assert "flops" not in pred.benchmark_batch(batch, iters=2,
                                               warmup_loops=1)


def test_flops_through_operators_bodies_and_the_card():
    """One forward's count with the kernels through their operators, the
    same through their bodies (the plain versions, counted op by op), and
    the same with the card path emulated (the kernels' launches, seen by
    the counter only as the operators' formulas)."""
    pred, batch = _predictor()
    kw = pred._blocked_kw(batch)
    args = pred._inputs(batch)

    def forward():
        from epnn_tpu_torch.ops import forward_blocked
        return forward_blocked(pred._fused, *args, pred.cfg, **kw)

    with torch.no_grad():
        via_ops = count_flops(forward)
        real = kernels._traced
        kernels._traced = lambda: False
        try:
            bodies = count_flops(forward)
        finally:
            kernels._traced = real
    assert via_ops == bodies > 0
    mp = pytest.MonkeyPatch()
    try:
        calls = arm_card(mp)
        kw = dict(kw, use_pallas=True)
        with torch.no_grad():
            card = count_flops(forward)
        assert card == via_ops
        assert {c["name"] for c in calls} == {
            "dense_message_rowsum", "near_message_corr", "near_pass_rowsum"}
    finally:
        mp.undo()


def test_eager_calls_skip_the_operators_outside_a_count(monkeypatch):
    """Without a dispatch mode a kernel call runs its body directly (the
    eager route, which skips the dispatcher), under one it goes through
    the operator."""
    args = _op_inputs("dense_message_rowsum", np.random.default_rng(1),
                      *SHAPES[0])
    seen = []
    real = kernels._OPS["dense_message_rowsum"]
    monkeypatch.setitem(kernels._OPS, "dense_message_rowsum",
                        lambda *a: seen.append(1) or real(*a))
    want = kernels.dense_message_rowsum(*args)
    assert not seen
    with FlopCounterMode(display=False):
        got = kernels.dense_message_rowsum(*args)
    assert seen == [1] and torch.equal(got, want)


@pytest.mark.parametrize("method", ["direct", "doubling"])
def test_work_bounds_count_live_pairs(method):
    """``work``'s bound counts: at the full grid the products the kernel
    design runs (far field plus the live correction's two mid layers) and
    the model's flops differ; live pairs scale them; the doubling trades
    E + 2 special-function ops a live pair for 4 and costs fewer CUDA-core
    FLOP than E exps' arguments."""
    full = kernels.work("fused_epn_rowsum", n=100, h=32, e=48,
                        rbf_method=method)
    assert full.flops == 2 * 100 * 100 * 32 * (48 + 2 * 32)
    live = kernels.work("fused_epn_rowsum", n=100, h=32, e=48, valid=90,
                        near=700, gated=500, rbf_method=method)
    assert live.flops == full.flops
    assert live.products == 500 * (2 * 48 * 32 + 4 * 32 * 32)
    assert live.special == 700 * (4 if method == "doubling" else 50)
    assert live.instructions == 90 * 90 * kernels.SCAN_INSTR
    direct, _ = kernels.rbf_channel_work(48)
    doubled, _ = kernels.rbf_channel_work(48, "doubling")
    assert doubled < direct
    with pytest.raises(ValueError, match="rbf_method"):
        kernels.work("fused_message_rowsum", n=4, h=8, e=8,
                     rbf_method="fast")
