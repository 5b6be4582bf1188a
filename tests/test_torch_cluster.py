"""The clustered far-field tier of the port against the JAX package, on the
CPU: ``ops.cluster.weighted_kmeans`` and ``mids_lipschitz_bound``,
``forward_blocked(far_cluster=…)``, the far-field kernels at centroid
shapes (the launch emulated), ``Predictor(far_cluster=…)`` with
``far_field_diagnostics`` / ``calibrate_far_cluster``, the clustered
train step's gradients, and ``Predictor.charge_position_vjp``.

Bars: the k-means fits make identical assignments, centroids within
rtol 1e-6 / atol 1e-6, cluster weights exactly equal for 0/1 weights
(sums of ones) and within rtol 1e-6 otherwise; the radius within rtol
1e-6 / atol 1e-6 in the differentiable mode, where it is (r − c)²
summed, and in serving mode, where JAX takes it from the scores by
cancellation, within 8 float32 ulps of max‖r‖² + max‖c‖² in d².  Every fit case
first checks on its own data, in float64, that each valid row's two best
distinct centroids score apart by more than 1e-4·(|best| + 1) at every
assignment of the fit, so that a float32 flip between the two packages
cannot pass unseen.  Charges: the JAX suite's bars, 2e-5·(max|q| + 1)
(``tests/test_fused.py:1340``) and conservation 2e-6·(Σ|q| + 1); the
forward's radius within 1e-5·(radius + max‖pj‖): the two packages' pj rows
differ by float32 noise relative to their norm.
Gradients: relative Frobenius error 1e-4 a leaf (summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epnn_tpu.data.dataset import pad_molecules as jax_pad_molecules
from epnn_tpu.data.xyz import Molecule as JaxMolecule
from epnn_tpu.elements import table_for_n_elems as jax_table
from epnn_tpu.infer import Predictor as JaxPredictor
from epnn_tpu.models import EPNNConfig
from epnn_tpu.models import init_params as jax_init_params
from epnn_tpu.ops import forward_blocked as jax_forward_blocked
from epnn_tpu.ops import fuse_params as jax_fuse_params
from epnn_tpu.ops.cluster import mids_lipschitz_bound as jax_lipschitz
from epnn_tpu.ops.cluster import weighted_kmeans as jax_kmeans
from epnn_tpu.train import TrainConfig as JaxTrainConfig
from epnn_tpu.train import create_state as jax_create_state
from epnn_tpu.train.loop import _loss_fn_fused as jax_loss_fn_fused
from epnn_tpu_torch.data import pad_molecules
from epnn_tpu_torch.data.xyz import Molecule
from epnn_tpu_torch.elements import table_for_n_elems
from epnn_tpu_torch.infer import Predictor
from epnn_tpu_torch.io.checkpoint import from_jax_params
from epnn_tpu_torch.models import tree_leaves
from epnn_tpu_torch.ops import cluster, fused, kernels
from epnn_tpu_torch.testing import water_box
from epnn_tpu_torch.train import TrainConfig
from epnn_tpu_torch.train import loop as L
from test_torch_fused import _t, port_cfg
from test_torch_widths import arm_card

torch.set_num_threads(2)

SMALL = EPNNConfig(h_dim=16, e_dim=16, msg_dim=8, mlp_hidden=(8, 8), T=2)
#: the fit's sum-of-scores margin, in units of |best| + 1
MARGIN = 1e-4


# ---------------------------------------------------------------------------
# weighted_kmeans
# ---------------------------------------------------------------------------

def blobs():
    """tests/test_cluster.py's fixture: three tight blobs, two rows of
    weight zero."""
    g = np.random.default_rng(0)
    centers = np.array([[0.0, 0.0, 0.0, 0.0], [10.0, 0.0, 0.0, 0.0],
                        [0.0, 10.0, 0.0, 0.0]])
    rows = np.concatenate([centers[i] + 0.05 * g.normal(size=(4, 4))
                           for i in range(3)]).astype(np.float32)
    w = g.uniform(0.5, 2.0, size=12).astype(np.float32)
    w[3] = w[7] = 0.0
    return rows, w


def seeded_rows(n, d, n_centres, seed, binary, zero_frac=0.15, dupes=0):
    """n rows around ``n_centres`` random centres (spread 0.3 around
    centres of scale 4), a share of zero weights, ``dupes`` duplicated
    rows; weights 0/1 or uniform in [0.5, 2)."""
    g = np.random.default_rng(seed)
    centres = g.normal(size=(n_centres, d)) * 4.0
    rows = centres[g.integers(0, n_centres, n)] + 0.3 * g.normal(size=(n, d))
    if dupes:
        src = g.integers(0, n, dupes)
        rows[g.choice(n, dupes, replace=False)] = rows[src]
    w = (np.ones(n) if binary else g.uniform(0.5, 2.0, n))
    w[g.uniform(size=n) < zero_frac] = 0.0
    return rows.astype(np.float32), w.astype(np.float32)


def _quantile_idx(r, valid, m, seed):
    nvalid = max(int(valid.sum()), 1)
    take = (np.arange(m) * nvalid) // m
    if seed == "stride":
        return np.minimum(np.searchsorted(np.cumsum(valid), take + 1),
                          len(r) - 1)
    key = np.where(valid, (r * r).sum(1), np.inf)
    return np.argsort(key, kind="stable")[take]


def _assign(cent, r):
    """(assignment, margin / (|best| + 1)) in float64: the margin between
    the best centroid and the best one at another position (identical
    centroids tie exactly in any arithmetic, so they are not a flip)."""
    score = (cent * cent).sum(1)[None] - 2.0 * r @ cent.T
    a = score.argmin(1)
    same = (cent[None, :, :] == cent[a][:, None, :]).all(-1)
    second = np.where(same, np.inf, score).min(1)
    best = score[np.arange(len(r)), a]
    return a, (second - best) / (np.abs(best) + 1.0)


def fit_margin(rows, w, c, iters=8, fit_rows=0, seed="norm"):
    """The fit in float64 (the JAX algorithm), the smallest margin over
    the valid rows at every assignment it makes, and the final
    assignment."""
    r, w = rows.astype(np.float64), w.astype(np.float64)
    valid = w > 0
    n = len(r)
    if fit_rows and fit_rows < n:
        idx = _quantile_idx(r, valid, fit_rows, seed)
        rf, wf = r[idx], w[idx]
        cent = rf[(np.arange(c) * fit_rows) // c]
    else:
        rf, wf = r, w
        cent = r[_quantile_idx(r, valid, c, seed)]
    worst = np.inf
    for _ in range(iters):
        a, m = _assign(cent, rf)
        worst = min(worst, m[wf > 0].min(initial=np.inf))
        wo = (a[:, None] == np.arange(c)[None]) * wf[:, None]
        wts = wo.sum(0)
        new = (wo.T @ rf) / np.maximum(wts, 1e-30)[:, None]
        cent = np.where((wts > 0)[:, None], new, cent)
    a, m = _assign(cent, r)
    return min(worst, m[valid].min(initial=np.inf)), a


#: (n, d, centres, C, weights, seed order, fit_rows, dupes, data seed):
#: N 12-300, D 4-32, C 1, 3, 8 and past the valid rows (0/1 weights
#: there: every valid row its own centroid); each data seed is the first
#: whose fit has the margin (k-means may split a blob between two
#: centroids, and the rows between them then nearly tie)
FIT_CASES = [
    (12, 4, 3, 1, "binary", "norm", 0, 0, 0),
    (40, 8, 3, 3, "real", "norm", 0, 2, 0),
    (40, 8, 3, 3, "real", "stride", 0, 0, 1),
    (120, 16, 8, 8, "binary", "norm", 0, 6, 11),
    (120, 16, 8, 8, "real", "stride", 48, 0, 3),
    (300, 32, 8, 8, "real", "norm", 96, 4, 17),
    (300, 32, 3, 3, "binary", "stride", 0, 10, 2),
    (30, 6, 5, 40, "binary", "norm", 0, 0, 0),
    (30, 6, 5, 40, "binary", "stride", 0, 3, 0),
]


def _port_fit(rows, w, c, **kw):
    return [t.detach().numpy() for t in cluster.weighted_kmeans(
        _t(rows), _t(w), c, **kw)]


def _assert_fit(rows, w, c, got, ref, binary, differentiable):
    cent, wts, rad = got
    rcent, rwts, rrad = (np.asarray(a) for a in ref)
    np.testing.assert_allclose(cent, rcent, rtol=1e-6, atol=1e-6)
    if differentiable:
        np.testing.assert_allclose(rad, rrad, rtol=1e-6, atol=1e-6)
    else:
        # the serving radius comes from the scores, ‖c‖² − 2r·c + ‖r‖²: its
        # cancellation leaves a few float32 ulps of ‖r‖² + ‖c‖² in d² in
        # either package (JAX's formula), whatever the summation order
        ulps = 8 * np.finfo(np.float32).eps * (
            (rows.astype(np.float64) ** 2).sum(1).max()
            + (rcent.astype(np.float64) ** 2).sum(1).max())
        assert abs(float(rad) ** 2 - float(rrad) ** 2) <= ulps
    if binary:
        np.testing.assert_array_equal(wts, rwts)
    else:
        np.testing.assert_allclose(wts, rwts, rtol=1e-6)
    np.testing.assert_allclose(wts.sum(), w.sum(), rtol=1e-6)
    if not differentiable:
        valid = w > 0
        a_port, _ = _assign(cent.astype(np.float64), rows.astype(np.float64))
        a_jax, _ = _assign(rcent.astype(np.float64), rows.astype(np.float64))
        np.testing.assert_array_equal(a_port[valid], a_jax[valid])


@pytest.mark.parametrize("differentiable", [False, True])
@pytest.mark.parametrize("case", FIT_CASES)
def test_weighted_kmeans_matches_jax(case, differentiable):
    n, d, n_centres, c, weights, seed, fit_rows, dupes, data_seed = case
    binary = weights == "binary"
    rows, w = seeded_rows(n, d, n_centres, seed=data_seed, binary=binary,
                          dupes=dupes)
    margin, _ = fit_margin(rows, w, c, fit_rows=fit_rows, seed=seed)
    assert margin > MARGIN, margin
    kw = dict(fit_rows=fit_rows, seed=seed, differentiable=differentiable)
    ref = jax_kmeans(jnp.asarray(rows), jnp.asarray(w), c, **kw)
    got = _port_fit(rows, w, c, **kw)
    _assert_fit(rows, w, c, got, ref, binary, differentiable)
    if c > int((w > 0).sum()):
        # every valid row its own centroid; the repeated seeds stay empty
        assert (got[1] > 0).sum() == len(np.unique(rows[w > 0], axis=0))


@pytest.mark.parametrize("differentiable", [False, True])
@pytest.mark.parametrize("iters,precision", [(8, "highest"), (2, "default")])
def test_weighted_kmeans_blobs_match_jax(differentiable, iters, precision):
    rows, w = blobs()
    margin, _ = fit_margin(rows, w, 3, iters=iters)
    assert margin > MARGIN
    jprec = (jax.lax.Precision.HIGHEST if precision == "highest"
             else jax.lax.Precision.DEFAULT)
    ref = jax_kmeans(jnp.asarray(rows), jnp.asarray(w), 3, iters,
                     fit_precision=jprec, differentiable=differentiable)
    got = _port_fit(rows, w, 3, iters=iters, fit_precision=precision,
                    differentiable=differentiable)
    _assert_fit(rows, w, 3, got, ref, False, differentiable)


def test_weighted_kmeans_is_deterministic_and_partitions():
    """The same bits on a repeated call; duplicates with C ≥ the distinct
    rows collapse to zero radius (tests/test_fused.py's check)."""
    g = np.random.default_rng(3)
    rows = np.repeat(g.normal(size=(6, 8)).astype(np.float32), 20, axis=0)
    w = np.ones(120, np.float32)
    w[::7] = 0.0
    a = _port_fit(rows, w, 8, iters=12)
    b = _port_fit(rows, w, 8, iters=12)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert a[1].sum() == w.sum() and float(a[2]) < 1e-3
    with pytest.raises(ValueError):
        cluster.weighted_kmeans(_t(rows), _t(w), 8, fit_precision="tf32")


def test_differentiable_jacobian_is_weighted_mean():
    """∂cent_c/∂rows_j = (w_j / W_c)·I for j in cluster c, zero otherwise;
    exactly zero in serving mode (tests/test_cluster.py:67-90)."""
    rows, w = blobs()
    wt = _t(w)

    def cent_of(diff):
        return lambda r: cluster.weighted_kmeans(r, wt, 3,
                                                 differentiable=diff)[0]

    jac = torch.autograd.functional.jacobian(cent_of(True), _t(rows))
    cent0 = cent_of(False)(_t(rows)).numpy()
    assign = ((rows[:, None, :] - cent0[None]) ** 2).sum(-1).argmin(1)
    big_w = np.array([(w * (assign == c)).sum() for c in range(3)])
    for c in range(3):
        for j in range(12):
            coeff = w[j] / big_w[c] if assign[j] == c and w[j] > 0 else 0.0
            np.testing.assert_allclose(jac[c, :, j, :].numpy(),
                                       coeff * np.eye(4), atol=1e-6)
    jac0 = torch.autograd.functional.jacobian(cent_of(False), _t(rows))
    assert float(jac0.abs().max()) == 0.0


def _fused_pair(cfg, seed=0):
    """JAX and port fused weights of a bias-perturbed random model."""
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a + 0.3 if a.ndim == 1 else a),
        jax_init_params(cfg, jax.random.key(seed)))
    pcfg = port_cfg(cfg)
    return (params, jax_fuse_params(params, cfg),
            fused.fuse_params(from_jax_params(params, pcfg), pcfg), pcfg)


@pytest.mark.parametrize("cfg", [EPNNConfig(), SMALL,
                                 EPNNConfig(mlp_hidden=(16, 24, 8), T=3)])
def test_lipschitz_bound_matches_jax(cfg):
    """The same float64 spectral norms: max over the rounds of each
    factor, JAX's stacked arrays against the port's list of rounds."""
    _, jf, pf, _ = _fused_pair(cfg)
    ref = jax_lipschitz(jf.messages)
    got = cluster.mids_lipschitz_bound(pf.messages)
    assert got == pytest.approx(ref, rel=1e-12) and got > 0
    one = jax.tree_util.tree_map(lambda a: a[1], jf.messages)
    assert cluster.mids_lipschitz_bound(pf.messages[1]) == pytest.approx(
        jax_lipschitz(one), rel=1e-12)


# ---------------------------------------------------------------------------
# forward_blocked(far_cluster=…)
# ---------------------------------------------------------------------------

def far_system(seed=0, b=2, n=48, n_real=41, cfg=None, uniform=False):
    """tests/test_fused.py's TestFarCluster system: random element
    features and coordinates in an 8 Å box, bias-perturbed weights."""
    cfg = cfg or EPNNConfig()
    rng = np.random.default_rng(seed)
    params, jf, pf, pcfg = _fused_pair(cfg)
    x = rng.normal(size=(b, n, cfg.n_elems)).astype(np.float32)
    xyz = rng.uniform(-4, 4, size=(b, n, 3)).astype(np.float32)
    mask = np.zeros((b, n), np.float32)
    mask[:, :n_real] = 1
    x[:, n_real:] = 0
    xyz[:, n_real:] = 0
    q_total = np.arange(b, dtype=np.float32) - 1.0
    q0 = mask * (q_total[:, None] / n_real)
    if uniform:
        q0 = np.full_like(q0, 1.0 / n)
    return cfg, pcfg, jf, pf, (x, q0, xyz, mask), q_total


def _jax_far(jf, arrays, cfg, **kw):
    out = jax_forward_blocked(jf, *arrays, cfg, block=8, neighbor_k=16, **kw)
    return tuple(np.asarray(o) for o in out) if kw.get("far_diag") \
        else np.asarray(out)


def _port_far(pf, arrays, pcfg, **kw):
    with torch.no_grad():
        out = fused.forward_blocked(pf, *map(_t, arrays), pcfg,
                                    neighbor_k=16, **kw)
    return tuple(o.numpy() for o in out) if kw.get("far_diag") \
        else out.numpy()


def _close_q(out, ref, bar=2e-5):
    scale = np.abs(ref).max() + 1.0
    assert np.abs(out - ref).max() < bar * scale, np.abs(out - ref).max()


def _conserves(q, q_total, mask):
    scale = np.abs(q).sum(1) + 1.0
    assert np.all(np.abs(q.astype(np.float64).sum(1) - q_total)
                  < 2e-6 * scale)
    assert np.all(q[mask == 0] == 0.0)


def spy_fits(monkeypatch):
    """Record the rows and weights of every k-means fit of the port's
    forward; returns the list."""
    seen = []
    fit = fused.weighted_kmeans

    def spy(rows, weights, c, **kw):
        seen.append((rows.detach().numpy().copy(), weights.numpy().copy()))
        return fit(rows, weights, c, **kw)

    monkeypatch.setattr(fused, "weighted_kmeans", spy)
    return seen


def _close_rad(rad, ref, fits):
    """The radius within 1e-5·(radius + max‖pj‖) of JAX's (the rows of
    the fits recorded by :func:`spy_fits`), or, where both are float32
    cancellation residue (C past the distinct rows: d² is a few ulps of
    ‖pj‖² in either package, and its root far more), d² within 32 ulps of
    max‖pj‖²."""
    scale = max(float(np.linalg.norm(r[w > 0], axis=1).max())
                for r, w in fits)
    rad, ref = np.asarray(rad, np.float64), np.asarray(ref, np.float64)
    residue = 32 * np.finfo(np.float32).eps * scale ** 2
    ok = ((np.abs(rad - ref) <= 1e-5 * (ref + scale))
          | (np.maximum(rad, ref) ** 2 <= residue))
    assert np.all(ok), (rad, ref, residue)


@pytest.mark.parametrize("mask_messages", [True, False])
def test_c_equals_n_matches_exact_and_jax(mask_messages):
    cfg, pcfg, jf, pf, arrays, _ = far_system(
        cfg=EPNNConfig(mask_messages=mask_messages))
    n = arrays[0].shape[1]
    ref = _jax_far(jf, arrays, cfg, far_cluster=n)
    out = _port_far(pf, arrays, pcfg, far_cluster=n)
    exact = _port_far(pf, arrays, pcfg)
    _close_q(out, ref)
    _close_q(out, exact)


@pytest.mark.parametrize("c", [2, 8])
def test_conservation_at_any_c_matches_jax(c):
    cfg, pcfg, jf, pf, arrays, q_total = far_system()
    ref = _jax_far(jf, arrays, cfg, far_cluster=c)
    out = _port_far(pf, arrays, pcfg, far_cluster=c)
    _close_q(out, ref)
    _conserves(out, q_total, arrays[3])
    exact = _port_far(pf, arrays, pcfg)
    assert np.abs(out - exact).max() > 2e-5 * (np.abs(exact).max() + 1.0)


def test_radius_falls_with_c_and_far_diag_shape(monkeypatch):
    cfg, pcfg, jf, pf, arrays, _ = far_system()
    fits = spy_fits(monkeypatch)
    rads = []
    for c in (2, 16, 48):
        q_ref, rad_ref = _jax_far(jf, arrays, cfg, far_cluster=c,
                                  far_diag=True)
        q, rad = _port_far(pf, arrays, pcfg, far_cluster=c, far_diag=True)
        assert rad.shape == (arrays[0].shape[0],) and rad.dtype == np.float32
        _close_q(q, q_ref)
        _close_rad(rad, rad_ref, fits)
        rads.append(rad.max())
    assert rads[0] > rads[1] > rads[2]


@pytest.mark.parametrize("env", [
    {"EPNN_FAR_CLUSTER_ITERS": "2"},
    {"EPNN_FAR_CLUSTER_FIT_PREC": "default"},
    {"EPNN_FAR_CLUSTER_SEED": "stride"},
    {"EPNN_FAR_CLUSTER_FIT_ROWS": "16", "EPNN_FAR_CLUSTER_SEED": "stride",
     "EPNN_FAR_CLUSTER_FIT_PREC": "default", "EPNN_FAR_CLUSTER_ITERS": "2"},
])
def test_fit_knobs_match_jax_and_keep_the_contract(monkeypatch, env):
    """The port reads JAX's four fit settings at every call: conservation
    exact, the radius live, the same bits on a repeated call, and JAX's
    charges and radius."""
    cfg, pcfg, jf, pf, arrays, q_total = far_system()
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jax.clear_caches()   # JAX reads them when it traces
    try:
        q_ref, rad_ref = _jax_far(jf, arrays, cfg, far_cluster=8,
                                  far_diag=True)
    finally:
        for k in env:
            monkeypatch.delenv(k)
        jax.clear_caches()
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    fits = spy_fits(monkeypatch)
    q, rad = _port_far(pf, arrays, pcfg, far_cluster=8, far_diag=True)
    q2, rad2 = _port_far(pf, arrays, pcfg, far_cluster=8, far_diag=True)
    assert np.array_equal(q, q2) and np.array_equal(rad, rad2)
    _conserves(q, q_total, arrays[3])
    assert np.all(rad > 0)
    _close_q(q, q_ref)
    _close_rad(rad, rad_ref, fits)
    monkeypatch.delenv("EPNN_FAR_CLUSTER_ITERS", raising=False)
    assert fused.far_cluster_fit_kw()["iters"] == 8


def test_uniform_q0_collapse_composes():
    """Round 1 keeps the exact collapse, round 2+ cluster: at C = N the
    result is the exact collapsed forward's, and JAX's."""
    cfg, pcfg, jf, pf, arrays, _ = far_system(b=1, n=40, n_real=40,
                                              uniform=True)
    ref = _jax_far(jf, arrays, cfg, uniform_q0=True, far_cluster=40)
    out = _port_far(pf, arrays, pcfg, uniform_q0=True, far_cluster=40)
    exact = _port_far(pf, arrays, pcfg, uniform_q0=True)
    _close_q(out, ref)
    _close_q(out, exact)


def test_far_cluster_errors():
    cfg, pcfg, jf, pf, arrays, _ = far_system()
    with pytest.raises(ValueError, match="far_diag requires far_cluster"):
        _port_far(pf, arrays, pcfg, far_diag=True)
    with pytest.raises(ValueError, match="requires neighbor_k"):
        fused.forward_blocked(pf, *map(_t, arrays), pcfg, far_cluster=8)
    with pytest.raises(ValueError):
        jax_forward_blocked(jf, *arrays, cfg, block=8, far_cluster=8)


def test_other_depths_take_the_plain_grid():
    """Rounds with two mid layers take no kernel (JAX's XLA branch) and
    run the same centroid grid through the plain version."""
    cfg = EPNNConfig(mlp_hidden=(16, 24, 8), T=2)
    cfg, pcfg, jf, pf, arrays, q_total = far_system(cfg=cfg)
    ref = _jax_far(jf, arrays, cfg, far_cluster=8)
    out = _port_far(pf, arrays, pcfg, far_cluster=8)
    _close_q(out, ref)
    _conserves(out, q_total, arrays[3])


# ---------------------------------------------------------------------------
# the far-field kernels at centroid shapes, the launch emulated
# ---------------------------------------------------------------------------

@pytest.fixture
def on_card(monkeypatch):
    return arm_card(monkeypatch)


def _centroid_args(c, h=32, r=300, seed=0):
    g = np.random.default_rng(seed + c)
    f = lambda *s, sc=1.0: _t((g.normal(size=s) * sc).astype(np.float32))  # noqa: E731
    wts = _t(np.where(np.arange(c) % 5 == 4, 0.0,
                      g.integers(1, 40, c)).astype(np.float32))
    return f(r, h), f(c, h), wts, f(h, h, sc=0.3), f(h, sc=0.3), f(r, h)


def _split_ok(r, n, target=kernels._DMR_TARGET_BLOCKS):
    """The C entries' contract on a fixed column split: whole tiles, every
    split non-empty."""
    splits, cols = kernels._dense_message_splits(r, n, target)
    assert cols % kernels._DMR_TILE == 0 and splits >= 1
    assert (splits - 1) * cols < n <= splits * cols


@pytest.mark.parametrize("c", [1, 16, 32, 40, 256])
def test_far_kernels_at_centroid_shapes(on_card, c):
    """R = 300 rows against C centroid columns (zero weight on every
    fifth): the far field, its int8 tier (pj padded apart, as the
    clustered call pads the centroid rows) and the backward each reach one
    launch whose emulation is the plain version."""
    pi, cent, wts, w2, b2, g = _centroid_args(c)
    for r, n in ((300, c), (c, 300)):
        _split_ok(r, n)
        _split_ok(r, n, kernels._DMR_BWD_TARGET_BLOCKS)
    out = kernels.dense_message_rowsum(pi, cent, wts, w2, b2)
    ref = kernels.dense_message_rowsum_plain(pi, cent, wts, w2, b2)
    assert torch.allclose(out, ref, rtol=0, atol=1e-6 * (
        float(ref.abs().max()) + 1.0))
    for pad_pj in (True, False):
        out8 = kernels.dense_message_rowsum_int8(
            pi, cent, wts, w2, b2, pad_pi=torch.tensor(0.0), pad_pj=pad_pj)
        ref8 = kernels.dense_message_rowsum_int8_plain(
            pi, cent, wts, w2, b2, torch.tensor(0.0), pad_pj)
        assert torch.allclose(out8, ref8, rtol=0, atol=1e-5 * (
            float(ref8.abs().max()) + 1.0))
    grads = kernels.dense_message_rowsum_bwd(pi, cent, wts, w2, b2, g)
    refs = kernels.dense_message_rowsum_bwd_plain(pi, cent, wts, w2, b2, g)
    for got, want in zip(grads, refs):
        assert torch.allclose(got, want, rtol=0, atol=1e-5 * (
            float(want.abs().max()) + 1.0))
    names = [call["name"] for call in on_card]
    assert names == ["dense_message_rowsum", "dense_message_rowsum_int8",
                     "dense_message_rowsum_int8", "dense_message_rowsum_bwd"]
    assert [call["tensors"][1].shape[0] for call in on_card] == [c] * 4
    # the int8 launches' maxima: pj's lifted to 0 only where it is padded
    for call, pad_pj in zip(on_card[1:3], (True, False)):
        pj_max = float(call["tensors"][7])
        assert pj_max == (max(float(cent.max()), 0.0) if pad_pj
                          else float(cent.max()))
        assert call["tensors"][8] is None


@pytest.mark.parametrize("pad_pi", [None, 8.0, 0.0])
@pytest.mark.parametrize("pad_pj", [True, False])
def test_int8_pad_pj_is_explicit_zero_rows(pad_pi, pad_pj):
    """``pad_pj`` stands for zero pj rows of weight 0, apart from the pi
    padding: the plain version equals itself on explicitly padded
    operands, within float32 summation order (pj all negative, so the
    zero rows move the scale)."""
    g = np.random.default_rng(1)
    pi = (g.normal(size=(24, 32))).astype(np.float32)
    pj = (-np.abs(g.normal(size=(6, 32))) - 0.2).astype(np.float32)
    cv = np.ones(6, np.float32)
    w2 = (g.normal(size=(32, 32)) * 0.3).astype(np.float32)
    b2 = (g.normal(size=32) * 0.1).astype(np.float32)
    pis, pjs, cvs = [pi], [pj], [cv]
    if pad_pi is not None:
        pis.append(np.full((3, 32), pad_pi, np.float32))
    if pad_pj:
        pjs.append(np.zeros((2, 32), np.float32))
        cvs.append(np.zeros(2, np.float32))
    want = kernels.dense_message_rowsum_int8_plain(
        *map(_t, (np.concatenate(pis), np.concatenate(pjs),
                  np.concatenate(cvs), w2, b2)))[:24]
    pp = None if pad_pi is None else torch.tensor(pad_pi)
    args = tuple(map(_t, (pi, pj, cv, w2, b2)))
    got = kernels.dense_message_rowsum_int8_plain(*args, pp, pad_pj)
    # the zero rows change only the float32 order of the sum over j
    tol = 1e-6 * (float(want.abs().max()) + 1.0)
    assert float((got - want).abs().max()) <= tol
    if pad_pj:
        apart = kernels.dense_message_rowsum_int8_plain(*args, pp, False)
        assert float((apart - want).abs().max()) > 100 * tol


@pytest.mark.parametrize("int8", [False, True])
def test_clustered_forward_launches_with_c_columns(on_card, int8):
    """``forward_blocked(far_cluster=C, use_pallas=True)`` on the emulated
    card: each clustered round launches its far field once, with C
    centroid columns and the cluster weights as cv, in the tier the
    config names; JAX's kernel path (interpret mode) gives the same
    charges (int8 at ``test_torch_int8``'s bar, 5e-3)."""
    kw = dict(dense_matmul_precision="int8") if int8 else {}
    cfg, pcfg, jf, pf, arrays, q_total = far_system(
        cfg=EPNNConfig(T=3, **kw), b=1)
    c = 6
    out = _port_far(pf, arrays, pcfg, far_cluster=c, use_pallas=True)
    name = "dense_message_rowsum" + ("_int8" if int8 else "")
    far = [call for call in on_card if call["name"] == name]
    assert len(far) == 3 and len(on_card) == 3 + 3 + 3
    for call in far:
        assert call["tensors"][1].shape[0] == c
        assert float(call["tensors"][2].sum()) == arrays[3].sum()
    ref = _jax_far(jf, arrays, cfg, far_cluster=c, use_pallas=True)
    _close_q(out, ref, 5e-3 if int8 else 2e-5)
    _conserves(out, q_total, arrays[3])


# ---------------------------------------------------------------------------
# Predictor
# ---------------------------------------------------------------------------

def _mol_pair(natoms, seed, side, copies=1, spacing=9.0):
    """A random H/C/N/O molecule of ``natoms`` in a ``side`` Å box, in both
    packages' types; with ``copies``, that many translated copies on a
    cubic grid of ``spacing`` Å (apart by more than the cutoff)."""
    g = np.random.default_rng(seed)
    sym = [str(s) for s in g.choice(["H", "C", "N", "O"], natoms)]
    xyz = g.uniform(0, side, (natoms, 3)).astype(np.float32)
    if copies > 1:
        grid = np.stack(np.meshgrid(*[np.arange(3)] * 3, indexing="ij"),
                        -1).reshape(-1, 3)[:copies] * spacing
        xyz = (grid[:, None, :] + xyz[None]).reshape(-1, 3).astype(
            np.float32)
        sym = sym * copies
    return (Molecule(name="m", symbols=sym, xyz=xyz, total_charge=0.0),
            JaxMolecule(name="m", symbols=sym, xyz=xyz.copy(),
                        total_charge=0.0))


#: the served system: 20 copies of a 15-atom molecule, 300 atoms
CLASSES = 15


@pytest.fixture(scope="module")
def served():
    """A random-weight model (biases + 0.05, so that a bias-handling fault
    cannot cancel; charges up to 23 e) and 20 copies of a random 15-atom molecule, 300 atoms (the blocked path:
    304 padded).  A clustered round's pj rows form one group per element
    (H, C, N, O: 6-18 apart), each of the 15 atoms' classes within it
    0.001-0.01 apart, and the 20 copies of a class within float32 noise.
    So C ≤ 4 fits with clear margins (each fit's margin is checked; C = 2
    merges elements and moves the charges by up to 4 e, C = 4 by 1e-4), and
    from C = 32 every class holds seeds of its own and the fit reproduces
    the exact forward.  Between the two, and on a random cloud, every fit
    has near ties (1e-6-1e-10 of the scores): a row that the two packages
    assign apart moves the charges past the bar, so no test uses such
    C."""
    cfg = EPNNConfig(n_elems=10, h_dim=16, e_dim=16, msg_dim=8,
                     mlp_hidden=(8, 8), T=2)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a + 0.05 if a.ndim == 1 else a),
        jax_init_params(cfg, jax.random.key(0)))
    pcfg = port_cfg(cfg)
    port_params = from_jax_params(params, pcfg)
    mol, jmol = _mol_pair(CLASSES, 5, 4.0, copies=20)
    return cfg, params, pcfg, port_params, mol, jmol


def assert_tie_free(fits, c):
    """Every recorded fit of C centroids has the margin."""
    assert fits
    for rows, w in fits:
        margin, _ = fit_margin(rows, w, c)
        assert margin > MARGIN, margin


def _preds(served, **kw):
    cfg, params, pcfg, port_params, mol, jmol = served
    return (JaxPredictor(params=params, cfg=cfg, **kw),
            Predictor(port_params, pcfg, device="cpu", **kw),
            pad_molecules([mol], table_for_n_elems(10)),
            jax_pad_molecules([jmol], jax_table(10)))


@pytest.mark.parametrize("c", [2, 32])
def test_predictor_far_cluster_matches_jax(served, monkeypatch, c):
    jp, pp, b, jb = _preds(served, far_cluster=c)
    assert pp._mode(b) == "blocked"
    fits = spy_fits(monkeypatch)
    ref = np.asarray(jp.predict_batch(jb))
    q = pp.predict_batch(b)
    if c < CLASSES:
        assert_tie_free(fits, c)
    _close_q(q, ref)
    assert abs(float(q.astype(np.float64).sum())) < 2e-6 * (
        np.abs(q).sum() + 1.0)
    exact = Predictor(served[3], served[2], device="cpu").predict_batch(b)
    gap = np.abs(q - exact).max() / (np.abs(exact).max() + 1.0)
    assert gap > 2e-5 if c < CLASSES else gap < 2e-5
    with pytest.raises(ValueError, match="far_cluster"):
        Predictor(served[3], served[2], device="cpu", far_cluster=-1)


def test_predictor_skin_composes_with_far_cluster(served, monkeypatch):
    """The skin branch passes far_cluster: two moved frames, each JAX's
    skin Predictor's and a fresh clustered call's."""
    jp, pp, b, jb = _preds(served, far_cluster=2, reuse_neighbors=True,
                           neighbor_skin=0.5)
    fresh = Predictor(served[3], served[2], device="cpu", far_cluster=2)
    g = np.random.default_rng(3)
    fits = spy_fits(monkeypatch)
    for _ in range(2):
        q, ref = pp.predict_batch(b), np.asarray(jp.predict_batch(jb))
        assert_tie_free(fits, 2)
        _close_q(q, ref)
        b2 = pad_molecules([served[4]], table_for_n_elems(10))
        b2.xyz[:] = b.xyz
        _close_q(q, fresh.predict_batch(b2))
        step = (g.uniform(-0.05, 0.05, b.xyz.shape) * b.node_mask[..., None]
                ).astype(np.float32)
        b.xyz += step
        jb.xyz += step
    assert pp.skin_rebuilds == jp.skin_rebuilds == 1


def test_far_field_diagnostics_match_jax(served, monkeypatch):
    jp, pp, b, jb = _preds(served, far_cluster=2)
    fits = spy_fits(monkeypatch)
    ref = jp.far_field_diagnostics(jb)
    got = pp.far_field_diagnostics(b)
    assert_tie_free(fits, 2)
    assert sorted(got) == sorted(ref) == ["lipschitz", "max_abs_dq",
                                          "max_radius", "message_bound"]
    assert got["lipschitz"] == pytest.approx(ref["lipschitz"], rel=1e-12)
    assert got["max_radius"].shape == got["message_bound"].shape == (1,)
    _close_rad(got["max_radius"], np.asarray(ref["max_radius"]), fits)
    np.testing.assert_allclose(
        got["message_bound"], b.node_mask.sum() * got["lipschitz"]
        * got["max_radius"], rtol=1e-6)
    assert abs(float(got["max_abs_dq"][0]) - float(ref["max_abs_dq"][0])
               ) <= _dq_bar(pp, b)
    assert float(got["max_abs_dq"][0]) > 0
    assert "max_abs_dq" not in pp.far_field_diagnostics(b,
                                                        compare_exact=False)
    with pytest.raises(ValueError, match="far_cluster"):
        Predictor(served[3], served[2], device="cpu").far_field_diagnostics(b)


def test_calibrate_far_cluster_selects_jax_c(served):
    jp, pp, b, jb = _preds(served)
    cands = (2, 4, 32, 304)
    full = jp.calibrate_far_cluster(jb, budget=0.0, candidates=cands)
    errs = sorted(full["errors"].values(), reverse=True)
    # a budget between the two largest errors, far from both
    budget = float(np.sqrt(errs[0] * errs[1]))
    ref = jp.calibrate_far_cluster(jb, budget=budget, candidates=cands)
    got = pp.calibrate_far_cluster(b, budget=budget, candidates=cands)
    assert got["selected"] == ref["selected"] == 4
    assert sorted(got["errors"]) == sorted(ref["errors"]) == [2, 4]
    bar = _dq_bar(pp, b)
    for cand, err in ref["errors"].items():
        assert abs(got["errors"][cand] - err) <= bar
        assert abs(err - budget) > bar
    assert got["budget"] == budget and pp.far_cluster == 0
    none = pp.calibrate_far_cluster(b, budget=0.0, candidates=(4,))
    assert none["selected"] is None and none["errors"][4] > 0
    pp.calibrate_far_cluster(b, budget=budget, candidates=cands, apply=True)
    assert pp.far_cluster == ref["selected"]


def _dq_bar(pred, batch):
    """The bar on a max|q_C − q_exact| error: each of the two charges is
    within the charge bar, 2e-5·(max|q| + 1), of JAX's, so their gap is
    within twice that (the charges here reach 23 e)."""
    q = Predictor(pred.params, pred.cfg, device="cpu").predict_batch(batch)
    return 4e-5 * (float(np.abs(q).max()) + 1.0)


def test_dense_path_stays_exact(served):
    """≤ 256 padded atoms run the dense forward, exact whatever C."""
    cfg, params, pcfg, port_params, _, _ = served
    mol, _ = _mol_pair(40, 2, 6.0)
    b = pad_molecules([mol], table_for_n_elems(10))
    q = Predictor(port_params, pcfg, device="cpu",
                  far_cluster=4).predict_batch(b)
    exact = Predictor(port_params, pcfg, device="cpu").predict_batch(b)
    assert np.array_equal(q, exact)


# ---------------------------------------------------------------------------
# the clustered train step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def toy_batch():
    """tests/test_cluster.py's toy_pad_batch: four random H/C/N/O
    molecules of 8-13 atoms padded to 16, labels summing to 0."""
    g = np.random.default_rng(5)
    mols = []
    for i in range(4):
        n = int(g.integers(8, 14))
        symbols = list(g.choice(["H", "C", "N", "O"], size=n))
        xyz = g.uniform(-4, 4, size=(n, 3)).astype(np.float32)
        labels = g.normal(0, 0.2, size=n).astype(np.float32)
        labels -= labels.sum() / n
        mols.append(JaxMolecule(name=f"c{i}", symbols=symbols, xyz=xyz,
                                total_charge=0.0, labels=labels))
    b = jax_pad_molecules(mols, jax_table(SMALL.n_elems), pad_to=16)
    return (b.x, b.q0, b.xyz, b.node_mask, b.y, np.ones((4,), np.float32))


def _port_state(params, tc=None):
    return L.create_state(port_cfg(SMALL), tc or TrainConfig(), device="cpu",
                          params=from_jax_params(
                              jax.tree_util.tree_map(np.asarray, params),
                              port_cfg(SMALL)))


def _port_loss(state, batch, diff):
    return L._loss_fused(state.params, port_cfg(SMALL), "masked_mse", 8,
                         12, False, *map(_t, batch), far_cluster=4,
                         far_cluster_grad=diff)[0]


@pytest.mark.parametrize("diff", [True, False])
def test_clustered_train_step_gradients_match_jax(toy_batch, diff):
    params = jax_create_state(SMALL, JaxTrainConfig(),
                              jax.random.key(0)).params
    jgrads = jax.grad(lambda p: jax_loss_fn_fused(
        p, SMALL, "masked_mse", 8, 12, False, *toy_batch, far_cluster=4,
        far_cluster_grad=diff)[0])(params)
    state = _port_state(params)
    _port_loss(state, toy_batch, diff).backward()
    ref = from_jax_params(jax.tree_util.tree_map(np.asarray, jgrads),
                          port_cfg(SMALL))
    for r, leaf in zip(tree_leaves(ref), tree_leaves(state.params)):
        got = torch.zeros_like(r) if leaf.grad is None else leaf.grad
        err = float((got - r).norm())
        assert err <= 1e-4 * float(r.norm()) + 1e-9, err


def test_clustered_gradient_is_exact_for_the_approximation(toy_batch):
    """JAX's finite-difference check (tests/test_cluster.py:92) on the
    port: along a seeded unit direction, central differences of the
    clustered loss match the autograd directional derivative, and the
    stop-gradient mode's gradient differs."""
    params = jax_create_state(SMALL, JaxTrainConfig(),
                              jax.random.key(0)).params
    grads = {}
    for diff in (True, False):
        state = _port_state(params)
        _port_loss(state, toy_batch, diff).backward()
        grads[diff] = [p.grad.clone() if p.grad is not None
                       else torch.zeros_like(p)
                       for p in tree_leaves(state.params)]
    state = _port_state(params)
    leaves = tree_leaves(state.params)
    g = torch.Generator().manual_seed(7)
    dirs = [torch.randn(p.shape, generator=g) for p in leaves]
    norm = torch.sqrt(sum((d * d).sum() for d in dirs))
    dirs = [d / norm for d in dirs]
    eps = 1e-3

    def shifted(sign):
        with torch.no_grad():
            for p, d in zip(leaves, dirs):
                p.add_(sign * eps * d)
            loss = float(_port_loss(state, toy_batch, True))
            for p, d in zip(leaves, dirs):
                p.sub_(sign * eps * d)
        return loss

    fd = (shifted(1.0) - shifted(-1.0)) / (2 * eps)
    ad = float(sum((a * d).sum() for a, d in zip(grads[True], dirs)))
    assert ad == pytest.approx(fd, rel=2e-2, abs=1e-7)
    gap = max(float((a - b).abs().max())
              for a, b in zip(grads[True], grads[False]))
    assert gap > 1e-7, gap


# ---------------------------------------------------------------------------
# charge_position_vjp
# ---------------------------------------------------------------------------

def test_charge_position_vjp_matches_jax():
    """tests/test_fused.py's 20-atom molecule padded to 24: the pullback
    against JAX's, padding rows exactly zero, JAX's shape error."""
    cfg = EPNNConfig(n_elems=10, h_dim=16, e_dim=16, msg_dim=8,
                     mlp_hidden=(8, 8), T=2)
    params = jax_init_params(cfg, jax.random.key(0))
    g = np.random.default_rng(11)
    sym = list(g.choice(["H", "C", "O"], 20))
    xyz = g.uniform(0, 5, (20, 3)).astype(np.float32)
    jb = jax_pad_molecules([JaxMolecule(name="fd", symbols=sym, xyz=xyz,
                                        total_charge=0.0)],
                           jax_table(10), pad_to=24)
    b = pad_molecules([Molecule(name="fd", symbols=sym, xyz=xyz.copy(),
                                total_charge=0.0)],
                      table_for_n_elems(10), pad_to=24)
    pcfg = port_cfg(cfg)
    jp = JaxPredictor(params=params, cfg=cfg, force_mode="blocked")
    pp = Predictor(from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                          params), pcfg),
                   pcfg, force_mode="blocked", device="cpu")
    cot = g.normal(size=jb.q0.shape).astype(np.float32) * jb.node_mask
    ref = np.asarray(jp.charge_position_vjp(jb, cot))
    got = pp.charge_position_vjp(b, cot)
    assert got.shape == b.xyz.shape == ref.shape
    assert np.all(got[0, 20:] == 0.0)
    assert np.abs(got - ref).max() <= 1e-5 * (np.abs(ref).max() + 1.0)
    assert np.abs(got).max() > 0.1
    with pytest.raises(ValueError, match="cotangent"):
        pp.charge_position_vjp(b, cot[:, :20])


def test_charge_position_vjp_finite_differences():
    """Central differences (ε = 3e-3 Å) of Σ cot·q on three (atom, axis)
    entries of a 300-atom water box through ``trained/mixed_b16`` (charges
    of order 1 e), JAX's bar (tests/test_fused.py:1258-1264).  Probed atoms
    have no pair within 0.05 Å of the cutoff (where the envelope's second
    derivative and the gate switch) and one-sided differences within 2% of
    the scale of each other (a relu of the model switching within ε makes
    a difference no derivative); the cotangent is random on the probed atom
    and its neighbors, zero elsewhere, so that float32 noise in Σ cot·q
    does not swamp the difference.  The cell builder's tables give
    top-k's pull."""
    pp = Predictor.from_checkpoint("trained/mixed_b16", device="cpu")
    table = table_for_n_elems(pp.cfg.n_elems)
    mol = water_box(100, seed=3)
    b = pad_molecules([mol], table)
    g = np.random.default_rng(4)
    d = np.sqrt(((mol.xyz[:, None] - mol.xyz[None]) ** 2).sum(-1))
    clear = np.nonzero(np.abs(d - pp.cfg.cutoff).min(1) > 0.05)[0]
    checked = 0
    for i, a in zip(clear[::7], [0, 1, 2] * 20):
        cot = np.zeros_like(b.q0)
        near = d[i] < pp.cfg.cutoff
        cot[0, :mol.natoms][near] = g.normal(size=int(near.sum()))
        grad = pp.charge_position_vjp(b, cot)

        vals = []
        for shift in (3e-3, 0.0, -3e-3):
            bb = pad_molecules([mol], table)
            bb.xyz[0, i, a] += shift
            vals.append(float((pp.predict_batch(bb).astype(np.float64)
                               * cot).sum()))
        fwd, bwd = (vals[0] - vals[1]) / 3e-3, (vals[1] - vals[2]) / 3e-3
        fd1 = 0.5 * (fwd + bwd)
        scale = max(abs(fd1), np.abs(grad).max(), 1e-3)
        if abs(fwd - bwd) > 2e-2 * scale:
            continue
        assert abs(grad[0, i, a] - fd1) < 5e-2 * scale, (i, a, fd1)
        checked += 1
        if checked == 3:
            break
    assert checked == 3
    assert np.all(grad[0, mol.natoms:] == 0.0)
    cell = Predictor.from_checkpoint("trained/mixed_b16", device="cpu",
                                     neighbor_method="cell")
    np.testing.assert_allclose(cell.charge_position_vjp(b, cot), grad,
                               rtol=0, atol=1e-5 * (np.abs(grad).max() + 1))
