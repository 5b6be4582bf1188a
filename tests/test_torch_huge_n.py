"""The port's huge-N memory mode against the JAX package, on the CPU:
``balanced_row_chunk``, ``neighbor_window_width``, the chunked and
windowed neighbor-split forward (``near_row_chunk``, ``near_window``),
``remat``, the 4-tuple ``neighbor_grid``, ``Predictor``'s chunk / window /
sort policy and the trainer's (auto chunking, forced remat, validation,
warnings); and the API repairs that came with it (``MolBatch.pair_mask``,
``count_params``, ``reference_compat``, ``RBFConfig``, ``pack_to``, the
train steps' signatures).

Tolerances.  Integers (chunks, widths, counts) are exact.  Charges
against JAX: 1e-5·(max|q| + 1), the JAX suite's bar between two paths of
the same math (``tests/test_fused.py``).  The port chunked against the
port full width: ``torch.equal`` — every near op is row-independent and
the CPU's products give the same bits a row at any row count here (the
card phase of ``chip_smoke.py`` holds the kernels to the same).
Gradients chunked against full width: 1e-5 relative Frobenius a leaf —
only the order in which the chunks' partial sums are added differs
(measured ≤ 5.9e-6, on the pass rounds' W2, whose pair terms cancel).
Losses of four Adam steps against JAX: rtol 2e-4 (JAX's own bar between
its chunked and full-width steps, ``tests/test_train.py``).
"""

import dataclasses
import inspect
import warnings

import jax
import numpy as np
import pytest
import torch

import epnn_tpu.infer as jax_infer
from epnn_tpu.data.dataset import pad_molecules as jax_pad_molecules
from epnn_tpu.elements import table_for_n_elems as jax_table
from epnn_tpu.featurize import RBFConfig as JaxRBFConfig
from epnn_tpu.infer import Predictor as JaxPredictor
from epnn_tpu.models import EPNNConfig as JaxConfig
from epnn_tpu.models import count_params as jax_count_params
from epnn_tpu.models import init_params as jax_init_params
from epnn_tpu.models import reference_compat as jax_reference_compat
from epnn_tpu.ops import forward_blocked as jax_forward_blocked
from epnn_tpu.ops import fuse_params as jax_fuse_params
from epnn_tpu.ops import fused as jax_fused
from epnn_tpu.train import loop as jax_loop
from epnn_tpu_torch import infer
from epnn_tpu_torch.data import Molecule, pad_molecules
from epnn_tpu_torch.elements import table_for_n_elems
from epnn_tpu_torch.featurize import RBFConfig
from epnn_tpu_torch.infer import Predictor
from epnn_tpu_torch.io.checkpoint import from_jax_params
from epnn_tpu_torch.models import (
    EPNN,
    count_params,
    reference_compat,
    tree_leaves,
)
from epnn_tpu_torch.ops import fused
from epnn_tpu_torch.ops.cluster import weighted_kmeans
from epnn_tpu_torch.testing import water_box
from epnn_tpu_torch.train import TrainConfig, train
from epnn_tpu_torch.train import loop as L
from test_torch_fused import _t, build, port_cfg, safe_k

torch.set_num_threads(2)

SMALL = JaxConfig(n_elems=9, h_dim=16, e_dim=16, msg_dim=8,
                  mlp_hidden=(8, 8), T=2)


def _close(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert np.abs(out - ref).max() < 1e-5 * (np.abs(ref).max() + 1.0)


def _port(params, cfg):
    pcfg = port_cfg(cfg)
    return fused.fuse_params(from_jax_params(params, pcfg), pcfg), pcfg


# ---------------------------------------------------------------------------
# the helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,bound,align", [
    (568320, 65536, 256), (142080, 65536, 256), (1000, 65536, 256),
    (1000, 0, 256), (200001, 65536, 256), (262144, 65536, 256),
    (300000, 65536, 256), (555555, 65536, 256), (1136640, 65536, 256),
    (213120, 65536, 256), (142080, 47360, 256), (99, 16, 8), (64, 16, 8)])
def test_balanced_row_chunk_matches_jax(n, bound, align):
    assert fused.balanced_row_chunk(n, bound, align) == \
        jax_fused.balanced_row_chunk(n, bound, align)


def _window_cases():
    """JAX's own cases (``tests/test_fused.py::test_neighbor_window_width``)
    and a random table in lattice and shuffled order."""
    n, k = 32, 4
    idx = np.zeros((n, k), np.int32)
    m = np.ones((n, k), np.float32)
    idx[:16] = np.arange(16)[:, None] + np.arange(k)[None, :] % 3
    idx[16:, -1] = n - 1
    m2 = m.copy()
    m2[16:, -1] = 0
    idxs = np.zeros((4, k), np.int32)
    idxs[:, -1] = n - 1
    g = np.random.default_rng(4)
    loc = np.clip(np.arange(200)[:, None] + g.integers(-9, 10, (200, 6)),
                  0, 199).astype(np.int32)
    lm = (g.uniform(size=(200, 6)) < 0.8).astype(np.float32)
    return [
        (idx[:16], m[:16], 8, 4, None), (idx, m, 16, 4, None),
        (idx, m, 0, 4, None), (idx, m2, 16, 4, None),
        (np.stack([idx[:16]] * 2), np.stack([m[:16]] * 2), 8, 4, None),
        (idxs, np.ones((4, k), np.float32), 4, 4, n),
        (loc, lm, 24, 8, None), (loc, lm, 7, 1, None),
        (g.permutation(loc), lm, 24, 8, None),
        (loc[None], np.zeros((1, 200, 6), np.float32), 16, 8, None),
    ]


@pytest.mark.parametrize("case", range(len(_window_cases())))
@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_neighbor_window_width_matches_jax(case, kind):
    """The same integer as JAX's for NumPy tables (the host loop) and for
    tensors (one reduction on the device)."""
    idx, m, chunk, align, rows = _window_cases()[case]
    want = jax_fused.neighbor_window_width(idx, m, chunk, align=align,
                                           table_rows=rows)
    if kind == "tensor":
        idx, m = torch.from_numpy(idx), torch.from_numpy(m)
    assert fused.neighbor_window_width(idx, m, chunk, align=align,
                                       table_rows=rows) == want


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sel", ["topk", "tuple2", "tuple3", "grid"])
@pytest.mark.parametrize("extra", [{}, {"far_cluster": 4},
                                   {"uniform_q0": True}],
                         ids=["exact", "cluster4", "collapse"])
def test_chunked_forward_matches_jax_and_full_width(rng, sel, extra):
    """``near_row_chunk`` at chunks that divide N, do not, equal N and
    exceed it: against JAX's chunked forward at the bar, and bit for bit
    against the port's full width, for every way of selecting."""
    cfg = JaxConfig(T=2)
    params, x, q0, xyz, mask, q_total = build(rng, cfg, 1, n=40,
                                              n_real=(34,))
    k = safe_k(xyz, mask, cfg.cutoff)
    fp, pcfg = _port(params, cfg)
    jkw = dict(cfg=cfg, block=40, neighbor_k=k, **extra)
    pkw = dict(neighbor_k=k, **extra)
    if sel in ("tuple2", "tuple3"):
        idx, nm, d2 = fused.build_neighbors(_t(xyz[0]), _t(mask[0]),
                                            cfg.cutoff, k, with_d2=True)
        nb = (idx[None], nm[None], d2[None])[:2 if sel == "tuple2" else 3]
        pkw["neighbors"] = nb
        jkw["neighbors"] = tuple(np.asarray(a) for a in nb)
    elif sel == "grid":
        grid = fused.batch_cell_grid(xyz, mask, cfg.cutoff)
        pkw["neighbor_grid"] = jkw["neighbor_grid"] = grid
    args = (_t(x), _t(q0), _t(xyz), _t(mask))
    with torch.no_grad():
        full = fused.forward_blocked(fp, *args, pcfg, **pkw)
        for chunk in (8, 16, 40, 64):
            kw = dict(pkw)
            if sel == "grid":
                kw["neighbor_grid"] = (*grid, "slices", chunk)
            out = fused.forward_blocked(fp, *args, pcfg,
                                        near_row_chunk=chunk, **kw)
            assert torch.equal(out, full), (chunk, sel)
    jkw2 = dict(jkw)
    if sel == "grid":
        jkw2["neighbor_grid"] = (*grid, "slices", 16)
    ref = jax_forward_blocked(jax_fuse_params(params, cfg), x, q0, xyz,
                              mask, near_row_chunk=16, **jkw2)
    _close(full.numpy(), ref)
    err = abs(float(full.double().sum()) - float(q_total[0]))
    assert err < 2e-6 * (float(full.abs().sum()) + 1.0)


def _line_system(rng, n=64, n_real=58):
    """Atoms on a line 1.1 Å apart: every row's neighbors lie within a few
    indices, so a window narrower than N covers every chunk."""
    cfg = JaxConfig(T=2)
    params, x, q0, _, mask, _ = build(rng, cfg, 1, n=n, n_real=(n_real,))
    line = np.zeros((1, n, 3), np.float32)
    line[0, :, 0] = np.arange(n) * 1.1
    xyz = line * mask[..., None]
    k = int(fused.max_neighbor_count(xyz[0], mask[0], cfg.cutoff)) + 2
    return cfg, params, x, q0, xyz, mask, k


@pytest.mark.parametrize("extra", [{}, {"far_cluster": 4}],
                         ids=["exact", "cluster4"])
def test_windowed_forward_matches_jax_and_full_width(rng, extra):
    """``near_window`` covering every chunk: JAX's windowed forward at the
    bar, the port's full width bit for bit; a window ≥ N is no window."""
    cfg, params, x, q0, xyz, mask, k = _line_system(rng)
    n = x.shape[1]
    fp, pcfg = _port(params, cfg)
    idx, nm, d2 = fused.build_neighbors(_t(xyz[0]), _t(mask[0]), cfg.cutoff,
                                        k, with_d2=True)
    nbrs = (idx[None], nm[None], d2[None])
    chunk = 16
    win = fused.neighbor_window_width(nbrs[0], nbrs[1], chunk, align=8)
    assert 0 < win < n
    args = (fp, _t(x), _t(q0), _t(xyz), _t(mask), pcfg)
    kw = dict(neighbor_k=k, neighbors=nbrs, **extra)
    with torch.no_grad():
        full = fused.forward_blocked(*args, **kw)
        out = fused.forward_blocked(*args, near_row_chunk=chunk,
                                    near_window=win, **kw)
        wide = fused.forward_blocked(*args, near_row_chunk=chunk,
                                     near_window=n + 8, **kw)
    assert torch.equal(out, full) and torch.equal(wide, full)
    ref = jax_forward_blocked(
        jax_fuse_params(params, cfg), x, q0, xyz, mask, cfg=cfg, block=n,
        neighbor_k=k, neighbors=tuple(np.asarray(a) for a in nbrs),
        near_row_chunk=chunk, near_window=win, **extra)
    _close(out.numpy(), ref)


def test_undersized_window_drops_pairs_deterministically(rng):
    """A window narrower than a chunk's spread drops the pairs outside it:
    the same charges on every call, the same as JAX's, and a visible
    conservation error — never another row's values."""
    cfg, params, x, q0, xyz, mask, k = _line_system(rng)
    fp, pcfg = _port(params, cfg)
    idx, nm, d2 = fused.build_neighbors(_t(xyz[0]), _t(mask[0]), cfg.cutoff,
                                        k, with_d2=True)
    nbrs = (idx[None], nm[None], d2[None])
    args = (fp, _t(x), _t(q0), _t(xyz), _t(mask), pcfg)
    kw = dict(neighbor_k=k, neighbors=nbrs, near_row_chunk=16)
    with torch.no_grad():
        full = fused.forward_blocked(*args, neighbor_k=k, neighbors=nbrs)
        small = [fused.forward_blocked(*args, near_window=8, **kw)
                 for _ in range(2)]
    assert torch.equal(small[0], small[1])
    assert not torch.equal(small[0], full)
    ref = jax_forward_blocked(
        jax_fuse_params(params, cfg), x, q0, xyz, mask, cfg=cfg,
        block=x.shape[1], neighbor_k=k,
        neighbors=tuple(np.asarray(a) for a in nbrs), near_row_chunk=16,
        near_window=8)
    _close(small[0].numpy(), ref)
    q_sum = float(q0.sum())
    assert abs(float(full.double().sum()) - q_sum) < 1e-5
    assert abs(float(small[0].double().sum()) - q_sum) > 1e-3


def test_forward_validation_matches_jax(rng):
    cfg = JaxConfig(T=2)
    params, x, q0, xyz, mask, _ = build(rng, cfg, 1)
    fp, pcfg = _port(params, cfg)
    args = (fp, _t(x), _t(q0), _t(xyz), _t(mask), pcfg)
    with pytest.raises(ValueError, match="near_row_chunk requires"):
        fused.forward_blocked(*args, near_row_chunk=8)
    with pytest.raises(ValueError, match="near_window requires"):
        fused.forward_blocked(*args, neighbor_k=8, near_window=16)


def test_neighbor_grid_4tuple(rng):
    """JAX's ``(ncells_pad, cell_cap, table_layout, row_chunk)``: the
    builder's row chunk gives the 2-tuple's charges bit for bit, and a
    row chunk with another layout raises as the builder does."""
    cfg = JaxConfig(T=2)
    params, x, q0, xyz, mask, _ = build(rng, cfg, 2)
    k = safe_k(xyz, mask, cfg.cutoff)
    fp, pcfg = _port(params, cfg)
    grid = fused.batch_cell_grid(xyz, mask, cfg.cutoff)
    args = (fp, _t(x), _t(q0), _t(xyz), _t(mask), pcfg)
    with torch.no_grad():
        two = fused.forward_blocked(*args, neighbor_k=k, neighbor_grid=grid)
        for ext in (("slices", 5), ("slices", 0), ("flat",), ("rows", 0)):
            four = fused.forward_blocked(*args, neighbor_k=k,
                                         neighbor_grid=(*grid, *ext))
            assert torch.equal(four, two), ext
        with pytest.raises(ValueError, match="row_chunk"):
            fused.forward_blocked(*args, neighbor_k=k,
                                  neighbor_grid=(*grid, "rows", 5))
    ref = jax_forward_blocked(jax_fuse_params(params, cfg), x, q0, xyz, mask,
                              cfg=cfg, block=8, neighbor_k=k,
                              neighbor_grid=(*grid, "slices", 5))
    _close(two.numpy(), ref)


@pytest.mark.parametrize("pack_to", [1, 4, 128])
@pytest.mark.parametrize("path", ["nbr", "dense"])
def test_pack_to_has_no_effect(rng, pack_to, path):
    """``pack_to`` is JAX's v5e lane packing: accepted (positionally too,
    at JAX's place), the same bits at every value, and JAX's charges."""
    cfg = JaxConfig(T=2)
    params, x, q0, xyz, mask, _ = build(rng, cfg, 1)
    k = safe_k(xyz, mask, cfg.cutoff) if path == "nbr" else None
    fp, pcfg = _port(params, cfg)
    args = (fp, _t(x), _t(q0), _t(xyz), _t(mask), pcfg)
    with torch.no_grad():
        ref = fused.forward_blocked(*args, 8, k, False)
        out = fused.forward_blocked(*args, 8, k, False, pack_to)
    assert torch.equal(out, ref)
    _close(out.numpy(), jax_forward_blocked(
        jax_fuse_params(params, cfg), x, q0, xyz, mask, cfg, 8, k, False,
        pack_to))


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

def _grads(params, cfg, args, **kw):
    """Every leaf's gradient of Σ_i w_i q_i through ``forward_blocked``."""
    pcfg = port_cfg(cfg)
    tree = from_jax_params(params, pcfg)
    leaves = tree_leaves(tree)
    for leaf in leaves:
        leaf.requires_grad_(True)
    q = fused.forward_blocked(fused.fuse_params(tree, pcfg), *args, pcfg,
                              **kw)
    (q * torch.arange(1.0, q.shape[-1] + 1.0)).sum().backward()
    return q.detach(), [torch.zeros_like(a) if a.grad is None else a.grad
                        for a in leaves]


def _rel_fro(got, want):
    return max(float(torch.linalg.norm(a - b))
               / max(float(torch.linalg.norm(b)), 1e-30)
               for a, b in zip(got, want, strict=True))


@pytest.mark.parametrize("kw", [
    dict(remat=True), dict(remat=True, near_row_chunk=8),
    dict(remat=True, near_row_chunk=16, near_window=40),
    dict(remat=True, uniform_q0=True, near_row_chunk=8),
    dict(near_row_chunk=8)], ids=["remat", "chunk", "window", "collapse",
                                  "chunk-no-remat"])
def test_remat_and_chunk_gradients(rng, kw):
    """Remat recomputes the same values: the same charges and gradients
    bit for bit; chunking changes only the order of the chunks' partial
    sums in the backward (1e-5 relative Frobenius a leaf)."""
    cfg = JaxConfig(T=2)
    params, x, q0, xyz, mask, _ = build(rng, cfg, 1, n=40, n_real=(34,))
    k = safe_k(xyz, mask, cfg.cutoff)
    args = (_t(x), _t(q0), _t(xyz), _t(mask))
    base = {"uniform_q0": True} if kw.get("uniform_q0") else {}
    q_ref, g_ref = _grads(params, cfg, args, neighbor_k=k, **base)
    q, g = _grads(params, cfg, args, neighbor_k=k, **kw)
    assert torch.equal(q, q_ref)
    if "near_row_chunk" in kw:
        assert _rel_fro(g, g_ref) <= 1e-5
    else:
        assert all(torch.equal(a, b) for a, b in zip(g, g_ref))


def test_remat_dense_path_gradients(rng):
    """``_forward_single`` (no ``neighbor_k``) with checkpointed rounds:
    the same charges and gradients bit for bit."""
    cfg = JaxConfig(T=2)
    params, x, q0, xyz, mask, _ = build(rng, cfg, 2)
    args = (_t(x), _t(q0), _t(xyz), _t(mask))
    q_ref, g_ref = _grads(params, cfg, args, block=8)
    q, g = _grads(params, cfg, args, block=8, remat=True)
    assert torch.equal(q, q_ref)
    assert all(torch.equal(a, b) for a, b in zip(g, g_ref))


@pytest.mark.parametrize("chunk", [0, 8])
def test_remat_refits_the_same_partition(rng, chunk):
    """Under ``far_cluster_grad`` the k-means fit inside a checkpointed
    round runs again in the backward: it gives the same bits (the fit has
    no randomness and no atomics), so remat's gradients are those of the
    un-rematerialized step."""
    cfg = JaxConfig(T=2)
    params, x, q0, xyz, mask, _ = build(rng, cfg, 1, n=40, n_real=(34,))
    k = safe_k(xyz, mask, cfg.cutoff)
    args = (_t(x), _t(q0), _t(xyz), _t(mask))
    kw = dict(neighbor_k=k, far_cluster=4, far_cluster_grad=True,
              near_row_chunk=chunk)
    fits = []
    real = fused.weighted_kmeans

    def spy(*a, **kwargs):
        out = real(*a, **kwargs)
        fits.append(tuple(t.detach().clone() for t in out))
        return out

    fused.weighted_kmeans = spy
    try:
        q, g = _grads(params, cfg, args, remat=True, **kw)
    finally:
        fused.weighted_kmeans = real
    # T = 2 without the collapse: two clustered rounds, fitted in the
    # forward and again in the backward's recompute (last round first)
    assert len(fits) == 4
    for fwd, again in ((fits[0], fits[3]), (fits[1], fits[2])):
        assert all(torch.equal(a, b) for a, b in zip(fwd, again))
    q_ref, g_ref = _grads(params, cfg, args, **kw)
    assert torch.equal(q, q_ref)
    assert all(torch.equal(a, b) for a, b in zip(g, g_ref))
    pj = torch.from_numpy(rng.normal(size=(50, 8)).astype(np.float32))
    w = torch.ones(50)
    one, two = (weighted_kmeans(pj, w, 4, differentiable=True)
                for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(one, two))


# ---------------------------------------------------------------------------
# Predictor
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_params():
    params = jax.tree_util.tree_map(np.asarray,
                                    jax_init_params(SMALL, jax.random.key(0)))
    return params, from_jax_params(params, port_cfg(SMALL))


def _cloud(n=48, seed=5):
    g = np.random.default_rng(seed)
    return Molecule(name="m", symbols=["C"] * n,
                    xyz=g.uniform(0, 9, (n, 3)).astype(np.float32),
                    total_charge=0.0)


def _shuffled_line(n=64, seed=7):
    line = np.zeros((n, 3), np.float32)
    line[:, 0] = np.arange(n) * 1.1
    perm = np.random.default_rng(seed).permutation(n)
    return Molecule(name="line", symbols=["C"] * n, xyz=line[perm],
                    total_charge=0.0)


def _both(mol, small_params, **kw):
    params, tree = small_params
    table = table_for_n_elems(9)
    return (Predictor(tree, port_cfg(SMALL), force_mode="blocked",
                      device="cpu", **kw),
            JaxPredictor(params=params, cfg=SMALL, force_mode="blocked",
                         **kw),
            pad_molecules([mol], table), jax_pad_molecules([mol],
                                                           jax_table(9)))


@pytest.mark.parametrize("kw", [
    dict(near_row_chunk=16), dict(near_row_chunk=16, reuse_neighbors=True),
    dict(near_row_chunk=16, reuse_neighbors=True, neighbor_skin=0.4),
    dict(near_row_chunk=16, far_cluster=4)],
    ids=["cold", "reuse", "skin", "cluster4"])
def test_predictor_explicit_chunk_matches_jax(small_params, kw):
    """An explicit ``near_row_chunk``: JAX's charges, and the port's
    unchunked charges bit for bit in each serving mode."""
    port, ref, bp, bj = _both(_cloud(), small_params, **kw)
    out = port.predict_batch(bp)
    _close(out, ref.predict_batch(bj))
    plain = Predictor(port.params, port.cfg, force_mode="blocked",
                      device="cpu", **{**kw, "near_row_chunk": 0})
    np.testing.assert_array_equal(out, plain.predict_batch(bp))


def test_predictor_auto_policy_matches_jax(small_params, monkeypatch):
    """The auto chunk with the thresholds patched small (both packages):
    off below, the balanced chunk above, riding the cell grid as JAX's
    4-tuple; the reused tables come from the chunked cell builder; the
    same charges as full width; ``near_row_chunk``/``near_window`` below
    −1 raise."""
    for mod in (infer, jax_infer):
        monkeypatch.setattr(mod, "HUGE_GRAPH_MIN_ATOMS", 16)
        monkeypatch.setattr(mod, "HUGE_GRAPH_ROW_CHUNK", 16)
        monkeypatch.setattr(mod, "CELL_GRID_MIN_ATOMS", 16)
    port, ref, bp, bj = _both(_cloud(), small_params, spatial_sort="off")
    assert port._near_chunk(bp) == ref._near_chunk(bj) == 16
    grid = port._neighbor_grid(bp)
    assert grid == ref._neighbor_grid(bj) and len(grid) == 4
    assert grid[3] == 16
    out = port.predict_batch(bp)
    _close(out, ref.predict_batch(bj))
    full = Predictor(port.params, port.cfg, force_mode="blocked",
                     device="cpu", near_row_chunk=0, spatial_sort="off")
    np.testing.assert_array_equal(out, full.predict_batch(bp))
    calls = []
    cell = fused.build_neighbors_cell
    monkeypatch.setattr(infer, "build_neighbors_cell", lambda *a, **kw: (
        calls.append(kw.get("row_chunk")), cell(*a, **kw))[1])
    reuse = Predictor(port.params, port.cfg, force_mode="blocked",
                      device="cpu", reuse_neighbors=True, spatial_sort="off")
    np.testing.assert_array_equal(reuse.predict_batch(bp), out)
    assert calls and all(c == 16 for c in calls)
    monkeypatch.setattr(infer, "HUGE_GRAPH_MIN_ATOMS", 200_000)
    assert port._near_chunk(bp) == 0 and len(port._neighbor_grid(bp)) == 2
    for field in ("near_row_chunk", "near_window"):
        with pytest.raises(ValueError, match=field):
            Predictor(port.params, port.cfg, device="cpu", **{field: -2})


def test_predictor_sorts_and_windows_chunked_batches(small_params,
                                                     monkeypatch):
    """A chunked batch below ``CELL_SORT_MIN_ATOMS`` is cell-sorted under
    ``spatial_sort='auto'`` (its windows need the order), its auto window
    comes from the reused tables and is narrower than the batch, and the
    charges come back in the caller's order, JAX's at the bar, conserved;
    the widths equal JAX's."""
    for mod in (infer, jax_infer):
        monkeypatch.setattr(mod, "HUGE_GRAPH_MIN_ATOMS", 16)
        monkeypatch.setattr(mod, "HUGE_GRAPH_ROW_CHUNK", 16)
        monkeypatch.setattr(mod, "CELL_GRID_MIN_ATOMS", 16)
    mol = _shuffled_line()
    port, ref, bp, bj = _both(mol, small_params, reuse_neighbors=True)
    out = port.predict_batch(bp)
    _close(out, ref.predict_batch(bj))
    assert abs(float(out.astype(np.float64).sum())) < 1e-4
    widths = [w for d in port._winw_cache.values() for w in d.values()]
    jwidths = [w for d in ref._winw_cache.values() for w in d.values()]
    assert widths == jwidths and all(0 < w < bp.padded_atoms
                                     for w in widths)
    unsorted = Predictor(port.params, port.cfg, force_mode="blocked",
                         device="cpu", reuse_neighbors=True,
                         spatial_sort="off")
    _close(out, unsorted.predict_batch(bp))


def test_predictor_cold_window_from_cell_keys(small_params, monkeypatch):
    """A cold chunked call of a sorted batch takes its window from the
    sorted cell keys (no tables in hand): JAX's width, JAX's charges."""
    for mod in (infer, jax_infer):
        monkeypatch.setattr(mod, "HUGE_GRAPH_MIN_ATOMS", 16)
        monkeypatch.setattr(mod, "HUGE_GRAPH_ROW_CHUNK", 16)
    mol = _shuffled_line(n=96, seed=3)
    port, ref, bp, bj = _both(mol, small_params)
    out = port.predict_batch(bp)
    _close(out, ref.predict_batch(bj))
    (twin, _), (jtwin, _) = port._spatial_view(bp), ref._spatial_view(bj)
    w = port._near_window_for(twin, None, 16, ("nbr", 0))
    assert w == ref._near_window_for(jtwin, None, 16, ("nbr", 0))
    assert 0 < w < bp.padded_atoms
    assert port._keys_window_width(port._geom_keys[twin], [(0, 96)], 16) \
        == JaxPredictor._keys_window_width(ref._geom_keys[jtwin],
                                           [(0, 96)], 16)
    explicit = Predictor(port.params, port.cfg, force_mode="blocked",
                         device="cpu", near_window=w)
    np.testing.assert_array_equal(explicit.predict_batch(bp), out)


def test_predictor_exact_far_field_warning(small_params, monkeypatch):
    """The exact far field from 2 × ``HUGE_GRAPH_MIN_ATOMS`` padded atoms
    warns, as JAX's does; the clustered tier does not."""
    monkeypatch.setattr(infer, "HUGE_GRAPH_MIN_ATOMS", 20)
    port, _, bp, _ = _both(_cloud(), small_params, near_row_chunk=0)
    with pytest.warns(UserWarning, match="exact far field"):
        port.predict_batch(bp)
    clustered = Predictor(port.params, port.cfg, force_mode="blocked",
                          device="cpu", far_cluster=4, near_row_chunk=0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        clustered.predict_batch(bp)


def test_predictor_diagnostics_and_vjp_chunked(small_params, monkeypatch):
    """``far_field_diagnostics``, ``calibrate_far_cluster`` and
    ``charge_position_vjp`` of a chunked Predictor: the unchunked results
    (the pullback within the gradient bar: chunk partials add in another
    order)."""
    port, _, bp, _ = _both(_cloud(), small_params, far_cluster=4,
                           near_row_chunk=16)
    full = Predictor(port.params, port.cfg, force_mode="blocked",
                     device="cpu", far_cluster=4, near_row_chunk=0)
    d, d0 = port.far_field_diagnostics(bp), full.far_field_diagnostics(bp)
    for key in ("max_radius", "message_bound", "max_abs_dq"):
        np.testing.assert_array_equal(d[key], d0[key])
    c = port.calibrate_far_cluster(bp, 1.0, candidates=(4, 8))
    assert c == full.calibrate_far_cluster(bp, 1.0, candidates=(4, 8))
    cot = np.random.default_rng(1).normal(size=bp.q0.shape).astype(
        np.float32)
    g, g0 = port.charge_position_vjp(bp, cot), full.charge_position_vjp(
        bp, cot)
    assert np.linalg.norm(g - g0) <= 1e-5 * np.linalg.norm(g0)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def toy_train_mols():
    """``tests/test_train.py``'s molecules, in the port's type."""
    g = np.random.default_rng(3)
    mols = []
    for i in range(24):
        n = int(g.integers(3, 12))
        symbols = [str(s) for s in g.choice(["H", "C", "N", "O"], size=n)]
        xyz = g.uniform(-3, 3, size=(n, 3)).astype(np.float32)
        q_total = float(g.integers(-1, 2))
        labels = g.normal(0, 0.2, size=n).astype(np.float32)
        labels += (q_total - labels.sum()) / n
        mols.append(Molecule(name=f"m{i}", symbols=symbols, xyz=xyz,
                             total_charge=q_total, labels=labels))
    return mols


TRAIN_CFG = JaxConfig(h_dim=16, e_dim=16, msg_dim=8, mlp_hidden=(8, 8), T=2)
SMALL_PORT = port_cfg(TRAIN_CFG)


def test_train_step_fused_chunk_remat_matches_jax(toy_train_mols):
    """Four chunked (and windowed) remat steps against JAX's, after
    ``tests/test_train.py::test_train_step_fused_near_row_chunk``: the
    losses at rtol 2e-4, and against the port's full-width steps without
    remat; the predictions conserve."""
    cfg = TRAIN_CFG
    pcfg = port_cfg(cfg)
    batch = pad_molecules(toy_train_mols[:6], table_for_n_elems(10),
                          pad_to=16)
    w = np.ones((6,), np.float32)
    args = (batch.x, batch.q0, batch.xyz, batch.node_mask, batch.y, w)
    idx, nm, _ = fused.build_neighbors_batch(_t(batch.xyz),
                                             _t(batch.node_mask),
                                             cfg.cutoff, 12)
    win = fused.neighbor_window_width(idx, nm, 8, align=2)
    assert 0 < win < 16
    jtc = jax_loop.TrainConfig(learning_rate=3e-3)
    opt = jax_loop.make_optimizer(jtc)
    params = jax.tree_util.tree_map(
        np.asarray, jax_loop.create_state(cfg, jtc,
                                          jax.random.key(0)).params)
    losses = {}
    for label, kw in (("full", dict(remat=False)),
                      ("chunk", dict(near_row_chunk=8)),
                      ("chunk+win", dict(near_row_chunk=8,
                                         near_window=win))):
        jstate = jax_loop.create_state(cfg, jtc, jax.random.key(0))
        state = L.create_state(pcfg, TrainConfig(learning_rate=3e-3),
                               device="cpu",
                               params=from_jax_params(params, pcfg))
        jl, pl = [], []
        for _ in range(4):
            jstate, jloss, _, _ = jax_loop.train_step_fused(
                jstate, cfg, "masked_mse", opt, 8, 12, *args,
                **{"remat": True, **kw})
            _, loss, pred, _ = L.train_step_fused(
                state, pcfg, "masked_mse", None, 8, 12,
                *(_t(a) for a in args), **kw)
            jl.append(float(jloss))
            pl.append(float(loss))
        cons = pred.sum(1) - _t(batch.q0 * batch.node_mask).sum(1)
        assert float(cons.abs().max()) < 1e-4, label
        np.testing.assert_allclose(pl, jl, rtol=2e-4)
        losses[label] = pl
    assert losses["full"][-1] < losses["full"][0]
    np.testing.assert_allclose(losses["chunk"], losses["full"], rtol=2e-4)
    np.testing.assert_allclose(losses["chunk+win"], losses["full"],
                               rtol=2e-4)


def test_eval_step_fused_chunked_matches_jax(toy_train_mols):
    cfg = TRAIN_CFG
    pcfg = port_cfg(cfg)
    batch = pad_molecules(toy_train_mols[:4], table_for_n_elems(10),
                          pad_to=16)
    args = (batch.x, batch.q0, batch.xyz, batch.node_mask, batch.y,
            np.ones((4,), np.float32))
    params = jax.tree_util.tree_map(np.asarray,
                                    jax_init_params(cfg, jax.random.key(1)))
    jloss, jpred, _ = jax_loop.eval_step_fused(
        params, cfg, "masked_mse", 8, 12, *args, near_row_chunk=8)
    loss, pred, _ = L.eval_step_fused(
        from_jax_params(params, pcfg), pcfg, "masked_mse", 8, 12,
        *(_t(a) for a in args), near_row_chunk=8)
    _close(pred.numpy(), jpred)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * (abs(float(jloss)) + 1)


def test_trainer_auto_chunk_forces_remat(toy_train_mols, monkeypatch):
    """``near_row_chunk=-1`` with ``HUGE_GRAPH_MIN_ATOMS`` patched small:
    every fused bucket trains chunked at the balanced chunk with remat
    forced, to the unchunked run's losses (rtol 1e-4, JAX's bar), with
    tables from the chunked cell builder, no warning; explicit 0 warns."""
    base = dict(epochs=2, batch_size=2, dense_max_atoms=4, seed=3)
    ref = train(toy_train_mols, SMALL_PORT, TrainConfig(**base),
                progress=False, device="cpu")
    monkeypatch.setattr(infer, "HUGE_GRAPH_MIN_ATOMS", 8)
    monkeypatch.setattr(infer, "HUGE_GRAPH_ROW_CHUNK", 8)
    monkeypatch.setattr(infer, "CELL_GRID_MIN_ATOMS", 8)
    seen, cells = [], []
    step = L.train_step_fused
    monkeypatch.setattr(L, "train_step_fused", lambda *a, **kw: (
        seen.append((a[6].shape[1], kw["near_row_chunk"], kw["remat"])),
        step(*a, **kw))[1])
    cell = L.build_neighbors_cell
    monkeypatch.setattr(L, "build_neighbors_cell", lambda *a, **kw: (
        cells.append(kw["row_chunk"]), cell(*a, **kw))[1])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        auto = train(toy_train_mols, SMALL_PORT, TrainConfig(**base),
                     progress=False, device="cpu")
    assert seen and all(
        ch == fused.balanced_row_chunk(pad, 8) and remat
        if 8 < pad else ch == 0 for pad, ch, remat in seen), seen
    assert any(ch for _, ch, _ in seen) and cells and all(
        c in (0, 8) for c in cells)
    for a, r in zip(auto.history, ref.history, strict=True):
        np.testing.assert_allclose(a["train_loss"], r["train_loss"],
                                   rtol=1e-4)
        np.testing.assert_allclose(a["val_loss"], r["val_loss"], rtol=1e-4)
    with pytest.warns(UserWarning, match="near_row_chunk=0"):
        train(toy_train_mols, SMALL_PORT,
              TrainConfig(**base, near_row_chunk=0), progress=False,
              device="cpu")


def test_trainer_validation_matches_jax(toy_train_mols):
    """JAX's rules (``epnn_tpu/train/loop.py:478-487``): a window needs a
    chunk, a chunk needs remat; a window that no bucket will use warns."""
    with pytest.raises(ValueError, match="near_window requires"):
        train(toy_train_mols, SMALL_PORT,
              TrainConfig(epochs=1, near_window=8, near_row_chunk=0),
              progress=False, device="cpu")
    with pytest.raises(ValueError, match="requires remat"):
        train(toy_train_mols, SMALL_PORT,
              TrainConfig(epochs=1, near_row_chunk=8), progress=False,
              device="cpu")
    with pytest.warns(UserWarning, match="no training bucket will chunk"):
        train(toy_train_mols, SMALL_PORT,
              TrainConfig(epochs=1, near_window=8), progress=False,
              device="cpu")


# ---------------------------------------------------------------------------
# the API repairs
# ---------------------------------------------------------------------------

def test_pair_mask_matches_jax():
    mols = [water_box(3, seed=1), water_box(5, seed=2, charge=1.0)]
    port = pad_molecules(mols, table_for_n_elems(10))
    ref = jax_pad_molecules(mols, jax_table(10))
    np.testing.assert_array_equal(port.pair_mask(), ref.pair_mask())


def test_count_params_reference_compat_rbfconfig_match_jax():
    params = jax_init_params(TRAIN_CFG, jax.random.key(2))
    tree = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                           SMALL_PORT)
    assert count_params(tree) == count_params({"params": tree}) == \
        jax_count_params(params)
    assert count_params(jax.tree_util.tree_map(np.asarray,
                                               params)["params"]) == \
        jax_count_params(params)
    assert dataclasses.asdict(reference_compat(SMALL_PORT)) == \
        dataclasses.asdict(jax_reference_compat(TRAIN_CFG))
    for kw in ({}, dict(e_dim=16, cutoff=4.5, eta=1.0)):
        np.testing.assert_array_equal(RBFConfig(**kw).centers(),
                                      JaxRBFConfig(**kw).centers())
        assert dataclasses.asdict(RBFConfig(**kw)) == \
            dataclasses.asdict(JaxRBFConfig(**kw))


def _names(fn):
    return list(inspect.signature(fn).parameters)


@pytest.mark.parametrize("name", ["train_step", "eval_step",
                                  "train_step_fused", "eval_step_fused"])
def test_train_step_signatures_match_jax(name):
    """JAX's parameter names in JAX's order (``jax.jit`` keeps the
    wrapped function's signature), with JAX's defaults."""
    port, ref = getattr(L, name), getattr(jax_loop, name)
    assert _names(port) == _names(ref)
    for p, r in zip(inspect.signature(port).parameters.values(),
                    inspect.signature(ref).parameters.values()):
        assert p.default == r.default, (name, p.name)


def test_forward_blocked_signature_matches_jax():
    assert _names(fused.forward_blocked) == _names(
        jax_fused.forward_blocked)
    for p, r in zip(inspect.signature(fused.forward_blocked)
                    .parameters.values(),
                    inspect.signature(jax_fused.forward_blocked)
                    .parameters.values()):
        assert p.default == r.default, p.name


def test_train_step_takes_the_module_or_its_config(toy_train_mols):
    """JAX's ``model`` position takes the port's ``EPNN`` (it carries
    ``cfg``) or the config: the same update either way."""
    batch = pad_molecules(toy_train_mols[:4], table_for_n_elems(10))
    args = [_t(a) for a in (batch.x, batch.q0, batch.xyz, batch.node_mask,
                            batch.y, np.ones(4, np.float32))]
    out = []
    for model in (SMALL_PORT, EPNN(SMALL_PORT)):
        state = L.create_state(SMALL_PORT, TrainConfig(), seed=1,
                               device="cpu")
        _, loss, _, _ = L.train_step(state, model, "masked_mse", None, *args)
        eloss, _, _ = L.eval_step(state.params, model, "masked_mse", *args)
        out.append((loss, eloss, [p.detach() for p in
                                  tree_leaves(state.params)]))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    assert all(torch.equal(a, b) for a, b in zip(out[0][2], out[1][2]))
