"""The port's large-graph and MD serving path against the JAX package, on
the CPU: the cell-list neighbor builder (``cell_grid_params``,
``build_neighbors_cell``), ``cell_sort_key``, ``refresh_neighbor_d2``, the
forward's ``neighbor_grid``, ``Predictor``'s cell selection, neighbor
reuse, spatial sort and Verlet-skin ``predict_trajectory``, and the
trainer's cell-built bucket tables.

Tolerances.  Grid bounds, counts and neighbor sets are exact.  XLA on the
CPU and PyTorch round the d² sum differently (XLA may contract a product
into an add), so d² is held to 2 float32 ulp and idx order wherever two
neighbouring slots' d² differ by more than that.  Within the port, the
cell builder and top-k give the same d² bits for every pair, and d²(i, j)
== d²(j, i).  Charges: 1e-5·(max|q| + 1), the JAX suite's bar between
two paths of the same math (``tests/test_fused.py``).
"""

import os

import jax
import numpy as np
import pytest
import torch

import epnn_tpu.infer as jax_infer
from epnn_tpu.data.dataset import pad_molecules as jax_pad_molecules
from epnn_tpu.elements import table_for_n_elems as jax_table
from epnn_tpu.infer import Predictor as JaxPredictor
from epnn_tpu.models import EPNNConfig as JaxConfig
from epnn_tpu.models import init_params as jax_init_params
from epnn_tpu.ops import fused as jax_fused
from epnn_tpu.train import TrainConfig as JaxTrainConfig
from epnn_tpu.train import train as jax_train
from epnn_tpu_torch import infer
from epnn_tpu_torch.data import Molecule, pad_molecules
from epnn_tpu_torch.elements import table_for_n_elems
from epnn_tpu_torch.infer import Predictor
from epnn_tpu_torch.io.checkpoint import from_jax_params
from epnn_tpu_torch.models import EPNNConfig
from epnn_tpu_torch.ops import fused
from epnn_tpu_torch.testing import water_box
from epnn_tpu_torch.train import TrainConfig, train
from epnn_tpu_torch.train import loop as port_loop

torch.set_num_threads(2)

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "trained", "mixed_b16")
CUTOFF = 3.0


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _face_points():
    """Atoms on a lattice whose x coordinates sit on cell faces: at and one
    float32 step around m/_CELL_INV, so that (x − min)·inv lands exactly
    on an integer for some of them."""
    inv = np.float32(fused._CELL_INV(CUTOFF))
    xs = [np.float32(0.0)]
    for m in (1, 2, 3):
        x = np.float32(m / inv)
        xs += [np.nextafter(x, np.float32(0)), x,
               np.nextafter(x, np.float32(9))]
    xs = np.array(xs, np.float32)
    assert any(float(x * inv) == np.floor(x * inv) > 0 for x in xs)
    yz = np.array([[0.0, 0.0], [0.7, 1.1], [2.9, 0.4]], np.float32)
    pts = np.array([[x, y, z] for x in xs for y, z in yz], np.float32)
    return pts, np.ones(len(pts), np.float32)


def _case(name):
    """(xyz, node_mask) of one geometry: (n, 3) float32, (n,) float32."""
    g = np.random.default_rng(5)
    if name == "water":
        xyz = np.concatenate([water_box(60, seed=4).xyz,
                              np.zeros((4, 3), np.float32)])
        mask = np.r_[np.ones(180), np.zeros(4)].astype(np.float32)
        return xyz, mask
    if name == "uniform":
        xyz = g.uniform(0, 14, size=(300, 3)).astype(np.float32)
        mask = np.ones(300, np.float32)
        mask[-9:] = 0.0
        return xyz, mask
    if name == "face":
        return _face_points()
    if name == "coincident":
        return np.zeros((8, 3), np.float32), np.ones(8, np.float32)
    if name == "one_real":
        return (np.zeros((8, 3), np.float32),
                np.r_[1.0, np.zeros(7)].astype(np.float32))
    if name == "all_masked":
        return np.zeros((8, 3), np.float32), np.zeros(8, np.float32)
    assert name == "cap_over_32"
    xyz = np.zeros((48, 3), np.float32)
    xyz[:40] = g.uniform(0, 1.5, size=(40, 3))
    xyz[40:] = g.uniform(5, 8, size=(8, 3))
    return xyz, np.ones(48, np.float32)


CASES = ["water", "uniform", "face", "coincident", "one_real", "all_masked",
         "cap_over_32"]


def _d2_close(a, b):
    """|a − b| within 2 float32 ulp of the larger."""
    big = np.maximum(np.abs(a), np.abs(b)).astype(np.float32)
    return np.abs(a - b) <= 2 * np.spacing(big)


def _assert_tables_match(port, ref, n):
    """Port (idx, mask, d2) against JAX's: the same set on every row, d²
    to 2 ulp, and the same idx wherever a slot's d² is more than 2 ulp
    from both neighbouring slots'."""
    ip, mp, dp = (np.asarray(a) for a in port)
    ij, mj, dj = (np.asarray(a) for a in ref)
    assert ip.shape == ij.shape
    np.testing.assert_array_equal(mp, mj)
    for r in range(n):
        assert set(ip[r][mp[r] > 0]) == set(ij[r][mj[r] > 0]), r
    assert _d2_close(dp, dj).all()
    live = mj > 0
    tied = np.zeros_like(live)
    near = ~_d2_close(dj[:, 1:], dj[:, :-1])
    tied[:, 1:] |= ~near
    tied[:, :-1] |= ~near
    order = live & ~tied
    np.testing.assert_array_equal(ip[order], ij[order])


@pytest.mark.parametrize("name", CASES)
def test_cell_grid_params_matches_jax(name):
    xyz, mask = _case(name)
    got = fused.cell_grid_params(xyz, mask, CUTOFF)
    assert got == jax_fused.cell_grid_params(xyz, mask, CUTOFF)
    if name == "coincident":
        assert got[1] == 8
    if name == "cap_over_32":
        assert got[1] > 32


@pytest.mark.parametrize("name", CASES)
def test_build_neighbors_cell_matches_jax(name):
    """count_only and the with_d2 tables against JAX's builder: padding
    rows empty, degenerate geometries without false pairs."""
    xyz, mask = _case(name)
    nc, cap = fused.cell_grid_params(xyz, mask, CUTOFF)
    count = fused.build_neighbors_cell(_t(xyz), _t(mask), CUTOFF, 1, nc, cap,
                                       count_only=True)
    assert count.dim() == 0
    assert int(count) == int(jax_fused.build_neighbors_cell(
        xyz, mask, CUTOFF, 1, nc, cap, count_only=True))
    k = int(count) + 2
    port = fused.build_neighbors_cell(_t(xyz), _t(mask), CUTOFF, k, nc, cap,
                                      with_d2=True)
    ref = jax_fused.build_neighbors_cell(xyz, mask, CUTOFF, k, nc, cap,
                                         with_d2=True)
    _assert_tables_match(port, ref, len(xyz))
    idx, m = fused.build_neighbors_cell(_t(xyz), _t(mask), CUTOFF, k, nc,
                                        cap)
    assert torch.equal(idx, port[0]) and torch.equal(m, port[1])
    m = m.numpy()
    assert (m[mask == 0] == 0).all()
    assert m.sum(1).max() == int(count)
    if name == "coincident":
        assert (m.sum(1) == 7).all()
    if name in ("one_real", "all_masked"):
        assert m.sum() == 0


def test_row_chunk_and_layouts_give_the_same_bits():
    xyz, mask = _case("uniform")
    nc, cap = fused.cell_grid_params(xyz, mask, CUTOFF)
    args = (_t(xyz), _t(mask), CUTOFF)
    count = int(fused.build_neighbors_cell(*args, 1, nc, cap,
                                           count_only=True))
    k = count + 2
    ref = fused.build_neighbors_cell(*args, k, nc, cap, with_d2=True)
    for chunk in (50, 128, 300, 512):
        out = fused.build_neighbors_cell(*args, k, nc, cap, with_d2=True,
                                         row_chunk=chunk)
        for a, b in zip(ref, out):
            assert torch.equal(a, b), chunk
        assert int(fused.build_neighbors_cell(
            *args, 1, nc, cap, count_only=True, row_chunk=chunk)) == count
    for layout in fused.CELL_TABLE_LAYOUTS:
        out = fused.build_neighbors_cell(*args, k, nc, cap, with_d2=True,
                                         table_layout=layout)
        for a, b in zip(ref, out):
            assert torch.equal(a, b), layout
    for build, a in ((fused.build_neighbors_cell, args),
                     (jax_fused.build_neighbors_cell, (xyz, mask, CUTOFF))):
        with pytest.raises(ValueError, match="slices"):
            build(*a, k, nc, cap, table_layout="rows", row_chunk=64)


@pytest.mark.parametrize("name", ["water", "uniform", "face", "cap_over_32"])
def test_cell_builder_matches_topk(name):
    """The port's cell builder and its top-k (build_neighbors): the same
    set on every row, the same d² bits for every pair, and each pair's d²
    the same both ways."""
    xyz, mask = _case(name)
    nc, cap = fused.cell_grid_params(xyz, mask, CUTOFF)
    k = int(fused.build_neighbors_cell(_t(xyz), _t(mask), CUTOFF, 1, nc,
                                       cap, count_only=True)) + 2
    cell = [a.numpy() for a in fused.build_neighbors_cell(
        _t(xyz), _t(mask), CUTOFF, k, nc, cap, with_d2=True)]
    topk = [a.numpy() for a in fused.build_neighbors(
        _t(xyz), _t(mask), CUTOFF, k, with_d2=True)]

    def pairs(idx, m, d2):
        return {(r, int(idx[r, s])): d2[r, s].tobytes()
                for r, s in zip(*np.nonzero(m > 0))}

    pc = pairs(*cell)
    assert pc == pairs(*topk)
    assert all(pc[(j, i)] == v for (i, j), v in pc.items())


def test_cell_sort_key_matches_jax():
    for xyz in (water_box(60, seed=4).xyz, _case("uniform")[0]):
        key, span = fused.cell_sort_key(xyz, CUTOFF)
        key_j, span_j = jax_fused.cell_sort_key(xyz, CUTOFF)
        np.testing.assert_array_equal(key, key_j)
        assert span == span_j


def test_refresh_neighbor_d2_matches_jax():
    """Two graphs' skin tables against JAX's refresh, and against the
    builder's own d² on every live slot, bit for bit."""
    mols = [water_box(20, seed=1), water_box(18, seed=2)]
    b = pad_molecules(mols, table_for_n_elems(10))
    idx, m, d2 = fused.build_neighbors_batch(_t(b.xyz), _t(b.node_mask),
                                             CUTOFF + 0.5, 24)
    got = fused.refresh_neighbor_d2(_t(b.xyz), idx)
    assert torch.equal(got * m, d2 * m)
    ref = np.asarray(jax_fused.refresh_neighbor_d2(b.xyz,
                                                   idx.numpy().astype(
                                                       np.int32)))
    assert _d2_close(got.numpy(), ref).all()


def test_forward_neighbor_grid_matches_jax():
    """forward_blocked(neighbor_grid=...) selects in the forward through
    the cell builder: against JAX's same call and the port's top-k."""
    from test_torch_fused import build, port_cfg, safe_k

    cfg = JaxConfig()
    params, x, q0, xyz, mask, _ = build(np.random.default_rng(0), cfg, 2,
                                        n=48, n_real=(48, 44))
    k = safe_k(xyz, mask, cfg.cutoff)
    grid = fused.batch_cell_grid(xyz, mask, cfg.cutoff)
    ref = np.asarray(jax_fused.forward_blocked(
        jax_fused.fuse_params(params, cfg), x, q0, xyz, mask, cfg, block=8,
        neighbor_k=k, neighbor_grid=grid))
    pcfg = port_cfg(cfg)
    pf = fused.fuse_params(from_jax_params(params), pcfg)
    args = (pf, _t(x), _t(q0), _t(xyz), _t(mask), pcfg)
    with torch.no_grad():
        out = fused.forward_blocked(*args, neighbor_k=k,
                                    neighbor_grid=grid).numpy()
        topk = fused.forward_blocked(*args, neighbor_k=k).numpy()
    bar = 1e-5 * (np.abs(ref).max() + 1.0)
    assert np.abs(out - ref).max() < bar
    assert np.abs(out - topk).max() < bar


# ---------------------------------------------------------------------------
# Predictor on trained/mixed_b16
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixed():
    return (Predictor.from_checkpoint(CKPT, device="cpu"),
            JaxPredictor.from_checkpoint(CKPT))


def _batches(mols):
    return (pad_molecules(mols, table_for_n_elems(10)),
            jax_pad_molecules(mols, jax_table(10)))


def _close(out, ref):
    assert np.abs(out - ref).max() < 1e-5 * (np.abs(ref).max() + 1.0)


@pytest.fixture(scope="module")
def box1032():
    return [water_box(342, seed=9, charge=1.0)]


@pytest.mark.parametrize("method", ["auto", "cell", "topk"])
def test_predictor_neighbor_method_matches_jax(mixed, box1032, method):
    """water_box(342): 1,026 atoms padded to 1,032, past
    CELL_GRID_MIN_ATOMS, so 'auto' takes the cell builder."""
    port, ref = mixed
    bp, bj = _batches(box1032)
    assert bp.padded_atoms >= infer.CELL_GRID_MIN_ATOMS
    p = Predictor(port.params, port.cfg, device="cpu",
                  neighbor_method=method)
    j = JaxPredictor(ref.params, ref.cfg, neighbor_method=method)
    assert (p._neighbor_grid(bp) is None) == (method == "topk")
    assert p._neighbor_grid(bp) == j._neighbor_grid(bj)
    assert p._neighbor_k(bp) == j._neighbor_k(bj)
    out = p.predict_batch(bp)
    _close(out, j.predict_batch(bj))
    assert abs(float(out.astype(np.float64).sum()) - 1.0) < 1e-4


def test_predictor_selects_by_cell_builder_from_the_threshold(
        mixed, box1032, monkeypatch):
    """'auto' calls the cell builder (count once a geometry, one build a
    graph a call) and never top-k at 1,032 atoms; below the threshold
    top-k selects and the grid is None."""
    port, _ = mixed
    calls = {"cell": 0, "count": 0, "topk": 0}
    cell, topk = fused.build_neighbors_cell, fused.build_neighbors

    def spy_cell(*a, **kw):
        calls["count" if kw.get("count_only") else "cell"] += 1
        return cell(*a, **kw)

    def spy_topk(*a, **kw):
        calls["topk"] += 1
        return topk(*a, **kw)

    for mod in (fused, infer):
        monkeypatch.setattr(mod, "build_neighbors_cell", spy_cell)
    monkeypatch.setattr(fused, "build_neighbors", spy_topk)
    bp, _ = _batches(box1032)
    p = Predictor(port.params, port.cfg, device="cpu")
    p.predict_batch(bp)
    p.predict_batch(bp)
    assert calls == {"cell": 2, "count": 1, "topk": 0}
    small, _ = _batches([water_box(100, seed=3)])
    assert p._neighbor_grid(small) is None
    p.predict_batch(small)
    assert calls["topk"] == 1 and calls["cell"] == 2


def test_reuse_neighbors_rebuilds_on_in_place_edits(mixed):
    """reuse_neighbors keeps the tables on the device; an in-place edit
    of batch.xyz rebuilds them through the CRC guard; charges follow
    JAX's before and after."""
    port, ref = mixed
    box = [water_box(96, seed=11)]
    bp, bj = _batches(box)
    p = Predictor(port.params, port.cfg, device="cpu", reuse_neighbors=True)
    j = JaxPredictor(ref.params, ref.cfg, reuse_neighbors=True)
    _close(p.predict_batch(bp), j.predict_batch(bj))
    tables = p._nbr_cache[bp][1]
    assert all(isinstance(t, torch.Tensor) for t in tables)
    assert p._neighbors(bp, p._neighbor_k(bp)) is tables
    shift = np.random.default_rng(1).normal(scale=0.05, size=bp.xyz.shape)
    shift = (shift * bp.node_mask[..., None]).astype(np.float32)
    bp.xyz += shift
    bj.xyz += shift
    out = p.predict_batch(bp)
    assert p._nbr_cache[bp][1] is not tables
    _close(out, j.predict_batch(bj))
    cold = Predictor(port.params, port.cfg, device="cpu")
    _close(out, cold.predict_batch(bp))


def test_spatial_sort_on_matches_jax(mixed):
    """spatial_sort='on' at 300 atoms: charges in the caller's order,
    against JAX's sorted Predictor and the port's unsorted one."""
    port, ref = mixed
    box = [water_box(100, seed=6, charge=-1.0)]
    bp, bj = _batches(box)
    p = Predictor(port.params, port.cfg, device="cpu", spatial_sort="on")
    j = JaxPredictor(ref.params, ref.cfg, spatial_sort="on")
    view = p._spatial_view(bp)
    assert view is not None
    assert not np.array_equal(view[1][0], np.arange(bp.padded_atoms))
    out = p.predict_batch(bp)
    _close(out, j.predict_batch(bj))
    _close(out, port.predict_batch(bp))
    assert abs(float(out.astype(np.float64).sum()) + 1.0) < 1e-4


def test_spatial_view_at_the_threshold_matches_jax(mixed):
    """At CELL_SORT_MIN_ATOMS padded atoms 'auto' sorts: the permutation,
    its inverse and the sorted twin equal JAX's (no forward); one
    molecule fewer (below the threshold) does not sort in either."""
    port, ref = mixed
    big = [water_box(5462, seed=3)]
    bp, bj = _batches(big)
    assert bp.padded_atoms >= infer.CELL_SORT_MIN_ATOMS
    p = Predictor(port.params, port.cfg, device="cpu")
    j = JaxPredictor(ref.params, ref.cfg)
    (b2, inv), (b2j, inv_j) = p._spatial_view(bp), j._spatial_view(bj)
    np.testing.assert_array_equal(inv, inv_j)
    np.testing.assert_array_equal(p._sort_cache[bp][1],
                                  j._sort_cache[bj][1])
    for f in ("x", "xyz", "q0", "node_mask"):
        np.testing.assert_array_equal(getattr(b2, f), getattr(b2j, f))
    assert p._spatial_view(bp)[0] is b2      # cached behind the CRC
    below, below_j = _batches([water_box(5458, seed=3)])
    assert below.padded_atoms < infer.CELL_SORT_MIN_ATOMS
    assert p._spatial_view(below) is None
    assert j._spatial_view(below_j) is None


# ---------------------------------------------------------------------------
# Verlet-skin MD serving (the JAX suite's TestVerletSkin setup)
# ---------------------------------------------------------------------------

SKIN_CFG = dict(n_elems=10, h_dim=16, e_dim=16, msg_dim=8,
                mlp_hidden=(8, 8), T=2)


@pytest.fixture(scope="module")
def skin_params():
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a + 0.3 if a.ndim == 1 else a),
        jax_init_params(JaxConfig(**SKIN_CFG), jax.random.key(0)))
    return params, from_jax_params(params)


def _trajectory(natoms=48, frames=6, seed=3):
    """A molecule and its frames: a seeded cumulative drift of at most
    0.03·√3 Å an atom a frame (under skin/2 = 0.25 Å for the first
    five), then one jump of up to 0.35 Å an axis (past it)."""
    g = np.random.default_rng(seed)
    mol = Molecule(name="traj",
                   symbols=list(g.choice(["H", "C", "N", "O"], natoms)),
                   xyz=g.uniform(0, 7, (natoms, 3)).astype(np.float32),
                   total_charge=1.0)
    steps = g.uniform(-1, 1, (frames, natoms, 3)) * 0.03
    steps[-1] = g.uniform(-1, 1, (natoms, 3)) * 0.35
    return mol, (mol.xyz[None] + np.cumsum(steps, axis=0)).astype(np.float32)


@pytest.mark.parametrize("method", ["auto", "topk"])
def test_skin_trajectory_matches_jax(skin_params, monkeypatch, method):
    """predict_trajectory with reuse_neighbors and neighbor_skin=0.5 in
    both packages, CELL_GRID_MIN_ATOMS lowered to 16 in both so the
    skin selection takes the cell builder at 48 atoms ('auto') or top-k
    ('topk'): one rebuild while the drift stays within skin/2, a second
    after the jump; every frame against JAX and against a cold Predictor
    of the port, with conservation."""
    monkeypatch.setattr(infer, "CELL_GRID_MIN_ATOMS", 16)
    monkeypatch.setattr(jax_infer, "CELL_GRID_MIN_ATOMS", 16)
    jparams, pparams = skin_params
    kw = dict(force_mode="blocked", reuse_neighbors=True, neighbor_skin=0.5,
              neighbor_method=method)
    p = Predictor(pparams, EPNNConfig(**SKIN_CFG), device="cpu", **kw)
    j = JaxPredictor(jparams, JaxConfig(**SKIN_CFG), **kw)
    cold = Predictor(pparams, EPNNConfig(**SKIN_CFG), device="cpu",
                     force_mode="blocked")
    cells = {"n": 0}
    cell = fused.build_neighbors_cell

    def spy(*a, **k):
        cells["n"] += 1
        return cell(*a, **k)

    monkeypatch.setattr(infer, "build_neighbors_cell", spy)
    mol, frames = _trajectory()
    q = p.predict_trajectory(mol, frames[:-1])
    qj = j.predict_trajectory(mol, frames[:-1])
    assert p.skin_rebuilds == j.skin_rebuilds == 1
    assert (cells["n"] > 0) == (method == "auto")
    q_last = p.predict_trajectory(mol, frames[-1:])
    qj_last = j.predict_trajectory(mol, frames[-1:])
    assert p.skin_rebuilds == j.skin_rebuilds == 2
    q, qj = np.concatenate([q, q_last]), np.concatenate([qj, qj_last])
    for t in range(len(frames)):
        _close(q[t], qj[t])
        m_t = Molecule(name="f", symbols=mol.symbols, xyz=frames[t],
                       total_charge=1.0)
        _close(q[t], cold.predict_molecules([m_t])[0])
        assert abs(float(q[t].astype(np.float64).sum()) - 1.0) < 1e-5


def test_skin_keeps_the_table_and_the_sort_within_half_the_skin(
        skin_params):
    """spatial_sort='on' with a skin: the sorted twin and its table stand
    while the drift stays within skin/2 (the twin's coordinates refreshed
    in place), and both are made again past it."""
    jparams, pparams = skin_params
    kw = dict(force_mode="blocked", reuse_neighbors=True, neighbor_skin=0.5,
              spatial_sort="on")
    p = Predictor(pparams, EPNNConfig(**SKIN_CFG), device="cpu", **kw)
    j = JaxPredictor(jparams, JaxConfig(**SKIN_CFG), **kw)
    mol, frames = _trajectory(seed=8)
    bp, bj = _batches([mol])
    twins = []
    for t in range(len(frames)):
        bp.xyz[0, :mol.natoms] = frames[t]
        bj.xyz[0, :mol.natoms] = frames[t]
        _close(p.predict_batch(bp), j.predict_batch(bj))
        twins.append(p._spatial_view(bp)[0])
        assert p.skin_rebuilds == j.skin_rebuilds == (1 if t < 5 else 2)
    assert all(tw is twins[0] for tw in twins[:5]) and twins[5] is not twins[0]


def test_skin_validation_matches_jax(skin_params):
    jparams, pparams = skin_params
    for make, cfg, params, extra in (
            (Predictor, EPNNConfig(**SKIN_CFG), pparams, {"device": "cpu"}),
            (JaxPredictor, JaxConfig(**SKIN_CFG), jparams, {})):
        with pytest.raises(ValueError, match="reuse_neighbors"):
            make(params, cfg, neighbor_skin=0.5, **extra)
        with pytest.raises(ValueError, match=">= 0"):
            make(params, cfg, reuse_neighbors=True, neighbor_skin=-1.0,
                 **extra)
        with pytest.raises(ValueError, match="spatial_sort"):
            make(params, cfg, spatial_sort="yes", **extra)


# ---------------------------------------------------------------------------
# the trainer's cell branch
# ---------------------------------------------------------------------------

def test_trainer_bucket_tables_match_jax(monkeypatch):
    """A bucket of CELL_GRID_MIN_ATOMS + 16 atoms (the JAX suite's
    test_precompute_neighbors_cell_branch): both trainers build its
    tables through the cell builder with the same grid and k, and the
    tables match (sets exact, d² to 2 ulp); one epoch runs with finite
    losses in both."""
    n = infer.CELL_GRID_MIN_ATOMS + 16
    g = np.random.default_rng(13)
    side = (n / 0.1) ** (1 / 3)
    labels = g.normal(0, 0.1, size=n).astype(np.float32)
    labels -= labels.sum() / n
    mol = Molecule(name="cell0",
                   symbols=list(g.choice(["H", "C", "N", "O"], size=n)),
                   xyz=g.uniform(0, side, (n, 3)).astype(np.float32),
                   total_charge=0.0, labels=labels)
    seen = {"port": [], "jax": []}

    def spy(tag, fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            seen[tag].append((a[3:6], tuple(np.asarray(o) for o in out)))
            return out
        return wrapped

    monkeypatch.setattr(port_loop, "build_neighbors_cell",
                        spy("port", fused.build_neighbors_cell))
    monkeypatch.setattr(jax_fused, "build_neighbors_cell",
                        spy("jax", jax_fused.build_neighbors_cell))
    small = dict(h_dim=16, e_dim=16, msg_dim=8, mlp_hidden=(8, 8), T=2)
    tc = dict(epochs=1, batch_size=1, seed=1, val_fraction=0.0)
    res = train([mol], EPNNConfig(**small), TrainConfig(**tc),
                val_mols=[mol], progress=False, device="cpu")
    res_j = jax_train([mol], JaxConfig(**small), JaxTrainConfig(**tc),
                      val_mols=[mol], progress=False)
    assert np.isfinite(res.history[0]["train_loss"])
    assert np.isfinite(res_j.history[0]["train_loss"])
    assert len(seen["port"]) == len(seen["jax"]) > 0
    for (args, port), (args_j, ref) in zip(seen["port"], seen["jax"]):
        assert tuple(map(int, args)) == tuple(map(int, args_j))
        _assert_tables_match(port, ref, n)
