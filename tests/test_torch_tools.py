"""The port's data and analysis tools against the JAX package's, on the
CPU: ``load_directory`` (the native bulk path and the Python path), the
HORTON and QM9 converters (byte for byte), ``compat.gen_padded_init_state``
and ``rbf_edges_np`` (1e-12), the polarization analysis (charges within
1e-5·(max|q| + 1), the JAX suite's bar between two paths of the same math;
the same ``ValueError``s), the timing helpers and
``Predictor.benchmark_batch`` (their keys, finite times; a CPU time is no
device metric), and the public names of the packages."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import epnn_tpu
import epnn_tpu.data
import epnn_tpu.io
from epnn_tpu import compat as jax_compat
from epnn_tpu.analysis import polarization as jax_pol
from epnn_tpu.data import horton as jax_horton
from epnn_tpu.data import native as jax_native
from epnn_tpu.data import qm9 as jax_qm9
from epnn_tpu.data import xyz as jax_xyz
from epnn_tpu.featurize import rbf_edges_np as jax_rbf_edges_np
from epnn_tpu.infer import Predictor as JaxPredictor
from epnn_tpu.models import EPNNConfig as JaxConfig
from epnn_tpu.models import init_params as jax_init_params
import epnn_tpu_torch
import epnn_tpu_torch.data
import epnn_tpu_torch.io
from epnn_tpu_torch import compat
from epnn_tpu_torch.analysis import polarization as pol
from epnn_tpu_torch.data import horton, native, pad_molecules, qm9
from epnn_tpu_torch.data import xyz
from epnn_tpu_torch.elements import table_for_n_elems
from epnn_tpu_torch.featurize import rbf_edges_np
from epnn_tpu_torch.infer import Predictor
from epnn_tpu_torch.io.checkpoint import from_jax_params
from epnn_tpu_torch.models import EPNNConfig
from epnn_tpu_torch.testing import water_box, write_xyz
from epnn_tpu_torch.utils import timing

torch.set_num_threads(1)

#: public names of the JAX package that later port items own (item 12:
#: the serving export)
LATER_ITEMS: set = set()


def _mols(g):
    specs = [("w1", 1, 0.0), ("w3", 3, -1.0), ("w2", 2, 1.0), ("w5", 5, 0.0)]
    mols = []
    for name, m, q in specs:
        mol = water_box(m, seed=m, charge=q, name=name)
        lab = g.normal(0, 0.3, size=mol.natoms).astype(np.float32)
        mol.labels = lab + np.float32((q - lab.sum()) / mol.natoms)
        mols.append(mol)
    mols[1].split = 3
    mols[3].labels = None
    return mols


@pytest.fixture()
def mol_dir(tmp_path):
    mols = _mols(np.random.default_rng(0))
    for m in mols:
        write_xyz(str(tmp_path), m)
    return str(tmp_path), mols


def _same(a, b):
    assert a.name == b.name and list(a.symbols) == list(b.symbols)
    assert a.total_charge == b.total_charge and a.split == b.split
    assert a.xyz.dtype == b.xyz.dtype == np.float32
    np.testing.assert_array_equal(a.xyz, b.xyz)
    if b.labels is None:
        assert a.labels is None
    else:
        np.testing.assert_array_equal(a.labels, b.labels)


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("sort", [True, False])
def test_load_directory_matches_jax(mol_dir, use_native, sort):
    path, mols = mol_dir
    assert native.available() == jax_native.available()
    ours = xyz.load_directory(path, sort=sort, use_native=use_native)
    theirs = jax_xyz.load_directory(path, sort=sort, use_native=use_native)
    assert [m.name for m in ours] == [m.name for m in theirs]
    if sort:
        assert [m.name for m in ours] == ["w1", "w2", "w3", "w5"]
    for a, b in zip(ours, theirs):
        _same(a, b)
    # the written files read back as the molecules' own bits
    by_name = {m.name: m for m in mols}
    for a in ours:
        _same(a, by_name[a.name])


def test_load_directory_native_and_python_agree(mol_dir):
    path, _ = mol_dir
    if not native.available():
        pytest.skip("native library not built (make -C native)")
    for a, b in zip(xyz.load_directory(path, use_native=True),
                    xyz.load_directory(path, use_native=False)):
        _same(a, b)
    mol = native.parse_xyz_file(os.path.join(path, "w3.xyz"))
    _same(mol, jax_native.parse_xyz_file(os.path.join(path, "w3.xyz")))


def test_load_directory_errors_match_jax(mol_dir):
    path, _ = mol_dir
    for use_native in (True, False):
        with pytest.raises(FileNotFoundError) as ours:
            xyz.load_directory(path, require_labels=True,
                               use_native=use_native)
        with pytest.raises(FileNotFoundError) as theirs:
            jax_xyz.load_directory(path, require_labels=True,
                                   use_native=use_native)
        assert str(ours.value) == str(theirs.value)
    np.save(os.path.join(path, "w1.npy"), np.zeros(2, np.float32))
    for use_native in (True, False):
        with pytest.raises(xyz.XYZParseError) as ours:
            xyz.load_directory(path, use_native=use_native)
        with pytest.raises(jax_xyz.XYZParseError) as theirs:
            jax_xyz.load_directory(path, use_native=use_native)
        assert str(ours.value) == str(theirs.value)


MTP = ("number of atoms: 3\nnumber of fields: 9\nMultipoles\n---\n"
       "0 0 0 | -0.512345678901 0.1 0.2\n\n"
       "1 1 1 | 0.25 0.0 0.0\n"
       "2 2 2 | 0.262345678901 0.0 0.0\n")

RAW_QM9 = ("3\ngdb 17 157.7 157.7 0.1\n"
           "C\t0.0\t1.5*^-3\t0.0\t-0.5\n"
           "O\t1.2*^-1\t0.0\t-2.25\t0.25\n"
           "H  0.5 0.5 0.5 0.25\n"
           "1.1 2.2 3.3\n")


def test_horton_matches_jax(tmp_path):
    np.testing.assert_array_equal(horton.parse_mtp_text(MTP),
                                  jax_horton.parse_mtp_text(MTP))
    with pytest.raises(ValueError) as ours:
        horton.parse_mtp_text(MTP + "3 3 3 |\n")
    with pytest.raises(ValueError) as theirs:
        jax_horton.parse_mtp_text(MTP + "3 3 3 |\n")
    assert str(ours.value) == str(theirs.value)
    src = tmp_path / "src" / "sub"
    src.mkdir(parents=True)
    (src / "a-mtp.txt").write_text(MTP)
    (src.parent / "b-mtp.txt").write_text(MTP.replace("0.25", "-0.75"))
    (src / "skip.txt").write_text("x")
    ours = horton.convert_tree(str(tmp_path / "src"), str(tmp_path / "port"))
    theirs = jax_horton.convert_tree(str(tmp_path / "src"),
                                     str(tmp_path / "jax"))
    assert sorted(ours) == sorted(theirs) and len(ours) == 2
    for src_path, dst in ours.items():
        want = open(theirs[src_path], "rb").read()
        assert open(dst, "rb").read() == want


def test_qm9_matches_jax(tmp_path):
    assert qm9.convert_text(RAW_QM9) == jax_qm9.convert_text(RAW_QM9)
    with pytest.raises(ValueError) as ours:
        qm9.convert_text("1\n")
    with pytest.raises(ValueError) as theirs:
        jax_qm9.convert_text("1\n")
    assert str(ours.value) == str(theirs.value)
    raw = tmp_path / "raw"
    raw.mkdir()
    (raw / "b.xyz").write_text(RAW_QM9)
    (raw / "a.xyz").write_text(RAW_QM9.replace("C\t", "N\t"))
    (raw / "note.txt").write_text("x")
    ours = qm9.convert_directory(str(raw), str(tmp_path / "port"))
    theirs = jax_qm9.convert_directory(str(raw), str(tmp_path / "jax"))
    assert list(ours) == list(theirs)
    for src_path, dst in ours.items():
        assert open(dst, "rb").read() == open(theirs[src_path], "rb").read()


def test_rbf_edges_np_matches_jax():
    g = np.random.default_rng(3)
    xyz_ = g.uniform(-2.0, 2.0, size=(9, 3)).astype(np.float32)
    xyz_[4] = xyz_[2]  # a coincident pair keeps C = 1 off the diagonal
    for kw in ({}, {"e_dim": 16, "cutoff": 4.0, "eta": 1.5}):
        e, c = rbf_edges_np(xyz_, **kw)
        ej, cj = jax_rbf_edges_np(xyz_, **kw)
        assert e.dtype == ej.dtype == np.float32 and c.dtype == np.float64
        np.testing.assert_allclose(e, ej, rtol=0, atol=1e-12)
        np.testing.assert_allclose(c, cj, rtol=0, atol=1e-12)


def test_gen_padded_init_state_matches_jax(mol_dir, capsys):
    path, _ = mol_dir
    ours = compat.gen_padded_init_state(path, h_dim=8, e_dim=16)
    theirs = jax_compat.gen_padded_init_state(path, h_dim=8, e_dim=16)
    assert len(ours) == len(theirs) == 8
    for a, b in zip(ours[:-1], theirs[:-1]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(ours[-1], theirs[-1])
    assert "No labels provided" in capsys.readouterr().out
    empty = os.path.join(path, "none")
    os.makedirs(empty)
    for fn in (compat.gen_padded_init_state,
               jax_compat.gen_padded_init_state):
        with pytest.raises(ValueError, match="no .xyz files"):
            fn(empty, 8, 16)


@pytest.fixture(scope="module")
def tiny():
    """JAX's analysis fixture (h 16, e 16, T 2, seed 0) in both packages."""
    jcfg = JaxConfig(h_dim=16, e_dim=16, msg_dim=8, mlp_hidden=(8, 8), T=2)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    pcfg = EPNNConfig(**dataclasses.asdict(jcfg))
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                             pcfg)
    return (Predictor(params, pcfg, device="cpu"),
            JaxPredictor(params=jparams, cfg=jcfg))


def _dimer():
    g = np.random.default_rng(5)
    xyz_ = np.concatenate([g.uniform(-1.5, 1.5, (5, 3)),
                           g.uniform(-1.5, 1.5, (4, 3)) + 2.0]).astype(
                               np.float32)
    kw = dict(name="dim", symbols=["C", "O", "H", "H", "H", "N", "H", "H",
                                   "H"], xyz=xyz_, total_charge=-1.0, split=5)
    return xyz.Molecule(**kw), jax_xyz.Molecule(**kw)


def test_split_dimer_matches_jax():
    dimer, jdimer = _dimer()
    for a, b in zip(pol.split_dimer(dimer, charges=(-1.0, 0.0)),
                    jax_pol.split_dimer(jdimer, charges=(-1.0, 0.0))):
        _same(a, b)
    nosplit = dataclasses.replace(dimer, split=None)
    jnosplit = dataclasses.replace(jdimer, split=None)
    for args, kw in (((nosplit,), {}), ((dimer,), {})):
        with pytest.raises(ValueError) as ours:
            pol.split_dimer(*args, **kw)
        jargs = (jnosplit,) if args[0] is nosplit else (jdimer,)
        with pytest.raises(ValueError) as theirs:
            jax_pol.split_dimer(*jargs, **kw)
        assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("labels", [False, True])
def test_polarization_response_matches_jax(tiny, labels):
    pred, jpred = tiny
    dimer, jdimer = _dimer()
    label = (np.linspace(-0.1, 0.1, dimer.natoms).astype(np.float32)
             if labels else None)
    res = pol.polarization_response(pred, dimer, monomer_charges=(-1.0, 0.0),
                                    label_polarization=label)
    jres = jax_pol.polarization_response(jpred, jdimer,
                                         monomer_charges=(-1.0, 0.0),
                                         label_polarization=label)
    for field in ("pred_dimer", "pred_monomers", "pred_polarization"):
        a, b = getattr(res, field), getattr(jres, field)
        assert a.shape == b.shape == (dimer.natoms,)
        assert float(np.abs(a - b).max()) < 1e-5 * (
            float(np.abs(b).max()) + 1.0)
    np.testing.assert_array_equal(res.pred_polarization,
                                  res.pred_dimer - res.pred_monomers)
    assert abs(float(res.pred_polarization.astype(np.float64).sum())) < 1e-4
    if labels:
        assert abs(res.mae - jres.mae) < 1e-5
        np.testing.assert_allclose(res.error, jres.error, atol=1e-5)
        assert "MAE" in res.summary()
    else:
        assert res.error is None and res.mae is None
    assert res.summary().splitlines()[0] == jres.summary().splitlines()[0]


def test_timing_helpers():
    t = timing.Timer()
    with t.span("a"):
        pass
    with t.span("a"):
        pass
    assert len(t.spans["a"]) == 2 and t.total("a") >= 0.0
    calls = []

    def fn(q0, ops=None):
        calls.append(float(q0.sum()))
        return (q0 * 2.0) @ torch.eye(3) + (0.0 if ops is None else ops)

    q0 = torch.ones(2, 3)
    out = timing.benchmark_chained(fn, q0, iters=3, warmup_loops=1,
                                   cost_analysis=True)
    # cost_analysis: the products of one more call, (2, 3) @ (3, 3)
    assert set(out) == {"mean_s", "iters", "method", "warmup_loops", "flops"}
    assert out["flops"] == 2 * 2 * 3 * 3
    assert out["method"] == "chained" and out["iters"] == 3
    assert np.isfinite(out["mean_s"]) and out["mean_s"] > 0.0
    # each call sees q0 plus a zero-weighted dependency on the last output
    assert calls == [6.0] * 7
    out = timing.benchmark_chained(fn, q0, iters=2, operands=1.0)
    assert out["warmup_loops"] == 2 and len(calls) == 7 + 6
    assert "flops" not in out
    stats = timing.benchmark_fn(lambda a: a + 1, torch.ones(3), warmup=1,
                                iters=4)
    assert set(stats) == {"mean_s", "median_s", "min_s", "std_s", "iters"}
    assert stats["iters"] == 4 and np.isfinite(stats["mean_s"])


@pytest.mark.parametrize("mode,kw", [
    ("dense", {}),
    ("blocked", {}),
    ("blocked", {"reuse_neighbors": True, "neighbor_skin": 0.5}),
])
def test_benchmark_batch_keys(tiny, mode, kw, tmp_path):
    pred0, _ = tiny
    pred = Predictor(pred0.params, pred0.cfg, force_mode=mode, device="cpu",
                     **kw)
    batch = pad_molecules([water_box(6, seed=2, charge=1.0)],
                          table_for_n_elems(pred.cfg.n_elems))
    chained = pred.benchmark_batch(batch, iters=2, warmup_loops=1)
    assert set(chained) == {"mean_s", "iters", "method", "warmup_loops"}
    assert chained["method"] == "chained" and chained["iters"] == 2
    assert np.isfinite(chained["mean_s"]) and chained["mean_s"] > 0.0
    per_call = pred.benchmark_batch(batch, iters=2, per_call=True,
                                    profile_dir=str(tmp_path / "prof"))
    assert per_call["method"] == "per_call" and per_call["iters"] == 2
    assert {"mean_s", "median_s", "min_s", "std_s"} <= set(per_call)
    assert os.path.exists(tmp_path / "prof" / "trace.json")


def test_public_names_match_jax():
    assert sorted(epnn_tpu_torch.__all__) == sorted(epnn_tpu.__all__)
    for mod, jmod in ((epnn_tpu_torch.data, epnn_tpu.data),
                      (epnn_tpu_torch.io, epnn_tpu.io)):
        missing = set(jmod.__all__) - LATER_ITEMS - set(mod.__all__)
        assert not missing, (mod.__name__, missing)
        for name in mod.__all__:
            assert hasattr(mod, name), (mod.__name__, name)
    for name in epnn_tpu_torch.__all__:
        assert hasattr(epnn_tpu_torch, name)


def test_import_stays_light():
    """Importing the package and its tools imports neither JAX, the JAX
    package nor triton, and builds no kernel."""
    code = (
        "import sys\n"
        "import epnn_tpu_torch, epnn_tpu_torch.cli, epnn_tpu_torch.compat\n"
        "import epnn_tpu_torch.analysis, epnn_tpu_torch.utils\n"
        "import epnn_tpu_torch.data.horton, epnn_tpu_torch.data.qm9\n"
        "import epnn_tpu_torch.io.tf_import, epnn_tpu_torch.__main__\n"
        "from epnn_tpu_torch.ops import kernels\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'epnn_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "assert not kernels.BUILD_DIR.exists() or not any("
        "p.stat().st_mtime > float(sys.argv[1]) for p in "
        "kernels.BUILD_DIR.iterdir())\n")
    import time

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    proc = subprocess.run([sys.executable, "-c", code, str(time.time())],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
