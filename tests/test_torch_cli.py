"""The port's CLI (``python -m epnn_tpu_torch``) against the JAX CLI, on
the CPU (``EPNN_PLATFORM=cpu``, which the suite's conftest sets):

* the two parsers: the same eight subcommands, and every option with the
  same flags, dest, default, type, choices and nargs;
* ``train`` → ``infer`` on toy molecules (h 8, as ``tests/test_cli.py``):
  the port's ``best/`` serves in both packages, and the port's and JAX's
  ``infer`` files agree within 1e-5·(max|q| + 1) (the JAX suite's bar
  between two paths of the same math), ``--far-budget`` included;
* ``bench``: JAX's keys and ``method``; ``eval-pol``, ``horton2npy`` and
  ``convert-qm9``: JAX's outputs (bytes where JAX writes bytes);
* the flags of later ROADMAP items exit non-zero naming their item, the
  trainer's deferred options raise naming theirs, and without
  ``EPNN_PLATFORM=cpu`` a CPU-only machine raises.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from epnn_tpu import cli as jax_cli
from epnn_tpu.infer import Predictor as JaxPredictor
from epnn_tpu_torch import cli
from epnn_tpu_torch.data import xyz
from epnn_tpu_torch.infer import Predictor
from epnn_tpu_torch.testing import water_box, write_xyz

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--rounds", "1", "--h-dim", "8", "--e-dim", "8", "--msg-dim", "8",
         "--layers", "8"]


def _subparsers(ap):
    return next(a for a in ap._actions
                if isinstance(a, argparse._SubParsersAction)).choices


def _options(p):
    return {tuple(a.option_strings) or (a.dest,): (
        a.dest, a.default, a.type, a.choices, a.nargs, a.required, a.const,
        type(a).__name__) for a in p._actions}


def test_parsers_match_jax():
    ours, theirs = _subparsers(cli.build_parser()), _subparsers(
        jax_cli.build_parser())
    assert set(ours) == set(theirs) == {
        "train", "infer", "import-ckpt", "eval-pol", "horton2npy",
        "convert-qm9", "export", "bench"}
    for name in theirs:
        assert _options(ours[name]) == _options(theirs[name]), name


def _toy(g):
    mols = []
    for i, (m, q) in enumerate(((3, 0.0), (4, 1.0), (5, -1.0), (6, 0.0),
                                (2, 0.0))):
        mol = water_box(m, seed=i, charge=q, name=f"toy{i}")
        lab = g.normal(0, 0.3, size=mol.natoms).astype(np.float32)
        mol.labels = lab + np.float32((q - lab.sum()) / mol.natoms)
        mols.append(mol)
    return mols


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Toy molecules written as .xyz + .npy and the port CLI's 2-epoch
    run on them."""
    root = tmp_path_factory.mktemp("cli")
    data = root / "data"
    mols = _toy(np.random.default_rng(0))
    for m in mols:
        write_xyz(str(data), m)
    cli.main(["train", "--data", str(data) + "/", "--out", str(root / "run"),
              "--epochs", "2", "--batch-size", "4", *SMALL])
    return root, data, mols


def _close(q, qj):
    assert q.shape == qj.shape and q.dtype == qj.dtype
    assert float(np.abs(q - qj).max()) < 1e-5 * (float(np.abs(qj).max())
                                                 + 1.0)


def test_train_checkpoint_serves_in_both_packages(trained):
    root, data, mols = trained
    best = root / "run" / "best"
    assert (best / "params.msgpack").exists()
    rows = [json.loads(ln) for ln in open(root / "run" / "metrics.jsonl")]
    assert len(rows) == 2
    from epnn_tpu.data.xyz import load_directory as jax_load_directory

    ours = Predictor.from_checkpoint(str(best), device="cpu")
    theirs = JaxPredictor.from_checkpoint(str(best))
    jmols = jax_load_directory(str(data))
    for q, qj in zip(ours.predict_molecules(mols),
                     theirs.predict_molecules(jmols)):
        _close(q, qj)


@pytest.mark.parametrize("extra", [[], ["--precision", "fast",
                                        "--no-collapse-round1"],
                                   ["--renormalize", "--far-budget", "1.0"]])
def test_infer_matches_jax_cli(trained, tmp_path, capsys, extra):
    root, data, mols = trained
    best = str(root / "run" / "best")
    cli.main(["infer", "--checkpoint", best, str(data), "--out",
              str(tmp_path / "port"), *extra])
    out = capsys.readouterr().out.splitlines()
    jax_cli.main(["infer", "--checkpoint", best, str(data), "--out",
                  str(tmp_path / "jax"), *extra])
    jout = capsys.readouterr().out.splitlines()
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax"))
    assert files == [f"{m.name}_pred.npy" for m in mols]
    for f in files:
        _close(np.load(tmp_path / "port" / f), np.load(tmp_path / "jax" / f))
    # the same lines (the charge sums print to 5 decimals)
    assert len(out) == len(jout) == len(mols) + 1 + ("--far-budget" in extra)
    for a, b in zip(out[:-1], jout[:-1]):
        if "calibration" in b:
            assert a.split("(")[0] == b.split("(")[0]
        else:
            assert a.split("sum(q)")[0] == b.split("sum(q)")[0]
    # one file: the same as its entry in the directory run
    cli.main(["infer", "--checkpoint", best, str(data / "toy2.xyz"),
              "--out", str(tmp_path / "one"), *extra])
    np.testing.assert_array_equal(np.load(tmp_path / "one" / "toy2_pred.npy"),
                                  np.load(tmp_path / "port" / "toy2_pred.npy"))
    capsys.readouterr()


def test_finetune_through_the_fused_path(trained, tmp_path):
    root, data, _ = trained
    out = tmp_path / "ft"
    cli.main(["train", "--data", str(data) + "/", "--out", str(out),
              "--epochs", "1", "--batch-size", "4", "--init-from",
              str(root / "run" / "best"), "--dense-max-atoms", "4",
              "--val-data", str(data)])
    assert (out / "best" / "params.msgpack").exists()


@pytest.mark.parametrize("extra", [[], ["--per-call"],
                                   ["--reuse-neighbors", "--neighbor-skin",
                                    "0.5"], ["--far-cluster", "4"]])
def test_bench_keys(trained, capsys, extra):
    root, data, _ = trained
    args = ["bench", "--checkpoint", str(root / "run" / "best"),
            str(data / "toy3.xyz"), "--iters", "2", "--warmup", "1", *extra]
    cli.main(args)
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jax_cli.main(args)
    jstats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(stats) == set(jstats)
    assert stats["method"] == jstats["method"] == (
        "per_call" if "--per-call" in extra else "chained")
    assert stats["natoms"] == 18 and stats["name"] == "toy3"
    assert np.isfinite(stats["mean_s"]) and stats["mean_s"] > 0.0
    if "--far-cluster" in extra:
        assert stats["far_cluster"] == 4
        assert np.isfinite(stats["far_cluster_max_abs_dq"])


def test_eval_pol_matches_jax_cli(trained, tmp_path, capsys, monkeypatch):
    root, _, _ = trained
    best = str(root / "run" / "best")
    dimer = water_box(6, seed=9, charge=-1.0, name="dimer")
    dimer.split = 9
    path = write_xyz(str(tmp_path), dimer)
    # monomer files at the dimer's geometry: their headers carry the charges
    monos = [write_xyz(str(tmp_path), xyz.Molecule(
        name=name, symbols=dimer.symbols[sl], xyz=dimer.xyz[sl],
        total_charge=q)) for name, sl, q in (("ma", slice(0, 9), -1.0),
                                             ("mb", slice(9, None), 0.0))]
    from epnn_tpu import analysis as jax_analysis
    from epnn_tpu_torch import analysis

    results = {}
    for side, mod in (("port", analysis), ("jax", jax_analysis)):
        real = mod.polarization_response
        monkeypatch.setattr(mod, "polarization_response",
                            lambda *a, _r=real, _s=side, **k:
                            results.setdefault(_s, []).append(_r(*a, **k))
                            or results[_s][-1])
    for extra in (["--monomer-charges", "-1", "0"], ["--monomers", *monos]):
        cli.main(["eval-pol", "--checkpoint", best, path, *extra])
        out = capsys.readouterr().out
        jax_cli.main(["eval-pol", "--checkpoint", best, path, *extra])
        jout = capsys.readouterr().out
        res, jres = results["port"][-1], results["jax"][-1]
        assert out == res.summary() + "\n"
        assert out.splitlines()[0] == jout.splitlines()[0]
        for field in ("pred_dimer", "pred_monomers", "pred_polarization"):
            _close(getattr(res, field), getattr(jres, field))
        assert abs(float(res.pred_polarization.astype(np.float64).sum())) \
            < 1e-4
    # split and monomer files at the same geometry: the same response
    np.testing.assert_array_equal(results["port"][0].pred_polarization,
                                  results["port"][1].pred_polarization)
    # the error of JAX's CLI without monomer charges or files
    with pytest.raises(SystemExit) as ours:
        cli.main(["eval-pol", "--checkpoint", best, path])
    with pytest.raises(SystemExit) as theirs:
        jax_cli.main(["eval-pol", "--checkpoint", best, path])
    assert str(ours.value) == str(theirs.value)


def test_horton2npy_and_convert_qm9_match_jax(tmp_path, capsys):
    src = tmp_path / "mtp"
    src.mkdir()
    (src / "x-mtp.txt").write_text(
        "number of atoms: 2\nnumber of fields: 9\nMultipoles\n---\n"
        "0 0 0 | -0.25 0.0\n1 1 1 | 0.125 0.0\n")
    for side, main in (("port", cli.main), ("jax", jax_cli.main)):
        main(["horton2npy", str(src), "--out", str(tmp_path / side)])
    assert (open(tmp_path / "port" / "x-mtp.npy", "rb").read()
            == open(tmp_path / "jax" / "x-mtp.npy", "rb").read())
    raw = tmp_path / "raw"
    raw.mkdir()
    (raw / "a.xyz").write_text("2\ngdb 1 2 3\nC\t0.0\t1.0*^-2\t0.0\t-0.1\n"
                               "H\t1.0\t0.0\t0.0\t0.1\n")
    for side, main in (("port", cli.main), ("jax", jax_cli.main)):
        main(["convert-qm9", str(raw), str(tmp_path / ("qm9_" + side))])
    assert (open(tmp_path / "qm9_port" / "a.xyz", "rb").read()
            == open(tmp_path / "qm9_jax" / "a.xyz", "rb").read())
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == lines[1] == "converted 1 MBIS multipole files"


@pytest.mark.parametrize("argv,item", [
    (["export", "--checkpoint", "c", "m.xyz", "--out", "o"], 12),
    (["train", "--data", "d", "--data-parallel"], 11),
    (["train", "--data", "d", "--multihost"], 11),
    (["infer", "--checkpoint", "c", "m.xyz", "--atom-shard", "2"], 11),
    (["infer", "--checkpoint", "c", "m.xyz", "--ring-shard", "2"], 11),
])
def test_later_items_exit_naming_their_item(argv, item):
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert isinstance(exc.value.code, str)  # a message: exit status 1
    assert f"ROADMAP queue 1 item {item}" in exc.value.code


@pytest.mark.parametrize("flags,item", [
    (["--lr-schedule", "cosine"], "9.2"),
    (["--lr-plateau-factor", "0.5"], "9.2"),
    (["--ema-decay", "0.99"], "9.2"),
    (["--grad-clip-norm", "1.0"], "9.2"),
    (["--grad-accum", "2"], "9.2"),
    (["--debug-nans"], "9.5"),
    (["--tensorboard"], "9.5"),
])
def test_deferred_train_options_raise(trained, tmp_path, flags, item):
    _, data, _ = trained
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1 item "
                                                  f"{item}"):
        cli.main(["train", "--data", str(data), "--out",
                  str(tmp_path / "run"), "--epochs", "1", *SMALL, *flags])


def test_platform_selects_the_device(trained, monkeypatch, tmp_path):
    root, data, _ = trained
    argv = ["infer", "--checkpoint", str(root / "run" / "best"), str(data),
            "--out", str(tmp_path / "p")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for value in (None, "cuda", "gpu"):
        if value is None:
            monkeypatch.delenv("EPNN_PLATFORM", raising=False)
        else:
            monkeypatch.setenv("EPNN_PLATFORM", value)
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)
    monkeypatch.setenv("EPNN_PLATFORM", "tpu")
    with pytest.raises(SystemExit, match="EPNN_PLATFORM"):
        cli.main(argv)
    monkeypatch.setenv("EPNN_PLATFORM", "CPU")
    cli.main(argv)
    assert len(os.listdir(tmp_path / "p")) == 5


def test_python_m_entry_point(trained, tmp_path):
    """``python -m epnn_tpu_torch`` from the repository root: exit 0 with
    the in-process files, and exit 1 with the message for a later item."""
    root, data, _ = trained
    best = str(root / "run" / "best")
    env = dict(os.environ, EPNN_PLATFORM="cpu", PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "epnn_tpu_torch", "infer", "--checkpoint",
         best, str(data), "--out", str(tmp_path / "sub")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith(f"wrote 5 prediction files to "
                                        f"{tmp_path / 'sub'}")
    cli.main(["infer", "--checkpoint", best, str(data), "--out",
              str(tmp_path / "inproc")])
    for f in os.listdir(tmp_path / "inproc"):
        np.testing.assert_array_equal(np.load(tmp_path / "sub" / f),
                                      np.load(tmp_path / "inproc" / f))
    proc = subprocess.run(
        [sys.executable, "-m", "epnn_tpu_torch", "export", "--checkpoint",
         best, str(data / "toy0.xyz"), "--out", str(tmp_path / "x")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1 and "item 12" in proc.stderr
