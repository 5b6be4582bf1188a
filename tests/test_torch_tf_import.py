"""The port's TF-checkpoint import against the JAX package's, on the CPU.

No reference checkpoint ships with the repository, so both packages read
synthetic TensorBundles written by ``epnn_tpu_torch.testing.
write_tf_bundle`` in the reference's variable layout (the last round under
the ``message_fn`` / ``pass_fn`` aliases), with uncompressed and
snappy-compressed blocks:

* ``read_bundle`` / ``list_variables``: the port's arrays equal JAX's bit
  for bit, and the C++ reader (where the library loads) equals the Python
  one; the robustness cases raise the same errors as JAX's.
* ``import_checkpoint``: params bit for bit and the same config as JAX's
  at T = 2 and 3, and the same ``ValueError``s.
* ``Predictor.from_reference`` and ``import-ckpt`` / ``infer
  --reference-models`` on the CLI: charges within 1e-5·(max|q| + 1) of
  JAX's (the JAX suite's bar between two paths of the same math).
"""

import dataclasses
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from epnn_tpu import cli as jax_cli
from epnn_tpu.infer import Predictor as JaxPredictor
from epnn_tpu.io import bundle_native as jax_bundle_native
from epnn_tpu.io import bundle_reader as jax_bundle_reader
from epnn_tpu.io import checkpoint as jax_ckpt
from epnn_tpu.io import tf_import as jax_tf_import
from epnn_tpu.models import EPNNConfig as JaxConfig
from epnn_tpu.models import init_params as jax_init_params
from epnn_tpu_torch import cli
from epnn_tpu_torch.infer import Predictor
from epnn_tpu_torch.io import bundle_native, bundle_reader, tf_import
from epnn_tpu_torch.io import checkpoint as ckpt
from epnn_tpu_torch.testing import (
    reference_variables,
    snappy_compress,
    water_box,
    write_tf_bundle,
)

torch.set_num_threads(1)


def jax_params(cfg, seed=0):
    """JAX init with every 1-D leaf perturbed, so biases carry load."""
    params = jax_init_params(cfg, jax.random.key(seed))
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a + 0.3 if a.ndim == 1 else a), params)


def small_cfg(t=3, e_dim=16):
    return JaxConfig(h_dim=16, e_dim=e_dim, msg_dim=8, mlp_hidden=(8, 8),
                     T=t)


def _bundle(tmp_path, params, name="ref_weights", **kw):
    d = tmp_path / "models"
    d.mkdir(exist_ok=True)
    prefix = str(d / name)
    write_tf_bundle(prefix, reference_variables(params), **kw)
    return prefix


def _equal_reads(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("snappy_blocks", [(), (0,), (1, 3)])
def test_read_bundle_matches_jax(tmp_path, snappy_blocks):
    params = jax_params(small_cfg())
    prefix = _bundle(tmp_path, params, snappy_blocks=snappy_blocks)
    ours = bundle_reader.read_bundle(prefix)
    _equal_reads(ours, jax_bundle_reader.read_bundle(prefix))
    _equal_reads(ours, reference_variables(params))
    assert (bundle_reader.list_variables(prefix)
            == jax_bundle_reader.list_variables(prefix))


@pytest.mark.parametrize("snappy_blocks", [(), (2,)])
def test_native_reader_matches_python(tmp_path, snappy_blocks):
    assert bundle_native.available() == jax_bundle_native.available()
    if not bundle_native.available():
        pytest.skip("native library not built (make -C native)")
    prefix = _bundle(tmp_path, jax_params(small_cfg()),
                     snappy_blocks=snappy_blocks)
    _equal_reads(bundle_native.read_bundle_native(prefix),
                 bundle_reader.read_bundle(prefix))
    _equal_reads(bundle_native.read_bundle_native(prefix),
                 jax_bundle_native.read_bundle_native(prefix))


def _errors(fn_port, fn_jax, prefix):
    with pytest.raises(bundle_reader.BundleError) as ours:
        fn_port(prefix)
    with pytest.raises(jax_bundle_reader.BundleError) as theirs:
        fn_jax(prefix)
    return str(ours.value), str(theirs.value)


def _readers():
    pairs = [(bundle_reader.read_bundle, jax_bundle_reader.read_bundle)]
    if bundle_native.available():
        pairs.append((bundle_native.read_bundle_native,
                      jax_bundle_native.read_bundle_native))
    return pairs


def test_truncated_index_raises(tmp_path):
    prefix = _bundle(tmp_path, jax_params(small_cfg()))
    data = open(prefix + ".index", "rb").read()
    (tmp_path / "trunc.index").write_bytes(data[: len(data) // 2])
    for ours, theirs in _readers():
        a, b = _errors(ours, theirs, str(tmp_path / "trunc"))
        assert a == b


def test_bad_magic_raises(tmp_path):
    prefix = _bundle(tmp_path, jax_params(small_cfg()))
    data = bytearray(open(prefix + ".index", "rb").read())
    data[-1] ^= 0xFF
    (tmp_path / "bad.index").write_bytes(bytes(data))
    for ours, theirs in _readers():
        a, b = _errors(ours, theirs, str(tmp_path / "bad"))
        assert a == b and "magic" in a


def test_missing_shard_raises(tmp_path):
    prefix = _bundle(tmp_path, jax_params(small_cfg()))
    shutil.copy(prefix + ".index", tmp_path / "m.index")
    a, b = _errors(bundle_reader.read_bundle, jax_bundle_reader.read_bundle,
                   str(tmp_path / "m"))
    assert a == b and "shard" in a


def test_snappy_helpers():
    # JAX's case: literal 'abc' then an overlapping copy (offset 3, len 6)
    raw = bytes([9]) + bytes([0b0000_1000]) + b"abc" + bytes([0b0000_1001, 3])
    assert bundle_reader.snappy_decompress(raw) == b"abcabcabc"
    assert bundle_reader.snappy_decompress(raw) == \
        jax_bundle_reader.snappy_decompress(raw)
    g = np.random.default_rng(0)
    for data in (b"abcabcabcabcabcabc", bytes(range(256)) * 9, b"x" * 3000,
                 g.bytes(200) + g.bytes(8) * 40 + g.bytes(70)):
        comp = snappy_compress(data)
        assert bundle_reader.snappy_decompress(comp) == data
        assert jax_bundle_reader.snappy_decompress(comp) == data
    with pytest.raises(bundle_reader.BundleError, match="length"):
        bundle_reader.snappy_decompress(bytes([4]) + bytes([0]) + b"a")


@pytest.mark.parametrize("t", [2, 3])
def test_import_checkpoint_matches_jax(tmp_path, t):
    cfg = small_cfg(t)
    params = jax_params(cfg, seed=t)
    prefix = _bundle(tmp_path, params, snappy_blocks=(1,))
    ours, pcfg = tf_import.import_checkpoint(prefix, e_dim=16)
    theirs, jcfg = jax_tf_import.import_checkpoint(prefix, e_dim=16)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    assert pcfg.T == t and pcfg.mask_messages is False
    assert pcfg.n_elems == cfg.n_elems and pcfg.mlp_hidden == (8, 8)
    # the alias maps to round T - 1: every round equals the source
    theirs = theirs["params"]
    assert set(ours) == set(theirs) == set(params["params"])
    for name, layers in theirs.items():
        assert set(ours[name]) == set(layers)
        for dname, leaf in layers.items():
            for part in ("kernel", "bias"):
                np.testing.assert_array_equal(ours[name][dname][part].numpy(),
                                              leaf[part])
                np.testing.assert_array_equal(
                    leaf[part], params["params"][name][dname][part])


def _value_errors(tmp_path, variables, e_dim=16):
    prefix = str(tmp_path / "broken")
    write_tf_bundle(prefix, variables)
    with pytest.raises(ValueError) as ours:
        tf_import.import_checkpoint(prefix, e_dim=e_dim)
    with pytest.raises(ValueError) as theirs:
        jax_tf_import.import_checkpoint(prefix, e_dim=e_dim)
    assert str(ours.value) == str(theirs.value)
    return str(ours.value)


def test_import_checkpoint_errors_match_jax(tmp_path):
    variables = reference_variables(jax_params(small_cfg()))
    no_alias = {k: v for k, v in variables.items() if "/message_fn/" not in k}
    assert "alias" in _value_errors(tmp_path, no_alias)
    short = {k: v for k, v in variables.items() if "/pass_fns/1/" not in k}
    assert "pass rounds" in _value_errors(tmp_path, short)
    assert "decompose" in _value_errors(tmp_path, variables, e_dim=17)


def _molecules():
    return [water_box(5, seed=1, charge=0.0, name="a"),
            water_box(7, seed=2, charge=1.0, name="b")]


def _jax_mols(mols):
    from epnn_tpu.data.xyz import Molecule as JaxMolecule

    return [JaxMolecule(name=m.name, symbols=list(m.symbols), xyz=m.xyz,
                        total_charge=m.total_charge) for m in mols]


def test_from_reference_matches_jax(tmp_path):
    # the reference import infers with the reference's e_dim, 48
    cfg = small_cfg(3, e_dim=48)
    prefix = _bundle(tmp_path, jax_params(cfg, seed=4))
    models_dir, name = os.path.split(prefix)
    pred = Predictor.from_reference(models_dir, name, device="cpu")
    jpred = JaxPredictor.from_reference(models_dir, name)
    assert dataclasses.asdict(pred.cfg) == dataclasses.asdict(jpred.cfg)
    mols = _molecules()
    for q, qj in zip(pred.predict_molecules(mols),
                     jpred.predict_molecules(_jax_mols(mols))):
        tol = 1e-5 * (float(np.abs(qj).max()) + 1.0)
        assert float(np.abs(q - qj).max()) < tol


def test_import_ckpt_and_reference_models_cli(tmp_path, capsys):
    cfg = small_cfg(3, e_dim=48)
    prefix = _bundle(tmp_path, jax_params(cfg, seed=5))
    cli.main(["import-ckpt", prefix, "--out", str(tmp_path / "port")])
    line = capsys.readouterr().out.strip()
    jax_cli.main(["import-ckpt", prefix, "--out", str(tmp_path / "jax")])
    jline = capsys.readouterr().out.strip()
    assert line == jline[:-len("jax")] + "port"
    # the imported checkpoint reads back in both packages, bit for bit
    pcfg = ckpt.load_config(str(tmp_path / "port"))
    ours = ckpt.load_params(str(tmp_path / "port"), pcfg)
    jcfg = jax_ckpt.load_config(str(tmp_path / "port"))
    theirs = jax_ckpt.load_params(str(tmp_path / "port"),
                                  jax_init_params(jcfg, jax.random.key(0)))
    for name, layers in theirs["params"].items():
        for dname, leaf in layers.items():
            for part in ("kernel", "bias"):
                np.testing.assert_array_equal(
                    ours[name][dname][part].numpy(), np.asarray(leaf[part]))
    # infer from the imported checkpoint and from the reference models
    # directory: the same files as the JAX CLI's, within the bar
    from epnn_tpu_torch.testing import write_xyz

    data = tmp_path / "mols"
    for m in _molecules():
        write_xyz(str(data), m)
    models_dir, name = os.path.split(prefix)
    runs = {
        "ckpt": ["--checkpoint", str(tmp_path / "port")],
        "ref": ["--reference-models", models_dir, "--reference-name", name],
    }
    for label, src in runs.items():
        cli.main(["infer", *src, str(data), "--out", str(tmp_path / label)])
        jax_cli.main(["infer", *src, str(data), "--out",
                      str(tmp_path / (label + "_jax"))])
        files = sorted(os.listdir(tmp_path / label))
        assert files == sorted(os.listdir(tmp_path / (label + "_jax")))
        assert files == ["a_pred.npy", "b_pred.npy"]
        for f in files:
            q = np.load(tmp_path / label / f)
            qj = np.load(tmp_path / (label + "_jax") / f)
            assert q.dtype == qj.dtype and q.shape == qj.shape
            assert float(np.abs(q - qj).max()) < 1e-5 * (
                float(np.abs(qj).max()) + 1.0)
    capsys.readouterr()


def test_python_reader_error_propagates(tmp_path, monkeypatch):
    """No TensorFlow fallback: the Python reader's errors reach the caller
    (the C++ reader's BundleError falls through to the Python reader)."""
    with pytest.raises(FileNotFoundError):
        tf_import.read_tf_checkpoint_raw(str(tmp_path / "absent"))
    prefix = _bundle(tmp_path, jax_params(small_cfg()))
    data = bytearray(open(prefix + ".index", "rb").read())
    data[-1] ^= 0xFF
    (tmp_path / "bad.index").write_bytes(bytes(data))
    with pytest.raises(bundle_reader.BundleError, match="magic"):
        tf_import.import_checkpoint(str(tmp_path / "bad"), e_dim=16)
    # without the library the Python reader serves alone
    monkeypatch.setattr(bundle_native, "available", lambda: False)
    _equal_reads(tf_import.read_tf_checkpoint_raw(prefix),
                 bundle_reader.read_bundle(prefix))
