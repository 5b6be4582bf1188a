"""The PyTorch port's leaf modules against the JAX package: config,
element tables, parsing, padding, featurization and checkpoint loading."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from epnn_tpu.data.dataset import pad_molecules as jax_pad_molecules
from epnn_tpu.data.dataset import uniform_q0_contract as jax_uq0
from epnn_tpu.data.xyz import parse_xyz_text as jax_parse_xyz_text
from epnn_tpu.elements import TABLES as JAX_TABLES
from epnn_tpu.featurize import rbf_edges as jax_rbf_edges
from epnn_tpu.io import checkpoint as jax_ckpt
from epnn_tpu.models import init_params as jax_init_params
from epnn_tpu.models.config import PRESETS as JAX_PRESETS
from epnn_tpu_torch.data import Molecule, pad_molecules, parse_xyz_text
from epnn_tpu_torch.data import uniform_q0_contract
from epnn_tpu_torch.elements import TABLES, table_for_n_elems
from epnn_tpu_torch.featurize import rbf_edges
from epnn_tpu_torch.io import checkpoint as ckpt
from epnn_tpu_torch.models import PRESETS, EPNNConfig, init_params

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINTS = ["trained/mixed_b16", "trained/mixed_repaired_b16"]


def _port_molecules(mols):
    return [Molecule(name=m.name, symbols=list(m.symbols), xyz=m.xyz.copy(),
                     total_charge=m.total_charge,
                     labels=None if m.labels is None else m.labels.copy())
            for m in mols]


@pytest.mark.parametrize("name", sorted(JAX_PRESETS))
def test_presets_match(name):
    assert dataclasses.asdict(PRESETS[name]) == dataclasses.asdict(
        JAX_PRESETS[name])


@pytest.mark.parametrize("name", sorted(JAX_TABLES))
def test_element_tables_match(name):
    a, b = TABLES[name], JAX_TABLES[name]
    assert tuple(a.symbols) == tuple(b.symbols)
    assert dict(a.atomic_numbers) == dict(b.atomic_numbers)
    np.testing.assert_array_equal(a.featurize_symbols(a.symbols),
                                  b.featurize_symbols(b.symbols))
    assert table_for_n_elems(a.n_features).name == name


def test_parse_xyz_matches():
    text = "3\n-1.0 extra\nO 0.0 0.1 0.2\nH 0.9 0.0 0.0 junk\n\nH -0.3 0.8 0\n"
    a = parse_xyz_text(text, name="w")
    b = jax_parse_xyz_text(text, name="w")
    assert a.symbols == b.symbols and a.total_charge == b.total_charge
    np.testing.assert_array_equal(a.xyz, b.xyz)


@pytest.mark.parametrize("with_mask", [False, True])
def test_rbf_edges_match(rng, with_mask):
    xyz = rng.uniform(-3, 3, size=(2, 12, 3)).astype(np.float32)
    xyz[0, 5] = xyz[0, 4]  # a coincident off-diagonal pair keeps C = 1
    mask = np.ones((2, 12), np.float32)
    mask[1, 9:] = 0
    m_j = mask if with_mask else None
    ref = np.asarray(jax_rbf_edges(xyz, m_j))
    out = rbf_edges(torch.from_numpy(xyz),
                    None if m_j is None else torch.from_numpy(m_j)).numpy()
    assert out.shape == ref.shape and out.dtype == np.float32
    assert np.abs(out - ref).max() <= 1e-6


def test_pad_molecules_match(toy_molecules):
    table = table_for_n_elems(10)
    a = pad_molecules(_port_molecules(toy_molecules), table)
    b = jax_pad_molecules(toy_molecules, JAX_TABLES[table.name])
    for field in ("x", "xyz", "q0", "total_q", "y", "node_mask", "natoms",
                  "has_labels"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert a.names == b.names
    assert uniform_q0_contract(a.x, a.q0, a.node_mask) == jax_uq0(
        b.x, b.q0, b.node_mask)


def test_uniform_q0_contract_cases(toy_molecules):
    table = table_for_n_elems(10)
    batch = pad_molecules(_port_molecules(toy_molecules), table, pad_to=16)
    assert uniform_q0_contract(batch.x, batch.q0, batch.node_mask)
    for mutate in (lambda b: b.q0.__setitem__((0, 1), 0.5),    # non-uniform
                   lambda b: b.x.__setitem__((1, 0, 0), 99.0),  # bad Z
                   lambda b: b.node_mask.__setitem__((2, 0), 0.0)):
        bad = pad_molecules(_port_molecules(toy_molecules), table, pad_to=16)
        mutate(bad)
        assert not uniform_q0_contract(bad.x, bad.q0, bad.node_mask)
        assert not jax_uq0(bad.x, bad.q0, bad.node_mask)


@pytest.mark.parametrize("directory", CHECKPOINTS)
def test_load_params_matches_jax(directory):
    path = os.path.join(ROOT, directory)
    cfg_j = jax_ckpt.load_config(path)
    ref = jax_ckpt.load_params(path, jax_init_params(cfg_j, jax.random.key(0)))
    cfg = ckpt.load_config(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
    params = ckpt.load_params(path, cfg)
    flat_ref = {tuple(str(getattr(k, "key", k)) for k in p): np.asarray(v)
                for p, v in jax.tree_util.tree_leaves_with_path(ref)}
    flat = {("params", m, d, leaf): v.numpy()
            for m, layers in params.items() for d, leaves in layers.items()
            for leaf, v in leaves.items()}
    assert set(flat) == set(flat_ref)
    for key, v in flat.items():
        assert v.dtype == np.float32 and v.flags.writeable
        np.testing.assert_array_equal(v, flat_ref[key])


def test_load_params_shape_mismatch_raises():
    path = os.path.join(ROOT, CHECKPOINTS[0])
    cfg = ckpt.load_config(path).replace(h_dim=16)
    with pytest.raises(ValueError, match="config needs"):
        ckpt.load_params(path, cfg)


@pytest.mark.parametrize("mask_messages", [True, False])
def test_init_params_shapes_match_jax(mask_messages):
    cfg = EPNNConfig(mask_messages=mask_messages, T=2)
    ref = jax_init_params(cfg, jax.random.key(0))["params"]
    out = init_params(cfg, torch.Generator().manual_seed(0))
    assert set(out) == set(ref)
    for m, layers in ref.items():
        for d, leaves in layers.items():
            for leaf, v in leaves.items():
                assert tuple(out[m][d][leaf].shape) == tuple(v.shape)
    # the same tree also crosses over from the JAX layout
    conv = ckpt.from_jax_params(jax.tree_util.tree_map(
        np.asarray, {"params": ref}), cfg)
    assert set(conv) == set(out)


def test_port_imports_no_jax():
    """Every module of the port imports without jax, flax, epnn_tpu or
    triton ending up in sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import epnn_tpu_torch\n"
        "for m in pkgutil.walk_packages(epnn_tpu_torch.__path__,"
        " 'epnn_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'epnn_tpu', 'triton'))\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BAD []" in proc.stdout


def test_predictor_without_device_needs_cuda():
    from epnn_tpu_torch.infer import Predictor

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor.from_checkpoint(os.path.join(ROOT, "trained/mixed_b16"))
