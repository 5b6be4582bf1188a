"""The port's Predictor against the JAX Predictor on the shipped
``trained/mixed_b16`` checkpoint: small molecules on the dense path and a
288-atom water box on the blocked path, within 1e-5·(max|q| + 1)."""

import os

import numpy as np
import pytest
import torch

from epnn_tpu.data.dataset import pad_molecules as jax_pad_molecules
from epnn_tpu.elements import table_for_n_elems as jax_table
from epnn_tpu.infer import Predictor as JaxPredictor
from epnn_tpu_torch.data import Molecule, pad_molecules
from epnn_tpu_torch.elements import table_for_n_elems
from epnn_tpu_torch.infer import DENSE_MAX_ATOMS, Predictor
from epnn_tpu_torch.testing import water_box

torch.set_num_threads(2)

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "trained", "mixed_b16")


@pytest.fixture(scope="module")
def predictors():
    return (Predictor.from_checkpoint(CKPT, device="cpu"),
            JaxPredictor.from_checkpoint(CKPT))


def _port(mols):
    return [Molecule(name=m.name, symbols=list(m.symbols), xyz=m.xyz.copy(),
                     total_charge=m.total_charge) for m in mols]


def _close(out, ref):
    assert np.abs(out - ref).max() < 1e-5 * (np.abs(ref).max() + 1.0)


def test_dense_path_matches_jax(predictors, toy_molecules):
    port, ref = predictors
    mols = list(toy_molecules) + [water_box(4, seed=3, charge=-1.0)]
    out = port.predict_molecules(_port(mols))
    want = ref.predict_molecules(mols)
    for o, w, m in zip(out, want, mols):
        assert o.shape == (m.natoms,)
        _close(o, w)
        assert abs(float(o.sum()) - m.total_charge) < 1e-5


@pytest.mark.parametrize("charge", [0.0, 1.0])
def test_blocked_path_matches_jax(predictors, charge):
    port, ref = predictors
    box = water_box(96, seed=11, charge=charge)
    batch = pad_molecules(_port([box]), table_for_n_elems(10))
    assert batch.padded_atoms > DENSE_MAX_ATOMS
    out = port.predict_batch(batch)
    want = ref.predict_batch(jax_pad_molecules([box], jax_table(10)))
    assert out.shape == want.shape == (1, 288)
    _close(out, want)
    assert abs(float(out.sum()) - charge) < 1e-4
    # the trained model gives chemically sane water charges
    assert -1.2 < out[0, 0::3].mean() < -0.5 < 0.2 < out[0, 1::3].mean() < 0.6


def test_blocked_batch_at_odd_width(predictors):
    """B = 2 padded to a width that is no multiple of 4 (graph 1's rows
    start off the 16-byte boundary, which the kernels accept as the CPU
    does) gives each molecule's charges at its own width."""
    port, _ = predictors
    boxes = [water_box(96, seed=11), water_box(90, seed=12, charge=1.0)]
    out = port.predict_molecules(boxes, pad_to=301)
    for o, box in zip(out, boxes):
        _close(o, port.predict_molecules([box])[0])


def test_forced_blocked_matches_dense(predictors, toy_molecules):
    port, _ = predictors
    batch = pad_molecules(_port(toy_molecules), table_for_n_elems(10))
    dense = port.predict_batch(batch)
    blocked = Predictor(port.params, port.cfg, device="cpu",
                        force_mode="blocked").predict_batch(batch)
    _close(blocked, dense)


def test_renormalize_conserves(predictors):
    port, _ = predictors
    renorm = Predictor(port.params, port.cfg, device="cpu", renormalize=True)
    batch = pad_molecules(_port([water_box(2, seed=1, charge=1.0)]),
                          table_for_n_elems(10))
    raw = port.predict_batch(batch)
    q = renorm.predict_batch(batch)
    assert abs(float(q.astype(np.float64).sum()) - 1.0) < 32 * 6e-8 * (
        np.abs(q).max() + 1)
    assert np.abs(q - raw).max() < 1e-5


def test_mixed_repaired_diverges_beyond_training_sizes(predictors):
    """Why the port's checks at scale use mixed_b16: on a 192-atom water
    box mixed_repaired_b16's charges blow up (both packages agree), while
    mixed_b16 stays sane."""
    port_b16, _ = predictors
    ckpt = CKPT.replace("mixed_b16", "mixed_repaired_b16")
    box = water_box(64, seed=0)
    q = Predictor.from_checkpoint(ckpt, device="cpu").predict_molecules(
        _port([box]))[0]
    want = JaxPredictor.from_checkpoint(ckpt).predict_molecules([box])[0]
    assert np.abs(q).max() > 10.0 and np.abs(want).max() > 10.0
    # same charges, to 1e-4 relative: the divergent network amplifies the
    # two packages' float32 summation noise past the 1e-5 bar
    assert np.abs(q - want).max() < 1e-4 * (np.abs(want).max() + 1.0)
    assert np.abs(port_b16.predict_molecules(_port([box]))[0]).max() < 1.5


@pytest.mark.parametrize("n_molecules,lo,hi", [
    (8, 1.0, 2.0),       # 24 atoms: inside its training sizes
    (300, 1e4, 1e7),     # 900 atoms
    (740, 1e6, 1e9),     # 2,220 atoms, the protein size
])
def test_mixed_repaired_grows_with_size(predictors, n_molecules, lo, hi):
    """The size sweep behind the ROADMAP note: on water boxes of seed 0,
    mixed_repaired_b16's max|q| grows by orders of magnitude with the
    atom count (its message sums run over all N atoms), while mixed_b16
    stays near 1 e."""
    port_b16, _ = predictors
    mols = _port([water_box(n_molecules, seed=0)])
    repaired = Predictor.from_checkpoint(
        CKPT.replace("mixed_b16", "mixed_repaired_b16"), device="cpu")
    assert lo < np.abs(repaired.predict_molecules(mols)[0]).max() < hi
    assert np.abs(port_b16.predict_molecules(mols)[0]).max() < 1.5
