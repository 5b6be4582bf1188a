"""The committed golden charges ``epnn_tpu_torch/testdata/water2220_mixed_b16
.npz`` — what the JAX Predictor gives for the 2,220-atom water boxes that
``chip_smoke.py`` serves on the card — regenerated here with JAX, so the
file can neither go stale nor be made up.

Write the file anew with ``python tests/test_torch_golden.py``.
"""

import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "trained", "mixed_b16")
GOLDEN = os.path.join(ROOT, "epnn_tpu_torch", "testdata",
                      "water2220_mixed_b16.npz")


def golden_charges():
    """(2, 2220) JAX charges: box seed 0 with Q = 0, box seed 1 with Q = +1
    (the ``epnn_tpu_torch.testing.GOLDEN_BOXES`` batch)."""
    from epnn_tpu.data.dataset import pad_molecules
    from epnn_tpu.data.xyz import Molecule
    from epnn_tpu.elements import table_for_n_elems
    from epnn_tpu.infer import Predictor
    from epnn_tpu_torch.testing import golden_boxes

    mols = [Molecule(name=m.name, symbols=m.symbols, xyz=m.xyz,
                     total_charge=m.total_charge) for m in golden_boxes()]
    batch = pad_molecules(mols, table_for_n_elems(10))
    q = Predictor.from_checkpoint(CKPT).predict_batch(batch)
    return np.asarray(q[:, :mols[0].natoms], np.float32), batch.total_q


def test_golden_is_current():
    with np.load(GOLDEN) as f:
        stored, total_q = f["charges"], f["total_q"]
    q, tq = golden_charges()
    assert stored.shape == q.shape == (2, 2220)
    np.testing.assert_array_equal(total_q, tq)
    assert np.abs(stored - q).max() <= 1e-6 * (np.abs(q).max() + 1.0)
    # water charges from the trained model: O negative, H positive, Σq = Q
    assert stored[:, 0::3].mean() < -0.5 and stored[:, 1::3].mean() > 0.2
    assert np.all(np.abs(stored.astype(np.float64).sum(1) - total_q) < 1e-4)


if __name__ == "__main__":
    import sys

    import jax

    sys.path.insert(0, ROOT)
    jax.config.update("jax_platforms", "cpu")
    q, tq = golden_charges()
    np.savez_compressed(GOLDEN, charges=q, total_q=tq)
    print(GOLDEN, q.shape, float(np.abs(q).max()), q.sum(1))
