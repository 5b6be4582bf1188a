"""The reference's loader layout, for code written against it
(counterpart of ``epnn_tpu/compat.py``).

:func:`gen_padded_init_state` returns the reference's tiled arrays
(``gen_padded_init_state``, charge_gn.py:292-366) from this package's
data layer, in float64:

* per-atom features, hidden state and charges tiled across a full
  (natom × natom) plane (row j holds a copy of the per-atom array),
* edges zero-padded to the directory's largest system,
* mask = ones over the (molec_size × molec_size) block,
* Q from line-2 token 0, labels zero-filled (with a printed note) when
  missing.

The models never use this layout (they take per-atom arrays).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from epnn_tpu_torch.data.xyz import load_directory
from epnn_tpu_torch.elements import TRAIN_TABLE, ElementTable
from epnn_tpu_torch.featurize import rbf_edges_np


def gen_padded_init_state(
    path: str,
    h_dim: int,
    e_dim: int,
    table: ElementTable = TRAIN_TABLE,
) -> Tuple[np.ndarray, ...]:
    """Reference-layout loader: returns (x, h, q, e, Q, y, mask, names),
    shapes (nmol, N, N, ·) with N the largest system in the directory, in
    directory order."""
    mols = load_directory(path, sort=False)
    if not mols:
        raise ValueError(f"no .xyz files under {path}")
    n = max(m.natoms for m in mols)
    nmol = len(mols)
    f = table.n_features

    x = np.zeros((nmol, n, n, f), np.float64)
    h = np.zeros((nmol, n, n, h_dim), np.float64)
    q = np.zeros((nmol, n, n, 1), np.float64)
    e = np.zeros((nmol, n, n, e_dim), np.float64)
    y = np.zeros((nmol, n, 1), np.float64)
    mask = np.zeros((nmol, n, n), np.float64)
    big_q = np.zeros((nmol,), np.float32)
    names = []

    for i, m in enumerate(mols):
        ni = m.natoms
        names.append(m.name)
        big_q[i] = m.total_charge
        if m.labels is not None:
            y[i, :ni, 0] = m.labels
        else:
            print("No labels provided, y set to 0")
        feats = table.featurize_symbols(m.symbols)
        x[i, :ni, :ni] = feats[None, :, :]
        q[i, :ni, :ni, 0] = np.float32(m.total_charge) / ni
        e[i, :ni, :ni], _ = rbf_edges_np(m.xyz, e_dim=e_dim)
        mask[i, :ni, :ni] = 1.0

    return x, h, q, e, big_q, y, mask, np.array(names)
