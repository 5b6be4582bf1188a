"""Per-atom features ``[Z, onehot]``: a frozen copy of the element tables
of ``epnn_tpu_torch.elements`` (feature width 10: the 9-element training
table; 9: the 8-element inference table, no P)."""

from __future__ import annotations

from typing import Sequence

import numpy as np

Z = {"H": 1, "C": 6, "N": 7, "O": 8, "F": 9, "P": 15, "S": 16, "Cl": 17,
     "Br": 35}
TABLES = {
    10: ("H", "C", "N", "O", "F", "P", "S", "Cl", "Br"),
    9: ("H", "C", "N", "O", "F", "S", "Cl", "Br"),
}


def features(symbols: Sequence[str], n_elems: int) -> np.ndarray:
    """(natom, n_elems) float32 rows ``[Z, onehot]``."""
    table = TABLES[n_elems]
    out = np.zeros((len(symbols), n_elems), np.float32)
    for i, s in enumerate(symbols):
        out[i, 0] = Z[s]
        out[i, table.index(s) + 1] = 1.0
    return out
