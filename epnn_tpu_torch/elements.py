"""Element tables for atomic featurization (counterpart of
``epnn_tpu/elements.py``).

A checkpoint bakes its table into its input width: feature width 10 is the
9-element training table, width 9 the 8-element inference table.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class ElementTable:
    """Maps element symbols to atomic numbers and one-hot slots.

    The per-atom feature vector is ``[Z, onehot]`` of length ``n_features =
    len(symbols) + 1``: slot 0 carries the raw atomic number, slots 1..
    the one-hot.
    """

    name: str
    symbols: Sequence[str]
    atomic_numbers: Mapping[str, int]

    @property
    def n_features(self) -> int:
        return len(self.symbols) + 1

    def index(self, symbol: str) -> int:
        return self.symbols.index(symbol)

    def feature_row(self, symbol: str) -> np.ndarray:
        row = np.zeros(self.n_features, dtype=np.float32)
        row[0] = self.atomic_numbers[symbol]
        row[self.index(symbol) + 1] = 1.0
        return row

    def featurize_symbols(self, symbols: Sequence[str]) -> np.ndarray:
        """(natom, n_features) feature matrix for a list of symbols."""
        out = np.zeros((len(symbols), self.n_features), dtype=np.float32)
        for i, s in enumerate(symbols):
            out[i, 0] = self.atomic_numbers[s]
            out[i, self.index(s) + 1] = 1.0
        return out


_Z = {
    "H": 1, "C": 6, "N": 7, "O": 8, "F": 9,
    "P": 15, "S": 16, "Cl": 17, "Br": 35,
}

#: 9-element training table; feature width 10.
TRAIN_TABLE = ElementTable(
    name="train9",
    symbols=("H", "C", "N", "O", "F", "P", "S", "Cl", "Br"),
    atomic_numbers=dict(_Z),
)

#: 8-element inference table (no P); feature width 9.
INFER_TABLE = ElementTable(
    name="infer8",
    symbols=("H", "C", "N", "O", "F", "S", "Cl", "Br"),
    atomic_numbers={k: v for k, v in _Z.items() if k != "P"},
)

TABLES = {t.name: t for t in (TRAIN_TABLE, INFER_TABLE)}


def table_for_n_elems(n_elems: int) -> ElementTable:
    """Pick the table whose feature width matches ``n_elems``."""
    for t in TABLES.values():
        if t.n_features == n_elems:
            return t
    raise ValueError(f"no element table with feature width {n_elems}")
