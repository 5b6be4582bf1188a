"""``.xyz`` geometry parsing (counterpart of ``epnn_tpu/data/xyz.py``,
pure-Python parser only).

File format: line 1 atom count (ignored — the count is inferred from the
atom lines); line 2 first token = float net charge Q; lines 3+ ``<element>
<x> <y> <z> [extra tokens ignored]``.  A molecule may have a sibling
``<name>.npy`` (per-atom charge labels) and ``<name>splits.npy`` (scalar
monomer-B start index, metadata only).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Molecule:
    """One parsed system (monomer, dimer, or whole protein)."""

    name: str
    symbols: List[str]
    xyz: np.ndarray            # (natom, 3) float32
    total_charge: float        # Q, from line-2 token 0
    labels: Optional[np.ndarray] = None   # (natom,) float32 per-atom charges
    split: Optional[int] = None           # dimer monomer-B start index

    @property
    def natoms(self) -> int:
        return len(self.symbols)


class XYZParseError(ValueError):
    pass


def parse_xyz_text(text: str, name: str = "") -> Molecule:
    lines = text.splitlines()
    label = name or "<string>"
    if len(lines) < 3:
        raise XYZParseError(f"{label}: need >=3 lines, got {len(lines)}")
    head = lines[1].split()
    if not head:
        raise XYZParseError(f"{label}: blank charge line")
    try:
        q_total = float(head[0])
    except ValueError as exc:
        raise XYZParseError(
            f"{label}: line-2 token {head[0]!r} is not a float net charge"
        ) from exc

    symbols: List[str] = []
    coords: List[Sequence[float]] = []
    for ln in lines[2:]:
        toks = ln.split()
        if not toks:
            continue
        if len(toks) < 4:
            raise XYZParseError(f"{label}: malformed atom line {ln!r}")
        symbols.append(toks[0])
        coords.append((float(toks[1]), float(toks[2]), float(toks[3])))
    if not symbols:
        raise XYZParseError(f"{label}: no atom lines")
    return Molecule(name=name, symbols=symbols,
                    xyz=np.asarray(coords, dtype=np.float32),
                    total_charge=q_total)


def parse_xyz_file(path: str) -> Molecule:
    name = os.path.basename(path)
    if name.endswith(".xyz"):
        name = name[:-4]
    with open(path, "r") as f:
        return parse_xyz_text(f.read(), name=name)


def load_molecule(xyz_path: str, require_labels: bool = False) -> Molecule:
    """Parse a .xyz plus its optional sibling label / splits files."""
    mol = parse_xyz_file(xyz_path)
    stem = xyz_path[:-4] if xyz_path.endswith(".xyz") else xyz_path
    label_path = stem + ".npy"
    if os.path.exists(label_path):
        labels = np.asarray(np.load(label_path), dtype=np.float32).reshape(-1)
        if labels.shape[0] != mol.natoms:
            raise XYZParseError(
                f"{xyz_path}: {mol.natoms} atoms but {labels.shape[0]} labels")
        mol.labels = labels
    elif require_labels:
        raise FileNotFoundError(label_path)
    splits_path = stem + "splits.npy"
    if os.path.exists(splits_path):
        split = np.load(splits_path)
        if split.shape == ():
            mol.split = int(split)
    return mol
