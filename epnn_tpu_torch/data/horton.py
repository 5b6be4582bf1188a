"""HORTON MBIS multipole → per-atom charge labels (counterpart of
``epnn_tpu/data/horton.py``, the same bytes out).

Format of a ``*-mtp.txt`` file:

    line 0: "number of atoms: N"
    line 1: "number of fields: F"
    line 2: "Multipoles"
    line 3: "---"
    line 4+: "<i> <i> <i> | <monopole> <dipole...> ..."

The monopole (space-token 4, the first value after the pipe) is the MBIS
atomic charge; one float64 ``.npy`` of shape (natom,) is written per input
file.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

MTP_SUFFIX = "-mtp.txt"
_HEADER_LINES = 4


def parse_mtp_text(text: str) -> np.ndarray:
    charges: List[float] = []
    for i, line in enumerate(text.splitlines()):
        if i < _HEADER_LINES or not line.strip():
            continue
        toks = line.split(" ")
        if len(toks) <= 4:
            raise ValueError(f"malformed MBIS multipole line {i}: {line!r}")
        charges.append(float(toks[4]))
    return np.asarray(charges, dtype=np.float64)


def parse_mtp_file(path: str) -> np.ndarray:
    with open(path, "r") as f:
        return parse_mtp_text(f.read())


def convert_tree(path: str, out_dir: str | None = None) -> Dict[str, str]:
    """Walk ``path`` recursively; for every ``*-mtp.txt`` write
    ``<stem>-mtp.npy`` (next to the source, or under ``out_dir``).
    Returns {input path: output path}."""
    written: Dict[str, str] = {}
    for root, _dirs, files in os.walk(path):
        for fname in files:
            if not fname.endswith(MTP_SUFFIX):
                continue
            src = os.path.join(root, fname)
            charges = parse_mtp_file(src)
            dest_dir = out_dir if out_dir is not None else root
            os.makedirs(dest_dir, exist_ok=True)
            dst = os.path.join(dest_dir, fname[:-4] + ".npy")
            np.save(dst, charges, allow_pickle=True)
            written[src] = dst
    return written
