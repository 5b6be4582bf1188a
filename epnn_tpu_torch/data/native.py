"""ctypes binding to the repository's C++ host library
``native/libepnn_native.so`` (built from ``native/`` with ``make -C
native``): its bulk ``.xyz`` parser here, its TensorBundle reader in
:mod:`epnn_tpu_torch.io.bundle_native`.  Counterpart of
``epnn_tpu/data/native.py``.

The library is a host parser, not a device kernel.  When it is not built
(or fails to load) :func:`available` is False and the callers fall back to
the pure-Python parsers, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional

import numpy as np

LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "native", "libepnn_native.so")

_LIB: Optional[ctypes.CDLL] = None
_LOAD_TRIED = False


def library() -> Optional[ctypes.CDLL]:
    """The loaded library with the parser's signature declared, or None
    where it is not built; loaded once a process."""
    global _LIB, _LOAD_TRIED
    if _LOAD_TRIED:
        return _LIB
    _LOAD_TRIED = True
    if not os.path.exists(LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(LIB_PATH)
    except OSError:
        return None
    lib.epnn_parse_xyz.restype = ctypes.c_int
    lib.epnn_parse_xyz.argtypes = [
        ctypes.c_char_p,                    # path
        ctypes.POINTER(ctypes.c_int),       # natoms out
        ctypes.POINTER(ctypes.c_double),    # Q out
        ctypes.POINTER(ctypes.c_float),     # xyz out (cap*3)
        ctypes.c_char_p,                    # symbols out (cap*4)
        ctypes.c_int,                       # capacity (atoms)
    ]
    _LIB = lib
    return _LIB


def available() -> bool:
    return library() is not None


_MAX_ATOMS = 65536

# scratch buffers reused across calls: a fresh 1 MB pair per molecule
# would dominate bulk parsing of thousands of small files
_SCRATCH_COORDS: Optional[np.ndarray] = None
_SCRATCH_SYMS: Optional[np.ndarray] = None


def _scratch():
    global _SCRATCH_COORDS, _SCRATCH_SYMS
    if _SCRATCH_COORDS is None:
        _SCRATCH_COORDS = np.empty((_MAX_ATOMS, 3), dtype=np.float32)
        _SCRATCH_SYMS = np.zeros(_MAX_ATOMS * 4, dtype=np.uint8)
    return _SCRATCH_COORDS, _SCRATCH_SYMS


def parse_xyz_file(path: str):
    """One ``.xyz`` through the native parser: a Molecule, or None where
    the library is absent or rejects the file."""
    from epnn_tpu_torch.data.xyz import Molecule

    lib = library()
    if lib is None:
        return None
    coords, syms = _scratch()
    natoms = ctypes.c_int(0)
    q = ctypes.c_double(0.0)
    rc = lib.epnn_parse_xyz(
        path.encode(),
        ctypes.byref(natoms),
        ctypes.byref(q),
        coords.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        syms.ctypes.data_as(ctypes.c_char_p),
        _MAX_ATOMS,
    )
    if rc != 0:
        return None
    n = natoms.value
    raw = syms[: n * 4].tobytes()
    symbols = [raw[i * 4:(i + 1) * 4].rstrip(b"\x00").decode()
               for i in range(n)]
    name = os.path.basename(path)
    if name.endswith(".xyz"):
        name = name[:-4]
    return Molecule(name=name, symbols=symbols, xyz=coords[:n].copy(),
                    total_charge=q.value)


def load_directory(path: str, names: List[str],
                   require_labels: bool = False):
    """Bulk-parse ``names`` in ``path`` with the native parser (a file it
    rejects goes through the Python parser); labels and splits by
    :func:`epnn_tpu_torch.data.xyz.attach_sidecars`."""
    from epnn_tpu_torch.data import xyz as pyxyz

    mols = []
    for fname in names:
        full = os.path.join(path, fname)
        mol = parse_xyz_file(full)
        if mol is None:
            mol = pyxyz.parse_xyz_file(full)
        mols.append(pyxyz.attach_sidecars(mol, full, require_labels))
    return mols
