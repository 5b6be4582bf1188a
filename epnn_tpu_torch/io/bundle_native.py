"""ctypes binding to the TensorBundle reader of the repository's C++ host
library (``native/bundle_reader.cc``, loaded by
:func:`epnn_tpu_torch.data.native.library`); counterpart of
``epnn_tpu/io/bundle_native.py``.  :mod:`epnn_tpu_torch.io.bundle_reader`
is the reference it agrees with bit for bit, and the fallback where the
library is absent or was built without the bundle reader.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np

from epnn_tpu_torch.data import native
from epnn_tpu_torch.io.bundle_reader import _DT_STRING, _DTYPES, BundleError

_DECLARED = False


def _load() -> Optional[ctypes.CDLL]:
    """The library with the bundle reader's signatures declared, or None
    where it is absent or predates the bundle reader."""
    global _DECLARED
    lib = native.library()
    if lib is None or not hasattr(lib, "epnn_bundle_open"):
        return None
    if not _DECLARED:
        lib.epnn_bundle_open.restype = ctypes.c_void_p
        lib.epnn_bundle_open.argtypes = [ctypes.c_char_p]
        lib.epnn_bundle_count.restype = ctypes.c_int
        lib.epnn_bundle_count.argtypes = [ctypes.c_void_p]
        lib.epnn_bundle_name.restype = ctypes.c_char_p
        lib.epnn_bundle_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.epnn_bundle_dtype.restype = ctypes.c_int
        lib.epnn_bundle_dtype.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.epnn_bundle_rank.restype = ctypes.c_int
        lib.epnn_bundle_rank.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.epnn_bundle_shape.restype = ctypes.POINTER(ctypes.c_longlong)
        lib.epnn_bundle_shape.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.epnn_bundle_data.restype = ctypes.c_void_p
        lib.epnn_bundle_data.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.epnn_bundle_nbytes.restype = ctypes.c_longlong
        lib.epnn_bundle_nbytes.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.epnn_bundle_close.restype = None
        lib.epnn_bundle_close.argtypes = [ctypes.c_void_p]
        lib.epnn_bundle_error.restype = ctypes.c_char_p
        lib.epnn_bundle_error.argtypes = []
        _DECLARED = True
    return lib


def available() -> bool:
    return _load() is not None


def read_bundle_native(prefix: str) -> Dict[str, np.ndarray]:
    """Read every numeric tensor of a TF checkpoint via the C++ parser."""
    lib = _load()
    if lib is None:
        raise BundleError("native bundle reader not built (make -C native)")
    handle = lib.epnn_bundle_open(prefix.encode())
    if not handle:
        raise BundleError(
            f"{prefix}: {lib.epnn_bundle_error().decode(errors='replace')}")
    try:
        out: Dict[str, np.ndarray] = {}
        for i in range(lib.epnn_bundle_count(handle)):
            tf_dtype = lib.epnn_bundle_dtype(handle, i)
            if tf_dtype == _DT_STRING:
                continue  # object-graph metadata
            dtype = _DTYPES.get(tf_dtype)
            if dtype is None:
                continue
            name = lib.epnn_bundle_name(handle, i).decode()
            rank = lib.epnn_bundle_rank(handle, i)
            shape = tuple(lib.epnn_bundle_shape(handle, i)[k]
                          for k in range(rank))
            nbytes = lib.epnn_bundle_nbytes(handle, i)
            buf = ctypes.string_at(lib.epnn_bundle_data(handle, i), nbytes)
            out[name] = np.frombuffer(buf, dtype=dtype).reshape(shape)
        return out
    finally:
        lib.epnn_bundle_close(handle)
