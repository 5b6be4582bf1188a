"""Checkpoint reading (counterpart of ``epnn_tpu/io/checkpoint.py``).

A checkpoint directory holds ``config.json`` (the :class:`EPNNConfig`
fields) and ``params.msgpack``, a flax-serialized parameter tree: a
msgpack map whose array leaves are msgpack ext type 1 holding the packed
tuple ``(shape, dtype name, C-order bytes)``.  It decodes with plain
``msgpack``; :func:`from_jax_params` then turns the tree into this
package's parameters — the one place weights cross from the JAX layout.
"""

from __future__ import annotations

import json
import os
from typing import Any

import msgpack
import numpy as np
import torch

from epnn_tpu_torch.models.config import EPNNConfig
from epnn_tpu_torch.models.epnn import param_shapes

CONFIG_FILE = "config.json"
PARAMS_FILE = "params.msgpack"
STATE_FILE = "train_state.msgpack"

_EXT_NDARRAY = 1


def load_config(directory: str) -> EPNNConfig:
    with open(os.path.join(directory, CONFIG_FILE)) as f:
        d = json.load(f)
    d["mlp_hidden"] = tuple(d.get("mlp_hidden", (32, 32)))
    return EPNNConfig(**d)


def has_checkpoint(directory: str) -> bool:
    return os.path.exists(os.path.join(directory, STATE_FILE)) or os.path.exists(
        os.path.join(directory, PARAMS_FILE))


def _ext_hook(code: int, data: bytes) -> Any:
    if code != _EXT_NDARRAY:
        return msgpack.ExtType(code, data)
    shape, dtype, buf = msgpack.unpackb(data, raw=False)
    # np.frombuffer views the msgpack buffer read-only: copy it out
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()


def decode_msgpack(data: bytes) -> dict:
    """Decode flax-serialized msgpack bytes into a tree of numpy arrays."""
    return msgpack.unpackb(data, ext_hook=_ext_hook, raw=False,
                           strict_map_key=False)


def from_jax_params(tree: dict, cfg: EPNNConfig | None = None) -> dict:
    """The JAX params tree (numpy leaves, with or without the outer
    ``"params"`` key) as this package's parameters: the same nested dict
    of float32 CPU tensors.  With ``cfg`` every kernel and bias shape is
    checked against the config and a mismatch raises ``ValueError``."""
    if "params" in tree:
        tree = tree["params"]
    out = {}
    for name, layers in tree.items():
        out[name] = {}
        for dname, leaf in layers.items():
            out[name][dname] = {
                k: torch.from_numpy(np.array(leaf[k], np.float32, copy=True))
                for k in ("kernel", "bias")}
    if cfg is not None:
        check_shapes(out, cfg)
    return out


def check_shapes(params: dict, cfg: EPNNConfig) -> None:
    want = param_shapes(cfg)
    if set(params) != set(want):
        raise ValueError(f"parameter tree has MLPs {sorted(params)}, config "
                         f"needs {sorted(want)}")
    for name, layers in want.items():
        if set(params[name]) != set(layers):
            raise ValueError(f"{name}: layers {sorted(params[name])}, config "
                             f"needs {sorted(layers)}")
        for dname, (fan_in, fan_out) in layers.items():
            leaf = params[name][dname]
            if (tuple(leaf["kernel"].shape) != (fan_in, fan_out)
                    or tuple(leaf["bias"].shape) != (fan_out,)):
                raise ValueError(
                    f"{name}/{dname}: kernel {tuple(leaf['kernel'].shape)} "
                    f"bias {tuple(leaf['bias'].shape)}, config needs "
                    f"({fan_in}, {fan_out}) and ({fan_out},)")


def load_params(directory: str, cfg: EPNNConfig) -> dict:
    """``params.msgpack`` decoded and carried over by
    :func:`from_jax_params` (shapes checked against ``cfg``)."""
    with open(os.path.join(directory, PARAMS_FILE), "rb") as f:
        tree = decode_msgpack(f.read())
    return from_jax_params(tree, cfg)
