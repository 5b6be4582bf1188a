"""Checkpoints (counterpart of ``epnn_tpu/io/checkpoint.py``).

A checkpoint directory holds ``config.json`` (the :class:`EPNNConfig`
fields) and ``params.msgpack``, a flax-serialized parameter tree: a
msgpack map whose array leaves are msgpack ext type 1 holding the packed
tuple ``(shape, dtype name, C-order bytes)``.  It decodes with plain
``msgpack``; :func:`from_jax_params` then turns the tree into this
package's parameters — the one place weights cross from the JAX layout.
:func:`save_params` writes the same format, so the JAX package's
``load_params`` reads what this package trains.

A training run adds ``train_state.msgpack`` (this package's own layout:
params, the Adam moments as trees of the same shape, the step, and the
optimizer's extras: Adam's update count, the plateau's rate, the open
gradient-accumulation window) and
``meta.json`` (epoch counters and best-val metrics).  Every file is
written atomically.  :func:`save_train_state_orbax` writes the same state
with ``torch.distributed.checkpoint`` into ``dcp/``, the sharding-aware
format (the JAX package's orbax backend).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional, Tuple

import msgpack
import numpy as np
import torch

from epnn_tpu_torch.models.config import EPNNConfig
from epnn_tpu_torch.models.epnn import map_tree, param_shapes

CONFIG_FILE = "config.json"
PARAMS_FILE = "params.msgpack"
STATE_FILE = "train_state.msgpack"
META_FILE = "meta.json"

_EXT_NDARRAY = 1


def _write_atomic(path: str, data, mode: str = "wb") -> None:
    """Write via a same-directory temp file and ``os.replace`` (atomic on
    POSIX): a crash mid-save leaves the previous file intact, never a torn
    one.  fsync before the rename, so the rename cannot overtake the
    data."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, mode) as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _ext_default(obj: Any) -> msgpack.ExtType:
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    if not isinstance(obj, np.ndarray):
        raise TypeError(f"cannot serialize {type(obj).__name__}")
    arr = np.ascontiguousarray(obj)
    return msgpack.ExtType(_EXT_NDARRAY, msgpack.packb(
        (arr.shape, arr.dtype.name, arr.tobytes("C")), use_bin_type=True))


def encode_msgpack(tree: Any) -> bytes:
    """A tree of dicts with tensor or array leaves as flax-serialized
    msgpack bytes (the inverse of :func:`decode_msgpack`)."""
    return msgpack.packb(tree, default=_ext_default, strict_types=True)


def _numpy_tree(tree: dict) -> dict:
    return map_tree(lambda v: v.detach().cpu().numpy().astype(np.float32),
                    tree)


def save_config(directory: str, cfg: EPNNConfig) -> None:
    os.makedirs(directory, exist_ok=True)
    _write_atomic(os.path.join(directory, CONFIG_FILE),
                  json.dumps(dataclasses.asdict(cfg), indent=2), "w")


def save_params(directory: str, params: dict,
                cfg: Optional[EPNNConfig] = None) -> None:
    """``params.msgpack`` in the flax layout (the tree under an outer
    ``"params"`` key, float32 leaves), plus ``config.json`` with ``cfg``."""
    os.makedirs(directory, exist_ok=True)
    tree = params if "params" in params else {"params": params}
    _write_atomic(os.path.join(directory, PARAMS_FILE),
                  encode_msgpack(_numpy_tree(tree)))
    if cfg is not None:
        save_config(directory, cfg)


def save_train_state(directory: str, params: dict, exp_avg: dict,
                     exp_avg_sq: dict, step: int,
                     meta: Optional[dict] = None,
                     extras: Optional[dict] = None) -> None:
    """The full train state — params, Adam's first and second moments in
    the params' tree layout, the step, the optimizer's ``extras``
    (``train.loop.Optimizer.extras``) — and ``meta.json``."""
    os.makedirs(directory, exist_ok=True)
    state = {"params": params, "exp_avg": exp_avg, "exp_avg_sq": exp_avg_sq}
    state = _numpy_tree(state)
    state["step"] = int(step)
    if extras is not None:
        state["opt"] = extras
    _write_atomic(os.path.join(directory, STATE_FILE), encode_msgpack(state))
    if meta is not None:
        meta = {k: (v.item() if isinstance(v, np.generic) else v)
                for k, v in meta.items()}
        _write_atomic(os.path.join(directory, META_FILE),
                      json.dumps(meta, indent=2), "w")


def load_train_state(directory: str) -> Tuple[dict, dict, dict, int, dict]:
    """``(params, exp_avg, exp_avg_sq, step, extras)`` from
    :func:`save_train_state`, the tensors on the CPU (``extras``: ``{}``
    where none were saved)."""
    with open(os.path.join(directory, STATE_FILE), "rb") as f:
        state = decode_msgpack(f.read())
    return (from_jax_params(state["params"]),
            from_jax_params(state["exp_avg"]),
            from_jax_params(state["exp_avg_sq"]), int(state["step"]),
            state.get("opt", {}))


#: the sharding-aware train-state format's subdirectory
DCP_DIR = "dcp"


def _dcp_state(state) -> dict:
    """A ``TrainState`` as the state dict ``torch.distributed.checkpoint``
    writes and loads in place: the parameter leaves (detached views of
    the state's own), Adam's moments (zeros before the first update,
    fresh tensors otherwise), the step, and the optimizer's extras as
    tensors (the open gradient-accumulation window as zeros with
    ``acc_open`` 0 where none is open)."""
    from epnn_tpu_torch.models import tree_leaves
    from epnn_tpu_torch.train.loop import _adam_moments

    params = map_tree(torch.Tensor.detach, state.params)
    exp_avg, exp_avg_sq = _adam_moments(state)
    opt = state.opt
    acc = opt.acc if opt.acc is not None else [
        torch.zeros_like(p).detach() for p in tree_leaves(state.params)]
    return {
        "params": params,
        "exp_avg": map_tree(torch.Tensor.clone, exp_avg),
        "exp_avg_sq": map_tree(torch.Tensor.clone, exp_avg_sq),
        "step": torch.tensor(int(state.step), dtype=torch.int64),
        "opt": {"count": torch.tensor(int(opt.count), dtype=torch.int64),
                "lr": opt.lr.detach().clone().to(torch.float32),
                "mini_step": torch.tensor(int(opt.mini_step),
                                          dtype=torch.int64),
                "acc_open": torch.tensor(int(opt.acc is not None),
                                         dtype=torch.int64),
                "acc": {str(i): a.detach().clone()
                        for i, a in enumerate(acc)}},
    }


def save_train_state_orbax(directory: str, state: Any) -> None:
    """The sharding-aware train-state format, the counterpart of the JAX
    package's orbax backend (``epnn_tpu/io/checkpoint.py:93``, whose name
    it keeps): ``state`` (a ``train.loop.TrainState``) written with
    ``torch.distributed.checkpoint`` into ``<directory>/dcp``, beside the
    single-host ``train_state.msgpack`` (the formats coexist, as JAX's
    do).  Under a process group every rank calls it and the ranks write
    one checkpoint together: a training mesh keeps every rank's
    parameters the same bits, so DCP's deduplication of replicated
    tensors writes each leaf once.  Without one it writes alone.  Its
    files are the port's (no orbax, and not readable by the JAX package,
    as ``train_state.msgpack``)."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(os.path.join(directory, DCP_DIR))
    os.makedirs(path, exist_ok=True)
    dcp.save(_dcp_state(state), checkpoint_id=path)


def load_train_state_orbax(directory: str, template: Any) -> Any:
    """:func:`save_train_state_orbax`'s state loaded into ``template`` (a
    ``TrainState`` of the same model and train config, from
    ``train.loop.create_state``), in place and on its device: the
    parameter leaves, Adam's moments and update count, the injected rate,
    the open accumulation window and the step.  Returns ``template``."""
    import torch.distributed.checkpoint as dcp

    from epnn_tpu_torch.train.loop import _restore

    path = os.path.abspath(os.path.join(directory, DCP_DIR))
    sd = _dcp_state(template)
    dcp.load(sd, checkpoint_id=path)
    opt = sd["opt"]
    extras = {"count": int(opt["count"]), "lr": float(opt["lr"]),
              "mini_step": int(opt["mini_step"])}
    if int(opt["acc_open"]):
        extras["acc_grads"] = [opt["acc"][str(i)]
                               for i in range(len(opt["acc"]))]
    _restore(template, sd["params"], sd["exp_avg"], sd["exp_avg_sq"],
             int(sd["step"]), extras)
    return template


def load_meta(directory: str) -> dict:
    path = os.path.join(directory, META_FILE)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


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
