"""Import the reference's TF object-based checkpoints (counterpart of
``epnn_tpu/io/tf_import.py``): the same variable mapping, inferred config
and errors, returning this package's parameters.

Variable layout of the reference checkpoints:

    layer_with_weights-0/message_fns/<t>/layer_set/<k>/{kernel,bias}/...
    layer_with_weights-0/update_fn/layer_set/<k>/{kernel,bias}/...
    layer_with_weights-1/pass_fns/<t>/layer_set/<k>/{kernel,bias}/...

plus the **aliasing trap**: the reference re-assigns ``self.message_fn =
self.message_fns[t]`` every round, so the *last* round's MLPs are
checkpointed under the alias paths ``message_fn`` / ``pass_fn`` and are
absent from the indexed lists — ``T = len(message_fns) + 1`` and the alias
maps to round ``T - 1``.

Model hyperparameters are inferred from the weight shapes; the element
table follows from the pair-input width.  The bundle is read by the C++
reader (:mod:`epnn_tpu_torch.io.bundle_native`) where the library loads,
else by :mod:`epnn_tpu_torch.io.bundle_reader`; there is no TensorFlow
fallback, and the Python reader's :class:`BundleError` propagates.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Tuple

import numpy as np

from epnn_tpu_torch.io import bundle_native, bundle_reader
from epnn_tpu_torch.io.checkpoint import from_jax_params
from epnn_tpu_torch.models.config import EPNNConfig

_SUFFIX = "/.ATTRIBUTES/VARIABLE_VALUE"
_VAR_RE = re.compile(
    r"^layer_with_weights-(?P<layer>[01])/"
    r"(?P<fn>message_fns/(?P<mt>\d+)|message_fn|update_fn|pass_fns/(?P<pt>\d+)|pass_fn)/"
    r"layer_set/(?P<k>\d+)/(?P<leaf>kernel|bias)$"
)


def read_tf_checkpoint_raw(prefix: str) -> Dict[str, np.ndarray]:
    """Every numeric variable of a TF object-based checkpoint as numpy:
    through the C++ reader where it loads (falling back on its
    :class:`~epnn_tpu_torch.io.bundle_reader.BundleError`), else the
    pure-Python reader."""
    if bundle_native.available():
        try:
            return bundle_native.read_bundle_native(prefix)
        except bundle_reader.BundleError:
            pass
    return bundle_reader.read_bundle(prefix)


def import_checkpoint(prefix: str, e_dim: int = 48) -> Tuple[dict, EPNNConfig]:
    """Convert a reference checkpoint into (this package's params, the
    inferred config).

    The variables are grouped into the JAX package's tree (modules
    ``message_{t}``, ``update``, ``pass_{t}``, each of ``dense_{k}``
    kernels and biases) and carried over by
    :func:`~epnn_tpu_torch.io.checkpoint.from_jax_params`; the
    :class:`EPNNConfig`'s T / h_dim / msg_dim / mlp_hidden / n_elems are
    read off the weight shapes, with ``mask_messages=False`` (the
    reference's semantics)."""
    raw = read_tf_checkpoint_raw(prefix)

    groups: Dict[str, Dict[int, Dict[str, np.ndarray]]] = {}
    max_msg_t = -1
    max_pass_t = -1
    for name, arr in raw.items():
        stem = name[: -len(_SUFFIX)] if name.endswith(_SUFFIX) else name
        m = _VAR_RE.match(stem)
        if not m:
            continue
        fn = m.group("fn")
        if fn.startswith("message_fns/"):
            t = int(m.group("mt"))
            key = f"message_{t}"
            max_msg_t = max(max_msg_t, t)
        elif fn == "message_fn":
            key = "message_LAST"
        elif fn == "update_fn":
            key = "update"
        elif fn.startswith("pass_fns/"):
            t = int(m.group("pt"))
            key = f"pass_{t}"
            max_pass_t = max(max_pass_t, t)
        else:  # pass_fn alias
            key = "pass_LAST"
        groups.setdefault(key, {}).setdefault(int(m.group("k")), {})[
            m.group("leaf")] = arr

    if "message_LAST" not in groups or "pass_LAST" not in groups:
        raise ValueError(f"{prefix}: missing last-round alias variables")
    t_rounds = max_msg_t + 2  # indexed rounds 0..T-2 plus the alias
    if max_pass_t + 2 != t_rounds:
        raise ValueError(
            f"{prefix}: message rounds ({max_msg_t + 2}) != pass rounds "
            f"({max_pass_t + 2})"
        )
    groups[f"message_{t_rounds - 1}"] = groups.pop("message_LAST")
    groups[f"pass_{t_rounds - 1}"] = groups.pop("pass_LAST")

    tree = {
        key: {
            f"dense_{k}": {
                "kernel": layers[k]["kernel"].astype(np.float32),
                "bias": layers[k]["bias"].astype(np.float32),
            }
            for k in sorted(layers)
        }
        for key, layers in groups.items()
    }

    # hyperparameters from the shapes; msg_dim from the message MLP's own
    # last layer (its depth may differ from the update MLP's)
    update_layers = sorted(tree["update"])
    h_dim = tree["update"][update_layers[-1]]["bias"].shape[0]
    msg_last = max(tree["message_0"], key=lambda k: int(k.split("_")[1]))
    msg_dim = tree["message_0"][msg_last]["bias"].shape[0]
    pair_in = tree["message_0"]["dense_0"]["kernel"].shape[0]
    n_elems = (pair_in - e_dim) // 2 - h_dim - 1
    hidden = tuple(
        tree["update"][f"dense_{k}"]["bias"].shape[0]
        for k in range(len(update_layers) - 1)
    )
    cfg = EPNNConfig(
        n_elems=n_elems,
        h_dim=h_dim,
        e_dim=e_dim,
        msg_dim=msg_dim,
        mlp_hidden=hidden,
        T=t_rounds,
        mask_messages=False,
    )

    expect = 2 * (n_elems + h_dim + 1) + e_dim
    if pair_in != expect:
        raise ValueError(
            f"{prefix}: pair input width {pair_in} does not decompose as "
            f"2*(n_elems+h_dim+1)+e_dim with e_dim={e_dim}"
        )
    return from_jax_params(tree), cfg


_KNOWN = {"model": "model_weights", "model2": "model2_weights",
          "decay_model": "decay_model_weights"}


def import_reference_model(
    models_dir: str, name: str = "model"
) -> Tuple[dict, EPNNConfig]:
    """Import one of the three reference checkpoints by preset name (or
    any checkpoint under ``models_dir`` by its prefix's basename)."""
    prefix = os.path.join(models_dir, _KNOWN.get(name, name))
    return import_checkpoint(prefix)
