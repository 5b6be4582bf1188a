"""Model configuration and named presets (counterpart of
``epnn_tpu/models/config.py``; same fields, same defaults, so a
``config.json`` written by either package loads in both)."""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class EPNNConfig:
    """Architecture hyperparameters.

    Attributes:
      n_elems: per-atom feature width ([Z, onehot]; 10 → 9-element table,
        9 → 8-element table).
      h_dim: hidden-state width.
      e_dim: RBF edge channels.
      msg_dim: message width.
      mlp_hidden: hidden widths of every MLP.
      T: rounds of message passing AND of electron passing.
      cutoff / eta: RBF physics constants.
      mask_messages: pairwise-mask GNN messages (clean default); False
        reproduces the reference's unmasked, padding-width-dependent sums.
      pass_weighting: 'hard_gate' (is-near indicator) or 'soft_envelope'
        (cosine-cutoff envelope).
      is_near_tol: the gate tolerance.
      compute_dtype / highest_precision / matmul_precision /
        dense_matmul_precision: the JAX package's precision policy, with its
        names, defaults and routes.  Three precisions are resolved from
        them, each by one function here: :func:`main_precision` (the pair
        MLPs, the fused dense kernels), :func:`dense_precision` (the far
        field) and :func:`near_precision` (the two near kernels).  Each is
        'default', 'high' or 'highest' ('bf16x3' for the far field too).
        On the card 'default' runs the tensor-core kernels at one TF32
        product a k-step, 'high' and 'highest' in 3xTF32; on the CPU the
        kernels' plain versions run in float32 at every precision, as
        XLA:CPU runs 'default'.  Plain products outside the kernels stay
        float32 at every precision (the port sets no global TF32 flag).
        dense_matmul_precision='bf16x3' runs the far field's plain version
        in JAX's split-float arithmetic (JAX runs no kernel there);
        'int8' is the far field's int8 serving tier, taken by the neighbor
        split with ``use_pallas`` (on the card, ``Predictor``'s default),
        and otherwise the far field at 'default', as in the JAX package.
        compute_dtype='bfloat16' runs JAX's bf16 recursion: messages,
        update weights and activations in bfloat16, the pass rounds and
        the charges in float32, the output float32.
    """

    n_elems: int = 10
    h_dim: int = 48
    e_dim: int = 48
    msg_dim: int = 32
    mlp_hidden: Tuple[int, ...] = (32, 32)
    T: int = 5
    cutoff: float = 3.0
    eta: float = 2.0
    mask_messages: bool = True
    pass_weighting: str = "hard_gate"
    is_near_tol: float = 1e-5
    compute_dtype: str = "float32"
    highest_precision: bool = True
    matmul_precision: str = ""
    dense_matmul_precision: str = ""

    @property
    def atom_feat_dim(self) -> int:
        """Width of the per-atom pair-input slice: [x, h, q]."""
        return self.n_elems + self.h_dim + 1

    @property
    def pair_feat_dim(self) -> int:
        """Width of a pair-MLP input row: [a_i, a_j, e_ij]."""
        return 2 * self.atom_feat_dim + self.e_dim

    def replace(self, **kw) -> "EPNNConfig":
        return dataclasses.replace(self, **kw)


#: the precision names of the JAX package's kernels and dots
PRECISIONS = ("default", "high", "highest")


def _checked(name: str, field: str, allowed=PRECISIONS) -> str:
    if name not in allowed:
        raise ValueError(f"{field}={name!r}: one of {allowed}")
    return name


def main_precision(cfg: EPNNConfig) -> str:
    """The model's precision, JAX's ``_resolve_precision`` by name
    (``epnn_tpu/ops/fused.py:44-52``): ``matmul_precision`` where set, else
    'highest' or 'default' from ``highest_precision``."""
    return _checked(cfg.matmul_precision or (
        "highest" if cfg.highest_precision else "default"),
        "matmul_precision")


def dense_precision(cfg: EPNNConfig) -> str:
    """The far field's precision (``epnn_tpu/ops/fused.py:1064-1080``,
    ``:1098-1102``): ``dense_matmul_precision`` where set — 'bf16x3' as it
    is, 'int8' as 'default' (the precision of the int8 kernel's call and of
    the unquantized far field that stands in for it) — else
    :func:`main_precision`."""
    name = cfg.dense_matmul_precision
    if name == "int8":
        return "default"
    if name:
        return _checked(name, "dense_matmul_precision",
                        PRECISIONS + ("bf16x3",))
    return main_precision(cfg)


def near_precision(cfg: EPNNConfig) -> str:
    """The near kernels' precision (``epnn_tpu/ops/fused.py:1137-1138``):
    the model's, :func:`main_precision`."""
    return main_precision(cfg)


def reference_compat(cfg: EPNNConfig) -> EPNNConfig:
    """``cfg`` with the reference's quirk switches on: unmasked message
    sums (``mask_messages=False``)."""
    return cfg.replace(mask_messages=False)


#: Presets matching the three reference checkpoints; ``*_clean`` variants
#: use pairwise-masked messages.
PRESETS = {
    "model": EPNNConfig(n_elems=10, T=5, mask_messages=False),
    "model2": EPNNConfig(n_elems=9, T=3, mask_messages=False),
    "decay_model": EPNNConfig(n_elems=9, T=5, mask_messages=False),
    "model_clean": EPNNConfig(n_elems=10, T=5),
    "model2_clean": EPNNConfig(n_elems=9, T=3),
    "decay_model_clean": EPNNConfig(n_elems=9, T=5),
}
