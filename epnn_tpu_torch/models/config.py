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
        dense_matmul_precision: precision policy of the JAX package.  This
        port runs float32 throughout (TF32 off): 'default' and 'highest'
        both run fp32 here.  dense_matmul_precision='int8' is the far
        field's int8 serving tier, taken by the neighbor split with
        ``use_pallas`` (on the card, ``Predictor``'s default), as in the
        JAX package.  'bfloat16' compute and the 'bf16x3' tier are not
        ported yet and raise in the forward.
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
