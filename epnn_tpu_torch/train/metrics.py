"""Loss functions and masked metrics (counterpart of
``epnn_tpu/train/metrics.py``).

Masked variants average over real atoms only and are the primary numbers;
the padded variants average over the padded width, as the original
reference trainer did, for comparison with its printouts.
"""

from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor


def masked_mse(pred: Tensor, y: Tensor, mask: Tensor,
               sample_weight: Optional[Tensor] = None) -> Tensor:
    """Mean over real atoms of squared error, averaged over molecules."""
    se = (pred - y) ** 2 * mask
    per_mol = se.sum(-1) / torch.clamp(mask.sum(-1), min=1.0)
    if sample_weight is not None:
        return ((per_mol * sample_weight).sum()
                / torch.clamp(sample_weight.sum(), min=1.0))
    return per_mol.mean()


def padded_mse(pred: Tensor, y: Tensor, mask: Tensor,
               sample_weight: Optional[Tensor] = None) -> Tensor:
    """Reference-equivalent loss: mean over the padded width."""
    per_mol = ((pred - y) ** 2).mean(-1)
    if sample_weight is not None:
        return ((per_mol * sample_weight).sum()
                / torch.clamp(sample_weight.sum(), min=1.0))
    return per_mol.mean()


def mae_sums(pred: Tensor, y: Tensor, mask: Tensor,
             sample_weight: Optional[Tensor] = None) -> Tensor:
    """(masked |err| sum, masked count, padded |err| sum, padded count) as
    one (4,) tensor, so metrics accumulate exactly across minibatches."""
    err = torch.abs(pred - y)
    if sample_weight is None:
        sample_weight = torch.ones(pred.shape[0], dtype=pred.dtype,
                                   device=pred.device)
    w = sample_weight[:, None]
    return torch.stack([(err * mask * w).sum(), (mask * w).sum(),
                        (err * w).sum(), (torch.ones_like(err) * w).sum()])


LOSSES = {"masked_mse": masked_mse, "padded_mse": padded_mse}
