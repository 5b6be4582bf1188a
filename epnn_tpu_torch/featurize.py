"""Edge featurization: all-pairs Gaussian RBF with a cosine-cutoff envelope
(counterpart of ``epnn_tpu/featurize.py``).

* RBF centers ``mu = linspace(0.1, cutoff, e_dim)``, width ``eta``.
* Envelope ``C = (cos(pi * D / cutoff) + 1) / 2`` with ``C[D >= cutoff] = 0``,
  ``C[D <= 0] = 1`` (off-diagonal coincident atoms keep C=1), and the
  diagonal forced to 0 after those rules.
* ``e = C * exp(-eta * (D - mu)**2)`` per channel.
"""

from __future__ import annotations

import math

import numpy as np
import torch

DEFAULT_CUTOFF = 3.0
DEFAULT_ETA = 2.0
DEFAULT_E_DIM = 48
MU_START = 0.1


def rbf_centers(e_dim: int, cutoff: float, device=None) -> torch.Tensor:
    """float32 centers, computed in float64 and rounded once (bitwise the
    JAX package's ``jnp.linspace(..., dtype=float32)``)."""
    mu = np.linspace(MU_START, cutoff, e_dim).astype(np.float32)
    return torch.from_numpy(mu).to(device)


def rbf_edges(
    xyz: torch.Tensor,
    node_mask: torch.Tensor | None = None,
    e_dim: int = DEFAULT_E_DIM,
    cutoff: float = DEFAULT_CUTOFF,
    eta: float = DEFAULT_ETA,
) -> torch.Tensor:
    """RBF edges for padded coordinates.

    Args:
      xyz: (..., natom, 3) coordinates (padding rows arbitrary).
      node_mask: (..., natom) 1.0 for real atoms; padded pairs get e = 0.

    Returns:
      e: (..., natom, natom, e_dim) float32.
    """
    xyz = xyz.to(torch.float32)
    d2 = torch.sum((xyz[..., :, None, :] - xyz[..., None, :, :]) ** 2, dim=-1)
    pos = d2 > 0.0
    d = torch.where(pos, torch.sqrt(torch.where(pos, d2, 1.0)), 0.0)

    c = (torch.cos(math.pi * d / cutoff) + 1.0) * 0.5
    c = torch.where(d >= cutoff, 0.0, c)
    c = torch.where(d <= 0.0, 1.0, c)
    n = xyz.shape[-2]
    eye = torch.eye(n, dtype=torch.bool, device=xyz.device)
    c = torch.where(eye, 0.0, c)
    if node_mask is not None:
        node_mask = node_mask.to(torch.float32)
        c = c * (node_mask[..., :, None] * node_mask[..., None, :])

    mu = rbf_centers(e_dim, cutoff, xyz.device)
    return c[..., None] * torch.exp(-eta * (d[..., None] - mu) ** 2)
