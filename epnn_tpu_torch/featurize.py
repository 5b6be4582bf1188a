"""Edge featurization: all-pairs Gaussian RBF with a cosine-cutoff envelope
(counterpart of ``epnn_tpu/featurize.py``).

* RBF centers ``mu = linspace(0.1, cutoff, e_dim)``, width ``eta``.
* Envelope ``C = (cos(pi * D / cutoff) + 1) / 2`` with ``C[D >= cutoff] = 0``,
  ``C[D <= 0] = 1`` (off-diagonal coincident atoms keep C=1), and the
  diagonal forced to 0 after those rules.
* ``e = C * exp(-eta * (D - mu)**2)`` per channel.

The pair pieces (:func:`pair_d2`, :func:`envelope_rbf`, :func:`hard_gate`,
:func:`kernel_mu`) are shared by the dense model, the blocked forwards and
the plain versions of the fused CUDA kernels (``csrc/common.cuh`` holds
their device side).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

DEFAULT_CUTOFF = 3.0
DEFAULT_ETA = 2.0
DEFAULT_E_DIM = 48
MU_START = 0.1


@dataclasses.dataclass(frozen=True)
class RBFConfig:
    """The featurization's constants, as the JAX package's ``RBFConfig``."""

    e_dim: int = DEFAULT_E_DIM
    cutoff: float = DEFAULT_CUTOFF
    eta: float = DEFAULT_ETA

    def centers(self) -> np.ndarray:
        """The float64 centers ``linspace(0.1, cutoff, e_dim)``."""
        return np.linspace(MU_START, self.cutoff, self.e_dim,
                           dtype=np.float64)


def rbf_centers(e_dim: int, cutoff: float, device=None) -> torch.Tensor:
    """float32 centers, computed in float64 and rounded once (bitwise the
    JAX package's ``jnp.linspace(..., dtype=float32)``)."""
    mu = np.linspace(MU_START, cutoff, e_dim).astype(np.float32)
    return torch.from_numpy(mu).to(device)


def kernel_mu(e: int, cutoff: float, device=None) -> torch.Tensor:
    """The RBF centers as the fused kernels build them in the tile
    (``_tile_rbf_flat``, ``pallas_kernels.py:253``): mu = 0.1 + (cutoff −
    0.1)·ch/(E − 1) in float32, which may differ in the last bit from the
    :func:`rbf_centers` of the other paths."""
    ch = torch.arange(e, dtype=torch.float32, device=device)
    return MU_START + (cutoff - MU_START) * ch / (e - 1)


def pair_d2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances between broadcastable (..., 3) coordinates, taken
    axis by axis as (a − b)² in x, y, z order.  The same ops on (b, a) give
    the same bits: a pair's d² — and so its RBF features — are symmetric,
    which the pass rounds rely on."""
    d2 = None
    for ax in range(3):
        diff = a[..., ax] - b[..., ax]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    return d2


def envelope_rbf(d2, cmask, cutoff: float, eta: float, mu):
    """RBF features from squared distances ``d2`` (any shape): the cosine
    envelope (0 from the cutoff on, 1 at d = 0) times ``cmask``, and
    ``rbf = c · exp(−eta · (d − mu)²)`` per center.  Returns ``(rbf, c)``
    with shapes ``d2.shape + mu.shape`` and ``d2.shape``."""
    d2 = d2.to(torch.float32)
    pos = d2 > 0.0
    d = torch.where(pos, torch.sqrt(torch.where(pos, d2, 1.0)), 0.0)
    c = (torch.cos(math.pi * d / cutoff) + 1.0) * 0.5
    c = torch.where(d >= cutoff, 0.0, c)
    c = torch.where(d <= 0.0, 1.0, c)
    c = c * cmask.to(torch.float32)
    rbf = c[..., None] * torch.exp(-eta * (d[..., None] - mu) ** 2)
    return rbf, c


def hard_gate(rbf, tol: float):
    """The is-near gate: 1 where any RBF channel exceeds ``tol``."""
    return (torch.amax(torch.clamp(rbf, tol, 1e5), dim=-1) != tol).to(
        torch.float32)


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
    n = xyz.shape[-2]
    cmask = ~torch.eye(n, dtype=torch.bool, device=xyz.device)
    if node_mask is not None:
        node_mask = node_mask.to(torch.float32)
        cmask = cmask * (node_mask[..., :, None] * node_mask[..., None, :])
    rbf, _ = envelope_rbf(d2, cmask, cutoff, eta,
                          rbf_centers(e_dim, cutoff, xyz.device))
    return rbf
