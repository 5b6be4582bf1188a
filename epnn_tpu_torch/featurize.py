"""Edge featurization: all-pairs Gaussian RBF with a cosine-cutoff envelope
(counterpart of ``epnn_tpu/featurize.py``).

* RBF centers ``mu = linspace(0.1, cutoff, e_dim)``, width ``eta``.
* Envelope ``C = (cos(pi * D / cutoff) + 1) / 2`` with ``C[D >= cutoff] = 0``,
  ``C[D <= 0] = 1`` (off-diagonal coincident atoms keep C=1), and the
  diagonal forced to 0 after those rules.
* ``e = C * exp(-eta * (D - mu)**2)`` per channel.

:func:`rbf_edges_np` is the float64 NumPy oracle of the same features
(the reference's output, byte for byte), used by :mod:`epnn_tpu_torch.compat`;
:func:`soft_envelope_np` its envelope alone.

The pair pieces (:func:`pair_d2`, :func:`envelope_rbf`, :func:`hard_gate`,
:func:`kernel_mu`; for the fused kernels' ``rbf_method="doubling"``,
:func:`envelope_rbf_doubling` and :func:`doubling_gains`) are shared by
the dense model, the blocked forwards and the plain versions of the fused
CUDA kernels (``csrc/common.cuh`` holds their device side).
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


def rbf_edges_np(
    xyz: np.ndarray,
    e_dim: int = DEFAULT_E_DIM,
    cutoff: float = DEFAULT_CUTOFF,
    eta: float = DEFAULT_ETA,
):
    """NumPy oracle, as the JAX package's.  xyz: (natom, 3).  Returns
    ``(e, C)``: e (natom, natom, e_dim) float32 RBF edge features, computed
    in float64 from the float32 coordinates; C (natom, natom) the float64
    cosine envelope (constant across channels, so 2-D)."""
    xyz = np.asarray(xyz, dtype=np.float32)
    diff = xyz[:, None, :].astype(np.float64) - xyz[None, :, :].astype(
        np.float64)
    d = np.sqrt((diff ** 2).sum(-1))
    c = (np.cos(np.pi * d / cutoff) + 1.0) / 2.0
    c[d >= cutoff] = 0.0
    c[d <= 0.0] = 1.0
    np.fill_diagonal(c, 0.0)
    mu = np.linspace(MU_START, cutoff, e_dim)
    e = c[:, :, None] * np.exp(-eta * (d[:, :, None] - mu[None, None, :]) ** 2)
    return e.astype(np.float32), c


def soft_envelope_np(xyz: np.ndarray,
                     cutoff: float = DEFAULT_CUTOFF) -> np.ndarray:
    """The (natom, natom) cosine envelope alone — the reference's unused
    'soft mask' return value (``charge_gn.py:331-333``), for the
    decay-weighted passing variant (``pass_weighting="soft_envelope"``);
    the JAX package's ``epnn_tpu.featurize.soft_envelope_np``."""
    _, c = rbf_edges_np(xyz, e_dim=1, cutoff=cutoff)
    return c


def rbf_centers(e_dim: int, cutoff: float, device=None) -> torch.Tensor:
    """float32 centers, computed in float64 and rounded once (bitwise the
    JAX package's ``jnp.linspace(..., dtype=float32)``)."""
    mu = np.linspace(MU_START, cutoff, e_dim).astype(np.float32)
    return torch.from_numpy(mu).to(device)


def _divide(x: torch.Tensor, y: float) -> torch.Tensor:
    """x / y by true division on every device, as the kernels and the JAX
    package divide: PyTorch's CUDA division by a Python scalar multiplies
    by its reciprocal, a float32 ulp off a third of the time (on the CPU
    the two are the same bits)."""
    return x / torch.full((), y, dtype=x.dtype, device=x.device)


def kernel_mu(e: int, cutoff: float, device=None) -> torch.Tensor:
    """The RBF centers as the fused kernels build them in the tile
    (``_tile_rbf_flat``, ``pallas_kernels.py:253``): mu = 0.1 + (cutoff −
    0.1)·ch/(E − 1) in float32, which may differ in the last bit from the
    :func:`rbf_centers` of the other paths."""
    ch = torch.arange(e, dtype=torch.float32, device=device)
    return MU_START + _divide((cutoff - MU_START) * ch, e - 1)


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


def _envelope(d2, cmask, cutoff: float):
    """``(d, c)`` from squared distances: d = sqrt(d²) (0 at d² = 0) and
    the cosine envelope (0 from the cutoff on, 1 at d = 0) times
    ``cmask``."""
    d2 = d2.to(torch.float32)
    pos = d2 > 0.0
    d = torch.where(pos, torch.sqrt(torch.where(pos, d2, 1.0)), 0.0)
    c = (torch.cos(_divide(math.pi * d, cutoff)) + 1.0) * 0.5
    c = torch.where(d >= cutoff, 0.0, c)
    c = torch.where(d <= 0.0, 1.0, c)
    return d, c * cmask.to(torch.float32)


def envelope_rbf(d2, cmask, cutoff: float, eta: float, mu):
    """RBF features from squared distances ``d2`` (any shape): the cosine
    envelope (0 from the cutoff on, 1 at d = 0) times ``cmask``, and
    ``rbf = c · exp(−eta · (d − mu)²)`` per center.  Returns ``(rbf, c)``
    with shapes ``d2.shape + mu.shape`` and ``d2.shape``."""
    d, c = _envelope(d2, cmask, cutoff)
    rbf = c[..., None] * torch.exp(-eta * (d[..., None] - mu) ** 2)
    return rbf, c


#: the fused kernels' ways of building the RBF channels (the JAX kernels'
#: ``rbf_method``)
RBF_METHODS = ("direct", "doubling")


def check_rbf_method(method: str, e: int = 2) -> str:
    """``method`` checked against :data:`RBF_METHODS` (the JAX kernels
    read any other string as "direct"; here it raises ``ValueError``), and
    the doubling's need of E ≥ 2 channels (JAX's raises
    ``ZeroDivisionError``)."""
    if method not in RBF_METHODS:
        raise ValueError(f"rbf_method {method!r}: one of {RBF_METHODS}")
    if method == "doubling" and e < 2:
        raise ValueError(f"rbf_method 'doubling' needs E >= 2 channels, "
                         f"got {e}")
    return method


def _doubling_step(e: int, cutoff: float) -> float:
    """Δ = (cutoff − 0.1) / (E − 1), the doubling's uniform center step
    (float64, as the JAX kernel's Python constant)."""
    check_rbf_method("doubling", e)
    return (cutoff - MU_START) / (e - 1)


def doubling_gains(e: int, cutoff: float, eta: float,
                   device=None) -> torch.Tensor:
    """The doubling's channel factors g_ch = exp(−η·Δ²·ch·ch), ch = 0 …
    E − 1, in float32 in the JAX kernel's order (``pallas_kernels.py:
    243-244``: the constant −η·Δ² in float64, rounded once, then times ch,
    times ch).  The fused kernels read them in place of the centers."""
    delta = _doubling_step(e, cutoff)
    ch = torch.arange(e, dtype=torch.float32, device=device)
    return torch.exp((-eta * delta * delta) * ch * ch)


def doubling_u_scale(e: int, cutoff: float, eta: float) -> float:
    """2·η·Δ (float64), the scale of u = exp(2ηΔ·dc)."""
    return 2.0 * eta * _doubling_step(e, cutoff)


def envelope_rbf_doubling(d2, cmask, cutoff: float, eta: float, gains):
    """:func:`envelope_rbf` by the JAX kernels' ``rbf_method="doubling"``
    (``_tile_rbf_flat``, ``pallas_kernels.py:238-250``), in the same
    float32 operations and order as JAX's and as the fused CUDA kernels
    (``csrc/common.cuh``, ``doubling_channel``): on the uniform centers
    mu_ch = 0.1 + ch·Δ the channels are a geometric sequence,

        dc = min(d, cutoff) − 0.1,  a = c · exp((−η·dc)·dc),
        u = exp(2ηΔ·dc),  rbf_ch = (a · g_ch) · u^ch,

    two exps a pair; u^ch multiplied in from u, u², u⁴, … for the set bits
    of ch in ascending order (the powers by repeated squaring).  ``gains``:
    :func:`doubling_gains`.  Returns ``(rbf, c)`` as :func:`envelope_rbf`;
    ~1e-6 relative from it (the exponent's rounding grows with ch), so a
    channel at the gate's tolerance can flip the hard gate."""
    d, c = _envelope(d2, cmask, cutoff)
    e = gains.shape[0]
    dc = torch.clamp(d, max=cutoff) - MU_START
    a = c * torch.exp(-eta * dc * dc)
    up = torch.exp(doubling_u_scale(e, cutoff, eta) * dc)[..., None]
    rbf = a[..., None] * gains
    ch = torch.arange(e, device=gains.device)
    nbits = max(1, (e - 1).bit_length())
    for b in range(nbits):
        rbf = torch.where((ch >> b) & 1 == 1, rbf * up, rbf)
        if b + 1 < nbits:
            up = up * up
    return rbf, c


def rbf_table(e: int, cutoff: float, eta: float, method: str = "direct",
              device=None) -> torch.Tensor:
    """What the fused kernels read a channel's constant from: the centers
    (:func:`kernel_mu`) for "direct", the gains (:func:`doubling_gains`)
    for "doubling"."""
    if check_rbf_method(method, e) == "doubling":
        return doubling_gains(e, cutoff, eta, device)
    return kernel_mu(e, cutoff, device)


def envelope_rbf_method(d2, cmask, cutoff: float, eta: float, table,
                        method: str = "direct"):
    """:func:`envelope_rbf` (``table`` the centers) or
    :func:`envelope_rbf_doubling` (``table`` the gains) by ``method``."""
    if check_rbf_method(method) == "doubling":
        return envelope_rbf_doubling(d2, cmask, cutoff, eta, table)
    return envelope_rbf(d2, cmask, cutoff, eta, table)


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
