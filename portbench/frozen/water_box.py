"""Seeded water boxes.

:func:`water_box` is a frozen copy of ``epnn_tpu_torch.testing.water_box``
(NumPy only; it returns coordinates and symbols, not the port's
``Molecule``, so that the reference can use it too).  :func:`water_boxes`
draws many such boxes at once on the device, for the traffic's pools: the
same lattice, the same water geometry and the same Gaussian jitter, each
molecule turned by a uniformly random rotation drawn as a normalised
Gaussian quaternion (the QR draw of :func:`water_box` is uniform too, but
a batched QR of a million 3 × 3 matrices costs seconds of set-up)."""

from __future__ import annotations

import numpy as np
import torch

#: water geometry: O–H bond (Å), H–O–H angle (degrees)
OH_BOND = 0.957
HOH_ANGLE = 104.5
#: molecule lattice spacing and per-atom jitter (Å)
LATTICE = 3.1
JITTER = 0.1


def _random_rotations(g: np.random.Generator, n: int) -> np.ndarray:
    """(n, 3, 3) uniformly random rotations (QR of Gaussian matrices)."""
    q, r = np.linalg.qr(g.normal(size=(n, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    det = np.linalg.det(q)
    q[:, :, 0] *= det[:, None]
    return q


def lattice_sites(n_molecules: int) -> np.ndarray:
    """(n, 3) the first ``n_molecules`` sites of the smallest cube of
    spacing :data:`LATTICE` Å that holds them."""
    side = int(np.ceil(round(n_molecules ** (1.0 / 3.0), 9)))
    while side ** 3 < n_molecules:
        side += 1
    return np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3)[:n_molecules] * LATTICE


def local_water() -> np.ndarray:
    """(3, 3) O, H, H of one water in its own frame (Å)."""
    half = np.deg2rad(HOH_ANGLE) / 2.0
    return np.array([[0.0, 0.0, 0.0],
                     [OH_BOND * np.sin(half), OH_BOND * np.cos(half), 0.0],
                     [-OH_BOND * np.sin(half), OH_BOND * np.cos(half), 0.0]])


def water_box(n_molecules: int, seed: int = 0):
    """``(xyz (3·n, 3) float32, symbols)``: ``n_molecules`` randomly
    oriented waters on a cubic lattice of spacing :data:`LATTICE` Å (the
    first ``n_molecules`` sites of the smallest cube that holds them),
    each atom jittered by :data:`JITTER` Å (Gaussian); atoms O, H, H per
    molecule."""
    g = np.random.default_rng(seed)
    sites = lattice_sites(n_molecules)
    rot = _random_rotations(g, n_molecules)
    xyz = sites[:, None, :] + np.einsum("mij,aj->mai", rot, local_water())
    xyz = xyz + g.normal(scale=JITTER, size=xyz.shape)
    return (xyz.reshape(-1, 3).astype(np.float32),
            ["O", "H", "H"] * n_molecules)


def _quaternion_rotations(quat: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrices of (..., 4) quaternions (w, x, y, z),
    normalised here."""
    w, x, y, z = (quat / quat.norm(dim=-1, keepdim=True)).unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(*quat.shape[:-1], 3, 3)


def water_boxes(n_molecules: int, count: int, generator: torch.Generator,
                jitter: float = JITTER) -> np.ndarray:
    """(count, 3·n, 3) float32 on the host: ``count`` boxes of
    :func:`water_box`'s construction, drawn on ``generator``'s device in
    three calls (rotations, then jitter)."""
    dev = generator.device
    sites = torch.as_tensor(lattice_sites(n_molecules), dtype=torch.float32,
                            device=dev)
    local = torch.as_tensor(local_water(), dtype=torch.float32, device=dev)
    quat = torch.randn((count, n_molecules, 4), generator=generator,
                       device=dev)
    rot = _quaternion_rotations(quat)
    xyz = sites[None, :, None, :] + torch.einsum("bmij,aj->bmai", rot, local)
    noise = torch.randn(xyz.shape, generator=generator, device=dev)
    xyz = xyz + jitter * noise
    return xyz.reshape(count, 3 * n_molecules, 3).cpu().numpy()
