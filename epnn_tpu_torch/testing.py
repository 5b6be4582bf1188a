"""Seeded synthetic geometries for tests and the chip smoke run (NumPy
only, so both packages can be fed the same molecules)."""

from __future__ import annotations

import numpy as np

from epnn_tpu_torch.data.xyz import Molecule

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


def water_box(n_molecules: int, seed: int = 0, charge: float = 0.0,
              name: str = "") -> Molecule:
    """A box of ``n_molecules`` randomly oriented waters on a cubic
    lattice of spacing :data:`LATTICE` Å (the first ``n_molecules`` sites
    of the smallest cube that holds them), each atom jittered by
    :data:`JITTER` Å (Gaussian).  Atoms are ordered O, H, H per molecule;
    ``charge`` is the net charge Q."""
    g = np.random.default_rng(seed)
    side = int(np.ceil(round(n_molecules ** (1.0 / 3.0), 9)))
    while side ** 3 < n_molecules:
        side += 1
    sites = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                     axis=-1).reshape(-1, 3)[:n_molecules] * LATTICE
    half = np.deg2rad(HOH_ANGLE) / 2.0
    local = np.array([[0.0, 0.0, 0.0],
                      [OH_BOND * np.sin(half), OH_BOND * np.cos(half), 0.0],
                      [-OH_BOND * np.sin(half), OH_BOND * np.cos(half), 0.0]])
    rot = _random_rotations(g, n_molecules)
    xyz = sites[:, None, :] + np.einsum("mij,aj->mai", rot, local)
    xyz = xyz + g.normal(scale=JITTER, size=xyz.shape)
    return Molecule(name=name or f"water{n_molecules}_s{seed}",
                    symbols=["O", "H", "H"] * n_molecules,
                    xyz=xyz.reshape(-1, 3).astype(np.float32),
                    total_charge=float(charge))


#: the protein-size box every record uses: 740 waters = 2,220 atoms
PROTEIN_SIZE_MOLECULES = 740
#: the scaling-size box: 5,920 waters = 17,760 atoms
SCALING_SIZE_MOLECULES = 5920


def disjoint_pair_gh(idx: np.ndarray, mask: np.ndarray, value: float = 0.5):
    """Pass weights for the ``near_pass_rowsum`` antisymmetry probe on a
    real neighbor table: a greedy matching of disjoint near pairs (i, j),
    each with gh non-zero on exactly the slot of row i that holds j and
    the slot of row j that holds i, and zero everywhere else.  Each
    matched pair's two output rows must then be exact negations.  Returns
    ``(gh, pairs)``; ``pairs`` is an (M, 2) array of (i, j)."""
    n, k = idx.shape
    gh = np.zeros((n, k), np.float32)
    used = np.zeros(n, bool)
    pairs = []
    for i in range(n):
        if used[i]:
            continue
        for s in range(k):
            j = int(idx[i, s])
            if not mask[i, s] or used[j] or j == i:
                continue
            back = np.nonzero((idx[j] == i) & (mask[j] > 0))[0]
            if len(back) != 1:
                continue
            gh[i, s] = gh[j, back[0]] = value
            used[i] = used[j] = True
            pairs.append((i, j))
            break
    return gh, np.array(pairs, np.int64).reshape(-1, 2)


#: dimer probe geometry (Å): pair separations, and the lattice of pair
#: centers, wide enough that atoms of two pairs are ≥ 4 Å apart
DIMER_SEPARATION = (1.0, 2.5)
DIMER_LATTICE = 7.0


def dimer_probe(n_pairs: int, seed: int = 0):
    """Coordinates for the dense pass kernel's antisymmetry probe:
    ``n_pairs`` disjoint atom pairs, each 1.0–2.5 Å apart (randomly
    oriented, centered on a cubic lattice of :data:`DIMER_LATTICE` Å), so
    every atom is ≥ 4 Å from all atoms but its partner and each row of the
    pair grid holds one near pair.  A seeded permutation of the atoms
    spreads most pairs over different tiles of the grid.  Returns ``(xyz
    (2·n_pairs, 3) float32, pairs (n_pairs, 2) int64)``."""
    g = np.random.default_rng(seed)
    side = 1
    while side ** 3 < n_pairs:
        side += 1
    centers = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                       axis=-1).reshape(-1, 3)[:n_pairs] * DIMER_LATTICE
    u = g.normal(size=(n_pairs, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    half = 0.5 * g.uniform(*DIMER_SEPARATION, size=(n_pairs, 1)) * u
    xyz = np.concatenate([centers - half, centers + half])
    perm = g.permutation(2 * n_pairs)          # new position of each atom
    out = np.empty_like(xyz)
    out[perm] = xyz
    pairs = np.stack([perm[:n_pairs], perm[n_pairs:]], axis=1)
    return out.astype(np.float32), pairs.astype(np.int64)


def golden_boxes():
    """The B = 2 batch of ``testdata/water2220_mixed_b16.npz``: two
    2,220-atom boxes, seed 0 with Q = 0 and seed 1 with Q = +1."""
    return [water_box(PROTEIN_SIZE_MOLECULES, seed=0, charge=0.0),
            water_box(PROTEIN_SIZE_MOLECULES, seed=1, charge=1.0)]
