"""Padded batch representation, size buckets and minibatches (counterpart
of ``epnn_tpu/data/dataset.py``).  Batches stay NumPy on the host; the
serving front end and the trainer move them to the device per call."""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from epnn_tpu_torch.data.xyz import Molecule
from epnn_tpu_torch.elements import ElementTable


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(eq=False)  # identity semantics (hashable/weakref-able)
class MolBatch:
    """A padded batch of molecules (B = batch, N = padded atoms,
    F = element-feature width):

      x:         (B, N, F) float32 — [Z, onehot] per atom, zero rows for padding
      xyz:       (B, N, 3) float32 — coordinates, zero for padding
      q0:        (B, N)    float32 — initial charges Q/natom on real atoms
      total_q:   (B,)      float32 — net molecular charge Q
      y:         (B, N)    float32 — per-atom labels (zero when absent)
      node_mask: (B, N)    float32 — 1 on real atoms
      natoms:    (B,)      int32
    """

    x: np.ndarray
    xyz: np.ndarray
    q0: np.ndarray
    total_q: np.ndarray
    y: np.ndarray
    node_mask: np.ndarray
    natoms: np.ndarray
    names: List[str]
    has_labels: np.ndarray  # (B,) bool

    @property
    def batch_size(self) -> int:
        return self.x.shape[0]

    @property
    def padded_atoms(self) -> int:
        return self.x.shape[1]

    def pair_mask(self) -> np.ndarray:
        """(B, N, N) pair validity: 1 where both atoms are real (the
        diagonal of a real atom included)."""
        return self.node_mask[:, :, None] * self.node_mask[:, None, :]

    def select(self, idx: Sequence[int]) -> "MolBatch":
        idx = np.asarray(idx)
        return MolBatch(
            x=self.x[idx], xyz=self.xyz[idx], q0=self.q0[idx],
            total_q=self.total_q[idx], y=self.y[idx],
            node_mask=self.node_mask[idx], natoms=self.natoms[idx],
            names=[self.names[i] for i in idx],
            has_labels=self.has_labels[idx])


def pad_molecules(
    mols: Sequence[Molecule],
    table: ElementTable,
    pad_to: Optional[int] = None,
    bucket_multiple: int = 8,
) -> MolBatch:
    """Pad a list of molecules into one dense batch."""
    if not mols:
        raise ValueError("empty molecule list")
    max_n = max(m.natoms for m in mols)
    if pad_to is None:
        pad_to = round_up(max_n, bucket_multiple)
    if pad_to < max_n:
        raise ValueError(f"pad_to={pad_to} < largest molecule {max_n}")

    b = len(mols)
    x = np.zeros((b, pad_to, table.n_features), dtype=np.float32)
    xyz = np.zeros((b, pad_to, 3), dtype=np.float32)
    q0 = np.zeros((b, pad_to), dtype=np.float32)
    total_q = np.zeros((b,), dtype=np.float32)
    y = np.zeros((b, pad_to), dtype=np.float32)
    node_mask = np.zeros((b, pad_to), dtype=np.float32)
    natoms = np.zeros((b,), dtype=np.int32)
    has_labels = np.zeros((b,), dtype=bool)

    for i, m in enumerate(mols):
        n = m.natoms
        x[i, :n] = table.featurize_symbols(m.symbols)
        xyz[i, :n] = m.xyz
        q0[i, :n] = np.float32(m.total_charge) / np.float32(n)
        total_q[i] = m.total_charge
        if m.labels is not None:
            y[i, :n] = m.labels
            has_labels[i] = True
        node_mask[i, :n] = 1.0
        natoms[i] = n

    return MolBatch(x=x, xyz=xyz, q0=q0, total_q=total_q, y=y,
                    node_mask=node_mask, natoms=natoms,
                    names=[m.name for m in mols], has_labels=has_labels)


def bucket_molecules(mols: Sequence[Molecule], table: ElementTable,
                     bucket_multiple: int = 8,
                     max_batch_atoms2: int = 2**22) -> Dict[int, MolBatch]:
    """Group molecules into size buckets: padded width → one batch of every
    molecule of that width, in input order, widths ascending.

    ``max_batch_atoms2`` — the JAX package's parameter, whose docstring
    calls it a cap on B·N² per bucket but whose body never reads it
    (``epnn_tpu/data/dataset.py:124-129``); accepted for that signature
    and unused here too: callers minibatch within a bucket."""
    by_bucket: Dict[int, List[Molecule]] = {}
    for m in mols:
        key = round_up(max(m.natoms, 1), bucket_multiple)
        by_bucket.setdefault(key, []).append(m)
    return {k: pad_molecules(v, table, pad_to=k)
            for k, v in sorted(by_bucket.items())}


def minibatches(batch: MolBatch, batch_size: int,
                rng: Optional[np.random.Generator] = None,
                drop_remainder: bool = False, with_indices: bool = False):
    """Yield ``(minibatch, n_real[, rows])``: fixed-size minibatches in the
    order ``rng.shuffle`` gives (bucket order without ``rng``).  A short
    tail is filled by ``np.resize`` of the order (so a bucket smaller than
    ``batch_size`` still fills one batch); ``n_real`` counts the rows that
    are not fill.  ``rows`` are the bucket rows backing the minibatch, for
    slicing per-bucket side tables such as neighbor lists."""
    n = batch.batch_size
    order = np.arange(n)
    if rng is not None:
        rng.shuffle(order)
    for start in range(0, n, batch_size):
        idx = order[start:start + batch_size]
        pad_count = 0
        if len(idx) < batch_size:
            if drop_remainder:
                return
            pad_count = batch_size - len(idx)
            idx = np.concatenate([idx, np.resize(order, pad_count)])
        if with_indices:
            yield batch.select(idx), batch_size - pad_count, idx
        else:
            yield batch.select(idx), batch_size - pad_count


def train_val_split(n: int, test_size: float = 0.2,
                    seed: int = 42) -> Tuple[np.ndarray, np.ndarray]:
    """``(train, val)`` index arrays equal to scikit-learn's
    ``train_test_split(np.arange(n), test_size=test_size,
    random_state=seed)`` (the reference trainer's split), from NumPy alone:
    a ``RandomState(seed)`` permutation whose first ``ceil(test_size·n)``
    entries are the validation set."""
    n_test = math.ceil(test_size * n)
    if not 0 < n_test < n:
        raise ValueError(f"test_size={test_size} of {n} samples leaves an "
                         "empty train or validation set")
    perm = np.random.RandomState(seed).permutation(n)
    return perm[n_test:], perm[:n_test]


def uniform_q0_contract(x: np.ndarray, q0: np.ndarray,
                        node_mask: np.ndarray) -> bool:
    """Host-side check of the round-1 far-field collapse contract (see
    :func:`epnn_tpu_torch.ops.fused.forward_blocked` ``uniform_q0``): per
    graph, valid atoms first, one q0 value on all valid atoms, zeros on
    padding; x rows exactly ``[Z, onehot]`` with one Z per element slot
    across the batch.  Arrays are the batched ``MolBatch`` fields."""
    x = np.asarray(x)
    q0 = np.asarray(q0)
    mask = np.asarray(node_mask)
    if not (np.all(np.diff(mask, axis=1) <= 0)           # valid-first
            and np.all((q0 == q0[:, :1]) | (mask == 0))  # uniform valid
            and np.all(q0 * (1 - mask) == 0)):           # zero padding
        return False
    oh = x[..., 1:]
    if not (np.all((oh == 0) | (oh == 1))
            and np.array_equal(oh.sum(axis=-1), mask)):
        return False
    z = x[..., 0]
    zmax = np.max(z[..., None] * oh, axis=(0, 1))
    zmin = np.min(np.where(oh > 0, z[..., None], np.inf), axis=(0, 1))
    return bool(np.all((zmin == np.inf) | (zmax == zmin)))
