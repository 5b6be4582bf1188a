"""Test helpers shared by the CPU tests and the chip smoke run (NumPy
only, so both packages can be fed the same inputs): seeded synthetic
geometries, an ``.xyz`` writer whose coordinates read back as the same
float32 bits, and a writer of synthetic TensorBundle checkpoints in the
reference's variable layout.  None of it is a package feature: the
package reads these formats, it does not write them."""

from __future__ import annotations

import os
import struct

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


def write_xyz(directory: str, mol: Molecule) -> str:
    """Write ``mol`` as ``<directory>/<name>.xyz`` (coordinates as the
    shortest decimal of each float32, so every parser reads back the same
    bits), with ``<name>.npy`` for its labels and ``<name>splits.npy`` for
    its split where it has them.  Returns the ``.xyz`` path."""
    os.makedirs(directory, exist_ok=True)
    stem = os.path.join(directory, mol.name)
    lines = [str(mol.natoms), f"{float(mol.total_charge)!r} 0"]
    for sym, row in zip(mol.symbols, np.asarray(mol.xyz, np.float32)):
        lines.append(" ".join([sym] + [repr(float(v)) for v in row]))
    with open(stem + ".xyz", "w") as f:
        f.write("\n".join(lines) + "\n")
    if mol.labels is not None:
        np.save(stem + ".npy", np.asarray(mol.labels, np.float32))
    if mol.split is not None:
        np.save(stem + "splits.npy", np.asarray(mol.split))
    return stem + ".xyz"


# ---- synthetic TensorBundle checkpoints ------------------------------------

_VALUE_SUFFIX = "/.ATTRIBUTES/VARIABLE_VALUE"
_TABLE_MAGIC = 0xDB4775248B80FB57
_DT_FLOAT, _DT_STRING = 1, 7


def reference_variables(params) -> dict:
    """A parameter tree (this package's, or the JAX layout with or without
    the outer ``"params"`` key; tensor or array leaves) as the reference
    checkpoint's variables: ``{name: float32 array}`` with the last round's
    message and pass MLPs under the alias paths ``message_fn`` /
    ``pass_fn`` and the earlier rounds under ``message_fns/<t>`` /
    ``pass_fns/<t>`` (the layout ``io.tf_import`` reads)."""
    tree = params["params"] if "params" in params else params
    t_last = sum(name.startswith("message_") for name in tree) - 1
    out = {}
    for name, layers in tree.items():
        if name == "update":
            path = "layer_with_weights-0/update_fn"
        else:
            kind, t = name.rsplit("_", 1)
            layer = 0 if kind == "message" else 1
            path = (f"layer_with_weights-{layer}/{kind}_fn" if int(t) == t_last
                    else f"layer_with_weights-{layer}/{kind}_fns/{t}")
        for dname, leaf in layers.items():
            k = int(dname.split("_")[1])
            for part in ("kernel", "bias"):
                value = leaf[part]
                if hasattr(value, "detach"):
                    value = value.detach().cpu().numpy()
                out[f"{path}/layer_set/{k}/{part}{_VALUE_SUFFIX}"] = (
                    np.asarray(value, np.float32))
    return out


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _field(number: int, payload) -> bytes:
    """One protobuf field: an int as a varint, bytes length-delimited."""
    if isinstance(payload, int):
        return _varint(number << 3) + _varint(payload)
    return _varint((number << 3) | 2) + _varint(len(payload)) + payload


def snappy_compress(data: bytes) -> bytes:
    """Raw snappy (no framing) by a greedy 4-byte matcher: literals and
    back-references of 4-64 bytes (1-byte offsets below 2,048 and lengths
    up to 11, else 2-byte offsets), overlapping copies included."""
    out = bytearray(_varint(len(data)))

    def literal(chunk):
        n = len(chunk) - 1
        if n < 60:
            out.append(n << 2)
        else:
            nbytes = (n.bit_length() + 7) // 8
            out.append((59 + nbytes) << 2)
            out.extend(n.to_bytes(nbytes, "little"))
        out.extend(chunk)

    last, pos, lit = {}, 0, 0
    while pos + 4 <= len(data):
        key = data[pos:pos + 4]
        cand = last.get(key)
        last[key] = pos
        if cand is None or pos - cand > 0xFFFF:
            pos += 1
            continue
        length = 4
        while (pos + length < len(data) and length < 64
               and data[cand + length] == data[pos + length]):
            length += 1
        if lit < pos:
            literal(data[lit:pos])
        offset = pos - cand
        if length <= 11 and offset < 2048:
            out.append(1 | ((length - 4) << 2) | ((offset >> 8) << 5))
            out.append(offset & 0xFF)
        else:
            out.append(2 | ((length - 1) << 2))
            out.extend(offset.to_bytes(2, "little"))
        pos += length
        lit = pos
    if lit < len(data):
        literal(data[lit:])
    return bytes(out)


def _table_block(entries) -> bytes:
    """A leveldb block: prefix-compressed (key, value) entries and one
    restart point."""
    out, prev = bytearray(), b""
    for key, value in entries:
        shared = 0
        while (shared < min(len(key), len(prev))
               and key[shared] == prev[shared]):
            shared += 1
        out += (_varint(shared) + _varint(len(key) - shared)
                + _varint(len(value)) + key[shared:] + value)
        prev = key
    return bytes(out) + struct.pack("<II", 0, 1)


#: entries a data block of :func:`write_tf_bundle`'s index table
BUNDLE_BLOCK_ENTRIES = 4


def write_tf_bundle(prefix: str, tensors: dict, snappy_blocks=()) -> None:
    """Write ``tensors`` ({name: array}) as a one-shard TensorBundle:
    ``<prefix>.index`` (a leveldb table: the header entry, a DT_STRING
    object-graph entry and one ``BundleEntryProto`` a tensor, sorted,
    :data:`BUNDLE_BLOCK_ENTRIES` entries a data block; the data blocks
    whose indices are in ``snappy_blocks`` snappy-compressed,
    :func:`snappy_compress`) and ``<prefix>.data-00000-of-00001``.  Block
    trailers carry a zero CRC (the readers do not check it)."""
    data = bytearray()
    entries = [(b"", _field(1, 1))]  # BundleHeaderProto: num_shards = 1
    items = [("_CHECKPOINTABLE_OBJECT_GRAPH", _DT_STRING, (), b"graph")]
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr, np.float32)
        items.append((name, _DT_FLOAT, arr.shape, arr.astype("<f4").tobytes()))
    for name, dtype, shape, raw in sorted(items):
        dims = b"".join(_field(2, _field(1, int(d))) for d in shape)
        proto = (_field(1, dtype) + _field(2, dims) + _field(4, len(data))
                 + _field(5, len(raw))
                 + _varint((6 << 3) | 5) + struct.pack("<I", 0))  # crc32c
        entries.append((name.encode(), proto))
        data += raw
    index = bytearray()

    def put(block: bytes, compress: bool) -> bytes:
        handle = _varint(len(index))
        body = snappy_compress(block) if compress else block
        handle += _varint(len(body))
        index.extend(body + bytes([1 if compress else 0]) + bytes(4))
        return handle

    handles = []
    for b, start in enumerate(range(0, len(entries), BUNDLE_BLOCK_ENTRIES)):
        chunk = entries[start:start + BUNDLE_BLOCK_ENTRIES]
        handles.append((chunk[-1][0],
                        put(_table_block(chunk), b in snappy_blocks)))
    meta = put(_table_block([]), False)
    top = put(_table_block(handles), False)
    footer = meta + top
    index += footer + bytes(40 - len(footer)) + struct.pack("<Q", _TABLE_MAGIC)
    with open(prefix + ".index", "wb") as f:
        f.write(bytes(index))
    with open(prefix + ".data-00000-of-00001", "wb") as f:
        f.write(bytes(data))
