"""Dependency-free reader for TF object-based checkpoints (TensorBundle),
the counterpart of ``epnn_tpu/io/bundle_reader.py`` (the same arrays, bit
for bit, and the same errors).  It parses the bundle format directly:

* ``<prefix>.index`` — a leveldb-style immutable table: prefix-compressed
  key/value blocks, each followed by a 1-byte compression tag + crc32 trailer,
  a two-handle footer, and the magic ``0xdb4775248b80fb57``.
* index values — ``BundleEntryProto`` (hand-decoded protobuf: dtype=1,
  shape=2, shard_id=3, offset=4, size=5, crc32c=6) locating each tensor in
  ``<prefix>.data-SSSSS-of-NNNNN`` shards; the empty key holds
  ``BundleHeaderProto`` (num_shards=1).
* block compression — raw snappy is implemented inline (tag-stream of
  literals and back-references) for bundles whose tables were written with
  compression enabled.

Only plain dense tensors are supported (no slices), which is all the
reference checkpoints contain.  The block trailers' CRCs are not checked.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, Tuple

import numpy as np

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_SIZE = 48

_DTYPES = {
    1: np.float32,    # DT_FLOAT
    2: np.float64,    # DT_DOUBLE
    3: np.int32,      # DT_INT32
    4: np.uint8,      # DT_UINT8
    5: np.int16,      # DT_INT16
    6: np.int8,       # DT_INT8
    9: np.int64,      # DT_INT64
    10: np.bool_,     # DT_BOOL
    19: np.float16,   # DT_HALF
}
_DT_STRING = 7


class BundleError(ValueError):
    pass


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise BundleError("varint too long")


def snappy_decompress(data: bytes) -> bytes:
    """Minimal raw-snappy decompressor (no framing)."""
    out = bytearray()
    length, pos = _varint(data, 0)
    while pos < len(data):
        tag = data[pos]
        pos += 1
        kind = tag & 0x3
        if kind == 0:  # literal
            size = (tag >> 2) + 1
            if size > 60:
                nbytes = size - 60
                size = int.from_bytes(data[pos:pos + nbytes], "little") + 1
                pos += nbytes
            out += data[pos:pos + size]
            pos += size
        else:
            if kind == 1:  # copy, 1-byte offset
                size = ((tag >> 2) & 0x7) + 4
                offset = ((tag >> 5) << 8) | data[pos]
                pos += 1
            elif kind == 2:  # copy, 2-byte offset
                size = (tag >> 2) + 1
                offset = int.from_bytes(data[pos:pos + 2], "little")
                pos += 2
            else:  # copy, 4-byte offset
                size = (tag >> 2) + 1
                offset = int.from_bytes(data[pos:pos + 4], "little")
                pos += 4
            if offset == 0:
                raise BundleError("zero copy offset")
            start = len(out) - offset
            for _ in range(size):  # may overlap — byte-at-a-time
                out.append(out[start])
                start += 1
    if len(out) != length:
        raise BundleError(f"snappy length mismatch {len(out)} != {length}")
    return bytes(out)


def _read_block(data: bytes, offset: int, size: int) -> bytes:
    block = data[offset:offset + size]
    compression = data[offset + size]
    if compression == 0:
        return block
    if compression == 1:
        return snappy_decompress(block)
    raise BundleError(f"unsupported block compression {compression}")


def _iter_block_entries(block: bytes) -> Iterator[Tuple[bytes, bytes]]:
    if len(block) < 4:
        return
    num_restarts = struct.unpack("<I", block[-4:])[0]
    data_end = len(block) - 4 * (num_restarts + 1)
    pos = 0
    key = b""
    while pos < data_end:
        shared, pos = _varint(block, pos)
        unshared, pos = _varint(block, pos)
        value_len, pos = _varint(block, pos)
        key = key[:shared] + block[pos:pos + unshared]
        pos += unshared
        value = block[pos:pos + value_len]
        pos += value_len
        yield key, value


def _proto_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) from a protobuf buffer."""
    pos = 0
    while pos < len(buf):
        tag, pos = _varint(buf, pos)
        field, wire = tag >> 3, tag & 0x7
        if wire == 0:
            val, pos = _varint(buf, pos)
        elif wire == 1:
            val = struct.unpack("<Q", buf[pos:pos + 8])[0]
            pos += 8
        elif wire == 2:
            ln, pos = _varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = struct.unpack("<I", buf[pos:pos + 4])[0]
            pos += 4
        else:
            raise BundleError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_shape(buf: bytes) -> Tuple[int, ...]:
    dims = []
    for field, _wire, val in _proto_fields(buf):
        if field == 2:  # TensorShapeProto.dim
            size = 0
            for f2, _w2, v2 in _proto_fields(val):
                if f2 == 1:
                    size = v2
            dims.append(int(size))
        elif field == 3 and val:
            raise BundleError("unknown-rank tensor shape")
    return tuple(dims)


def _parse_entry(buf: bytes) -> dict:
    entry = {"dtype": 0, "shape": (), "shard_id": 0, "offset": 0, "size": 0}
    for field, _wire, val in _proto_fields(buf):
        if field == 1:
            entry["dtype"] = int(val)
        elif field == 2:
            entry["shape"] = _parse_shape(val)
        elif field == 3:
            entry["shard_id"] = int(val)
        elif field == 4:
            entry["offset"] = int(val)
        elif field == 5:
            entry["size"] = int(val)
        elif field == 7:
            raise BundleError("sliced tensors not supported")
    return entry


def _parse_index(index_bytes: bytes) -> Dict[str, dict]:
    if len(index_bytes) < FOOTER_SIZE:
        raise BundleError("index file too small")
    footer = index_bytes[-FOOTER_SIZE:]
    magic = struct.unpack("<Q", footer[-8:])[0]
    if magic != TABLE_MAGIC:
        raise BundleError(f"bad table magic {magic:#x}")
    pos = 0
    _meta_off, pos = _varint(footer, pos)
    _meta_size, pos = _varint(footer, pos)
    index_off, pos = _varint(footer, pos)
    index_size, pos = _varint(footer, pos)

    index_block = _read_block(index_bytes, index_off, index_size)
    entries: Dict[str, dict] = {}
    num_shards = 1
    for _key, handle in _iter_block_entries(index_block):
        hpos = 0
        block_off, hpos = _varint(handle, hpos)
        block_size, hpos = _varint(handle, hpos)
        block = _read_block(index_bytes, block_off, block_size)
        for key, value in _iter_block_entries(block):
            name = key.decode("utf-8", errors="replace")
            if name == "":
                for field, _w, val in _proto_fields(value):
                    if field == 1:
                        num_shards = int(val)
                continue
            entries[name] = _parse_entry(value)
    for e in entries.values():
        e["num_shards"] = num_shards
    return entries


def list_variables(prefix: str) -> Dict[str, Tuple[int, ...]]:
    """{variable name: shape} without reading tensor data."""
    with open(prefix + ".index", "rb") as f:
        entries = _parse_index(f.read())
    return {k: v["shape"] for k, v in entries.items()
            if v["dtype"] in _DTYPES}


def read_bundle(prefix: str) -> Dict[str, np.ndarray]:
    """Read every numeric tensor of a TF checkpoint as {name: ndarray}."""
    with open(prefix + ".index", "rb") as f:
        entries = _parse_index(f.read())
    if not entries:
        raise BundleError(f"{prefix}: empty bundle index")

    shards: Dict[int, np.memmap] = {}

    def shard(entry) -> np.memmap:
        sid = entry["shard_id"]
        if sid not in shards:
            path = f"{prefix}.data-{sid:05d}-of-{entry['num_shards']:05d}"
            if not os.path.exists(path):
                raise BundleError(f"missing shard {path}")
            shards[sid] = np.memmap(path, dtype=np.uint8, mode="r")
        return shards[sid]

    out: Dict[str, np.ndarray] = {}
    for name, entry in entries.items():
        if entry["dtype"] == _DT_STRING:
            continue  # object-graph metadata — not needed for weights
        dtype = _DTYPES.get(entry["dtype"])
        if dtype is None:
            continue
        raw = shard(entry)[entry["offset"]:entry["offset"] + entry["size"]]
        arr = np.frombuffer(raw.tobytes(), dtype=dtype)
        out[name] = arr.reshape(entry["shape"])
    return out
