"""The benchmark's own count of a graph's pairs, from the coordinates it
sent: the largest number of neighbors of any atom within a cutoff (the
neighbor slots k follow from it, ``frozen.work.safe_k``), the ordered
pairs within the cutoff, and the atoms that have one.  Squared distances
in float32, axis by axis, against cutoff² in float32, in blocks of rows
on the device, with one readback a graph."""

from __future__ import annotations

import numpy as np
import torch

#: (rows, N) squared distances a block
BLOCK_ELEMS = 1 << 25


def count(xyz, n: int, cutoff: float, device) -> tuple:
    """``(max_count, pairs, rows)`` of the first ``n`` atoms of ``xyz``."""
    pts = torch.as_tensor(np.asarray(xyz[:n], np.float32), device=device)
    cut2 = torch.tensor(np.float32(cutoff) * np.float32(cutoff),
                        device=device)
    step = max(1, BLOCK_ELEMS // max(n, 1))
    per = torch.empty(n, dtype=torch.int64, device=pts.device)
    for s in range(0, n, step):
        blk = pts[s:s + step]
        d2 = None
        for ax in range(3):
            diff = blk[:, None, ax] - pts[None, :, ax]
            d2 = diff * diff if d2 is None else d2 + diff * diff
        hit = d2 < cut2
        idx = torch.arange(blk.shape[0], device=pts.device)
        hit[idx, s + idx] = False
        per[s:s + blk.shape[0]] = hit.sum(1)
    top, pairs, live = torch.stack(
        [per.max(), per.sum(), (per > 0).sum()]).tolist()
    return int(top), int(pairs), int(live)
