"""The one traffic generator: it reads a traffic file
(``portbench/traffic/<mix>.json``) and makes, from the seed, every input
of a run before the window opens.

A traffic file holds:

* ``kind``: ``"frames"`` (every call a new geometry, as a code that
  charges snapshots sends) or ``"walk"`` (the coordinates take a random
  step before every call, as an MD code sends);
* ``molecules``: waters a graph (``frozen.water_box``: a 3.1 Å lattice,
  random orientations, ``jitter`` Å of Gaussian jitter);
  ``graphs_per_call``; ``charges``: the net charges Q, graph after graph
  and call after call, in turn;
* ``frames``: a pool of ``pool`` seeded boxes taken in a seeded order, each
  call's box moved rigidly by a seeded shift of up to ``shift`` Å an axis,
  so that no two calls send the same coordinates;
* ``walk``: one seeded box, then a step of ``step`` Å (Gaussian, an axis)
  before every call, taken from a pool of ``pool`` steps in a seeded
  order;
* ``predictor``: keyword arguments of ``Predictor`` for this traffic;
* ``warmup_calls``, ``trace_seconds`` (how much of a traced window the
  profiler records), ``check_calls`` (sampled calls the reference
  judges), ``check_last`` (the last call is judged too) and
  ``check_rebuild`` (one call that selected its neighbors anew is judged
  too).

Every call goes to the program as one ``MolBatch`` object whose arrays
are written in place, as ``Predictor.predict_trajectory`` feeds an MD
code's frames: the program sees a new geometry in an old batch.  Each seed
gives the same sizes, the same number of graphs a call and the same
arrivals; only the coordinates differ."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from portbench.frozen import elements, work
from portbench.frozen.water_box import water_boxes

#: shifts and step orders drawn ahead for this many calls (they repeat
#: after it)
MAX_CALLS = 20_000


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), stream])


def _torch_gen(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


class Traffic:
    """The calls of one run.  :meth:`batch` gives call ``c``'s batch (the
    port's ``MolBatch``, one object for every call); :meth:`graphs` gives
    the reference's inputs of calls, made again from the seed."""

    def __init__(self, spec: dict, n_elems: int, seed: int, device,
                 pad_molecules_fn, molecule_cls, table):
        """``pad_molecules_fn``, ``molecule_cls`` and ``table``: the port's
        ``pad_molecules``, ``Molecule`` and element table, which make the
        batch the program is sent."""
        self.kind = spec["kind"]
        if self.kind not in ("frames", "walk"):
            raise ValueError(f"traffic kind {self.kind!r}")
        self.b = int(spec["graphs_per_call"])
        self.charges = [float(q) for q in spec["charges"]]
        dev = torch.device(device)
        pool = int(spec["pool"])
        rng = _rng(seed, 3)
        boxes = pool if self.kind == "frames" else 1
        self.pool = water_boxes(int(spec["molecules"]), boxes,
                                _torch_gen(seed, 1, dev),
                                float(spec["jitter"]))
        self.symbols = ["O", "H", "H"] * int(spec["molecules"])
        self.n = len(self.symbols)
        self.n_pad = work.padded_atoms(self.n)
        self.n_elems = n_elems
        mols = [molecule_cls(name=f"g{g}", symbols=self.symbols,
                             xyz=self.pool[0], total_charge=self.charge(0, g))
                for g in range(self.b)]
        self.batch_ = pad_molecules_fn(mols, table)
        if self.batch_.padded_atoms != self.n_pad:
            raise ValueError(f"the port pads {self.n} atoms to "
                             f"{self.batch_.padded_atoms}, the benchmark's "
                             f"count to {self.n_pad}")
        self.q0_rows = {q: self._q0_row(q) for q in self.charges}
        self.x_ref = elements.features(self.symbols, n_elems)
        if self.kind == "frames":
            self.order = rng.permutation(pool)
            self.shifts = (rng.random((MAX_CALLS, self.b, 3), np.float32)
                           * np.float32(spec["shift"]))
        else:
            steps = torch.randn((pool, self.n, 3),
                                generator=_torch_gen(seed, 2, dev),
                                device=dev)
            self.steps = (float(spec["step"]) * steps).cpu().numpy()
            self.order = rng.integers(0, pool, size=MAX_CALLS)
            self.start = np.zeros((self.b, self.n_pad, 3), np.float32)
            self.start[:, :self.n] = self.pool[0]
            self.batch_.xyz[:] = self.start
        self.at = -1

    # -- what a call sends ---------------------------------------------------
    def charge(self, c: int, g: int) -> float:
        return self.charges[(c * self.b + g) % len(self.charges)]

    def box(self, c: int, g: int) -> int:
        """The pool box of graph ``g`` of call ``c`` (frames)."""
        return int(self.order[(c * self.b + g) % len(self.order)])

    def _q0_row(self, q: float) -> np.ndarray:
        row = np.zeros(self.n_pad, np.float32)
        row[:self.n] = np.float32(q) / np.float32(self.n)
        return row

    def _frame_xyz(self, c: int, g: int) -> np.ndarray:
        return self.pool[self.box(c, g)] + self.shifts[c % MAX_CALLS, g]

    def _step(self, c: int) -> np.ndarray:
        return self.steps[self.order[c % MAX_CALLS]]

    def batch(self, c: int):
        """Call ``c``'s batch: the run's one batch with call ``c``'s
        coordinates and charges written in.  Calls come in order."""
        if c != self.at + 1:
            raise ValueError("calls come in order")
        self.at = c
        bt = self.batch_
        for g in range(self.b):
            if self.kind == "frames":
                bt.xyz[g, :self.n] = self._frame_xyz(c, g)
            else:
                bt.xyz[g, :self.n] += self._step(c)
            q = self.charge(c, g)
            bt.q0[g] = self.q0_rows[q]
            bt.total_q[g] = np.float32(q)
        return bt

    # -- what the reference is given ----------------------------------------
    def coordinates(self, calls: List[int]) -> dict:
        """{call: (B, N, 3) float32 coordinates it sent}, made again from
        the seed (a walk replayed step by step, in the program's order of
        float32 additions)."""
        out = {}
        if not calls:
            return out
        if self.kind == "frames":
            for c in calls:
                xyz = np.zeros((self.b, self.n_pad, 3), np.float32)
                for g in range(self.b):
                    xyz[g, :self.n] = self._frame_xyz(c, g)
                out[c] = xyz
            return out
        want = set(calls)
        xyz = self.start.copy()
        for c in range(max(calls) + 1):
            for g in range(self.b):
                xyz[g, :self.n] += self._step(c)
            if c in want:
                out[c] = xyz.copy()
        return out

    def graphs(self, calls: List[int]) -> List[dict]:
        """The reference's inputs of each graph of ``calls``: its own
        features of the symbols, q0 = Q / n, the coordinates, the mask."""
        x = np.zeros((self.n_pad, self.n_elems), np.float32)
        x[:self.n] = self.x_ref
        mask = np.zeros(self.n_pad, np.float32)
        mask[:self.n] = 1.0
        out = []
        for c, xyz in self.coordinates(calls).items():
            for g in range(self.b):
                q = self.charge(c, g)
                q0 = np.zeros(self.n_pad, np.float64)
                q0[:self.n] = q / self.n
                out.append(dict(call=c, graph=g, x=x, q0=q0, xyz=xyz[g],
                                mask=mask, n=self.n, total=q))
        return out
