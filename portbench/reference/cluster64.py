"""The plain reference of the clustered far-field tier, in float64.

The tier (``far_cluster`` = C > 0 in a traffic file's ``predictor``
options) replaces the O(N²) far field of the message rounds after the
first by a sum over C weighted k-means centroids of the j-side rows.
This module works it out again from the inputs, in float64, and imports
nothing of the port.  It follows the JAX package's clustered far field
(``epnn_tpu/ops/fused.py``, the message round's ``far_cluster > 0``
branch) and its k-means contract (``epnn_tpu/ops/cluster.py``,
``weighted_kmeans``).  With u = a W1_i + b1 and v = a W1_j the two atom
projections of a round (a = [x, h, q0]), z(p) = mids(relu(p)) the
message MLP up to its last layer, w_j the column weights (the node mask
where ``mask_messages``, else ones) and ρ_i the row factor (the node
mask where ``mask_messages``, else 1):

* **Round 1** (h = 0): a_j = [x_j, 0, q0_j], so v_j takes one value per
  distinct input row g, and Σ_j w_j z(u_i + v_j) = Σ_g W_g z(u_i + v_g)
  with W_g = Σ_{j: a_j = g} w_j.  An identity, not an approximation (the
  program's round-1 collapse to the count-weighted element grid).
* **Rounds 2..T**: Σ_j w_j z(u_i + v_j) becomes Σ_c W_c z(u_i + c_c),
  (c, W) = :func:`weighted_kmeans` (v, w, C).
* **The near correction**, every round: Σ_{j near i} w_j [z(u_i + v_j +
  e_ij W_e) − z(u_i + v_j)] over the ordered pairs within the cutoff,
  exact.
* The round's message sum ρ_i (far_i + near_i) then meets W_out and the
  count-weighted b_out, and the update MLP, as in
  :mod:`portbench.reference.epnn64`; so do the pass rounds, the self
  pair (in its own cluster) and the masks.

**The fit** (the tier's contract, its settings' defaults): C seeds, C
evenly spaced valid rows (w_j > 0) of one stable argsort of the squared
row norms (invalid rows last); then :data:`ITERS` weighted Lloyd steps
over every row (assign each row to the centroid of least ‖c‖² − 2 r·c,
first on ties; each non-empty cluster moves to its rows' weighted mean,
an empty one stays); then one final assignment gives the weights W_c,
against the last step's centroids.  The sums are one-hot products, as
the program's.

Departures:

* the sums over centroids and grid rows, the near correction and the
  fit run in float64 here (the program fits in float32 with TF32 off; a
  fit of this reference's rows in float32 read the same gaps on the
  card, within 0.5%);
* the fit runs on this reference's own rows, which differ from the
  program's by the program's rounding.  Where two rows' norms lie closer
  than that rounding, the norm seeds can fall on other rows, and Lloyd
  can settle elsewhere: the gap the comparison reads then holds the
  spread of the fit as well as the program's rounding;
* the pairs come from a cell list (:func:`cell_pairs`), not from every
  pair, so the search scales as N;
* ``mid_round`` rounds the operands of the far sums' middle products
  (grid and centroids), not the near correction's: the products the
  far-field kernel makes.  ``to_bfloat16`` gives the control of a
  clustered cell whose far field runs one TF32 pass."""

from __future__ import annotations

import math

import torch

from portbench.reference import epnn64

F64 = epnn64.F64
#: the fit's Lloyd steps
ITERS = 8
#: elements of one (rows, C, H) block of the far sums
BLOCK_ELEMS = 1 << 27
#: ordered pairs of one block of the near correction
PAIR_BLOCK = 1 << 21
#: atoms of one block of the cell-list search
ATOM_BLOCK = 1 << 16


def weighted_kmeans(rows: torch.Tensor, weights: torch.Tensor,
                    n_clusters: int, iters: int = ITERS):
    """``(centroids (C, D), cluster_weights (C,))`` of the weighted Lloyd
    fit above, in float64.  Rows of zero weight take no part; every
    other row's weight lands in one cluster."""
    r, w = rows.to(F64), weights.to(F64)
    dev = r.device
    valid = w > 0
    nvalid = torch.clamp(valid.sum(), min=1)
    take = torch.arange(n_clusters, device=dev) * nvalid // n_clusters
    key = torch.where(valid, (r * r).sum(1), torch.inf)
    cent = r[torch.argsort(key, stable=True)[take]]
    clusters = torch.arange(n_clusters, device=dev)

    def weighted_onehot(cent):
        score = (cent * cent).sum(1)[None, :] - 2.0 * (r @ cent.T)
        return (torch.argmin(score, dim=1)[:, None]
                == clusters[None, :]).to(F64) * w[:, None]

    for _ in range(iters):
        wo = weighted_onehot(cent)
        wts = wo.sum(0)
        new = (wo.T @ r) / torch.clamp(wts, min=1e-30)[:, None]
        cent = torch.where((wts > 0)[:, None], new, cent)
    return cent, weighted_onehot(cent).sum(0)


def cell_pairs(xyz: torch.Tensor, real: torch.Tensor, cutoff: float):
    """``(i, j, d)``: the ordered pairs of real atoms i ≠ j with d_ij <
    ``cutoff``, in order of (i, j), from a cell list of cells ``cutoff``
    wide (each atom against the 27 cells around its own)."""
    dev = xyz.device
    atoms = torch.nonzero(real).flatten()
    pts = xyz[atoms]
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    if len(atoms) < 2:
        return empty, empty, torch.zeros(0, dtype=F64, device=dev)
    cell = torch.floor((pts - pts.amin(0)) / cutoff).to(torch.int64) + 1
    dims = cell.amax(0) + 2                      # a ring of empty cells
    key = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    order = torch.argsort(key)
    skey = key[order]
    ncell = int(dims.prod())
    start = torch.searchsorted(skey, torch.arange(ncell, device=dev))
    count = torch.searchsorted(skey, torch.arange(ncell, device=dev),
                               right=True) - start
    cap = int(count.max())
    off = torch.tensor([-1, 0, 1], device=dev)
    dx, dy, dz = torch.meshgrid(off, off, off, indexing="ij")
    delta = ((dx * dims[1] + dy) * dims[2] + dz).flatten()     # (27,)
    slot = torch.arange(cap, device=dev)
    ii, jj, dd = [], [], []
    for s in range(0, len(atoms), ATOM_BLOCK):
        a = torch.arange(s, min(s + ATOM_BLOCK, len(atoms)), device=dev)
        nk = key[a, None] + delta[None, :]                     # (b, 27)
        cand = start[nk][..., None] + slot                     # (b, 27, cap)
        ok = slot < count[nk][..., None]
        b = order[cand.clamp(max=len(atoms) - 1)]
        d = torch.sqrt(((pts[a, None, None, :] - pts[b]) ** 2).sum(-1))
        hit = ok & (d < cutoff) & (b != a[:, None, None])
        ai, _, _ = hit.nonzero(as_tuple=True)
        ii.append(a[ai])
        jj.append(b[hit])
        dd.append(d[hit])
    i, j, d = atoms[torch.cat(ii)], atoms[torch.cat(jj)], torch.cat(dd)
    by = torch.argsort(i * xyz.shape[0] + j)
    return i[by], j[by], d[by]


class Graph(epnn64.Graph):
    """One graph at the clustered tier of ``far_cluster`` = C centroids:
    the inputs of :class:`portbench.reference.epnn64.Graph`, whose pass
    rounds and gate ties it keeps."""

    def __init__(self, params: dict, model: dict, x, q0, xyz, mask,
                 device="cpu", mid_round=None, far_cluster: int = 32):
        if far_cluster <= 0:
            raise ValueError("far_cluster must be > 0")
        self.far_cluster = int(far_cluster)
        super().__init__(params, model, x, q0, xyz, mask, device,
                         mid_round)

    # -- pairs within the cutoff -------------------------------------------
    def _pairs(self):
        """As :meth:`epnn64.Graph._pairs`, the pairs from a cell list."""
        cut = self.model["cutoff"]
        self.pi, self.pj, d = cell_pairs(self.xyz, self.mask > 0, cut)
        c = (torch.cos(math.pi * d / cut) + 1.0) / 2.0
        c = torch.where(d <= 0.0, torch.ones_like(c), c)
        self.e = c[:, None] * torch.exp(
            -self.model["eta"] * (d[:, None] - self.mu[None, :]) ** 2)
        tol = self.model["is_near_tol"]
        top = self.e.amax(-1)
        self.gate = (top > tol).to(F64)
        self.margin = (top / tol - 1.0).abs()

    # -- message rounds -----------------------------------------------------
    @staticmethod
    def _z(pre, mids, mid_round=None):
        """mids(relu(pre)) over the last axis; ``mid_round`` on the
        operands of each middle product."""
        z = torch.relu(pre)
        for w, b in mids:
            if mid_round is not None:
                z, w = mid_round(z), mid_round(w)
            z = torch.relu(torch.matmul(z, w) + b)
        return z

    def _far(self, u, cols, wts, mids, mid_round):
        """(N, H'): Σ_c wts_c z(u_i + cols_c), in blocks of rows."""
        n, c, hid = u.shape[0], cols.shape[0], u.shape[1]
        rows = max(1, BLOCK_ELEMS // max(c * hid, 1))
        out = []
        for s in range(0, n, rows):
            z = self._z(u[s:s + rows, None, :] + cols[None, :, :], mids,
                        mid_round)
            out.append(torch.einsum("rch,c->rh", z, wts))
            del z
        return torch.cat(out)

    def _near(self, u, v, ew, jw, mids):
        """(N, H'): Σ_{j near i} w_j [z(u_i + v_j + e_ij W_e) − z(u_i +
        v_j)], in blocks of pairs."""
        out = None
        for s in range(0, len(self.pi), PAIR_BLOCK):
            pi, pj = self.pi[s:s + PAIR_BLOCK], self.pj[s:s + PAIR_BLOCK]
            base = u[pi] + v[pj]
            corr = (self._z(base + ew[s:s + PAIR_BLOCK], mids)
                    - self._z(base, mids)) * jw[pj, None]
            if out is None:
                out = torch.zeros((self.n, corr.shape[1]), dtype=F64,
                                  device=self.device)
            out.index_add_(0, pi, corr)
            del base, corr
        return out

    def _message_rounds(self, mid_round=None) -> torch.Tensor:
        """(N, H) hidden state after the T message rounds of the tier."""
        model, n, dev = self.model, self.n, self.device
        fa = self.x.shape[1] + model["h_dim"] + 1
        masked = model["mask_messages"]
        # the column weights, and the row factor: the node mask, or ones
        jw = self.mask if masked else torch.ones(n, dtype=F64, device=dev)
        count = (self.mask * jw.sum() if masked
                 else torch.full((n,), float(n), dtype=F64, device=dev))
        h = torch.zeros((n, model["h_dim"]), dtype=F64, device=dev)
        nm = self.mask[:, None]
        for t, layers in enumerate(self.msg):
            (w1, b1), *rest = layers
            mids, (w_out, b_out) = rest[:-1], rest[-1]
            a = self._atoms(h, self.q0)
            w_i, w_j, w_e = w1[:fa], w1[fa:2 * fa], w1[2 * fa:]
            u = a @ w_i + b1
            v = a @ w_j
            if t == 0:
                grid, inv = torch.unique(a, dim=0, return_inverse=True)
                wts = torch.zeros(len(grid), dtype=F64,
                                  device=dev).index_add_(0, inv, jw)
                cols = grid @ w_j
            else:
                cols, wts = weighted_kmeans(v, jw, self.far_cluster)
            far = self._far(u, cols, wts, mids, mid_round)
            if len(self.pi):
                far = far + self._near(u, v, self.e @ w_e, jw, mids)
            agg = (jw[:, None] * far) @ w_out + count[:, None] * b_out
            h = epnn64._mlp(self.upd, torch.cat([h, agg], dim=-1) * nm) * nm
        return h
