"""Weighted k-means for the clustered far-field tier (counterpart of
``epnn_tpu/ops/cluster.py``).

The far-field (beyond-cutoff) message reduction evaluates, for every atom i,

    Σ_j jvec_j · mids(relu(pi_i + pj_j))

over all columns j.  In physical systems the ``pj`` rows of an h ≠ 0 round
are highly clustered, so quantizing them to C weighted centroids turns the
O(N²) reduction into a count-weighted O(N·C) one over the centroids, with
an error bounded by

    |Δ(message term)_pair| ≤ L(mids ∘ w_out) · max_j ‖pj_j − c(j)‖₂

(relu is 1-Lipschitz).  Charge conservation is untouched: charges move
only in the electron-passing rounds, which stay exact and antisymmetric.

This module holds the clustering primitive (:func:`weighted_kmeans`, plain
PyTorch on the device of its inputs, as it is plain XLA in the JAX
package: no kernel of its own) and the error-bound helper
(:func:`mids_lipschitz_bound`), and the fit's distributed twin for
row-sharded inputs (:func:`weighted_kmeans_sharded`, the ring path's).
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

#: the JAX package's fit precisions; every one runs float32 products here
#: (TF32 off), as the port's config maps JAX's "default" and "highest"
FIT_PRECISIONS = ("highest", "high", "default")


def weighted_kmeans(rows: torch.Tensor, weights: torch.Tensor,
                    n_clusters: int, iters: int = 8, *,
                    fit_precision: str = "highest", fit_rows: int = 0,
                    seed: str = "norm", differentiable: bool = False):
    """Deterministic weighted Lloyd k-means, JAX's contract
    (``epnn_tpu/ops/cluster.py:37``).

    ``rows`` (N, D): the points (a round's ``pj`` projections);
    ``weights`` (N,): nonnegative column weights (the node mask, or ones in
    reference-compat mode); zero-weight rows take no part in the fit and
    add no cluster weight.  Returns ``(centroids (C, D), cluster_weights
    (C,), max_radius)`` in float32 on the device of ``rows``: every row's
    weight lands in exactly one cluster, so ``Σ cluster_weights = Σ
    weights``, and ``max_radius = max_{j: w_j > 0} ‖rows_j −
    centroids_{assign_j}‖₂``, the factor the far-field error bound is
    linear in.

    Seeds: ``"norm"`` takes C evenly spaced valid rows in the order of one
    stable argsort of the squared row norms (invalid rows keyed +inf);
    ``"stride"`` every (nvalid/C)-th valid row in input order (cumsum +
    searchsorted).  With C > nvalid the seeds repeat; the repeats stay
    empty (``argmin`` takes the first minimum) with zero weight.  Lloyd
    sums are the one-hot weighted matrix times the rows, as in JAX, and
    empty clusters keep their previous centroid with zero weight.  The
    fit is a fixed sequence of launches: no host sync, no atomics, so
    repeated calls give the same bits (a serving requirement).

    ``fit_precision``: JAX's name of the fit products' precision; each
    runs float32 products here.  ``fit_rows`` > 0 (and < N): Lloyd runs on
    that many evenly spaced valid rows of the seed ordering; the final
    assignment, weights and radius cover every row.  JAX compares
    ``fit_rows`` with its own row count, which on its Pallas path includes
    the padding it adds at entry; the port adds none, so it compares with
    the caller's N, as JAX's XLA path does.

    ``differentiable``: the fit and the assignment carry no gradient, but
    the returned centroids are the weighted mean of the differentiable
    ``rows`` under the final assignment (one half Lloyd step more than
    serving's), so ``∂cent_c/∂rows_j = w_j / W_c`` for j in cluster c —
    the clustered training tier's exact VJP.  The radius is then taken
    against the returned centroids, without gradient."""
    if fit_precision not in FIT_PRECISIONS:
        raise ValueError(f"fit_precision must be one of {FIT_PRECISIONS}")
    if seed not in ("norm", "stride"):
        raise ValueError("seed must be 'norm' or 'stride'")
    n = rows.shape[0]
    dev = rows.device
    r32 = rows.detach().to(torch.float32)
    w32 = weights.detach().to(torch.float32)
    valid = w32 > 0
    nvalid = torch.clamp(valid.sum(), min=1)
    clusters = torch.arange(n_clusters, device=dev)

    def valid_quantile_idx(m: int) -> torch.Tensor:
        """Indices of m evenly spaced valid rows, in the seed ordering."""
        take = torch.arange(m, device=dev) * nvalid // m
        if seed == "stride":
            cums = torch.cumsum(valid.to(torch.int64), 0)
            # JAX clamps an out-of-range gather (a graph with no valid row)
            return torch.searchsorted(cums, take + 1).clamp(max=n - 1)
        key = torch.where(valid, (r32 * r32).sum(1), torch.inf)
        return torch.argsort(key, stable=True)[take]

    if fit_rows and fit_rows < n:
        fit_idx = valid_quantile_idx(fit_rows)
        rf, wf = r32[fit_idx], w32[fit_idx]
        cent = rf[torch.arange(n_clusters, device=dev) * fit_rows
                  // n_clusters]
    else:
        rf, wf = r32, w32
        cent = r32[valid_quantile_idx(n_clusters)]

    def assign_of(cent, rws):
        # argmin_c ‖r − c‖² = argmin_c (‖c‖² − 2 r·c); ‖r‖² is row-constant
        score = (cent * cent).sum(1)[None, :] - 2.0 * (rws @ cent.T)
        return torch.argmin(score, dim=1), score

    for _ in range(iters):
        assign, _ = assign_of(cent, rf)
        wo = (assign[:, None] == clusters[None, :]).to(torch.float32) \
            * wf[:, None]
        wts = wo.sum(0)
        cent_new = (wo.T @ rf) / torch.clamp(wts, min=1e-30)[:, None]
        cent = torch.where((wts > 0)[:, None], cent_new, cent)

    assign, score = assign_of(cent, r32)
    wo = (assign[:, None] == clusters[None, :]).to(torch.float32) \
        * w32[:, None]
    wts = wo.sum(0)
    if differentiable:
        sums = wo.T @ rows.to(torch.float32)
        cent = torch.where((wts > 0)[:, None],
                           sums / torch.clamp(wts, min=1e-30)[:, None], cent)
        d2 = ((r32 - cent.detach()[assign]) ** 2).sum(1)
        d2 = torch.where(valid, d2, 0.0)
        return cent, wts, torch.sqrt(d2.amax())
    # ‖r − c‖² from the assignment scores, ‖r‖² added back; the
    # cancellation residue clamped at 0
    d2 = score.gather(1, assign[:, None])[:, 0] + (r32 * r32).sum(1)
    d2 = torch.where(valid, torch.clamp(d2, min=0.0), 0.0)
    return cent, wts, torch.sqrt(d2.amax())


def weighted_kmeans_sharded(rows: torch.Tensor, weights: torch.Tensor,
                            n_clusters: int, axis_name, iters: int = 8, *,
                            differentiable: bool = False):
    """Distributed twin of :func:`weighted_kmeans` for row-sharded inputs,
    JAX's contract (``epnn_tpu/ops/cluster.py:170``): the ring path, where
    a round's ``pj`` never exists whole on one rank.

    Called on every rank of the axis: ``rows`` (nd, D) and ``weights``
    (nd,) are this rank's block of the global (N, D) / (N,) arrays, the
    blocks in axis order.  ``axis_name``: the mesh axis, as the process
    group of this rank's line along it (``mesh.get_group("atoms")``) or
    that 1-D sub-mesh (``mesh["atoms"]``).  Returns the same
    ``(centroids (C, D), cluster_weights (C,), max_radius)`` on every
    rank.

    The seed keys (squared row norms, +inf on zero-weight rows) are
    all-gathered, O(N) scalars, so the norm-quantile seed choice is the
    one :func:`weighted_kmeans` makes on the gathered rows (the same
    stable argsort); the seed rows are fetched by a masked one-hot
    product and a ``psum`` (each global index is owned by one rank).  The
    Lloyd partial sums and the final weights are ``psum``-ed, and the
    radius ``pmax``-ed, so the centroids follow the single-rank fit up to
    the order of the sums.  The fit runs in float32 (JAX's HIGHEST), a
    fixed sequence of launches and collectives: repeated calls give the
    same bits.  ``differentiable=True``: as :func:`weighted_kmeans`'s, the
    returned centroids are the weighted means of the differentiable rows
    under the final (stop-gradient) assignment, the partial sums
    ``psum``-ed, whose VJP is a ``psum``: each rank's rows get ``w_j /
    W_c`` of the whole axis's cotangent of their centroid.  The radius
    is then ``pmax``-ed from ‖r − c[assign]‖², without gradient."""
    from epnn_tpu_torch.parallel import _collectives as C

    group = axis_name.get_group() if hasattr(axis_name, "get_group") \
        else axis_name
    nd = rows.shape[0]
    dev = rows.device
    r32 = rows.detach().to(torch.float32)
    w32 = weights.detach().to(torch.float32)
    valid = w32 > 0
    clusters = torch.arange(n_clusters, device=dev)
    my_start = C.index(group) * nd

    # seeds: global norm quantiles (keys gathered, rows psum-fetched)
    rn2 = (r32 * r32).sum(1)
    keys = C.all_gather(torch.where(valid, rn2, torch.inf), group)
    nvalid = torch.clamp(C.psum(valid.sum(), group), min=1)
    take = torch.arange(n_clusters, device=dev) * nvalid // n_clusters
    seed_g = torch.argsort(keys, stable=True)[take]
    onehot_seed = (seed_g[:, None] == (my_start + torch.arange(
        nd, device=dev))[None, :]).to(torch.float32)
    cent = C.psum(onehot_seed @ r32, group)

    def assign_of(cent):
        score = (cent * cent).sum(1)[None, :] - 2.0 * (r32 @ cent.T)
        return torch.argmin(score, dim=1), score

    for _ in range(iters):
        assign, _ = assign_of(cent)
        wo = (assign[:, None] == clusters[None, :]).to(torch.float32) \
            * w32[:, None]
        wts = C.psum(wo.sum(0), group)
        sums = C.psum(wo.T @ r32, group)
        cent_new = sums / torch.clamp(wts, min=1e-30)[:, None]
        cent = torch.where((wts > 0)[:, None], cent_new, cent)

    assign, score = assign_of(cent)
    wo = (assign[:, None] == clusters[None, :]).to(torch.float32) \
        * w32[:, None]
    wts = C.psum(wo.sum(0), group)
    if differentiable:
        sums = C.psum(wo.T @ rows.to(torch.float32), group)
        cent = torch.where((wts > 0)[:, None],
                           sums / torch.clamp(wts, min=1e-30)[:, None], cent)
        d2 = ((r32 - cent.detach()[assign]) ** 2).sum(1)
        d2 = torch.where(valid, d2, 0.0)
        return cent, wts, torch.sqrt(C.pmax(d2.amax() if nd
                                            else d2.new_zeros(()), group))
    d2 = score.gather(1, assign[:, None])[:, 0] + rn2
    d2 = torch.where(valid, torch.clamp(d2, min=0.0), 0.0)
    radius = torch.sqrt(C.pmax(d2.amax() if nd else d2.new_zeros(()),
                               group))
    return cent, wts, radius


def mids_lipschitz_bound(w: Union["PairMLPWeights", Sequence]) -> float:  # noqa: F821
    """Upper bound on the Lipschitz constant of the message MLP's tail (the
    mid layers and the linear head) as JAX computes it
    (``epnn_tpu/ops/cluster.py:259``): ``‖W_out‖₂ · Π_m ‖W_m‖₂`` from exact
    spectral norms in float64 on the host.  ``w`` is one
    :class:`~epnn_tpu_torch.ops.fused.PairMLPWeights` or a sequence of
    them, one a round (where JAX stacks the rounds); each factor is then
    the maximum over the rounds.  The far field's clustered error then
    satisfies, per atom and message round,

        ‖Δ(Σ_j jvec_j mids(relu(pi_i + pj_j)) @ w_out)‖₂
            ≤ (Σ_j jvec_j) · L · max_radius ."""
    rounds = [w] if hasattr(w, "w_out") else list(w)

    def spec(mats) -> float:
        return float(max(np.linalg.norm(
            m.detach().cpu().numpy().astype(np.float64), 2) for m in mats))

    lip = spec([r.w_out for r in rounds])
    for m in range(len(rounds[0].mids)):
        lip *= spec([r.mids[m][0] for r in rounds])
    return lip
