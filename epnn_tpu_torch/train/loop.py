"""Training loop (counterpart of ``epnn_tpu/train/loop.py``, single device):
bucketed batching, Adam updates, masked metrics, best-val checkpoints and
exact resume.

The parameters are one tree in the JAX layout (``{"message_t" | "update" |
"pass_t": {"dense_k": {"kernel", "bias"}}}``) whose leaves are the tensors
Adam updates.  Buckets padded to at most ``dense_max_atoms`` atoms train
through the dense model (:func:`epnn_tpu_torch.models.dense_apply`); wider
buckets through the neighbor-split blocked forward
(:func:`epnn_tpu_torch.ops.forward_blocked`), whose far field runs the
``dense_message_rowsum`` kernel forward and its backward kernel in the
backward.  Both paths differentiate the same leaves, and checkpoints stay
in the JAX layout.  ``TrainConfig(far_cluster=C)`` trains the fused
buckets through the clustered far-field tier (eval steps and checkpoint
selection stay exact, as in the JAX trainer).  Buckets of
``infer.HUGE_GRAPH_MIN_ATOMS`` padded atoms and more train in the huge-N
memory mode (the near field in row chunks, every round and chunk
rematerialized in the backward), as JAX's trainer does.

Every precision tier of the config trains, with JAX's routes (see
:func:`epnn_tpu_torch.ops.fused.forward_blocked`): under ``"default"``
(the CLI's ``fast``) the far field's forward and its backward kernel run
at one TF32 pass on the card, and the near kernels' forward too, while
their backward recomputes through their float32 plain versions (JAX
recomputes at the precision: a departure, ROADMAP); ``compute_dtype=
"bfloat16"`` trains the bf16 recursion, its parameters and checkpoints
float32.

The optimizer is JAX's optax chain in PyTorch (:class:`Optimizer`): Adam
at the float32 rate of the constant or warmup-cosine schedule, or of the
reduce-on-plateau rate, after global-norm clipping, over gradients
averaged across ``grad_accum`` minibatches; ``ema_decay`` keeps JAX's
moving average of the weights, which then validates and is what
``best/`` holds.  ``tensorboard_dir`` writes each epoch's row as
scalars; ``debug_nans`` raises ``FloatingPointError`` at the first
non-finite loss or gradient (JAX's ``jax_debug_nans`` stops at the
operation that made it: a departure).

``train`` runs on the first CUDA card unless it is given ``device="cpu"``;
without a card it raises.  ``train(mesh=...)`` trains on a device mesh
(:func:`epnn_tpu_torch.parallel.make_mesh`, one process a rank, every
rank calling it with the same molecules): each ``data`` coordinate trains
its block of every minibatch (:func:`data_parallel_train_step`), buckets
wider than ``dense_max_atoms`` go through the atom-sharded step when the
``atoms`` axis is longer than 1 and divides their width
(:func:`~epnn_tpu_torch.parallel.atom_shard.make_sharded_train_step`), the
loss is the global batch's and the gradients are summed over the mesh
before clipping and Adam, so the parameters stay equal on every rank bit
for bit.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from epnn_tpu_torch.data.dataset import (
    MolBatch,
    bucket_molecules,
    minibatches,
    round_up,
    train_val_split,
    uniform_q0_contract,
)
from epnn_tpu_torch import infer as infer_mod
from epnn_tpu_torch.data.xyz import Molecule
from epnn_tpu_torch.device import resolve_device
from epnn_tpu_torch.elements import table_for_n_elems
from epnn_tpu_torch.featurize import rbf_edges
from epnn_tpu_torch.io import checkpoint as ckpt_io
from epnn_tpu_torch.models import (
    EPNN,
    EPNNConfig,
    dense_apply,
    init_params,
    map_tree,
    tree_leaves,
)
from epnn_tpu_torch.ops.fused import (
    balanced_row_chunk,
    batch_cell_grid,
    build_neighbors_batch,
    build_neighbors_cell,
    forward_blocked,
    fuse_params,
    max_neighbor_count,
)
from epnn_tpu_torch.train import metrics as M

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX trainer's hyperparameters, with the same names and defaults
    (Adam lr 1e-3, betas 0.9/0.999, eps 1e-7 — the reference's keras
    defaults — 500 epochs, 80/20 split with seed 42).  See
    ``epnn_tpu/train/loop.py`` for what each field means there.  Here:

    * ``fused_block`` has no effect: the port's kernels choose their own
      tiles;
    * ``precompute_neighbors`` builds each fused bucket's neighbor tables
      once, as the JAX trainer does: through the cell-list builder from
      ``CELL_GRID_MIN_ATOMS`` padded atoms, by top-k over −d² below;
    * ``lr_schedule`` (``'constant'`` or ``'cosine'``: optax's
      ``warmup_cosine_decay_schedule`` from 0 over ``warmup_steps`` when
      there are any, to ``lr_final_fraction`` of the peak at
      ``total_steps``, default 100,000, warmup included),
      ``lr_plateau_factor`` / ``lr_plateau_patience`` (the rate times the
      factor after that many evaluated epochs without a better val masked
      MAE; constant schedule only), ``grad_clip_norm``, ``grad_accum`` and
      ``ema_decay`` are JAX's (:class:`Optimizer`, :func:`train`);
      ``tensorboard_dir`` writes the scalars of each row;
      ``debug_nans`` raises ``FloatingPointError`` naming the step of the
      first non-finite loss or gradient;
    * ``remat`` checkpoints every round of the fused train step
      (``torch.utils.checkpoint``); ``near_row_chunk`` is the huge-N
      memory mode of fused buckets: ``-1`` (auto) chunks buckets of
      ``infer.HUGE_GRAPH_MIN_ATOMS`` padded atoms and more at the
      Predictor's balanced chunk and forces remat for them, ``0`` never
      chunks, ``> 0`` chunks every fused bucket and requires ``remat``
      (without it the backward keeps every chunk's activations);
      ``near_window`` > 0 windows the chunked gathers (requires chunking;
      spatially sorted atoms, width from
      ``ops.fused.neighbor_window_width``);
    * ``far_cluster`` = C > 0 runs the train steps of fused buckets with
      their far field over C weighted k-means centroids a round, as JAX's
      (``epnn_tpu/train/loop.py:121-129``); ``far_cluster_grad`` (default
      True) takes the gradient through the differentiable final centroids
      (∂cent_c/∂pj_j = w_j/W_c) into the far-field backward kernel, False
      drops that path.  Eval steps stay exact."""

    learning_rate: float = 1e-3
    lr_schedule: str = "constant"
    lr_final_fraction: float = 0.05
    warmup_steps: int = 0
    total_steps: Optional[int] = None
    lr_plateau_factor: Optional[float] = None
    lr_plateau_patience: int = 2
    ema_decay: Optional[float] = None
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-7
    grad_clip_norm: Optional[float] = None
    grad_accum: int = 1
    epochs: int = 500
    batch_size: int = 32
    loss: str = "masked_mse"
    seed: int = 0
    val_fraction: float = 0.2
    split_seed: int = 42
    bucket_multiple: int = 8
    checkpoint_dir: Optional[str] = None
    log_path: Optional[str] = None
    resume: bool = False
    init_from: Optional[str] = None
    tensorboard_dir: Optional[str] = None
    debug_nans: bool = False
    eval_every: int = 1
    early_stop_patience: Optional[int] = None
    dump_predictions: bool = False
    dense_max_atoms: int = 256
    fused_block: int = 256
    collapse_round1: bool = True
    far_cluster: int = 0
    precompute_neighbors: bool = True
    remat: bool = False
    far_cluster_grad: bool = True
    near_row_chunk: int = -1
    near_window: int = 0


def check_supported(tc: TrainConfig) -> None:
    """Raise ``ValueError`` for a setting the trainer cannot run: an
    unknown loss or schedule, or the plateau with a step-indexed schedule
    (JAX's ``make_optimizer``)."""
    if tc.loss not in M.LOSSES:
        raise ValueError(f"unknown loss {tc.loss!r}; one of "
                         f"{sorted(M.LOSSES)}")
    if tc.lr_schedule not in ("constant", "cosine"):
        raise ValueError(f"lr_schedule {tc.lr_schedule!r}: 'constant' or "
                         "'cosine'")
    if tc.lr_plateau_factor is not None and tc.lr_schedule != "constant":
        raise ValueError(
            "lr_plateau_factor requires lr_schedule='constant' "
            "(a step-indexed schedule and plateau scaling would fight)")
    if tc.grad_accum < 1:
        raise ValueError("grad_accum must be >= 1")
    if (tc.lr_schedule == "cosine"
            and (tc.total_steps or 100_000) <= tc.warmup_steps):
        raise ValueError("lr_schedule='cosine' needs total_steps > "
                         "warmup_steps")


def lr_at(tc: TrainConfig, count: int) -> float:
    """The schedule's rate for Adam's update ``count`` (0 first), as optax
    computes it in float32 (``warmup_cosine_decay_schedule`` with JAX's
    arguments, ``epnn_tpu/train/loop.py:202-210``: ``decay_steps``
    includes the warmup; ``count`` is the update count, once a window
    under ``grad_accum``), as the Python float of that float32."""
    peak = tc.learning_rate
    if tc.lr_schedule != "cosine":
        return float(torch.tensor(peak, dtype=torch.float32))
    warm = tc.warmup_steps
    total = tc.total_steps or 100_000
    init = 0.0 if warm else peak
    end = peak * tc.lr_final_fraction
    step = torch.tensor(count, dtype=torch.int32)
    if warm > 0 and count < warm:
        frac = 1 - torch.clamp(step, 0, warm) / warm
        return float((init - peak) * frac ** 1 + peak)
    alpha = 0.0 if peak == 0.0 else end / peak
    decay = float(total - warm)
    t = torch.minimum(step - max(warm, 0),
                      torch.tensor(decay, dtype=torch.float32))
    cosine = 0.5 * (1 + torch.cos(math.pi * t / decay))
    return float(peak * ((1 - alpha) * cosine ** 1.0 + alpha))


class Optimizer:
    """The JAX trainer's optimizer (``make_optimizer``,
    ``epnn_tpu/train/loop.py:189-222``) over the tree's leaves, one update
    at each :meth:`step` after ``loss.backward()``:

    * ``grad_accum`` = k > 1 is ``optax.MultiSteps``: the gradients'
      running mean ``acc + (g − acc)/(n + 1)`` (Welford's, n the
      minibatches so far in the window), and on the k-th the rest of the
      chain on the mean, Adam's update count advancing once a window;
      in between the parameters do not move;
    * ``grad_clip_norm`` is ``optax.clip_by_global_norm``: ``g`` where
      ‖g‖ < max, else ``(g / ‖g‖) · max`` (not
      ``torch.nn.utils.clip_grad_norm_``, whose ``+1e-6`` moves the bits);
    * Adam (PyTorch's, optax's form: eps outside the root) at the float32
      rate :func:`lr_at` of its update count, or under
      ``lr_plateau_factor`` at :attr:`lr`, the rate optax injects into its
      state as float32 (:meth:`scale_lr` multiplies it, as JAX's
      ``_scale_plateau_lr``).

    ``debug_nans``: :func:`_apply` checks each loss and gradient."""

    def __init__(self, tc: TrainConfig, params: dict):
        check_supported(tc)
        self.tc = tc
        self.leaves = tree_leaves(params)
        self.adam = torch.optim.Adam(self.leaves, lr=lr_at(tc, 0),
                                     betas=(tc.beta1, tc.beta2), eps=tc.eps)
        #: the plateau's injected rate (float32)
        self.lr = torch.tensor(tc.learning_rate, dtype=torch.float32)
        #: Adam's updates so far (optax's inner count)
        self.count = 0
        #: minibatches in the open window, and their gradients' mean
        self.mini_step = 0
        self.acc: Optional[List[Tensor]] = None

    @property
    def state(self) -> dict:
        """Adam's per-leaf state (``exp_avg``, ``exp_avg_sq``, ``step``)."""
        return self.adam.state

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.adam.zero_grad(set_to_none=set_to_none)

    def rate(self) -> float:
        """The rate of Adam's next update."""
        if self.tc.lr_plateau_factor is not None:
            return float(self.lr)
        return lr_at(self.tc, self.count)

    def scale_lr(self, factor: float) -> None:
        self.lr = self.lr * factor

    def step(self) -> None:
        grads = [p.grad for p in self.leaves]
        k = self.tc.grad_accum
        if k > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            n = self.mini_step
            self.acc = [a + (g - a) / (n + 1)
                        for a, g in zip(self.acc, grads)]
            if n + 1 < k:
                self.mini_step += 1
                return
            grads, self.acc, self.mini_step = self.acc, None, 0
        if self.tc.grad_clip_norm is not None:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            mx = self.tc.grad_clip_norm
            grads = [torch.where(norm < mx, g, (g / norm) * mx)
                     for g in grads]
        for p, g in zip(self.leaves, grads):
            p.grad = g
        for group in self.adam.param_groups:
            group["lr"] = self.rate()
        self.adam.step()
        self.count += 1

    def extras(self) -> dict:
        """What a checkpoint keeps beside Adam's moments: the update
        count, the injected rate and the open window."""
        out = {"count": self.count, "lr": float(self.lr),
               "mini_step": self.mini_step}
        if self.acc is not None:
            out["acc_grads"] = [a.detach().cpu().numpy() for a in self.acc]
        return out

    def restore_extras(self, extras: dict, step: int) -> None:
        self.count = int(extras.get("count", step))
        self.lr = torch.tensor(extras.get("lr", self.tc.learning_rate),
                               dtype=torch.float32)
        self.mini_step = int(extras.get("mini_step", 0))
        acc = extras.get("acc_grads")
        self.acc = None if acc is None else [
            torch.as_tensor(a).to(p.device)
            for a, p in zip(acc, self.leaves, strict=True)]


@dataclasses.dataclass
class TrainState:
    """``params``: the JAX-layout tree of leaf tensors (``requires_grad``);
    ``opt``: the :class:`Optimizer` over those leaves; ``step``: step
    calls made (minibatches, as JAX's ``state.step``)."""

    params: dict
    opt: "Optimizer"
    step: int = 0


def make_optimizer(tc: TrainConfig, params: dict) -> Optimizer:
    """JAX's optimizer over the tree's leaves (:class:`Optimizer`)."""
    return Optimizer(tc, params)


def create_state(cfg: EPNNConfig, tc: TrainConfig, seed: int = 0,
                 device=None, params: Optional[dict] = None) -> TrainState:
    """A fresh state: ``params`` (default: :func:`init_params` from
    ``seed``) copied to ``device`` as leaves that require grad."""
    device = resolve_device(device, "training")
    if params is None:
        params = init_params(cfg, torch.Generator().manual_seed(seed))
    if "params" in params:
        params = params["params"]
    params = map_tree(lambda a: a.detach().to(device, torch.float32)
                      .clone().requires_grad_(True), params)
    return TrainState(params=params, opt=make_optimizer(tc, params))


def _model_cfg(model) -> EPNNConfig:
    """The config of JAX's ``model`` argument: an :class:`EPNN` (its
    ``cfg``) or the config itself."""
    return model.cfg if isinstance(model, EPNN) else model


def _loss_dense(params, cfg, loss_name, x, q0, xyz, node_mask, y, weight):
    e = rbf_edges(xyz, node_mask, e_dim=cfg.e_dim, cutoff=cfg.cutoff,
                  eta=cfg.eta)
    pred = dense_apply(params, cfg, x, q0, e, node_mask)
    return M.LOSSES[loss_name](pred, y, node_mask, weight), pred


def _loss_fused(params, cfg, loss_name, block, neighbor_k, use_pallas, x,
                q0, xyz, node_mask, y, weight, uniform_q0=False,
                far_cluster=0, far_cluster_grad=False, remat=False,
                neighbors=None, nbr_tables=None, nbr_rows=None,
                near_row_chunk=0, near_window=0):
    """Loss through the blocked forward, JAX's ``_loss_fn_fused``.
    ``fuse_params`` only slices and copies, so gradients reach the same
    tree the dense path trains.  ``nbr_tables``/``nbr_rows``: the bucket's
    (B, N, k) tables and this minibatch's rows of them, in place of
    ``neighbors``.  The rest as :func:`~epnn_tpu_torch.ops.fused.
    forward_blocked` (``far_cluster``: the clustered far field;
    ``near_row_chunk``/``near_window``/``remat``: the huge-N memory mode).
    The trainer passes ``use_pallas=False``: under
    ``dense_matmul_precision="int8"`` its far field stays unquantized, as
    in the JAX trainer, which takes its far-field kernel only at
    ``"default"`` (``epnn_tpu/train/loop.py:646-652``)."""
    if nbr_tables is not None:
        neighbors = tuple(t[nbr_rows] for t in nbr_tables)
    device = node_mask.device
    pred = forward_blocked(fuse_params(params, cfg, device), x, q0, xyz,
                           node_mask, cfg, block=block,
                           neighbor_k=neighbor_k, use_pallas=use_pallas,
                           remat=remat, neighbors=neighbors,
                           uniform_q0=uniform_q0, far_cluster=far_cluster,
                           far_cluster_grad=far_cluster_grad,
                           near_row_chunk=near_row_chunk,
                           near_window=near_window)
    return M.LOSSES[loss_name](pred, y, node_mask, weight), pred


def _apply(state: TrainState, loss: Tensor, opt=None, mesh=None) -> None:
    """One optimizer step (``opt``, default the state's own).  A leaf the
    loss does not reach (the pass MLPs' output bias cancels in f_ij −
    f_ji) gets a zero gradient, as under JAX, so its moments decay and
    every leaf's step count stays the global one.  Under ``debug_nans``
    of the stepping optimizer's config (the state's where ``opt`` has
    none) a non-finite loss or gradient raises ``FloatingPointError``
    before the update (one host sync a step).

    ``mesh``: ``loss`` is the global batch's, computed alike on every rank
    of the mesh from charges gathered through the collectives, whose VJPs
    sum the ranks' cotangents: each rank back-propagates 1/(ranks) of it,
    and the gradients are then summed over the mesh, so every rank steps
    with the whole batch's gradient, the same bits everywhere."""
    opt = state.opt if opt is None else opt
    opt.zero_grad(set_to_none=True)
    if mesh is None:
        loss.backward()
    else:
        loss.backward(torch.full_like(loss, 1.0 / mesh.size()))
    leaves = tree_leaves(state.params)
    for p in leaves:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if mesh is not None:
        from epnn_tpu_torch.parallel._collectives import mesh_sum_

        mesh_sum_([p.grad for p in leaves], mesh)
    if getattr(opt, "tc", state.opt.tc).debug_nans:
        for what, ok in (("loss", torch.isfinite(loss).all()),
                         ("gradient", torch.stack([
                             torch.isfinite(p.grad).all() for p in leaves])
                          .all())):
            if not bool(ok):
                raise FloatingPointError(
                    f"debug_nans: non-finite {what} at step {state.step}")
    opt.step()
    state.step += 1


def train_step(state: TrainState, model, loss_name: str, opt,
               x, q0, xyz, node_mask, y, weight):
    """One dense update in place, with JAX's parameters in JAX's order.
    ``model``: an :class:`EPNN` or its :class:`EPNNConfig`; ``opt``: an
    optimizer over the state's leaves (``zero_grad`` and ``step``: an
    :class:`Optimizer` or a ``torch.optim`` one), ``None`` for the state's
    own.  Returns ``(state, loss, pred, mets)``."""
    loss, pred = _loss_dense(state.params, _model_cfg(model), loss_name, x,
                             q0, xyz, node_mask, y, weight)
    _apply(state, loss, opt)
    pred = pred.detach()
    return state, loss.detach(), pred, M.mae_sums(pred, y, node_mask, weight)


@torch.no_grad()
def eval_step(params: dict, model, loss_name: str,
              x, q0, xyz, node_mask, y, weight):
    """Loss, charges and metric sums of the dense forward; ``model`` as in
    :func:`train_step`."""
    loss, pred = _loss_dense(params, _model_cfg(model), loss_name, x, q0,
                             xyz, node_mask, y, weight)
    return loss, pred, M.mae_sums(pred, y, node_mask, weight)


def train_step_fused(state: TrainState, cfg: EPNNConfig, loss_name: str,
                     opt, block: int, neighbor_k: int, x, q0, xyz,
                     node_mask, y, weight, use_pallas: bool = False,
                     uniform_q0: bool = False, far_cluster: int = 0,
                     far_cluster_grad: bool = False, remat: bool = True,
                     neighbors=None, nbr_tables=None, nbr_rows=None,
                     near_row_chunk: int = 0, near_window: int = 0):
    """One update through the blocked forward in place, with JAX's
    parameters in JAX's order and defaults (:func:`_loss_fused`).
    ``opt``: as in :func:`train_step`; ``block``: JAX's row block,
    accepted as ``forward_blocked`` accepts it; ``neighbors``: the
    minibatch's ``(idx, mask, d2)``, or ``nbr_tables`` and ``nbr_rows``;
    ``far_cluster``: the clustered far field; ``near_row_chunk`` /
    ``near_window`` / ``remat``: the huge-N memory mode.  Returns
    ``(state, loss, pred, mets)``."""
    loss, pred = _loss_fused(state.params, cfg, loss_name, block,
                             neighbor_k, use_pallas, x, q0, xyz, node_mask,
                             y, weight, uniform_q0, far_cluster,
                             far_cluster_grad, remat, neighbors, nbr_tables,
                             nbr_rows, near_row_chunk, near_window)
    _apply(state, loss, opt)
    pred = pred.detach()
    return state, loss.detach(), pred, M.mae_sums(pred, y, node_mask, weight)


@torch.no_grad()
def eval_step_fused(params: dict, cfg: EPNNConfig, loss_name: str,
                    block: int, neighbor_k: int, x, q0, xyz, node_mask, y,
                    weight, use_pallas: bool = False,
                    uniform_q0: bool = False, neighbors=None,
                    nbr_tables=None, nbr_rows=None,
                    near_row_chunk: int = 0, near_window: int = 0):
    """Loss, charges and metric sums of the exact blocked forward, with
    JAX's parameters in JAX's order."""
    loss, pred = _loss_fused(params, cfg, loss_name, block, neighbor_k,
                             use_pallas, x, q0, xyz, node_mask, y, weight,
                             uniform_q0, neighbors=neighbors,
                             nbr_tables=nbr_tables, nbr_rows=nbr_rows,
                             near_row_chunk=near_row_chunk,
                             near_window=near_window)
    return loss, pred, M.mae_sums(pred, y, node_mask, weight)


def _data_parallel_loss(params, cfg: EPNNConfig, loss_name: str, mesh,
                        x, q0, xyz, node_mask, y, weight, neighbor_k, block,
                        neighbors, fused_kw):
    """The global batch's loss and charges on a mesh: this rank's
    ``data`` block through the dense model (``neighbor_k`` None) or the
    blocked forward, the blocks' charges all-gathered (differentiable),
    the loss of the whole batch."""
    from epnn_tpu_torch.parallel.atom_shard import gather_batch, local_batch
    from epnn_tpu_torch.parallel.sharding import DATA_AXIS, axis_size

    if x.shape[0] % axis_size(mesh, DATA_AXIS):
        raise ValueError(f"batch dim {x.shape[0]} not divisible by data "
                         f"axis {axis_size(mesh, DATA_AXIS)}")
    mine = local_batch(mesh, x.shape[0])
    if neighbors is not None:
        neighbors = tuple(t[mine] for t in neighbors)
    local = (x[mine], q0[mine], xyz[mine], node_mask[mine])
    if neighbor_k is None:
        _, pred = _loss_dense(params, cfg, loss_name, *local, y[mine],
                              weight[mine])
    else:
        _, pred = _loss_fused(params, cfg, loss_name, block, neighbor_k,
                              False, *local, y[mine], weight[mine],
                              neighbors=neighbors, **fused_kw)
    pred = gather_batch(pred.contiguous(), mesh)
    return M.LOSSES[loss_name](pred, y, node_mask, weight), pred


def data_parallel_train_step(state: TrainState, cfg: EPNNConfig,
                             loss_name: str, opt, mesh, x, q0, xyz,
                             node_mask, y, weight, neighbor_k=None,
                             block: int = 256, neighbors=None, **fused_kw):
    """One data-parallel update in place, the mesh twin of
    :func:`train_step` (``neighbor_k`` None) and :func:`train_step_fused`
    (``fused_kw``: its ``uniform_q0``, ``far_cluster``, ``far_cluster_grad``,
    ``remat``, ``near_row_chunk``, ``near_window``): called on every rank
    of ``mesh`` with the whole batch (tensors on :func:`~epnn_tpu_torch.
    parallel.sharding.mesh_device`, B a multiple of the ``data`` axis)
    and the replicated state.  Each ``data`` coordinate runs its B/n_data
    molecules (every rank along ``atoms`` alike), the charges are
    all-gathered, and the loss, the metric sums and the gradients are
    the whole batch's (:func:`_apply` with ``mesh``).  Returns ``(state,
    loss, pred, mets)``, the same on every rank."""
    loss, pred = _data_parallel_loss(state.params, cfg, loss_name, mesh, x,
                                     q0, xyz, node_mask, y, weight,
                                     neighbor_k, block, neighbors, fused_kw)
    _apply(state, loss, opt, mesh=mesh)
    pred = pred.detach()
    return state, loss.detach(), pred, M.mae_sums(pred, y, node_mask, weight)


@torch.no_grad()
def data_parallel_eval_step(params: dict, cfg: EPNNConfig, loss_name: str,
                            mesh, x, q0, xyz, node_mask, y, weight,
                            neighbor_k=None, block: int = 256,
                            neighbors=None, **fused_kw):
    """Loss, charges and metric sums of the whole batch, each ``data``
    coordinate evaluating its block (:func:`data_parallel_train_step`'s
    arguments)."""
    loss, pred = _data_parallel_loss(params, cfg, loss_name, mesh, x, q0,
                                     xyz, node_mask, y, weight, neighbor_k,
                                     block, neighbors, fused_kw)
    return loss, pred, M.mae_sums(pred, y, node_mask, weight)


class MetricAccumulator:
    """Keeps losses and metric sums on the device and reads them to the
    host once, when a property is first asked for."""

    def __init__(self):
        self._losses: List[Tensor] = []
        self._mets: List[Tensor] = []
        self._cache = None

    def update(self, loss: Tensor, mets: Tensor) -> None:
        self._losses.append(loss)
        self._mets.append(mets)
        self._cache = None

    def _reduced(self):
        if self._cache is None:
            if self._losses:
                ls = torch.stack(self._losses).double().cpu().numpy()
                ms = torch.stack(self._mets).double().cpu().numpy()
                self._cache = (float(np.mean(ls)), ms.sum(axis=0))
            else:
                self._cache = (0.0, np.zeros(4))
        return self._cache

    @property
    def masked_mae(self) -> float:
        _, (ms, mn, _, _) = self._reduced()
        return float(ms / max(mn, 1.0))

    @property
    def padded_mae(self) -> float:
        _, (_, _, ps, pn) = self._reduced()
        return float(ps / max(pn, 1.0))

    @property
    def loss(self) -> float:
        return self._reduced()[0]


@dataclasses.dataclass
class TrainResult:
    state: TrainState
    best_val_masked_mae: float
    best_val_padded_mae: float
    history: List[Dict[str, float]]


def _dump_prediction_artifacts(out_dir, params, cfg, device, train_mols,
                               val_mols):
    """The best checkpoint's prediction dumps (padded (nmol, natom) arrays
    and name lists, the reference's ``model_systems/`` artifact set)."""
    from epnn_tpu_torch.infer import Predictor

    pred = Predictor(params=map_tree(lambda a: a.detach().clone(), params),
                     cfg=cfg, device=device)
    art = os.path.join(out_dir, "artifacts")
    os.makedirs(art, exist_ok=True)
    for split, mols in (("train", train_mols), ("val", val_mols)):
        if not mols:
            continue
        width = max(m.natoms for m in mols)
        charges = pred.predict_molecules(mols)
        preds = np.zeros((len(mols), width), np.float32)
        labs = np.zeros((len(mols), width), np.float32)
        for i, (m, q) in enumerate(zip(mols, charges)):
            preds[i, :m.natoms] = q
            if m.labels is not None:
                labs[i, :m.natoms] = m.labels
        np.save(os.path.join(art, f"{split}_pred_charges.npy"), preds)
        np.save(os.path.join(art, f"{split}_lab_charges.npy"), labs)
        np.save(os.path.join(art, f"{split}_names.npy"),
                np.array([m.name for m in mols]), allow_pickle=True)


def _adam_moments(state: TrainState):
    """(exp_avg, exp_avg_sq) trees; zeros before the first update."""
    return tuple(
        map_tree(lambda leaf, key=key: state.opt.state.get(leaf, {}).get(
            key, torch.zeros_like(leaf)).detach(), state.params)
        for key in ("exp_avg", "exp_avg_sq"))


def _restore(state: TrainState, params, exp_avg, exp_avg_sq,
             step: int, extras: Optional[dict] = None) -> None:
    """Load a saved train state into ``state`` in place (same leaves);
    ``extras``: the optimizer's (:meth:`Optimizer.extras`)."""
    state.opt.restore_extras(extras or {}, step)
    count = state.opt.count
    for leaf, p, m, v in zip(*(tree_leaves(t) for t in (
            state.params, params, exp_avg, exp_avg_sq)), strict=True):
        with torch.no_grad():
            leaf.copy_(p)
        if count > 0:
            state.opt.state[leaf] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": m.to(leaf.device).clone(),
                "exp_avg_sq": v.to(leaf.device).clone(),
            }
    state.step = step


def _make_tb_writer(directory: str):
    """A TensorBoard ``SummaryWriter`` from whichever backend is installed
    (``torch.utils.tensorboard``, then ``tensorboardX``), as JAX's
    ``_make_tb_writer`` (``epnn_tpu/train/loop.py:447-463``): the option
    was asked for, so with neither it raises ``RuntimeError``."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except Exception:
        try:
            from tensorboardX import SummaryWriter
        except Exception as e:
            raise RuntimeError(
                "tensorboard_dir is set but no SummaryWriter backend is "
                "available (tried torch.utils.tensorboard, tensorboardX): "
                f"{e}. Install one or drop --tensorboard; JSONL metrics "
                "(log_path) are always written.") from e
    return SummaryWriter(directory)


def train(
    mols: Sequence[Molecule],
    cfg: EPNNConfig,
    tc: TrainConfig,
    val_mols: Optional[Sequence[Molecule]] = None,
    mesh=None,
    progress: bool = True,
    device=None,
) -> TrainResult:
    """Train an EPNN on a molecule list.  Without ``val_mols``, an 80/20
    split with ``tc.split_seed`` is used (the reference's behavior).
    ``device``: ``None`` → the first CUDA card (raises without one).

    ``mesh``: a :class:`~torch.distributed.device_mesh.DeviceMesh` of
    :func:`epnn_tpu_torch.parallel.make_mesh`, every rank calling
    ``train`` alike; the run is then on :func:`~epnn_tpu_torch.parallel.
    sharding.mesh_device` (``device`` is not read).  JAX's mesh trainer:
    minibatches a multiple of the ``data`` axis, each ``data`` coordinate
    training its block of them, and fused buckets whose width the
    ``atoms`` axis (longer than 1) divides trained atom-sharded, with
    their row chunk from the per-rank rows
    (``bucket_chunk_sharded``).  The loss and the metrics are the global
    batch's and the gradients are summed over the mesh, so the
    parameters (checked alike on every rank at the start, ``shard_state``)
    and the EMA stay equal on every rank.  Only the world's rank 0 writes
    the checkpoints, the log and the TensorBoard scalars."""
    if mesh is not None:
        from torch.distributed.device_mesh import DeviceMesh

        if not isinstance(mesh, DeviceMesh):
            raise TypeError("train(mesh=...) takes a DeviceMesh (see "
                            "epnn_tpu_torch.parallel.make_mesh), got "
                            f"{type(mesh).__name__}")
    check_supported(tc)
    if tc.near_window and tc.near_row_chunk == 0:
        raise ValueError("TrainConfig.near_window requires near_row_chunk "
                         "(windowed gathers exist on the chunked path)")
    if tc.near_row_chunk > 0 and not tc.remat:
        raise ValueError(
            "TrainConfig.near_row_chunk requires remat=True: without the "
            "round and chunk checkpoints the backward keeps every chunk's "
            "activations at once, so the chunking saves no memory (the -1 "
            "auto policy forces remat for the huge buckets it chunks)")
    n_dev = n_atoms_axis = 1
    writes = True
    if mesh is None:
        device = resolve_device(device, "training")
    else:
        import torch.distributed as dist

        from epnn_tpu_torch.parallel.sharding import (ATOM_AXIS, DATA_AXIS,
                                                      axis_size, mesh_device)

        device = mesh_device(mesh)
        n_dev = axis_size(mesh, DATA_AXIS)
        n_atoms_axis = axis_size(mesh, ATOM_AXIS)
        writes = dist.get_rank() == 0

    if val_mols is None:
        if tc.val_fraction <= 0.0:
            train_mols, val_mols = list(mols), []
        else:
            tr_idx, va_idx = train_val_split(len(mols), tc.val_fraction,
                                             tc.split_seed)
            train_mols = [mols[i] for i in tr_idx]
            val_mols = [mols[i] for i in va_idx]
    else:
        train_mols = list(mols)
    has_val = len(val_mols) > 0
    if not has_val:
        warnings.warn(
            "empty validation set: val metrics will be null, no best "
            "checkpoint is selected, and early stopping never fires — "
            "pass val_mols or val_fraction > 0", stacklevel=2)

    table = table_for_n_elems(cfg.n_elems)
    train_buckets = bucket_molecules(train_mols, table, tc.bucket_multiple)
    val_buckets = bucket_molecules(val_mols, table, tc.bucket_multiple)
    huge = infer_mod.HUGE_GRAPH_MIN_ATOMS
    if tc.near_row_chunk == 0 and any(pad >= huge for pad in train_buckets):
        warnings.warn(
            f"huge-N training bucket (>= {huge} padded atoms) with "
            "TrainConfig.near_row_chunk=0 (explicitly off): the full-width "
            "near field keeps every round's (N, k, H) activations for the "
            "backward.  Use -1 (auto) or an explicit chunk (requires "
            "remat=True) and, with spatially sorted atoms, near_window "
            "(safe width from ops.fused.neighbor_window_width)",
            stacklevel=2)

    def bucket_chunk(pad: int) -> int:
        """The row chunk of a fused bucket (``TrainConfig.near_row_chunk``;
        -1: the Predictor's balanced chunk from ``HUGE_GRAPH_MIN_ATOMS``
        padded atoms, 0 where it would not split the bucket)."""
        if tc.near_row_chunk >= 0:
            return tc.near_row_chunk
        if pad < infer_mod.HUGE_GRAPH_MIN_ATOMS:
            return 0
        ch = balanced_row_chunk(pad, infer_mod.HUGE_GRAPH_ROW_CHUNK)
        return ch if 0 < ch < pad else 0

    def sharded(pad: int) -> bool:
        """Whether a fused bucket trains atom-sharded."""
        return n_atoms_axis > 1 and pad % n_atoms_axis == 0

    def bucket_chunk_sharded(pad: int) -> int:
        """The mesh twin of :func:`bucket_chunk` (JAX's): keyed on the
        global padded width, sized to the per-rank rows R."""
        r_dev = max(pad // n_atoms_axis, 1)
        if tc.near_row_chunk >= 0:
            return tc.near_row_chunk if tc.near_row_chunk < r_dev else 0
        if pad < infer_mod.HUGE_GRAPH_MIN_ATOMS:
            return 0
        ch = balanced_row_chunk(r_dev, infer_mod.HUGE_GRAPH_ROW_CHUNK)
        return ch if 0 < ch < r_dev else 0

    if tc.near_window > 0 and not any(
            bucket_chunk_sharded(pad) if sharded(pad) else bucket_chunk(pad)
            for pad in train_buckets):
        warnings.warn(
            "TrainConfig.near_window is set but no training bucket will "
            f"chunk (auto chunking engages at {huge} padded atoms; widest "
            f"bucket here: {max(train_buckets, default=0)}): the window "
            "has no effect; set near_row_chunk to chunk smaller buckets",
            stacklevel=2)

    init = ckpt_io.load_params(tc.init_from, cfg) if tc.init_from else None
    state = create_state(cfg, tc, tc.seed, device, params=init)
    start_epoch = 0
    best = best_padded = float("inf")
    stale_evals = 0
    lr_now, lr_stale = tc.learning_rate, 0
    if (tc.resume and tc.checkpoint_dir
            and ckpt_io.has_checkpoint(tc.checkpoint_dir)):
        meta = ckpt_io.load_meta(tc.checkpoint_dir)
        saved_accum = int(meta.get("grad_accum", 1))
        if saved_accum != tc.grad_accum:
            raise ValueError(
                f"resume with grad_accum={tc.grad_accum} but the checkpoint "
                f"was trained with grad_accum={saved_accum}; resume with "
                f"the same value (the accumulator is part of the optimizer "
                f"state)")
        _restore(state, *ckpt_io.load_train_state(tc.checkpoint_dir))
        start_epoch = int(meta.get("epoch", -1)) + 1
        best = float(meta.get("best_val_masked_mae", best))
        best_padded = float(meta.get("best_val_padded_mae", best_padded))
        stale_evals = int(meta.get("stale_evals", 0))
        # the scaled rate itself is in the optimizer's extras; these are
        # the host's mirrors (the rows' "lr" and the plateau counter)
        lr_now = float(meta.get("lr_now", lr_now))
        lr_stale = int(meta.get("lr_stale", 0))
    if mesh is not None:
        from epnn_tpu_torch.parallel.sharding import shard_state

        shard_state(state.params, mesh)

    # the weights' moving average, after every step call (JAX's ema_step);
    # it validates and is what best/ holds.  Resumes from <out>/ema
    ema = None
    if tc.ema_decay is not None:
        ema_dir = (os.path.join(tc.checkpoint_dir, "ema")
                   if tc.checkpoint_dir else None)
        src = (ckpt_io.load_params(ema_dir, cfg)
               if tc.resume and ema_dir and os.path.isdir(ema_dir)
               else state.params)
        ema = map_tree(lambda a: a.detach().to(device, torch.float32)
                       .clone(), src)
        decay = float(tc.ema_decay)

    def ema_step():
        with torch.no_grad():
            for e, p in zip(tree_leaves(ema), tree_leaves(state.params)):
                e.copy_(decay * e + (1.0 - decay) * p)

    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(device)

    def put(mb: MolBatch, n_real: int):
        weight = np.zeros(mb.batch_size, np.float32)
        weight[:n_real] = 1.0
        if tc.debug_nans:
            # JAX's jax_debug_nans stops at the first operation on a NaN
            # input; the port checks the inputs before the step reads them
            for name in ("x", "q0", "xyz", "y"):
                if not np.isfinite(getattr(mb, name)).all():
                    raise FloatingPointError(
                        f"debug_nans: non-finite {name} at step "
                        f"{state.step}")
        return tuple(tensor(a) for a in (mb.x, mb.q0, mb.xyz, mb.node_mask,
                                         mb.y, weight))

    # per-bucket plan, keyed by bucket object: train and val buckets can
    # share a padded width but hold different geometries
    fused_k: Dict[int, int] = {}
    uq0: Dict[int, bool] = {}
    nbr_tables: Dict[int, tuple] = {}

    def bucket_plan(pad: int, bucket: MolBatch):
        """(batch_size, neighbor_k or None) for one bucket; on a mesh the
        batch a multiple of the ``data`` axis, as JAX's."""
        bs = min(tc.batch_size, round_up(bucket.batch_size, n_dev))
        if n_dev > 1:
            bs = max(bs - bs % n_dev, n_dev)
        if pad <= tc.dense_max_atoms:
            return bs, None
        key = id(bucket)
        if key not in fused_k:
            k = max(max_neighbor_count(bucket.xyz[b], bucket.node_mask[b],
                                       cfg.cutoff)
                    for b in range(bucket.batch_size))
            fused_k[key] = max(min(round_up(k + 4, 8), pad - 1), 1)
        return bs, fused_k[key]

    def bucket_uq0(bucket: MolBatch) -> bool:
        """The round-1 collapse contract, checked once per bucket."""
        if not tc.collapse_round1:
            return False
        key = id(bucket)
        if key not in uq0:
            uq0[key] = uniform_q0_contract(bucket.x, bucket.q0,
                                           bucket.node_mask)
        return uq0[key]

    def bucket_neighbors(bucket: MolBatch, k: int, rows):
        """The minibatch's rows of the bucket's (B, N, k) idx/mask/d²
        tables, built once on the device (geometries never move): through
        the cell-list builder from ``CELL_GRID_MIN_ATOMS`` padded atoms (in
        the bucket's row chunks), else by top-k."""
        if not tc.precompute_neighbors:
            return None
        key = id(bucket)
        if key not in nbr_tables:
            xyz, mask = tensor(bucket.xyz), tensor(bucket.node_mask)
            if bucket.padded_atoms >= infer_mod.CELL_GRID_MIN_ATOMS:
                grid = batch_cell_grid(bucket.xyz, bucket.node_mask,
                                       cfg.cutoff)
                outs = [build_neighbors_cell(
                    xyz[b], mask[b], float(cfg.cutoff), int(k), *grid,
                    with_d2=True,
                    row_chunk=bucket_chunk(bucket.padded_atoms))
                    for b in range(bucket.batch_size)]
                nbr_tables[key] = tuple(torch.stack(parts)
                                        for parts in zip(*outs))
            else:
                nbr_tables[key] = build_neighbors_batch(
                    xyz, mask, float(cfg.cutoff), int(k))
        rows = torch.as_tensor(np.asarray(rows), device=device)
        return tuple(t[rows] for t in nbr_tables[key])

    def epoch_rng(epoch: int) -> np.random.Generator:
        # re-derived per epoch: a run resumed at epoch E draws the order an
        # uninterrupted run would have
        return np.random.default_rng([tc.seed, epoch])

    # the mesh's steps: the atom-sharded pair per (k, uniform_q0, chunk)
    # for the buckets the atoms axis divides (JAX's ``_sh_cache``), the
    # data-parallel ones for the rest
    sh_cache: Dict[tuple, tuple] = {}

    def sharded_steps(k: int, uq0: bool, nch: int):
        from epnn_tpu_torch.parallel.atom_shard import (
            make_sharded_eval_step,
            make_sharded_train_step,
        )

        if (k, uq0, nch) not in sh_cache:
            sh_cache[(k, uq0, nch)] = (
                make_sharded_train_step(
                    cfg, None, mesh, tc.loss, neighbor_k=k, uniform_q0=uq0,
                    far_cluster=tc.far_cluster,
                    far_cluster_grad=tc.far_cluster_grad,
                    remat=tc.remat or nch > 0, near_row_chunk=nch,
                    near_window=tc.near_window if nch else 0),
                make_sharded_eval_step(
                    cfg, mesh, tc.loss, neighbor_k=k, uniform_q0=uq0,
                    near_row_chunk=nch,
                    near_window=tc.near_window if nch else 0))
        return sh_cache[(k, uq0, nch)]

    def fused_kw(pad: int, bucket: MolBatch, train_kw: bool) -> dict:
        """The blocked step's keywords for a bucket (its huge-N chunk)."""
        nch = bucket_chunk(pad)
        kw = dict(uniform_q0=bucket_uq0(bucket), near_row_chunk=nch,
                  near_window=tc.near_window if nch else 0)
        if train_kw:
            kw.update(far_cluster=tc.far_cluster,
                      far_cluster_grad=tc.far_cluster_grad,
                      remat=tc.remat or nch > 0)
        return kw

    history: List[Dict[str, float]] = []
    log_f = open(tc.log_path, "a") if tc.log_path and writes else None
    tb = (_make_tb_writer(tc.tensorboard_dir)
          if tc.tensorboard_dir and writes else None)
    try:
        for epoch in range(start_epoch, tc.epochs):
            t0 = time.time()
            acc = MetricAccumulator()
            rng = epoch_rng(epoch)
            for pad, bucket in train_buckets.items():
                bs, k = bucket_plan(pad, bucket)
                for mb, n_real, rows in minibatches(bucket, bs, rng=rng,
                                                    with_indices=True):
                    args = put(mb, n_real)
                    nbrs = (None if k is None
                            else bucket_neighbors(bucket, k, rows))
                    if k is not None and mesh is not None and sharded(pad):
                        step = sharded_steps(k, bucket_uq0(bucket),
                                             bucket_chunk_sharded(pad))[0]
                        _, loss, _, mets = step(state, *args, neighbors=nbrs)
                    elif mesh is not None:
                        _, loss, _, mets = data_parallel_train_step(
                            state, cfg, tc.loss, None, mesh, *args,
                            neighbor_k=k, block=min(tc.fused_block, pad),
                            neighbors=nbrs,
                            **({} if k is None
                               else fused_kw(pad, bucket, True)))
                    elif k is None:
                        _, loss, _, mets = train_step(
                            state, cfg, tc.loss, None, *args)
                    else:
                        _, loss, _, mets = train_step_fused(
                            state, cfg, tc.loss, None,
                            min(tc.fused_block, pad), k, *args,
                            neighbors=nbrs, **fused_kw(pad, bucket, True))
                    acc.update(loss, mets)
                    if ema is not None:
                        ema_step()
            eval_params = state.params if ema is None else ema
            run_eval = has_val and (tc.eval_every <= 1
                                    or (epoch + 1) % tc.eval_every == 0
                                    or epoch == tc.epochs - 1)
            vacc = MetricAccumulator()
            for pad, bucket in (val_buckets.items() if run_eval else ()):
                bs, k = bucket_plan(pad, bucket)
                for mb, n_real, rows in minibatches(bucket, bs,
                                                    with_indices=True):
                    args = put(mb, n_real)
                    nbrs = (None if k is None
                            else bucket_neighbors(bucket, k, rows))
                    if k is not None and mesh is not None and sharded(pad):
                        step = sharded_steps(k, bucket_uq0(bucket),
                                             bucket_chunk_sharded(pad))[1]
                        loss, _, mets = step(eval_params, *args,
                                             neighbors=nbrs)
                    elif mesh is not None:
                        loss, _, mets = data_parallel_eval_step(
                            eval_params, cfg, tc.loss, mesh, *args,
                            neighbor_k=k, block=min(tc.fused_block, pad),
                            neighbors=nbrs,
                            **({} if k is None
                               else fused_kw(pad, bucket, False)))
                    elif k is None:
                        loss, _, mets = eval_step(
                            eval_params, cfg, tc.loss, *args)
                    else:
                        loss, _, mets = eval_step_fused(
                            eval_params, cfg, tc.loss,
                            min(tc.fused_block, pad), k, *args,
                            neighbors=nbrs, **fused_kw(pad, bucket, False))
                    vacc.update(loss, mets)

            row = {
                "epoch": epoch,
                "train_loss": acc.loss,
                "train_masked_mae": acc.masked_mae,
                "train_padded_mae": acc.padded_mae,
                "val_loss": vacc.loss if run_eval else None,
                "val_masked_mae": vacc.masked_mae if run_eval else None,
                "val_padded_mae": vacc.padded_mae if run_eval else None,
                "seconds": time.time() - t0,
            }
            if tc.lr_plateau_factor is not None:
                row["lr"] = lr_now
            history.append(row)
            if log_f:
                log_f.write(json.dumps(row) + "\n")
                log_f.flush()
            if tb is not None:
                for key, val in row.items():
                    if key != "epoch" and val is not None:
                        tb.add_scalar(key, val, epoch)
            if progress:
                vtxt = f"{vacc.masked_mae:.5f}" if run_eval else "—"
                print(f"epoch {epoch}: loss {acc.loss:.3e} train MAE "
                      f"{acc.masked_mae:.5f} val MAE {vtxt} "
                      f"({row['seconds']:.1f}s)", flush=True)

            improved = run_eval and vacc.masked_mae < best
            if improved:
                best, best_padded = vacc.masked_mae, vacc.padded_mae
            if run_eval:
                stale_evals = 0 if improved else stale_evals + 1
                if tc.lr_plateau_factor is not None:
                    lr_stale = 0 if improved else lr_stale + 1
                    if lr_stale >= tc.lr_plateau_patience:
                        state.opt.scale_lr(tc.lr_plateau_factor)
                        lr_now *= tc.lr_plateau_factor
                        lr_stale = 0
                        if progress:
                            print(f"plateau: LR -> {lr_now:.3e}", flush=True)
            if tc.checkpoint_dir and writes:
                ckpt_io.save_train_state(
                    tc.checkpoint_dir, state.params, *_adam_moments(state),
                    state.step,
                    meta={"epoch": epoch, "best_val_masked_mae": best,
                          "best_val_padded_mae": best_padded,
                          "stale_evals": stale_evals, "lr_now": lr_now,
                          "lr_stale": lr_stale, "step": state.step,
                          "grad_accum": tc.grad_accum},
                    extras=state.opt.extras())
                if ema is not None:
                    ckpt_io.save_params(
                        os.path.join(tc.checkpoint_dir, "ema"), ema, cfg)
                if improved:
                    ckpt_io.save_params(
                        os.path.join(tc.checkpoint_dir, "best"),
                        eval_params, cfg)
                    if tc.dump_predictions:
                        _dump_prediction_artifacts(
                            tc.checkpoint_dir, eval_params, cfg, device,
                            train_mols, val_mols)
            if (run_eval and tc.early_stop_patience is not None
                    and stale_evals >= tc.early_stop_patience):
                if progress:
                    print(f"early stop at epoch {epoch}: no val improvement "
                          f"in {stale_evals} evaluated epochs", flush=True)
                break
    finally:
        if log_f:
            log_f.close()
        if tb is not None:
            tb.close()
    return TrainResult(state=state, best_val_masked_mae=best,
                       best_val_padded_mae=best_padded, history=history)
