"""Electron-Passing Neural Network, dense form (counterpart of
``epnn_tpu/models/epnn.py``).

* ``T`` rounds of dense all-pairs message passing with untied per-round
  message MLPs and one shared update MLP;
* ``T`` rounds of antisymmetric pairwise electron passing: the round-t pass
  MLP is evaluated on both pair orderings and the transfer matrix is
  ``0.5 * (f_ij - f_ji) * pair_mask * gate`` — exactly antisymmetric, so
  the total predicted charge equals the net molecular charge.

This module materializes the (B, N, N, 2F+E) pair tensor; it is the
readable reference and the small-graph serving path.  Big graphs go
through :func:`epnn_tpu_torch.ops.fused.forward_blocked`.

Parameters live in a nested dict with the JAX tree's names and shapes
(``{"message_t"|"update"|"pass_t": {"dense_k": {"kernel": (in, out),
"bias": (out,)}}}``); :meth:`EPNN.from_params` builds a module from one.
Training differentiates the tree's own leaves through :func:`dense_apply`
(the module's forward with the tree substituted for its weights), so the
dense and the blocked path update the same tensors.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch import nn

from epnn_tpu_torch.models.config import EPNNConfig
from epnn_tpu_torch.models.mlp import MLP


def _dtype(cfg: EPNNConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def pair_gate(e: torch.Tensor, tol: float) -> torch.Tensor:
    """Is-near gate: a pair passes charge iff any RBF channel exceeds
    ``tol`` (within the cutoff, not a padded/diagonal pair)."""
    largest = torch.amax(torch.clamp(e, tol, 1e5), dim=-1)
    return (largest != tol).to(e.dtype)


class EPNN(nn.Module):
    """The full model: node embedding rounds + electron passing rounds.

    Call signature (all batched, N = padded atoms):
      x:         (B, N, n_elems) per-atom [Z, onehot] features
      q0:        (B, N) initial per-atom charges (Q / natoms on real atoms)
      e:         (B, N, N, e_dim) RBF edge features (0 for padded pairs)
      node_mask: (B, N) 1.0 on real atoms
      soft_env:  optional (B, N, N) cosine envelope for pass_weighting =
                 'soft_envelope'
      h0:        optional (B, N, h_dim) initial hidden state (default zeros)

    Returns per-atom charges (B, N), in the compute type: under
    ``compute_dtype="bfloat16"`` every input, activation and layer runs in
    bfloat16 (flax's ``dtype=bf16``, the JAX model's ``_dtype``) and the
    charges come back in bfloat16, as the JAX model's do; the parameters
    stay float32.  Every product is float32 (or bf16) whatever the
    precision fields say: the plain products of the port run at full
    precision.
    """

    def __init__(self, cfg: EPNNConfig):
        super().__init__()
        if cfg.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype={cfg.compute_dtype!r}: "
                             "'float32' or 'bfloat16'")
        self.cfg = cfg
        dt = _dtype(cfg)
        f = cfg.pair_feat_dim
        self.message_mlps = nn.ModuleList(
            MLP(f, cfg.mlp_hidden, cfg.msg_dim, dt) for _ in range(cfg.T))
        self.update_mlp = MLP(cfg.h_dim + cfg.msg_dim, cfg.mlp_hidden,
                              cfg.h_dim, dt)
        self.pass_mlps = nn.ModuleList(
            MLP(f, cfg.mlp_hidden, 1, dt) for _ in range(cfg.T))

    @classmethod
    def from_params(cls, cfg: EPNNConfig, params: dict,
                    device=None) -> "EPNN":
        model = cls(cfg)
        for t in range(cfg.T):
            model.message_mlps[t].load_tree(params[f"message_{t}"])
            model.pass_mlps[t].load_tree(params[f"pass_{t}"])
        model.update_mlp.load_tree(params["update"])
        return model.to(device).eval()

    def forward(
        self,
        x: torch.Tensor,
        q0: torch.Tensor,
        e: torch.Tensor,
        node_mask: torch.Tensor,
        soft_env: Optional[torch.Tensor] = None,
        h0: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        cfg = self.cfg
        dt = _dtype(cfg)
        x, e, node_mask, q = x.to(dt), e.to(dt), node_mask.to(dt), q0.to(dt)
        b, n = x.shape[0], x.shape[1]
        h = (x.new_zeros((b, n, cfg.h_dim)) if h0 is None else h0.to(dt))
        pair_mask = node_mask[:, :, None] * node_mask[:, None, :]

        nm = node_mask[..., None]
        for t in range(cfg.T):
            a_i, a_j = self._atom_pairs(x, h, q)
            msgs = self.message_mlps[t](torch.cat([a_i, a_j, e], dim=-1))
            if cfg.mask_messages:
                msgs = msgs * pair_mask[..., None]
            agg = torch.sum(msgs, dim=2)
            upd_in = torch.cat([h, agg], dim=-1) * nm
            h = self.update_mlp(upd_in) * nm

        if cfg.pass_weighting == "soft_envelope":
            if soft_env is None:
                raise ValueError("pass_weighting='soft_envelope' needs soft_env")
            gate = soft_env.to(dt)
        else:
            gate = pair_gate(e, cfg.is_near_tol)
        weight = gate * pair_mask

        for t in range(cfg.T):
            a_i, a_j = self._atom_pairs(x, h, q)
            f_ij = self.pass_mlps[t](torch.cat([a_i, a_j, e], -1))[..., 0]
            f_ji = self.pass_mlps[t](torch.cat([a_j, a_i, e], -1))[..., 0]
            transfer = 0.5 * (f_ij - f_ji) * weight
            q = q + torch.sum(transfer, dim=2)
        return q

    @staticmethod
    def _atom_pairs(x, h, q):
        """(a_i, a_j), each (B, N, N, F') views of a = [x, h, q]."""
        a = torch.cat([x, h, q[..., None]], dim=-1)
        b, n, f = a.shape
        return (a[:, :, None, :].expand(b, n, n, f),
                a[:, None, :, :].expand(b, n, n, f))


def map_tree(fn, tree: dict) -> dict:
    """The nested dict with ``fn`` applied to every leaf."""
    return {k: map_tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def tree_leaves(tree: dict) -> list:
    """Every leaf, in sorted key order (the same order for any two trees
    of one layout)."""
    return [leaf for k in sorted(tree) for leaf in (
        tree_leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]


def count_params(params) -> int:
    """The number of scalars in a parameter tree (a nested dict of
    tensors or arrays, with or without the ``"params"`` level)."""
    return sum(math.prod(leaf.shape) for leaf in tree_leaves(params))


@functools.lru_cache(maxsize=8)
def _skeleton(cfg: EPNNConfig) -> EPNN:
    """An EPNN whose own weights are never read: :func:`dense_apply`
    substitutes the tree for all of them."""
    return EPNN(cfg)


def _module_weights(params: dict, cfg: EPNNConfig) -> dict:
    """The tree as the module's parameter names: ``weight = kernel.T``
    (a view, so gradients reach the tree's leaves)."""
    p = params["params"] if "params" in params else params
    names = {f"message_{t}": f"message_mlps.{t}" for t in range(cfg.T)}
    names.update({f"pass_{t}": f"pass_mlps.{t}" for t in range(cfg.T)})
    names["update"] = "update_mlp"
    out = {}
    for tree_name, mod_name in names.items():
        for dname, leaf in p[tree_name].items():
            out[f"{mod_name}.{dname}.weight"] = leaf["kernel"].T
            out[f"{mod_name}.{dname}.bias"] = leaf["bias"]
    return out


def dense_apply(params: dict, cfg: EPNNConfig, x, q0, e, node_mask,
                soft_env=None, h0=None) -> torch.Tensor:
    """The dense EPNN forward as a function of the parameter tree
    (counterpart of ``EPNN(cfg).apply(params, ...)``): differentiable in
    the tree's leaves, on whatever device they and the inputs share."""
    return torch.func.functional_call(
        _skeleton(cfg), _module_weights(params, cfg),
        (x, q0, e, node_mask), dict(soft_env=soft_env, h0=h0))


def _mlp_shapes(in_dim, hidden, out_dim):
    widths = [in_dim, *hidden, out_dim]
    return [(widths[i], widths[i + 1]) for i in range(len(widths) - 1)]


def param_shapes(cfg: EPNNConfig) -> dict:
    """The parameter tree's kernel shapes, ``{mlp: {dense_k: (in, out)}}``."""
    f = cfg.pair_feat_dim
    tree = {}
    for t in range(cfg.T):
        tree[f"message_{t}"] = _mlp_shapes(f, cfg.mlp_hidden, cfg.msg_dim)
    tree["update"] = _mlp_shapes(cfg.h_dim + cfg.msg_dim, cfg.mlp_hidden,
                                 cfg.h_dim)
    for t in range(cfg.T):
        tree[f"pass_{t}"] = _mlp_shapes(f, cfg.mlp_hidden, 1)
    return {name: {f"dense_{k}": s for k, s in enumerate(shapes)}
            for name, shapes in tree.items()}


def init_params(cfg: EPNNConfig, generator: torch.Generator) -> dict:
    """Glorot-uniform kernels and zero biases, in the JAX tree's layout
    (the two packages draw different numbers from the same seed)."""
    params = {}
    for name, layers in param_shapes(cfg).items():
        params[name] = {}
        for dname, (fan_in, fan_out) in layers.items():
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            kernel = (torch.rand((fan_in, fan_out), generator=generator)
                      * 2.0 - 1.0) * limit
            params[name][dname] = {"kernel": kernel,
                                   "bias": torch.zeros(fan_out)}
    return params
