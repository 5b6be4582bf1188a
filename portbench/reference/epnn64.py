"""The plain reference: the dense EPNN in float64, in blocks of rows.

It follows the model's equations (the reference repository's
``charge_gn.py``, as ``epnn_tpu_torch.models.epnn.EPNN`` writes them)
and imports nothing of the port:

* edge features e_ij = C(d_ij) · exp(−η (d_ij − μ_k)²), μ = linspace(0.1,
  cutoff, E), C the cosine envelope (0 from the cutoff on), zero on the
  diagonal and on pairs with a padding atom;
* T message rounds: m_ij = MLP_t([a_i, a_j, e_ij]) with a = [x, h, q0],
  times the pair mask where ``mask_messages``; h ← update([h, Σ_j m_ij])
  on real atoms;
* T pass rounds: q_i ← q_i + Σ_j ½ (f_ij − f_ji) · gate_ij · pair mask,
  f = MLP_pass_t([a_i, a_j, e_ij]) with a = [x, h, q], the gate 1 where
  some channel of e_ij exceeds ``is_near_tol``.

Each MLP's first layer is applied as a_i W_i + a_j W_j + e_ij W_e (the
same product, split by the blocks of its input), and a message round's
last layer after the sum over j; every pair of every graph is visited,
in float64, on whatever device the inputs are put.  The pass rounds visit
the pairs whose gate is not zero (the others add exactly 0).

:class:`Graph` keeps what the message rounds made, so that the pass
rounds can run again with some gates set the other way
(``portbench.compare`` resolves gates that float32 cannot decide).

A rounding (a function of a float64 tensor) may be applied to both
operands of every message round's middle products, the products the
far-field kernel makes on the tensor cores (``mid_round``):
``to_bfloat16`` gives the control of a cell whose far field runs one TF32
pass (``portbench.compare``, ``portbench.control``).  It rounds the near
pairs' middle products too, a few slots an atom against every atom."""

from __future__ import annotations

import math
from typing import Optional

import torch

F64 = torch.float64
MU_START = 0.1
#: elements of one (rows, N, H) block of the message rounds
BLOCK_ELEMS = 1 << 27


def to_bfloat16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 (to nearest even), kept in float64."""
    return t.to(torch.bfloat16).to(F64)


def _layers(tree: dict, device):
    """[(W (in, out), b (out,)), ...] in float64, ``dense_0`` first."""
    return [(torch.as_tensor(tree[f"dense_{i}"]["kernel"]).to(device, F64),
             torch.as_tensor(tree[f"dense_{i}"]["bias"]).to(device, F64))
            for i in range(len(tree))]


def _mlp(layers, v):
    for w, b in layers[:-1]:
        v = torch.relu(v @ w + b)
    w, b = layers[-1]
    return v @ w + b


class Graph:
    """One graph: ``x`` (N, F), ``q0`` (N,), ``xyz`` (N, 3), ``mask`` (N,)
    (float32 or float64 arrays or tensors; the coordinates are taken as
    given and widened to float64)."""

    def __init__(self, params: dict, model: dict, x, q0, xyz, mask,
                 device="cpu", mid_round=None):
        self.model, self.device = model, torch.device(device)
        p = params["params"] if "params" in params else params
        t_rounds = model["T"]
        self.msg = [_layers(p[f"message_{t}"], self.device)
                    for t in range(t_rounds)]
        self.pas = [_layers(p[f"pass_{t}"], self.device)
                    for t in range(t_rounds)]
        self.upd = _layers(p["update"], self.device)
        dev = self.device
        self.x = torch.as_tensor(x).to(dev, F64)
        self.q0 = torch.as_tensor(q0).to(dev, F64)
        self.xyz = torch.as_tensor(xyz).to(dev, F64)
        self.mask = torch.as_tensor(mask).to(dev, F64)
        self.n = self.x.shape[0]
        self.mu = torch.linspace(MU_START, model["cutoff"], model["e_dim"],
                                 dtype=F64, device=dev)
        self._pairs()
        self.h = self._message_rounds(mid_round)

    # -- pairs within the cutoff -------------------------------------------
    def _pairs(self):
        """The ordered pairs with C > 0 (d < cutoff, i ≠ j, both real):
        ``pi, pj`` (P,), their features ``e`` (P, E), the gate (P,) and
        its margin |max_k e / tol − 1|."""
        cut, n = self.model["cutoff"], self.n
        real = self.mask > 0
        rows = max(1, (1 << 24) // max(n, 1))
        ii, jj, dd = [], [], []
        cols = torch.arange(n, device=self.device)
        for s in range(0, n, rows):
            d = torch.cdist(self.xyz[s:s + rows], self.xyz,
                            compute_mode="donot_use_mm_for_euclid_dist")
            r = s + torch.arange(d.shape[0], device=self.device)
            hit = ((d < cut) & (r[:, None] != cols[None, :])
                   & real[s:s + rows, None] & real[None, :])
            a, b = hit.nonzero(as_tuple=True)
            ii.append(s + a)
            jj.append(b)
            dd.append(d[a, b])
        self.pi, self.pj = torch.cat(ii), torch.cat(jj)
        d = torch.cat(dd)
        c = (torch.cos(math.pi * d / cut) + 1.0) / 2.0
        c = torch.where(d <= 0.0, torch.ones_like(c), c)
        self.e = c[:, None] * torch.exp(
            -self.model["eta"] * (d[:, None] - self.mu[None, :]) ** 2)
        tol = self.model["is_near_tol"]
        top = self.e.amax(-1)
        self.gate = (top > tol).to(F64)
        self.margin = (top / tol - 1.0).abs()

    # -- message rounds -----------------------------------------------------
    def _atoms(self, h, q):
        return torch.cat([self.x, h, q[:, None]], dim=-1)

    def _message_rounds(self, mid_round=None) -> torch.Tensor:
        """(N, H) hidden state after the T message rounds, with
        ``mid_round`` applied to the middle products' operands."""
        model, n, dev = self.model, self.n, self.device
        fa = self.x.shape[1] + model["h_dim"] + 1
        jw = (self.mask if model["mask_messages"]
              else torch.ones(n, dtype=F64, device=dev))
        h = torch.zeros((n, model["h_dim"]), dtype=F64, device=dev)
        nm = self.mask[:, None]
        for layers in self.msg:
            (w1, b1), *rest = layers
            a = self._atoms(h, self.q0)
            w_i, w_j, w_e = w1[:fa], w1[fa:2 * fa], w1[2 * fa:]
            u = a @ w_i + b1                      # (N, H)
            v = a @ w_j
            ew = self.e @ w_e                     # (P, H)
            hid = u.shape[1]
            rows = max(1, BLOCK_ELEMS // max(n * hid, 1))
            mids, (w_out, b_out) = rest[:-1], rest[-1]
            sums = []
            for s in range(0, n, rows):
                r = min(rows, n - s)
                pre = u[s:s + r, None, :] + v[None, :, :]      # (r, N, H)
                sel = (self.pi >= s) & (self.pi < s + r)
                pre.index_put_((self.pi[sel] - s, self.pj[sel]), ew[sel],
                               accumulate=True)
                z = torch.relu_(pre)
                for w, b in mids:
                    if mid_round is not None:
                        z, w = mid_round(z), mid_round(w)
                    z = torch.relu_(torch.addmm(
                        b, z.reshape(-1, w.shape[0]), w).reshape(r, n, -1))
                wj = jw[None, :] * (self.mask[s:s + r, None]
                                    if model["mask_messages"] else 1.0)
                sums.append(torch.einsum("rnh,rn->rh", z, wj))
                del pre, z
            zsum = torch.cat(sums)                 # Σ_j w_ij z_ij
            count = (self.mask * jw.sum() if model["mask_messages"]
                     else torch.full((n,), float(n), dtype=F64, device=dev))
            agg = zsum @ w_out + count[:, None] * b_out
            h = _mlp(self.upd, torch.cat([h, agg], dim=-1) * nm) * nm
        return h

    # -- pass rounds --------------------------------------------------------
    def charges(self, gate: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(N,) float64 charges, with ``gate`` (P,) in place of the pairs'
        own where given (it has to hold the same value on (i, j) and
        (j, i))."""
        gate = self.gate if gate is None else gate
        live = gate != 0
        pi, pj, e, g = self.pi[live], self.pj[live], self.e[live], gate[live]
        fa = self.x.shape[1] + self.model["h_dim"] + 1
        q = self.q0.clone()
        for layers in self.pas:
            (w1, b1), *rest = layers
            a = self._atoms(self.h, q)
            u = a @ w1[:fa]
            v = a @ w1[fa:2 * fa]
            ew = e @ w1[2 * fa:] + b1

            def f(x_in):
                z = torch.relu(x_in)
                for w, b in rest[:-1]:
                    z = torch.relu(z @ w + b)
                return (z @ rest[-1][0] + rest[-1][1])[:, 0]

            f_ij = f(u[pi] + v[pj] + ew)
            f_ji = f(u[pj] + v[pi] + ew)
            t = 0.5 * (f_ij - f_ji) * g
            q = q + torch.zeros_like(q).index_add_(0, pi, t)
        return q

    def flip_partner(self) -> torch.Tensor:
        """(P,) the index of each pair's reverse (j, i)."""
        key = self.pi * self.n + self.pj
        rkey = self.pj * self.n + self.pi
        order = torch.argsort(key)
        return order[torch.searchsorted(key[order], rkey)]
