"""The collectives of the sharded forwards, over one axis of a mesh (its
process group): ``all_gather`` along dim 0, ``psum``, ``pmax`` and
``ppermute`` to the next rank of the ring — JAX's ``lax`` collectives
under SPMD, each with JAX's transpose as its VJP.

Gradients.  A value computed on every rank (the gathered state, the
charges) gets on each rank only the cotangent of that rank's own uses: a
*partial* cotangent, which the collectives' VJPs sum.  So

* ``all_gather``'s VJP is a reduce-scatter: the cotangents summed over
  the axis, this rank's block kept;
* ``psum``'s VJP is a ``psum`` (as ``jax.lax.psum`` transposes inside
  ``shard_map``);
* ``ppermute``'s VJP is the reverse ring: each cotangent goes back to
  the previous rank;
* ``pmax`` carries no gradient, and raises where autograd would need one.

A loss computed whole on every rank from the gathered charges hands each
rank the full cotangent instead: its caller back-propagates the loss
divided by the mesh's rank count, and sums the parameter gradients over
the mesh (:func:`mesh_sum_`; ``epnn_tpu_torch.train.loop``).

Backends.  NCCL carries every one of them on CUDA tensors, and gloo on
CPU tensors.  gloo on CUDA tensors carries the collectives of
:data:`GLOO_CUDA_NATIVE` (PyTorch's backend table documents
``all_reduce`` and ``broadcast``; ``all_gather`` and ``reduce_scatter``
were measured on the card, torch 2.11: ``chip_smoke.py``'s gloo probe
checks them every run) and refuses point-to-point sends; for it the ring
exchange is staged through the host: copied to the CPU, exchanged,
copied back.  That is a fixed rule of the group's backend and the
tensors' device (:func:`host_staged`), made before the call, never a
retry after an error.  The staging happens inside each collective's
forward and backward, out of autograd's sight: the autograd engine runs
CPU and CUDA nodes on different threads, and a copy it saw could reorder
one rank's backward collectives against another's.  The NCCL path never
stages.
(gloo on a CUDA card is the arrangement of two ranks sharing one card,
where NCCL refuses a second rank on the same GPU.)
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist

#: the collectives gloo carries on CUDA tensors
GLOO_CUDA_NATIVE = ("all_reduce", "broadcast", "all_gather",
                    "reduce_scatter")


def host_staged(op: str, group, device: torch.device) -> bool:
    """Whether collective ``op`` on ``group`` stages CUDA tensors through
    the host: gloo on a CUDA device, for an op outside
    :data:`GLOO_CUDA_NATIVE`."""
    return (device.type == "cuda" and op not in GLOO_CUDA_NATIVE
            and dist.get_backend(group) == "gloo")


def size(group) -> int:
    return dist.get_world_size(group)


def index(group) -> int:
    """This rank's position along the axis of ``group``."""
    return dist.get_rank(group)


def _gather(t: torch.Tensor, group) -> torch.Tensor:
    src = t.contiguous()
    if host_staged("all_gather", group, t.device):
        src = src.cpu()
    outs = [torch.empty_like(src) for _ in range(size(group))]
    dist.all_gather(outs, src, group=group)
    return torch.cat(outs).to(t.device)


def _reduce_scatter(t: torch.Tensor, group) -> torch.Tensor:
    """Σ over the axis of ``t`` (D·R rows on every rank), this rank's R
    rows of it."""
    r = t.shape[0] // size(group)
    src = t.contiguous()
    if host_staged("reduce_scatter", group, t.device):
        src = src.cpu()
    out = src.new_empty((r,) + tuple(src.shape[1:]))
    dist.reduce_scatter(out, list(src.split(r)), group=group)
    return out.to(t.device)


def _all_reduce(t: torch.Tensor, group, op) -> torch.Tensor:
    out = t.clone().contiguous()
    if size(group) > 1:
        dist.all_reduce(out, op=op, group=group)
    return out


def _exchange(srcs: Sequence[torch.Tensor], group, shift: int):
    """Each tensor of ``srcs`` to the rank ``shift`` places on along the
    axis, and those of the rank ``shift`` places back received, in one
    ``batch_isend_irecv`` (sends and receives posted together, so no
    order of them can deadlock)."""
    d = size(group)
    ranks = dist.get_process_group_ranks(group)
    me = index(group)
    to, frm = ranks[(me + shift) % d], ranks[(me - shift) % d]
    device = srcs[0].device
    stage = host_staged("ppermute", group, device)
    srcs = [t.contiguous().cpu() if stage else t.contiguous() for t in srcs]
    recvs = [torch.empty_like(s) for s in srcs]
    ops = ([dist.P2POp(dist.isend, s, to, group) for s in srcs]
           + [dist.P2POp(dist.irecv, r, frm, group) for r in recvs])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return tuple(r.to(device) for r in recvs)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _gather(t, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group), None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_reduce(t, group, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group, dist.ReduceOp.SUM), None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *ts):
        ctx.group = group
        return _exchange(ts, group, 1)

    @staticmethod
    def backward(ctx, *gs):
        # every rank records the same graph, so ``needs_input_grad`` is
        # the same on every rank and the exchanges pair up
        need = ctx.needs_input_grad[1:]
        back = iter(_exchange([g for g, n in zip(gs, need) if n],
                              ctx.group, -1) if any(need) else ())
        return (None,) + tuple(next(back) if n else None for n in need)


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0 in axis order (JAX's
    ``all_gather(..., tiled=True)``); every rank's ``t`` has one shape.
    Its VJP is the reduce-scatter."""
    if size(group) == 1:
        return t
    return _AllGather.apply(t, group)


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """Σ over the axis of ``t`` (a new tensor); its VJP is a ``psum``."""
    return _Psum.apply(t, group)


def pmax(t: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max over the axis of ``t`` (a new tensor), which
    carries no gradient: a ``t`` that autograd records raises."""
    if torch.is_grad_enabled() and t.requires_grad:
        raise RuntimeError("pmax carries no gradient; pass a tensor that "
                           "does not require one")
    return _all_reduce(t, group, dist.ReduceOp.MAX)


def ppermute(ts: Sequence[torch.Tensor], group) -> Tuple[torch.Tensor, ...]:
    """The ring step of JAX's ``ppermute(perm=[(i, i + 1 mod D)])``: each
    tensor of ``ts`` goes to the next rank of the axis, and the previous
    rank's come back.  Its VJP sends the cotangents the reverse way."""
    if size(group) == 1:
        return tuple(ts)
    return _Ppermute.apply(group, *ts)


def mesh_sum_(tensors: Sequence[torch.Tensor], mesh) -> None:
    """Each of ``tensors`` replaced in place by its sum over every rank of
    ``mesh`` (the parameter gradients of a sharded step): one flat
    ``all_reduce`` over each mesh axis in turn, so every rank ends with
    the same bits."""
    if mesh.size() == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    for axis in mesh.mesh_dim_names:
        flat = _all_reduce(flat, mesh.get_group(axis), dist.ReduceOp.SUM)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()
