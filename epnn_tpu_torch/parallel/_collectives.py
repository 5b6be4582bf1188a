"""The collectives of the sharded forwards, over one axis of a mesh (its
process group): ``all_gather`` along dim 0, ``psum``, ``pmax`` and
``ppermute`` to the next rank of the ring — JAX's ``lax`` collectives
under SPMD.  Forward only: autograd does not see them.

Backends.  NCCL carries every one of them on CUDA tensors, and gloo on
CPU tensors.  gloo on CUDA tensors carries the collectives of
:data:`GLOO_CUDA_NATIVE` (PyTorch's backend table documents
``all_reduce`` and ``broadcast``; ``all_gather`` was measured on the
card, torch 2.11: ``chip_smoke.py``'s gloo probe checks all three every
run) and refuses point-to-point sends; for it the ring exchange is
staged through the host: copied to the CPU, exchanged, copied back.
That is a fixed rule of the group's backend and the tensors' device
(:func:`host_staged`), made before the call, never a retry after an
error.  The NCCL path never stages.  (gloo on a CUDA card is the
arrangement of two ranks sharing one card, where NCCL refuses a second
rank on the same GPU.)
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist

#: the collectives gloo carries on CUDA tensors
GLOO_CUDA_NATIVE = ("all_reduce", "broadcast", "all_gather")


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


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0 in axis order (JAX's
    ``all_gather(..., tiled=True)``); every rank's ``t`` has one shape."""
    if size(group) == 1:
        return t
    src = t.contiguous()
    if host_staged("all_gather", group, t.device):
        src = src.cpu()
    outs = [torch.empty_like(src) for _ in range(size(group))]
    dist.all_gather(outs, src, group=group)
    return torch.cat(outs).to(t.device)


def _all_reduce(t: torch.Tensor, group, op) -> torch.Tensor:
    out = t.clone().contiguous()
    if size(group) > 1:
        dist.all_reduce(out, op=op, group=group)
    return out


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """Σ over the axis of ``t`` (a new tensor)."""
    return _all_reduce(t, group, dist.ReduceOp.SUM)


def pmax(t: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max over the axis of ``t`` (a new tensor)."""
    return _all_reduce(t, group, dist.ReduceOp.MAX)


def ppermute(ts: Sequence[torch.Tensor], group) -> Tuple[torch.Tensor, ...]:
    """The ring step of JAX's ``ppermute(perm=[(i, i + 1 mod D)])``: each
    tensor of ``ts`` goes to the next rank of the axis, and the previous
    rank's come back, all in one ``batch_isend_irecv`` (sends and
    receives posted together, so no order of them can deadlock)."""
    d = size(group)
    if d == 1:
        return tuple(ts)
    ranks = dist.get_process_group_ranks(group)
    me = index(group)
    nxt, prv = ranks[(me + 1) % d], ranks[(me - 1) % d]
    device = ts[0].device
    stage = host_staged("ppermute", group, device)
    srcs = [t.contiguous().cpu() if stage else t.contiguous() for t in ts]
    recvs = [torch.empty_like(s) for s in srcs]
    ops = ([dist.P2POp(dist.isend, s, nxt, group) for s in srcs]
           + [dist.P2POp(dist.irecv, r, prv, group) for r in recvs])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return tuple(r.to(device) for r in recvs)
