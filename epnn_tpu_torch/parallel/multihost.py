"""Multi-host meshes (counterpart of ``epnn_tpu/parallel/multihost.py``).

One process per device, on one host or many: :func:`initialize_distributed`
joins the ``torch.distributed`` world (from its arguments, else the
``EPNN_*`` variables, else torchrun's), and :func:`make_multihost_mesh`
lays the two mesh axes onto the fabric so that

* ``atoms`` never crosses a host: its per-round collectives (the
  all-gather of updated rows, the ring's block circulation) stay on the
  host's NVLink;
* only ``data`` spans hosts: a data-parallel gradient sum is one small
  all-reduce a step (≤ 75K parameters), the one collective that tolerates
  the network's latency.

Run the same program on every host, for example::

    torchrun --nnodes 2 --nproc-per-node 4 --rdzv-endpoint host0:29500 \\
        -m epnn_tpu_torch infer ... --atom-shard 4

The layout logic (:func:`multihost_layout`) is a pure function of the
ranks' hosts, tested on fake rank lists; one host runs it through
:func:`make_mesh`.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from epnn_tpu_torch.parallel.sharding import (
    _device_type,
    _mesh_of,
    make_mesh,
)

__all__ = [
    "initialize_distributed",
    "is_coordinator",
    "make_multihost_mesh",
]


def _env_int(*names) -> Optional[int]:
    for name in names:
        v = os.environ.get(name)
        if v:
            return int(v)
    return None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    initialization_timeout: Optional[int] = None,
    *,
    device_type: Optional[str] = None,
    backend: Optional[str] = None,
) -> None:
    """Start (or join) the ``torch.distributed`` world.

    Any argument left ``None`` falls back to ``EPNN_COORDINATOR`` /
    ``EPNN_NUM_PROCESSES`` / ``EPNN_PROCESS_ID`` (the JAX package's
    names), then to torchrun's ``MASTER_ADDR:MASTER_PORT`` /
    ``WORLD_SIZE`` / ``RANK``; with none of them, a world of this one
    process on a free local port.  ``coordinator_address`` is
    ``host:port`` (rank 0's TCP store).  ``local_device_ids``: the card
    this process drives, its first entry (default ``LOCAL_RANK``).
    ``initialization_timeout``: seconds to wait for every rank.
    ``device_type``: ``"cuda"`` (default; raises without a card) or
    ``"cpu"``; ``backend``: NCCL on the card and gloo on the CPU unless
    given (gloo with CUDA tensors stages what it cannot carry through the
    host, :mod:`~epnn_tpu_torch.parallel._collectives`).  Idempotent: a
    second call in an initialized process does nothing."""
    if dist.is_initialized():
        return
    device_type = _device_type(device_type)
    if coordinator_address is None:
        coordinator_address = os.environ.get("EPNN_COORDINATOR") or None
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("EPNN_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("EPNN_PROCESS_ID", "RANK")
    if num_processes is None:
        num_processes = 1
    if process_id is None:
        process_id = 0
    if coordinator_address is None:
        if num_processes != 1:
            raise ValueError(
                f"{num_processes} processes need a coordinator address "
                "(coordinator_address=, EPNN_COORDINATOR, or torchrun's "
                "MASTER_ADDR/MASTER_PORT)")
        coordinator_address = f"localhost:{_free_port()}"
    if device_type == "cuda":
        local = (local_device_ids[0] if local_device_ids
                 else _env_int("LOCAL_RANK") or 0)
        os.environ.setdefault("LOCAL_RANK", str(local))
        torch.cuda.set_device(local)
    kw = {}
    if initialization_timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=initialization_timeout)
    dist.init_process_group(
        backend or ("nccl" if device_type == "cuda" else "gloo"),
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id), **kw)


def is_coordinator() -> bool:
    """True on the process that owns checkpoint writes and logging: rank 0
    (and a process that has joined no world)."""
    return not dist.is_initialized() or dist.get_rank() == 0


class RankDevice(NamedTuple):
    """A rank of the world and the host it runs on."""

    rank: int
    host: str


def world_devices() -> list:
    """Every rank of the initialized world with its host name, in rank
    order (one all-gather of the names)."""
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    return [RankDevice(r, h) for r, h in enumerate(names)]


def _num_hosts(devices) -> int:
    return len({d.host for d in devices})


def multihost_layout(n_data: Optional[int], n_atoms: int,
                     devices: Sequence[RankDevice]) -> np.ndarray:
    """The (n_data, n_atoms) rank array of a multi-host mesh: ranks grouped
    by host (hosts in order of their first rank), every ``atoms`` row
    inside one host, the data axis running over the rows of every host.
    ``n_atoms`` must divide the ranks of a host; ``n_data`` defaults to
    every row and must equal it (the data axis carries all the cross-host
    parallelism)."""
    devices = list(devices)
    hosts = list(dict.fromkeys(d.host for d in devices))
    per_host = len(devices) // len(hosts)
    by_host = {h: [d.rank for d in devices if d.host == h] for h in hosts}
    if any(len(r) != per_host for r in by_host.values()):
        raise ValueError(
            f"uneven hosts: {len(devices)} ranks over {len(hosts)} hosts "
            f"({[len(r) for r in by_host.values()]})")
    if n_atoms > per_host or per_host % n_atoms:
        raise ValueError(
            f"atoms axis ({n_atoms}) must evenly divide one host "
            f"({per_host} ranks/host): the per-round atom collectives "
            "(all-gather / ring permute) must not cross the network")
    local_data = per_host // n_atoms
    if n_data is None:
        n_data = local_data * len(hosts)
    if n_data != local_data * len(hosts):
        raise ValueError(
            f"n_data={n_data} must equal (ranks/host ÷ n_atoms) × hosts = "
            f"{local_data} × {len(hosts)} = {local_data * len(hosts)} (the "
            "data axis carries all cross-host parallelism; shrink n_atoms "
            "or pass devices= to use a subset)")
    ranks = [r for h in hosts for r in sorted(by_host[h])]
    return np.asarray(ranks).reshape(n_data, n_atoms)


def make_multihost_mesh(
    n_data: Optional[int] = None,
    n_atoms: int = 1,
    devices: Optional[Sequence[RankDevice]] = None,
    device_type: Optional[str] = None,
):
    """The global (data, atoms) mesh across every process of the world.
    On one host it is :func:`make_mesh` over the world's ranks; across
    hosts, :func:`multihost_layout` keeps every ``atoms`` row inside one
    host.  ``devices``: :class:`RankDevice` entries (default: the world's,
    :func:`world_devices`)."""
    device_type = _device_type(device_type)
    if not dist.is_initialized():
        initialize_distributed(device_type=device_type)
    devices = list(devices if devices is not None else world_devices())
    if _num_hosts(devices) == 1:
        return make_mesh(n_data, n_atoms, [d.rank for d in devices],
                         device_type=device_type)
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    return _mesh_of(multihost_layout(n_data, n_atoms, devices), device_type)
