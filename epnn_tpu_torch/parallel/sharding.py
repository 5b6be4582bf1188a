"""Device meshes over ``torch.distributed`` (counterpart of
``epnn_tpu/parallel/sharding.py``).

The JAX package runs one controller that drives every device through
``shard_map``; the port runs SPMD, PyTorch's own idiom: one process per
device, all running the same program, each computing its share and
exchanging it through collectives (:mod:`epnn_tpu_torch.parallel._collectives`).
A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` of the
initialized world with JAX's two axes:

  * ``data`` — the molecule batch axis: each coordinate along it takes
    B / n_data molecules;
  * ``atoms`` — the row-block axis of a graph's pair grid: each rank along
    it owns N / n_atoms atom rows (atom-sharded) or an atom block that
    circulates (ring-sharded).

NCCL carries the collectives on the card, gloo on the CPU; the CPU is used
only when the caller asks for it (``device_type="cpu"``).  Importing this
module starts no process group: :func:`make_mesh` does, through
:func:`~epnn_tpu_torch.parallel.multihost.initialize_distributed`, when
none is running.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DATA_AXIS = "data"
ATOM_AXIS = "atoms"


def _device_type(device_type: Optional[str]) -> str:
    if device_type is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a mesh runs on CUDA cards by default and none is "
                "available; pass device_type='cpu' to run on the CPU")
        return "cuda"
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device_type='cuda' requested but CUDA is not "
                           "available")
    return device_type


def make_mesh(
    n_data: Optional[int] = None,
    n_atoms: int = 1,
    devices: Optional[Sequence[int]] = None,
    device_type: Optional[str] = None,
) -> DeviceMesh:
    """A (data, atoms) mesh over the world's ranks (``devices``: the
    global ranks to use, default all of them, in order; the first
    ``n_data · n_atoms`` are taken, as JAX takes the first devices).
    ``n_data`` defaults to every rank the atoms axis leaves.  Starts the
    process group when none is running (one process unless torchrun's
    variables say otherwise; :func:`~epnn_tpu_torch.parallel.multihost.
    initialize_distributed`).  ``device_type``: ``"cuda"`` (default, each
    rank on ``cuda:LOCAL_RANK``, raising without a card) or ``"cpu"``."""
    from epnn_tpu_torch.parallel.multihost import initialize_distributed

    device_type = _device_type(device_type)
    if not dist.is_initialized():
        initialize_distributed(device_type=device_type)
    world = dist.get_world_size()
    ranks = list(range(world) if devices is None else devices)
    if n_data is None:
        n_data = max(len(ranks) // n_atoms, 1)
    if n_data * n_atoms > len(ranks):
        raise ValueError(
            f"mesh ({n_data} data x {n_atoms} atoms) needs "
            f"{n_data * n_atoms} ranks but the world has {world} "
            f"({len(ranks)} offered). Start one process per device, e.g. "
            f"torchrun --nproc-per-node {n_data * n_atoms} ...")
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    arr = np.asarray(ranks[: n_data * n_atoms]).reshape(n_data, n_atoms)
    return _mesh_of(arr, device_type)


def _mesh_of(arr: np.ndarray, device_type: str) -> DeviceMesh:
    return DeviceMesh(device_type, torch.as_tensor(arr, dtype=torch.int64),
                      mesh_dim_names=(DATA_AXIS, ATOM_AXIS))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``: the CPU, or its current card
    (:func:`make_mesh` sets it to ``cuda:LOCAL_RANK``)."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def replicated(mesh: DeviceMesh) -> Tuple[str, ...]:
    """The placement of a replicated value: no mesh axis (JAX's ``P()``).
    Under SPMD every rank holds the whole value."""
    return ()


def batch_sharding(mesh: DeviceMesh) -> Tuple[str, ...]:
    """The placement of a batch operand: its leading axis over ``data``
    (JAX's ``P(DATA_AXIS)``)."""
    return (DATA_AXIS,)


def shard_state(state: Any, mesh: DeviceMesh) -> Any:
    """The train state replicated on every rank of ``mesh`` (parameters are
    tiny, ≤ 75K; sharding them would be pure overhead): every tensor in
    ``state`` is checked against rank 0's by a broadcast, and a rank whose
    copy differs raises.  Returns ``state``."""
    device = mesh_device(mesh)
    for t in _tensors(state):
        ref = t.detach().to(device).clone()
        dist.broadcast(ref, src=int(mesh.mesh.reshape(-1)[0]))
        if not torch.equal(ref, t.detach().to(device)):
            raise ValueError("shard_state: this rank's state differs from "
                             "rank 0's; every rank must start from the "
                             "same parameters")
    return state


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif hasattr(tree, "__dataclass_fields__"):
        for f in tree.__dataclass_fields__:
            yield from _tensors(getattr(tree, f))


def shard_batch_args(args: Tuple, mesh: DeviceMesh) -> Tuple:
    """This rank's slice of every batch array along its leading (molecule)
    axis: the block of B / n_data molecules at its ``data`` coordinate,
    as a tensor on its device."""
    n_shards = axis_size(mesh, DATA_AXIS)
    d = axis_index(mesh, DATA_AXIS)
    device = mesh_device(mesh)
    out = []
    for a in args:
        a = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                            else a)
        if a.shape[0] % n_shards:
            raise ValueError(
                f"batch dim {a.shape[0]} not divisible by data axis "
                f"{n_shards}")
        per = a.shape[0] // n_shards
        out.append(a[d * per:(d + 1) * per].to(device))
    return tuple(out)
