"""Multi-device serving and training over ``torch.distributed``
(counterpart of ``epnn_tpu/parallel``): meshes, the atom-sharded and
ring-sharded forwards (:mod:`~epnn_tpu_torch.parallel.atom_shard`,
:mod:`~epnn_tpu_torch.parallel.ring_shard`) and the sharded train and
eval steps.  Importing it starts no process group."""

from epnn_tpu_torch.parallel.atom_shard import (
    make_sharded_eval_step,
    make_sharded_train_step,
)
from epnn_tpu_torch.parallel.multihost import (
    initialize_distributed,
    is_coordinator,
    make_multihost_mesh,
)
from epnn_tpu_torch.parallel.sharding import (
    ATOM_AXIS,
    DATA_AXIS,
    batch_sharding,
    make_mesh,
    replicated,
    shard_batch_args,
    shard_state,
)

__all__ = [
    "ATOM_AXIS",
    "DATA_AXIS",
    "batch_sharding",
    "initialize_distributed",
    "is_coordinator",
    "make_mesh",
    "make_multihost_mesh",
    "make_sharded_eval_step",
    "make_sharded_train_step",
    "replicated",
    "shard_batch_args",
    "shard_state",
]
