from epnn_tpu_torch.ops.fused import (
    FusedParams,
    PairMLPWeights,
    build_neighbors,
    build_neighbors_batch,
    forward_blocked,
    fuse_params,
    max_neighbor_count,
    rbf_and_gate,
)

__all__ = ["FusedParams", "PairMLPWeights", "build_neighbors",
           "build_neighbors_batch", "forward_blocked", "fuse_params",
           "max_neighbor_count", "rbf_and_gate"]
