from epnn_tpu_torch.ops.fused import (
    FusedParams,
    PairMLPWeights,
    build_neighbors,
    build_neighbors_batch,
    build_neighbors_cell,
    cell_grid_params,
    forward_blocked,
    fuse_params,
    max_neighbor_count,
    rbf_and_gate,
    refresh_neighbor_d2,
)

__all__ = ["FusedParams", "PairMLPWeights", "build_neighbors",
           "build_neighbors_batch", "build_neighbors_cell",
           "cell_grid_params", "forward_blocked", "fuse_params",
           "max_neighbor_count", "rbf_and_gate", "refresh_neighbor_d2"]
