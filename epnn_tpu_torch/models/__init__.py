from epnn_tpu_torch.models.config import PRESETS, EPNNConfig, reference_compat
from epnn_tpu_torch.models.epnn import (
    EPNN,
    count_params,
    dense_apply,
    init_params,
    map_tree,
    pair_gate,
    param_shapes,
    tree_leaves,
)
from epnn_tpu_torch.models.mlp import MLP

__all__ = ["EPNN", "EPNNConfig", "MLP", "PRESETS", "count_params",
           "dense_apply", "init_params", "map_tree", "pair_gate",
           "param_shapes", "reference_compat", "tree_leaves"]
