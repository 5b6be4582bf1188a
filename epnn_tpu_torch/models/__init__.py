from epnn_tpu_torch.models.config import PRESETS, EPNNConfig
from epnn_tpu_torch.models.epnn import EPNN, init_params, pair_gate, param_shapes
from epnn_tpu_torch.models.mlp import MLP

__all__ = ["EPNN", "EPNNConfig", "MLP", "PRESETS", "init_params",
           "pair_gate", "param_shapes"]
