from epnn_tpu_torch.train.loop import (
    MetricAccumulator,
    TrainConfig,
    TrainResult,
    TrainState,
    create_state,
    eval_step,
    eval_step_fused,
    make_optimizer,
    train,
    train_step,
    train_step_fused,
)
from epnn_tpu_torch.train.metrics import (
    LOSSES,
    mae_sums,
    masked_mse,
    padded_mse,
)

__all__ = ["LOSSES", "MetricAccumulator", "TrainConfig", "TrainResult",
           "TrainState", "create_state", "eval_step", "eval_step_fused",
           "mae_sums", "make_optimizer", "masked_mse", "padded_mse", "train",
           "train_step", "train_step_fused"]
