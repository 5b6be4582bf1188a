from epnn_tpu_torch.io.checkpoint import (
    from_jax_params,
    has_checkpoint,
    load_config,
    load_params,
)

__all__ = ["from_jax_params", "has_checkpoint", "load_config", "load_params"]
