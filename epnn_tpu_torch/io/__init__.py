from epnn_tpu_torch.io.checkpoint import (
    from_jax_params,
    has_checkpoint,
    load_config,
    load_meta,
    load_params,
    load_train_state,
    save_params,
    save_train_state,
)
from epnn_tpu_torch.io.export_serving import (
    ServingArtifact,
    export_predictor,
    load_serving,
)
from epnn_tpu_torch.io.tf_import import import_checkpoint, import_reference_model

__all__ = ["ServingArtifact", "export_predictor", "load_serving",
           "from_jax_params", "has_checkpoint", "import_checkpoint",
           "import_reference_model", "load_config", "load_meta",
           "load_params", "load_train_state", "save_params",
           "save_train_state"]
