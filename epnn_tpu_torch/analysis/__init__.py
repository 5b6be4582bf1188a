from epnn_tpu_torch.analysis.polarization import (
    PolarizationResult,
    polarization_response,
    split_dimer,
)

__all__ = ["PolarizationResult", "polarization_response", "split_dimer"]
