from epnn_tpu_torch.utils.timing import Timer, benchmark_fn

__all__ = ["Timer", "benchmark_fn"]
