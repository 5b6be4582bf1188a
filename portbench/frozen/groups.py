"""The kernels of the port's own CUDA libraries (``epnn_tpu_torch/csrc``),
by the names their ``__global__`` functions have in a device trace.  A
trace entry belongs to a group when its name holds one of the group's
keys; every other kernel is PyTorch's."""

from __future__ import annotations

#: the far field's forward (3xTF32 and one-pass libraries alike) and the
#: reduction of its column splits
FAR_FIELD = ("dmr_partial", "sum_parts")
#: the two near kernels
NEAR = ("nmc_kernel", "npr_kernel")
#: every kernel the port's libraries hold
PORT = ("dmr_partial", "dmr_bwd_partial", "dmr_bwd_d", "dmr_bwd_w",
        "dmr_int8_partial", "sum_parts", "nmc_kernel", "npr_kernel",
        "fmr_kernel", "fepn_kernel", "nc_scan", "nc_merge")
#: device activity that is a copy or a fill, not a kernel
COPIES = ("Memcpy", "Memset")


def matching(kernels: dict, keys) -> float:
    """Seconds of the entries whose name holds one of ``keys``."""
    return sum(sec for name, sec in kernels.items()
               if any(k in name for k in keys))


def torch_kernels(kernels: dict) -> float:
    """Seconds of the kernels that are neither the port's nor copies."""
    return sum(sec for name, sec in kernels.items()
               if not any(k in name for k in PORT + COPIES))
