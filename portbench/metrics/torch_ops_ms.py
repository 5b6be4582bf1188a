"""``ops.fused``'s PyTorch operators on the card: device ms a call in the
kernels that are not the port's own CUDA kernels (selection, sorts,
gathers, RBF and gate, projections, the update MLP), copies and fills
left out, in the traced window."""

from portbench.frozen import groups


def read(ctx):
    t = ctx.trace
    if not t or not t["calls"] or t["busy_s"] <= 0:
        return None
    return groups.torch_kernels(t["kernels"]) * 1e3 / t["calls"]
