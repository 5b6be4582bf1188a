"""The card's published peaks (NVIDIA H100 SXM data sheet, dense rates
without sparsity, at the full 700 W power limit), and the rate a product
can reach at each of the port's precision tiers.

The port runs its products on the tensor cores in TF32: one product a
k-step at "default", three (the 3xTF32 split) at "high" and "highest".
So a product at "highest" can reach at most a third of the TF32 rate;
counting it against the full rate would read a kernel that runs at its
best as a third of its roofline."""

TF32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12

#: TF32 products a model product takes, by precision
PASSES = {"default": 1, "high": 3, "highest": 3}


def tier_flops(precision: str) -> float:
    """The FLOP/s a model product can reach at ``precision``."""
    return TF32_FLOPS / PASSES[precision]
