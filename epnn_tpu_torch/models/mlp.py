"""Plain MLP block: relu hidden stack + linear head (counterpart of
``epnn_tpu/models/mlp.py``).  Layers are named ``dense_0..dense_L`` as in
the JAX parameter tree; each holds the JAX ``kernel`` (in, out) transposed
into ``nn.Linear.weight`` (out, in).  ``dtype`` is flax ``Dense``'s: each
layer's input, weight and bias are cast to it at use, the parameters stay
float32 (``param_dtype``)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F


class MLP(nn.Module):
    def __init__(self, in_dim: int, hidden: Sequence[int], out_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        widths = [in_dim, *hidden, out_dim]
        self.n_layers = len(widths) - 1
        for i in range(self.n_layers):
            self.add_module(f"dense_{i}", nn.Linear(widths[i], widths[i + 1]))

    def layers(self):
        return [getattr(self, f"dense_{i}") for i in range(self.n_layers)]

    def _dense(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), layer.weight.to(dt), layer.bias.to(dt))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        *hidden, head = self.layers()
        for layer in hidden:
            x = torch.relu(self._dense(layer, x))
        return self._dense(head, x)

    @torch.no_grad()
    def load_tree(self, tree: dict) -> None:
        """Copy a ``{"dense_k": {"kernel", "bias"}}`` subtree in."""
        for i, layer in enumerate(self.layers()):
            leaf = tree[f"dense_{i}"]
            layer.weight.copy_(leaf["kernel"].T)
            layer.bias.copy_(leaf["bias"])
