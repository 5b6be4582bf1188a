"""Plain MLP block: relu hidden stack + linear head (counterpart of
``epnn_tpu/models/mlp.py``).  Layers are named ``dense_0..dense_L`` as in
the JAX parameter tree; each holds the JAX ``kernel`` (in, out) transposed
into ``nn.Linear.weight`` (out, in)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class MLP(nn.Module):
    def __init__(self, in_dim: int, hidden: Sequence[int], out_dim: int):
        super().__init__()
        widths = [in_dim, *hidden, out_dim]
        self.n_layers = len(widths) - 1
        for i in range(self.n_layers):
            self.add_module(f"dense_{i}", nn.Linear(widths[i], widths[i + 1]))

    def layers(self):
        return [getattr(self, f"dense_{i}") for i in range(self.n_layers)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        *hidden, head = self.layers()
        for layer in hidden:
            x = torch.relu(layer(x))
        return head(x)

    @torch.no_grad()
    def load_tree(self, tree: dict) -> None:
        """Copy a ``{"dense_k": {"kernel", "bias"}}`` subtree in."""
        for i, layer in enumerate(self.layers()):
            leaf = tree[f"dense_{i}"]
            layer.weight.copy_(leaf["kernel"].T)
            layer.bias.copy_(leaf["bias"])
