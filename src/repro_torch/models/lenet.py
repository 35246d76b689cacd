"""LeNet-300-100: the paper's own model (§IV).

Fully-connected 784 -> 300 -> 100 -> 10 with ReLU; 266,610 parameters.

Parameters are a nested dict ``{"fc1": {"w": (784, 300), "b": (300,)}, ...}``
in the reference's ``(in, out)`` weight layout, so the port's weights compare
with the reference's like for like.  :func:`forward` also takes a leading
client axis on every leaf (weights (K, in, out), inputs (K, B, 784)): that
is how the batched engine trains K clients at once, the client axis written
out where the reference uses ``vmap``.
"""
from __future__ import annotations

import torch
from torch import nn

LAYERS = (("fc1", 784, 300), ("fc2", 300, 100), ("fc3", 100, 10))
NUM_PARAMS = sum(i * o + o for _, i, o in LAYERS)   # 266,610


def forward(params, x: torch.Tensor) -> torch.Tensor:
    """x: (..., B, 784) -> logits (..., B, 10); params may carry the same
    leading client axis as x."""
    h = x
    for i, (name, _, _) in enumerate(LAYERS):
        w, b = params[name]["w"], params[name]["b"]
        h = torch.matmul(h, w) + b.unsqueeze(-2)
        if i < len(LAYERS) - 1:
            h = torch.relu(h)
    return h


def accuracy(params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Top-1 accuracy as a float32 scalar tensor."""
    pred = torch.argmax(forward(params, x), dim=-1)
    return torch.mean((pred == y).to(torch.float32))


class LeNet(nn.Module):
    """LeNet-300-100 as an ``nn.Module`` over the same ``(in, out)`` layout."""

    def __init__(self, params=None):
        super().__init__()
        self.layers = nn.ModuleDict()
        for name, fan_in, fan_out in LAYERS:
            layer = nn.Module()
            src = params[name] if params is not None else None
            layer.w = nn.Parameter(
                src["w"].clone() if src else torch.zeros(fan_in, fan_out)
            )
            layer.b = nn.Parameter(
                src["b"].clone() if src else torch.zeros(fan_out)
            )
            self.layers[name] = layer

    def params(self):
        """The parameters as the nested ``{"fc1": {"w", "b"}, ...}`` dict."""
        return {
            name: {"w": layer.w, "b": layer.b}
            for name, layer in self.layers.items()
        }

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return forward(self.params(), x)
