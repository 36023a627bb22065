"""Eval-mode MLPs with the reference's three tails (port of
text2loc_tpu/models/mlp.py).

* get_mlp        — Linear + BatchNorm + ReLU after every layer, the last too;
* get_mlp2       — the last layer Linear + BatchNorm only;
* get_mlp_offset — Linear/ReLU, nothing after the last Linear.

BatchNorm runs on its running statistics (inference), applied as one folded
affine in the input dtype like the JAX package's MaskedBatchNorm. Layers are
named dense_{i} / bn_{i} as in the JAX parameter tree.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class BatchNormEval(nn.Module):
    """BatchNorm1d over the last axis with running statistics (eval).

    y = x * a + b with a = weight / sqrt(running_var + eps) and
    b = bias - running_mean * a, both computed in f32 and cast to x.dtype."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.reciprocal(torch.sqrt(self.running_var + self.eps))
        a = (self.weight * inv).to(x.dtype)
        b = (self.bias - self.running_mean * self.weight * inv).to(x.dtype)
        return x * a + b


class MLP(nn.Module):
    """Stack of Linear[+BatchNorm][+ReLU] blocks computed in `dtype`.

    tail: "relu" (get_mlp), "bn" (get_mlp2) or "none" (get_mlp_offset)."""

    def __init__(self, channels: Sequence[int], tail: str = "relu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if tail not in ("relu", "bn", "none"):
            raise ValueError(tail)
        self.tail = tail
        self.dtype = dtype
        dims = list(channels)
        self.n_layers = len(dims) - 1
        for i in range(self.n_layers):
            setattr(self, f"dense_{i}", nn.Linear(dims[i], dims[i + 1]))
            if tail != "none":
                setattr(self, f"bn_{i}", BatchNormEval(dims[i + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for i in range(self.n_layers):
            last = i == self.n_layers - 1
            lin = getattr(self, f"dense_{i}")
            x = nn.functional.linear(x, lin.weight.to(self.dtype),
                                     lin.bias.to(self.dtype))
            if self.tail == "none":
                if not last:
                    x = torch.relu(x)
                continue
            x = getattr(self, f"bn_{i}")(x)
            if not last or self.tail == "relu":
                x = torch.relu(x)
        return x


def get_mlp(channels, dtype=torch.float32) -> MLP:
    return MLP(channels, tail="relu", dtype=dtype)


def get_mlp2(channels, dtype=torch.float32) -> MLP:
    return MLP(channels, tail="bn", dtype=dtype)


def get_mlp_offset(channels, dtype=torch.float32) -> MLP:
    return MLP(channels, tail="none", dtype=dtype)
