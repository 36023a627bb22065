"""MLPs with the reference's three tails (port of
text2loc_tpu/models/mlp.py).

* get_mlp        — Linear + BatchNorm + ReLU after every layer, the last too;
* get_mlp2       — the last layer Linear + BatchNorm only;
* get_mlp_offset — Linear/ReLU, nothing after the last Linear.

BatchNorm is MaskedBatchNorm: in training (module.train()) f32 batch
statistics over the mask-valid rows, and the running statistics updated
with momentum 0.1 and the unbiased variance; in eval the running
statistics. Either way it is applied as one folded affine in the input
dtype, like the JAX package's MaskedBatchNorm. Under a data-parallel mesh
(parallel/mesh.use_mesh) the training statistics are the global batch's.
Layers are named dense_{i} / bn_{i} as in the JAX parameter tree.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from text2loc_tpu_torch.parallel.mesh import global_sums


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over every leading axis, counting only mask-valid rows.

    Train: mean = sum(x m) / count, var = sum((x - mean)^2 m) / count (two
    passes, f32), count = max(sum m, 1); running_mean/var <- 0.9 * running +
    0.1 * (mean, var * count / max(count - 1, 1)). Eval: the running
    statistics. y = x * a + b with a = weight / sqrt(var + eps) and
    b = bias - mean * a, both in f32 and cast to x.dtype.

    `mesh` (set by parallel/mesh.use_mesh): the training statistics over
    every rank's rows, in the same two passes: the sums of x m and m
    all-reduced, the mean formed, then the centred squares all-reduced."""

    MOMENTUM = 0.1

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.mesh = None

    def batch_stats(self, x: torch.Tensor, mask=None):
        """(mean, biased var, count) of x over the mask-valid rows, in f32."""
        x32 = x.float()
        dims = tuple(range(x.ndim - 1))
        if self.mesh is not None:
            return self._global_stats(x32, mask, dims)
        if mask is None:
            count = torch.tensor(float(x32.numel() // x32.shape[-1]), device=x.device)
            mean = x32.mean(dim=dims)
            return mean, torch.square(x32 - mean).mean(dim=dims), count
        m = mask.to(torch.bool)
        while m.ndim < x32.ndim:
            m = m[..., None]
        m = m.float()
        count = torch.clamp(m.sum(), min=1.0)
        mean = (x32 * m).sum(dim=dims) / count
        return mean, (torch.square(x32 - mean) * m).sum(dim=dims) / count, count

    def _global_stats(self, x32, mask, dims):
        """batch_stats over every rank of self.mesh."""
        if mask is None:
            m = torch.ones((), dtype=torch.float32, device=x32.device)
            local = torch.tensor(float(x32.numel() // x32.shape[-1]), device=x32.device)
        else:
            m = mask.to(torch.bool)
            while m.ndim < x32.ndim:
                m = m[..., None]
            m = m.float()
            local = m.sum()
        total, count = global_sums(self.mesh, (x32 * m).sum(dim=dims), local)
        count = torch.clamp(count, min=1.0)
        mean = total / count
        (sq,) = global_sums(self.mesh, (torch.square(x32 - mean) * m).sum(dim=dims))
        return mean, sq / count, count

    @torch.no_grad()
    def update_running(self, mean, var, count) -> None:
        """The running-statistics update of one training batch."""
        unbiased = var * count / torch.clamp(count - 1.0, min=1.0)
        self.running_mean.mul_(1 - self.MOMENTUM).add_(self.MOMENTUM * mean)
        self.running_var.mul_(1 - self.MOMENTUM).add_(self.MOMENTUM * unbiased)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        if self.training:
            mean, var, count = self.batch_stats(x, mask)
            self.update_running(mean.detach(), var.detach(), count)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.reciprocal(torch.sqrt(var + self.eps))
        a = (self.weight * inv).to(x.dtype)
        b = (self.bias - mean * self.weight * inv).to(x.dtype)
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
                setattr(self, f"bn_{i}", MaskedBatchNorm(dims[i + 1]))

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        """`mask` ([rows] bool, or None) marks the rows the training
        BatchNorm statistics count."""
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
            x = getattr(self, f"bn_{i}")(x, mask)
            if not last or self.tail == "relu":
                x = torch.relu(x)
        return x


def get_mlp(channels, dtype=torch.float32) -> MLP:
    return MLP(channels, tail="relu", dtype=dtype)


def get_mlp2(channels, dtype=torch.float32) -> MLP:
    return MLP(channels, tail="bn", dtype=dtype)


def get_mlp_offset(channels, dtype=torch.float32) -> MLP:
    return MLP(channels, tail="none", dtype=dtype)
