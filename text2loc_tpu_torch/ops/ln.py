"""Residual add + LayerNorm, LayerNorm(x + res) * scale + bias, with the
TPU kernel's numerics: the plain PyTorch version and the dispatch (port of
text2loc_tpu/ops/pallas_ln.py: fused_add_layernorm).

The kernel casts x and res to f32 before the sum; the JAX package's stock
branch (and add_layernorm_reference) sums in x's dtype and casts after.
In f32 the two are one function; in bf16 they differ by the rounding of
x + res. The port's stock formula stays models/transformer.add_layernorm.
"""

from __future__ import annotations

import torch

from text2loc_tpu_torch.ops import cuda_ln


def add_layernorm_plain(x, res, scale, bias, eps: float = 1e-5):
    """[..., D] in x.dtype: f32 sum of x and res, mean, mean of squared
    deviations (biased variance), rsqrt, affine, cast to x's dtype."""
    s = x.float() + res.float()
    mu = s.mean(dim=-1, keepdim=True)
    var = torch.square(s - mu).mean(dim=-1, keepdim=True)
    y = (s - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def add_layernorm(x, res, scale, bias, eps: float = 1e-5):
    """The block on the tensors' device: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors. x and res: the same shape and dtype."""
    if res.dtype != x.dtype or res.shape != x.shape:
        raise ValueError(f"res {res.dtype} {tuple(res.shape)} does not match x "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.is_cuda:
        return cuda_ln.add_layernorm_cuda(x.contiguous(), res.contiguous(), scale, bias, eps)
    if x.device.type != "cpu":
        raise ValueError(f"no add+LayerNorm for device {x.device}")
    return add_layernorm_plain(x, res, scale, bias, eps)
