"""The post-LN feed-forward block LayerNorm(x + relu(x@W1+b1)@W2 + b2): the
plain PyTorch version and the dispatch (port of
text2loc_tpu/ops/pallas_ffn.py:fused_ffn_addlayernorm and its oracle
ffn_addlayernorm_reference). Weights [in, out]: w1 [D, F], w2 [F, D]."""

from __future__ import annotations

import torch

from text2loc_tpu_torch.ops import cuda_ffn
from text2loc_tpu_torch.ops.mha import layer_norm_f32


def ffn_hidden_plain(x, w1, b1):
    """The hidden [..., F] in x.dtype: relu(f32(x) f32(W1) + b1), summed
    and relu'd in f32, then rounded to x.dtype (the tiled chain's stage
    (a))."""
    dt = x.dtype
    return torch.relu(x.float() @ w1.to(dt).float() + b1.float()).to(dt)


def ffn_out_addln_plain(h, x, w2, b2, scale, bias, eps: float = 1e-5):
    """LayerNorm((f32(x) + f32(h) W2) + b2) in x.dtype, the sums and the
    statistics in f32 (the tiled chain's stages (b) and (c))."""
    dt = x.dtype
    s = x.float() + h.float() @ w2.to(dt).float() + b2.float()
    return layer_norm_f32(s, scale, bias, eps).to(dt)


def ffn_addln_plain(x, w1, b1, w2, b2, scale, bias, eps: float = 1e-5):
    """[..., D] in x.dtype with the TPU kernel's numerics: both products
    summed in f32, the relu'd hidden rounded to x.dtype, f32 residual and
    LayerNorm. The composition of the two plain stages."""
    return ffn_out_addln_plain(ffn_hidden_plain(x, w1, b1), x, w2, b2, scale, bias, eps)


def ffn_addln(x, w1, b1, w2, b2, scale, bias, eps: float = 1e-5):
    """The block on the tensors' device: for CUDA tensors one of the two
    CUDA kernels (cuda_ffn.route: the fused block up to d=256, the tiled
    chain above), for CPU tensors the plain version."""
    if x.is_cuda:
        return cuda_ffn.ffn_addln_cuda(x, w1, b1, w2, b2, scale, bias, eps)
    if x.device.type != "cpu":
        raise ValueError(f"no feed-forward block for device {x.device}")
    return ffn_addln_plain(x, w1, b1, w2, b2, scale, bias, eps)
