"""The post-LN feed-forward block LayerNorm(x + relu(x@W1+b1)@W2 + b2): the
plain PyTorch version and the dispatch (port of
text2loc_tpu/ops/pallas_ffn.py:fused_ffn_addlayernorm and its oracle
ffn_addlayernorm_reference). Weights [in, out]: w1 [D, F], w2 [F, D]."""

from __future__ import annotations

import torch

from text2loc_tpu_torch.ops import cuda_ffn
from text2loc_tpu_torch.ops.mha import layer_norm_f32


def ffn_addln_plain(x, w1, b1, w2, b2, scale, bias, eps: float = 1e-5):
    """[..., D] in x.dtype with the TPU kernel's numerics: both products
    summed in f32, the relu'd hidden rounded to x.dtype, f32 residual and
    LayerNorm."""
    dt = x.dtype
    xf = x.float()
    h = torch.relu(xf @ w1.to(dt).float() + b1.float()).to(dt).float()
    s = xf + h @ w2.to(dt).float() + b2.float()
    return layer_norm_f32(s, scale, bias, eps).to(dt)


def ffn_addln(x, w1, b1, w2, b2, scale, bias, eps: float = 1e-5):
    """The block on the tensors' device: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if x.is_cuda:
        return cuda_ffn.ffn_addln_cuda(x, w1, b1, w2, b2, scale, bias, eps)
    if x.device.type != "cpu":
        raise ValueError(f"no feed-forward block for device {x.device}")
    return ffn_addln_plain(x, w1, b1, w2, b2, scale, bias, eps)
