"""The post-LN multi-head attention block LayerNorm(x + MHA(x, kv)): the
plain PyTorch version and the dispatch (port of
text2loc_tpu/ops/pallas_mha.py:fused_mha_addlayernorm and its oracle
mha_addlayernorm_ref).

Weights in the port's layout: wq/wk/wv [D, H*DH] and wo [H*DH, D] ([in, out],
the flax DenseGeneral kernels flattened over the heads), biases [H*DH] / [D],
LayerNorm scale/bias [D].
"""

from __future__ import annotations

import math

import torch

from text2loc_tpu_torch.ops import cuda_mha

MASKED = -1e9  # additive key bias of a padded key


def key_bias(key_mask, b: int, lk: int, device) -> torch.Tensor:
    """[B, Lk] f32 additive bias: 0 for a valid key, -1e9 for a padded one."""
    if key_mask is None:
        return torch.zeros((b, lk), dtype=torch.float32, device=device)
    return torch.where(key_mask.to(torch.bool), 0.0, MASKED).to(torch.float32)


def layer_norm_f32(s: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    """LayerNorm of f32 rows: biased variance, f32 statistics."""
    mu = s.mean(dim=-1, keepdim=True)
    var = torch.square(s - mu).mean(dim=-1, keepdim=True)
    return (s - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def mha_addln_plain(x, kv, wq, bq, wk, bk, wv, bv, wo, bo, scale, bias,
                    key_mask=None, *, num_heads: int, eps: float = 1e-5):
    """[B, Lq, D] in x.dtype, with the TPU kernel's numerics: projections
    summed in f32, q scaled by 1/sqrt(dh) and q/k/v rounded to x.dtype, key
    mask as a -1e9 bias, f32 softmax rounded to x.dtype, the attention output
    rounded before the out-projection, f32 residual and LayerNorm. An
    all-masked sample attends uniformly over its own keys."""
    dt = x.dtype
    b, lq, d = x.shape
    lk = kv.shape[1]
    dh = d // num_heads

    def w(t):
        return t.to(dt).float()

    xf, kvf = x.float(), kv.float()
    q = ((xf @ w(wq) + bq.float()) * (1.0 / math.sqrt(dh))).to(dt).float()
    k = (kvf @ w(wk) + bk.float()).to(dt).float()
    v = (kvf @ w(wv) + bv.float()).to(dt).float()
    q = q.reshape(b, lq, num_heads, dh)
    k = k.reshape(b, lk, num_heads, dh)
    v = v.reshape(b, lk, num_heads, dh)
    s = torch.einsum("bqhe,bkhe->bhqk", q, k)
    s = s + key_bias(key_mask, b, lk, x.device)[:, None, None, :]
    p = torch.softmax(s, dim=-1).to(dt).float()
    o = torch.einsum("bhqk,bkhe->bqhe", p, v).reshape(b, lq, d).to(dt).float()
    s2 = xf + o @ w(wo) + bo.float()
    return layer_norm_f32(s2, scale, bias, eps).to(dt)


def mha_addln(x, kv, wq, bq, wk, bk, wv, bv, wo, bo, scale, bias,
              key_mask=None, *, num_heads: int, eps: float = 1e-5):
    """The block on the tensors' device: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors. Pass the same tensor as x and kv for
    self-attention."""
    args = (x, kv, wq, bq, wk, bk, wv, bv, wo, bo, scale, bias, key_mask)
    if x.is_cuda:
        return cuda_mha.mha_addln_cuda(*args, num_heads=num_heads, eps=eps)
    if x.device.type != "cpu":
        raise ValueError(f"no attention block for device {x.device}")
    return mha_addln_plain(*args, num_heads=num_heads, eps=eps)
