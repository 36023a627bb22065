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


def _as(t, dt):
    """A weight rounded to the compute dtype, in f32."""
    return t.to(dt).float()


def mha_project_plain(x, kv, wq, bq, wk, bk, wv, bv, *, num_heads: int):
    """(q, k, v) in x.dtype: [B, Lq, D], [B, Lk, D], [B, Lk, D]. Sums in
    f32; q = (x Wq + bq) / sqrt(dh), k = kv Wk + bk, v = kv Wv + bv, each
    rounded to x.dtype."""
    dt = x.dtype
    dh = x.shape[-1] // num_heads
    xf, kvf = x.float(), kv.float()
    q = ((xf @ _as(wq, dt) + bq.float()) * (1.0 / math.sqrt(dh))).to(dt)
    k = (kvf @ _as(wk, dt) + bk.float()).to(dt)
    v = (kvf @ _as(wv, dt) + bv.float()).to(dt)
    return q, k, v


def mha_core_plain(q, k, v, key_mask=None, *, num_heads: int):
    """The attention output o [B, Lq, D] in q.dtype from the projected (and
    scaled) q, k, v: per head f32 scores plus the key bias, an f32 softmax
    rounded to the dtype, p v summed in f32 and rounded."""
    dt = q.dtype
    b, lq, d = q.shape
    lk = k.shape[1]
    dh = d // num_heads
    qh = q.float().reshape(b, lq, num_heads, dh)
    kh = k.float().reshape(b, lk, num_heads, dh)
    vh = v.float().reshape(b, lk, num_heads, dh)
    s = torch.einsum("bqhe,bkhe->bhqk", qh, kh)
    s = s + key_bias(key_mask, b, lk, q.device)[:, None, None, :]
    p = torch.softmax(s, dim=-1).to(dt).float()
    return torch.einsum("bhqk,bkhe->bqhe", p, vh).reshape(b, lq, d).to(dt)


def mha_out_addln_plain(x, o, wo, bo, scale, bias, *, eps: float = 1e-5):
    """LayerNorm(s2) in x.dtype, s2 = f32(x) + o Wo + bo summed in f32."""
    dt = x.dtype
    s2 = x.float() + o.float() @ _as(wo, dt) + bo.float()
    return layer_norm_f32(s2, scale, bias, eps).to(dt)


def mha_addln_plain(x, kv, wq, bq, wk, bk, wv, bv, wo, bo, scale, bias,
                    key_mask=None, *, num_heads: int, eps: float = 1e-5):
    """[B, Lq, D] in x.dtype, with the TPU kernel's numerics: projections
    summed in f32, q scaled by 1/sqrt(dh) and q/k/v rounded to x.dtype, key
    mask as a -1e9 bias, f32 softmax rounded to x.dtype, the attention output
    rounded before the out-projection, f32 residual and LayerNorm. An
    all-masked sample attends uniformly over its own keys. The composition
    of the three plain stages, which are the plain versions of the tiled
    kernel's stages."""
    q, k, v = mha_project_plain(x, kv, wq, bq, wk, bk, wv, bv, num_heads=num_heads)
    o = mha_core_plain(q, k, v, key_mask, num_heads=num_heads)
    return mha_out_addln_plain(x, o, wo, bo, scale, bias, eps=eps)


def mha_addln(x, kv, wq, bq, wk, bk, wv, bv, wo, bo, scale, bias,
              key_mask=None, *, num_heads: int, eps: float = 1e-5):
    """The block on the tensors' device: for CUDA tensors one of the two CUDA
    kernels (cuda_mha.route: the fused block up to d=256, the tiled chain
    above), for CPU tensors the plain version. Pass the same tensor as x and
    kv for self-attention."""
    args = (x, kv, wq, bq, wk, bk, wv, bv, wo, bo, scale, bias, key_mask)
    if x.is_cuda:
        return cuda_mha.mha_addln_cuda(*args, num_heads=num_heads, eps=eps)
    if x.device.type != "cpu":
        raise ValueError(f"no attention block for device {x.device}")
    return mha_addln_plain(*args, num_heads=num_heads, eps=eps)
