"""Wrapper of the fused attention block kernel (csrc/mha_addln.cu)."""

from __future__ import annotations

import ctypes
import math

import torch

from text2loc_tpu_torch.ops import _cuda

KERNEL = _cuda.Kernel(
    name="mha_addln",
    source="text2loc_tpu_torch/csrc/mha_addln.cu",
    replaces="text2loc_tpu/ops/pallas_mha.py:137",
)


def mha_addln_cuda(x, kv, wq, bq, wk, bk, wv, bv, wo, bo, scale, bias,
                   key_mask=None, *, num_heads: int, eps: float = 1e-5):
    """[B, Lq, D] in x.dtype; the arguments as mha_addln_plain's. `kv is x`
    selects the self-attention layout (one copy of the rows on chip)."""
    from text2loc_tpu_torch.ops.mha import key_bias

    dt = x.dtype
    if dt not in _cuda.DTYPE_CODE:
        raise ValueError(f"x: unsupported dtype {dt}")
    if x.ndim != 3 or kv.ndim != 3:
        raise ValueError("x and kv must be [B, L, D]")
    b, lq, d = x.shape
    lk = kv.shape[1]
    if d % num_heads or tuple(kv.shape) != (b, lk, d):
        raise ValueError(f"x {tuple(x.shape)} / kv {tuple(kv.shape)} / "
                         f"heads {num_heads} do not fit")
    self_attn = kv is x
    dev = x.device
    _cuda.check(x, "x", dtype=dt)
    if not self_attn:
        _cuda.check(kv, "kv", dtype=dt)
    mats = [t.to(dt).contiguous() for t in (wq, wk, wv, wo)]
    vecs = [t.float().contiguous() for t in (bq, bk, bv, bo, scale, bias)]
    for name, t in zip(("wq", "wk", "wv", "wo"), mats):
        _cuda.check(t, name, shape=(d, d))
    for name, t in zip(("bq", "bk", "bv", "bo", "scale", "bias"), vecs):
        _cuda.check(t, name, shape=(d,))
    kb = key_bias(key_mask, b, lk, dev).contiguous()
    lib = _cuda.library()
    smem = lib.t2l_mha_addln_smem(lq, lk, d, num_heads, int(self_attn),
                                  _cuda.DTYPE_CODE[dt])
    if smem > _cuda.SMEM_LIMIT:
        raise ValueError(f"attention block needs {smem} B of shared memory "
                         f"(Lq={lq}, Lk={lk}, D={d}, {dt})")
    out = torch.empty_like(x)
    wq_, wk_, wv_, wo_ = mats
    bq_, bk_, bv_, bo_, g_, be_ = vecs
    if b:
        _cuda.launch(
            KERNEL, "t2l_mha_addln",
            *(_cuda.ptr(t) for t in (x, kv, kb, wq_, bq_, wk_, bk_, wv_, bv_,
                                     wo_, bo_, g_, be_, out)),
            b, lq, lk, d, num_heads,
            ctypes.c_float(1.0 / math.sqrt(d // num_heads)), ctypes.c_float(eps),
            int(self_attn), _cuda.DTYPE_CODE[dt],
        )
    return out
