"""Wrappers of the attention block's two CUDA kernels: the fused block, one
CUDA block per sample (csrc/mha_addln.cu), up to d=256; the tiled chain
over all rows (csrc/mha_tiled.cu: tensor-core GEMMs, an attention core, a
row LayerNorm) above it and wherever the fused block's layout does not fit
in shared memory. `route` picks one; there is no fallback."""

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
KERNEL_TILED = _cuda.Kernel(
    name="mha_addln_tiled",
    source="text2loc_tpu_torch/csrc/mha_tiled.cu",
    replaces="text2loc_tpu/ops/pallas_mha.py:137",
)

FUSED_MAX_D = 256   # above it the fused block reads its weights once per sample


def _tsize(dtype) -> int:
    return 2 if dtype == torch.bfloat16 else 4


def _align16(n: int) -> int:
    return (n + 15) & ~15


def fused_smem(lq: int, lk: int, d: int, heads: int, self_attn: bool, dtype) -> int:
    """Shared bytes of the fused block: the sum of make_layout
    (csrc/mha_addln.cu) — x (and kv), q, k, v in the dtype, the f32
    [heads, lq, lk] probabilities and the f32 [lq, d] pre-norm rows."""
    t = _tsize(dtype)
    off = _align16(t * lq * d)
    if not self_attn:
        off = _align16(off + t * lk * d)
    for rows in (lq, lk, lk):
        off = _align16(off + t * rows * d)
    off = _align16(off + 4 * heads * lq * lk)
    return _align16(off + 4 * lq * d)


def core_smem(lq: int, lk: int, d: int, heads: int, dtype) -> int:
    """Shared bytes of the tiled chain's attention core (one block per sample
    and head): q, k, v of the head in the dtype, then the f32 [lq, lk]
    probabilities (core_smem in csrc/mha_tiled.cu)."""
    return _align16(_tsize(dtype) * (lq + 2 * lk) * (d // heads)) + 4 * lq * lk


def route(lq: int, lk: int, d: int, heads: int, dtype, *, self_attn: bool = False) -> str:
    """"fused" where d <= 256 and the fused block's layout fits a block's
    shared memory, else "tiled". Without `self_attn` the cross layout
    (x and kv both on chip) is assumed."""
    if d <= FUSED_MAX_D and fused_smem(lq, lk, d, heads, self_attn, dtype) <= _cuda.SMEM_LIMIT:
        return "fused"
    return "tiled"


def check_tiled(lq: int, lk: int, d: int, heads: int, dtype) -> None:
    """Raise ValueError where the tiled chain cannot take the shape: D a
    multiple of 128 (the GEMM tiles; the TPU kernel asks the same), and the
    attention core's q, k, v of one head plus its probabilities within a
    block's shared memory."""
    if d % 128:
        raise ValueError(f"the tiled attention block takes D a multiple of 128, not {d}")
    need = core_smem(lq, lk, d, heads, dtype)
    if need > _cuda.SMEM_LIMIT:
        raise ValueError(
            f"the tiled attention core needs (Lq + 2 Lk) * dh * {_tsize(dtype)} + 4 Lq Lk = "
            f"{need} B of shared memory (Lq={lq}, Lk={lk}, dh={d // heads}, {dtype}); "
            f"the limit is {_cuda.SMEM_LIMIT} B")


def _check_block(x, kv, mats, vecs, num_heads):
    """Validate the block's operands; return (b, lq, lk, d)."""
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
    _cuda.check(x, "x", dtype=dt)
    if kv is not x:
        _cuda.check(kv, "kv", dtype=dt)
    for name, t in zip(("wq", "wk", "wv", "wo"), mats):
        _cuda.check(t, name, shape=(d, d))
    for name, t in zip(("bq", "bk", "bv", "bo", "scale", "bias"), vecs):
        _cuda.check(t, name, shape=(d,))
    return b, lq, lk, d


def mha_addln_cuda(x, kv, wq, bq, wk, bk, wv, bv, wo, bo, scale, bias,
                   key_mask=None, *, num_heads: int, eps: float = 1e-5):
    """[B, Lq, D] in x.dtype; the arguments as mha_addln_plain's. `kv is x`
    selects the self-attention layout (one copy of the rows, one
    projection GEMM). The fused kernel or the tiled chain, by `route`."""
    from text2loc_tpu_torch.ops.mha import key_bias

    dt = x.dtype
    self_attn = kv is x
    mats = [t.to(dt).contiguous() for t in (wq, wk, wv, wo)]
    vecs = [t.float().contiguous() for t in (bq, bk, bv, bo, scale, bias)]
    b, lq, lk, d = _check_block(x, kv, mats, vecs, num_heads)
    kb = key_bias(key_mask, b, lk, x.device).contiguous()
    if route(lq, lk, d, num_heads, dt, self_attn=self_attn) == "tiled":
        check_tiled(lq, lk, d, num_heads, dt)
        return _tiled_block(x, kv, kb, mats, vecs, num_heads, eps, self_attn)
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


def _packed_qkv(wq, bq, wk, bk, wv, bv, dt):
    """[Wq|Wk|Wv] [D, 3D] in the dtype and [bq|bk|bv] [3D] in f32: one
    projection GEMM for self-attention, column slices for cross."""
    return (torch.cat([t.to(dt) for t in (wq, wk, wv)], dim=1),
            torch.cat([t.float() for t in (bq, bk, bv)]))


def _tiled_block(x, kv, kb, mats, vecs, num_heads, eps, self_attn):
    """One call of t2l_mha_addln_tiled: the projection GEMM(s), the core,
    the out-projection GEMM with the residual, the LayerNorm. Scratch
    from torch.empty: q/k/v and o in the dtype, the pre-norm rows in f32."""
    dt = x.dtype
    b, lq, d = x.shape
    lk = kv.shape[1]
    m, mk = b * lq, b * lk
    wq, wk, wv, wo = mats
    bq, bk, bv, bo, g, be = vecs
    wqkv, bqkv = _packed_qkv(wq, bq, wk, bk, wv, bv, dt)
    qkv = torch.empty(m * 3 * d if self_attn else m * d + mk * 2 * d, dtype=dt,
                      device=x.device)
    o = torch.empty((m, d), dtype=dt, device=x.device)
    s2 = torch.empty((m, d), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    if b:
        _cuda.launch(
            KERNEL_TILED, "t2l_mha_addln_tiled",
            *(_cuda.ptr(t) for t in (x, kv, kb, wqkv, bqkv, wo, bo, g, be, out, qkv,
                                     o, s2)),
            b, lq, lk, d, num_heads,
            ctypes.c_float(1.0 / math.sqrt(d // num_heads)), ctypes.c_float(eps),
            int(self_attn), _cuda.DTYPE_CODE[dt],
        )
    return out


# The tiled chain's stages launched one at a time, each to be held against
# its plain stage (ops/mha.py). The main path never calls these, and they
# do not count as launches of the block.


def _gemm(a, w, bias, c, *, res=None, nscale=0, scale=1.0):
    """c = round((a w + bias) * colscale) (the first nscale columns scaled),
    or with `res` c (f32) = (f32(res) + a w) + bias. a [M, K] and res [M, N]
    contiguous; w [K, N] and c [M, N] may be column slices of a wider
    matrix (row strides taken from them)."""
    m, k = a.shape
    n = c.shape[1]
    _cuda.launch(KERNEL_TILED, "t2l_mha_tiled_gemm", _cuda.ptr(a), k, _cuda.ptr(w),
                 w.stride(0), _cuda.ptr(bias), _cuda.ptr(c), c.stride(0),
                 None if res is None else _cuda.ptr(res), n, m, n, k, nscale,
                 ctypes.c_float(scale), _cuda.DTYPE_CODE[a.dtype], count=False)


def tiled_project_cuda(x, kv, wq, bq, wk, bk, wv, bv, *, num_heads: int):
    """Stage (a): (q, k, v) as mha_project_plain returns them, by the
    projection GEMM(s) of the main path (one over [Wq|Wk|Wv] when `kv is
    x`, else x Wq and kv [Wk|Wv])."""
    dt = x.dtype
    b, lq, d = x.shape
    lk = kv.shape[1]
    _cuda.check(x, "x", dtype=dt)
    _cuda.check(kv, "kv", dtype=dt)
    wqkv, bqkv = _packed_qkv(wq, bq, wk, bk, wv, bv, dt)
    scale = 1.0 / math.sqrt(d // num_heads)
    x2, kv2 = x.reshape(b * lq, d), kv.reshape(b * lk, d)
    if kv is x:
        qkv = torch.empty((b * lq, 3 * d), dtype=dt, device=x.device)
        _gemm(x2, wqkv, bqkv, qkv, nscale=d, scale=scale)
        q, k, v = qkv[:, :d], qkv[:, d:2 * d], qkv[:, 2 * d:]
    else:
        q = torch.empty((b * lq, d), dtype=dt, device=x.device)
        kvp = torch.empty((b * lk, 2 * d), dtype=dt, device=x.device)
        _gemm(x2, wqkv[:, :d], bqkv[:d], q, nscale=d, scale=scale)
        _gemm(kv2, wqkv[:, d:], bqkv[d:], kvp)
        k, v = kvp[:, :d], kvp[:, d:]
    return q.reshape(b, lq, d), k.reshape(b, lk, d), v.reshape(b, lk, d)


def tiled_core_cuda(q, k, v, key_mask=None, *, num_heads: int):
    """Stage (b): the attention output o [B, Lq, D], as mha_core_plain."""
    from text2loc_tpu_torch.ops.mha import key_bias

    dt = q.dtype
    b, lq, d = q.shape
    lk = k.shape[1]
    check_tiled(lq, lk, d, num_heads, dt)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _cuda.check(t, name, dtype=dt)
    kb = key_bias(key_mask, b, lk, q.device).contiguous()
    o = torch.empty_like(q)
    _cuda.launch(KERNEL_TILED, "t2l_mha_tiled_core", _cuda.ptr(q), d, _cuda.ptr(k),
                 _cuda.ptr(v), d, _cuda.ptr(kb), _cuda.ptr(o), b, lq, lk, d, num_heads,
                 _cuda.DTYPE_CODE[dt], count=False)
    return o


def tiled_out_addln_cuda(x, o, wo, bo, scale, bias, *, eps: float = 1e-5):
    """Stages (c) and (d): LayerNorm((f32(x) + o Wo) + bo) in x.dtype, as
    mha_out_addln_plain; x [..., D], o [..., K] and wo [K, D]. K = D here;
    with the hidden h as o and K = F, the feed-forward chain's stages (b)
    and (c), as ffn_out_addln_plain."""
    dt = x.dtype
    d, k = x.shape[-1], o.shape[-1]
    m = x.numel() // d
    _cuda.check(x, "x", dtype=dt)
    _cuda.check(o, "o", dtype=dt, shape=(*x.shape[:-1], k))
    wo_, bo_, g, be = (wo.to(dt).contiguous(), bo.float().contiguous(),
                       scale.float().contiguous(), bias.float().contiguous())
    _cuda.check(wo_, "wo", shape=(k, d))
    s2 = torch.empty((m, d), dtype=torch.float32, device=x.device)
    _gemm(o.reshape(m, k), wo_, bo_, s2, res=x.reshape(m, d))
    out = torch.empty_like(x)
    _cuda.launch(KERNEL_TILED, "t2l_mha_tiled_ln", _cuda.ptr(s2), _cuda.ptr(g),
                 _cuda.ptr(be), _cuda.ptr(out), m, d, ctypes.c_float(eps),
                 _cuda.DTYPE_CODE[dt], count=False)
    return out
