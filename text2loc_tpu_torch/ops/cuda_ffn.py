"""Wrappers of the feed-forward block's two CUDA kernels: the fused block,
one CUDA block per 16 rows with the hidden rows in shared memory
(csrc/ffn_addln.cu), up to d=256; the tiled chain over all rows
(csrc/ffn_tiled.cu: two tensor-core GEMMs and a row LayerNorm) above it and
wherever the fused block's layout does not fit in shared memory. `route`
picks one; there is no fallback."""

from __future__ import annotations

import ctypes

import torch

from text2loc_tpu_torch.ops import _cuda

KERNEL = _cuda.Kernel(
    name="ffn_addln",
    source="text2loc_tpu_torch/csrc/ffn_addln.cu",
    replaces="text2loc_tpu/ops/pallas_ffn.py:47",
)
KERNEL_TILED = _cuda.Kernel(
    name="ffn_addln_tiled",
    source="text2loc_tpu_torch/csrc/ffn_tiled.cu",
    replaces="text2loc_tpu/ops/pallas_ffn.py:47",
)

FUSED_MAX_D = 256   # above it the fused block re-reads its weights every 16 rows
TILE_ROWS = 16      # rows of one fused block (kTileRows in csrc/ffn_addln.cu)


def _align16(n: int) -> int:
    return (n + 15) & ~15


def fused_smem(d: int, f: int, dtype) -> int:
    """Shared bytes of the fused block: the sum of make_layout
    (csrc/ffn_addln.cu) — the x tile and the hidden rows in the dtype, the
    f32 pre-norm rows."""
    t = 2 if dtype == torch.bfloat16 else 4
    off = _align16(t * TILE_ROWS * d)
    off = _align16(off + t * TILE_ROWS * f)
    return _align16(off + 4 * TILE_ROWS * d)


def route(d: int, f: int, dtype) -> str:
    """"fused" where d <= 256 and the fused block's layout fits a block's
    shared memory, else "tiled"."""
    if d <= FUSED_MAX_D and fused_smem(d, f, dtype) <= _cuda.SMEM_LIMIT:
        return "fused"
    return "tiled"


def check_tiled(d: int, f: int) -> None:
    """Raise ValueError where the tiled chain cannot take the shape: D and
    F multiples of 128 (the GEMM tiles; the TPU kernel asserts the same)."""
    if d % 128 or f % 128:
        raise ValueError(f"the tiled feed-forward block takes D and F multiples of 128, "
                         f"not D={d}, F={f}")


def _operands(x, w1, b1, w2, b2, scale, bias):
    """The weights in x.dtype and the vectors in f32, contiguous and
    checked against x [..., D] and w1 [D, F]."""
    dt = x.dtype
    if dt not in _cuda.DTYPE_CODE:
        raise ValueError(f"x: unsupported dtype {dt}")
    _cuda.check(x, "x", dtype=dt)
    d, f = x.shape[-1], w1.shape[1]
    w1_, w2_ = w1.to(dt).contiguous(), w2.to(dt).contiguous()
    b1_, b2_, g_, be_ = (t.float().contiguous() for t in (b1, b2, scale, bias))
    _cuda.check(w1_, "w1", shape=(d, f))
    _cuda.check(w2_, "w2", shape=(f, d))
    _cuda.check(b1_, "b1", shape=(f,))
    for name, t in (("b2", b2_), ("scale", g_), ("bias", be_)):
        _cuda.check(t, name, shape=(d,))
    return w1_, b1_, w2_, b2_, g_, be_


def ffn_addln_cuda(x, w1, b1, w2, b2, scale, bias, eps: float = 1e-5):
    """[..., D] in x.dtype; the arguments as ffn_addln_plain's. The fused
    kernel or the tiled chain, by `route`."""
    d, f = x.shape[-1], w1.shape[1]
    if route(d, f, x.dtype) == "fused":
        return fused_block_cuda(x, w1, b1, w2, b2, scale, bias, eps)
    check_tiled(d, f)
    ops = _operands(x, w1, b1, w2, b2, scale, bias)
    rows = x.numel() // d
    # Scratch: the hidden [rows, F] in the dtype (208 MB in bf16 at the
    # intra stack's 25,344 rows), the pre-norm rows [rows, D] in f32.
    h = torch.empty((rows, f), dtype=x.dtype, device=x.device)
    s2 = torch.empty((rows, d), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    if rows:
        _cuda.launch(KERNEL_TILED, "t2l_ffn_addln_tiled", _cuda.ptr(x),
                     *(_cuda.ptr(t) for t in ops), _cuda.ptr(out), _cuda.ptr(h),
                     _cuda.ptr(s2), rows, d, f, ctypes.c_float(eps),
                     _cuda.DTYPE_CODE[x.dtype])
    return out


def fused_block_cuda(x, w1, b1, w2, b2, scale, bias, eps: float = 1e-5):
    """One launch of the fused kernel (csrc/ffn_addln.cu), which
    ffn_addln_cuda takes where `route` says "fused". Called directly it
    takes any shape whose layout fits (chip_smoke.py times it at D=1024
    beside the chain) and raises on one that does not."""
    ops = _operands(x, w1, b1, w2, b2, scale, bias)
    d, f = x.shape[-1], w1.shape[1]
    smem = fused_smem(d, f, x.dtype)
    if smem > _cuda.SMEM_LIMIT:
        raise ValueError(f"the fused feed-forward block needs {smem} B of shared memory "
                         f"(D={d}, F={f}, {x.dtype}); the limit is {_cuda.SMEM_LIMIT} B")
    rows = x.numel() // d
    out = torch.empty_like(x)
    if rows:
        _cuda.launch(KERNEL, "t2l_ffn_addln", _cuda.ptr(x), *(_cuda.ptr(t) for t in ops),
                     _cuda.ptr(out), rows, d, f, ctypes.c_float(eps),
                     _cuda.DTYPE_CODE[x.dtype])
    return out


# The tiled chain's stages launched one at a time, each to be held against
# its plain stage (ops/ffn.py). The main path never calls these, and they
# do not count as launches of the block. Stages (b) and (c), the residual
# GEMM (K = F) and the LayerNorm, are the attention chain's:
# cuda_mha.tiled_out_addln_cuda(x, h, w2, b2, scale, bias).


def tiled_hidden_cuda(x, w1, b1):
    """Stage (a): round(relu(x W1 + b1)) [..., F] in x.dtype, as
    ffn_hidden_plain."""
    dt = x.dtype
    _cuda.check(x, "x", dtype=dt)
    d, f = x.shape[-1], w1.shape[1]
    check_tiled(d, f)
    w1_, b1_ = w1.to(dt).contiguous(), b1.float().contiguous()
    _cuda.check(w1_, "w1", shape=(d, f))
    _cuda.check(b1_, "b1", shape=(f,))
    h = torch.empty((*x.shape[:-1], f), dtype=dt, device=x.device)
    _cuda.launch(KERNEL_TILED, "t2l_ffn_tiled_gemm_relu", _cuda.ptr(x), _cuda.ptr(w1_),
                 _cuda.ptr(b1_), _cuda.ptr(h), x.numel() // d, d, f, _cuda.DTYPE_CODE[dt],
                 count=False)
    return h

