"""Wrapper of the fused feed-forward block kernel (csrc/ffn_addln.cu)."""

from __future__ import annotations

import ctypes

import torch

from text2loc_tpu_torch.ops import _cuda

KERNEL = _cuda.Kernel(
    name="ffn_addln",
    source="text2loc_tpu_torch/csrc/ffn_addln.cu",
    replaces="text2loc_tpu/ops/pallas_ffn.py:47",
)


def ffn_addln_cuda(x, w1, b1, w2, b2, scale, bias, eps: float = 1e-5):
    """[..., D] in x.dtype; the arguments as ffn_addln_plain's."""
    dt = x.dtype
    if dt not in _cuda.DTYPE_CODE:
        raise ValueError(f"x: unsupported dtype {dt}")
    _cuda.check(x, "x", dtype=dt)
    d = x.shape[-1]
    f = w1.shape[1]
    w1_, w2_ = w1.to(dt).contiguous(), w2.to(dt).contiguous()
    b1_, b2_, g_, be_ = (t.float().contiguous() for t in (b1, b2, scale, bias))
    _cuda.check(w1_, "w1", shape=(d, f))
    _cuda.check(w2_, "w2", shape=(f, d))
    _cuda.check(b1_, "b1", shape=(f,))
    for name, t in (("b2", b2_), ("scale", g_), ("bias", be_)):
        _cuda.check(t, name, shape=(d,))
    lib = _cuda.library()
    smem = lib.t2l_ffn_addln_smem(d, f, _cuda.DTYPE_CODE[dt])
    if smem > _cuda.SMEM_LIMIT:
        raise ValueError(f"feed-forward block needs {smem} B of shared memory "
                         f"(D={d}, F={f}, {dt})")
    rows = x.numel() // d
    out = torch.empty_like(x)
    if rows:
        _cuda.launch(
            KERNEL, "t2l_ffn_addln",
            *(_cuda.ptr(t) for t in (x, w1_, b1_, w2_, b2_, g_, be_, out)),
            rows, d, f, ctypes.c_float(eps), _cuda.DTYPE_CODE[dt],
        )
    return out
