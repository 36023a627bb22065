"""Wrapper of the fused residual add + LayerNorm kernel (csrc/add_ln.cu)."""

from __future__ import annotations

import ctypes

import torch

from text2loc_tpu_torch.ops import _cuda

KERNEL = _cuda.Kernel(
    name="add_ln",
    source="text2loc_tpu_torch/csrc/add_ln.cu",
    replaces="text2loc_tpu/ops/pallas_ln.py:36",
)
WIDTHS = (128, 256, 512, 1024)   # the kernel's row widths (one warp per row)


def add_layernorm_cuda(x, res, scale, bias, eps: float = 1e-5):
    """[..., D] in x.dtype; the arguments as add_layernorm_plain's."""
    dt = x.dtype
    if dt not in _cuda.DTYPE_CODE:
        raise ValueError(f"x: unsupported dtype {dt}")
    d = x.shape[-1]
    if d not in WIDTHS:
        raise ValueError(f"add+LayerNorm kernel: width {d} not in {WIDTHS}")
    _cuda.check(x, "x", dtype=dt)
    _cuda.check(res, "res", dtype=dt, shape=x.shape)
    g_, b_ = scale.float().contiguous(), bias.float().contiguous()
    _cuda.check(g_, "scale", shape=(d,))
    _cuda.check(b_, "bias", shape=(d,))
    rows = x.numel() // d
    out = torch.empty_like(x)
    if rows:
        _cuda.launch(KERNEL, "t2l_add_ln",
                     *(_cuda.ptr(t) for t in (x, res, g_, b_, out)),
                     rows, d, ctypes.c_float(eps), _cuda.DTYPE_CODE[dt])
    return out
