"""Wrapper of the "first"-selection SA kernel (csrc/sa_select.cu)."""

from __future__ import annotations

import ctypes

import torch

from text2loc_tpu_torch.ops import _cuda

KERNEL = _cuda.Kernel(
    name="sa_select_first",
    source="text2loc_tpu_torch/csrc/sa_select.cu",
    replaces="text2loc_tpu/ops/pallas_pointconv.py:451",
)
MAX_K = 32
_THREADS = 256


def sa_select_first_cuda(feat, pos, centers, w1, wp, ab1, w2, ab2,
                         radius: float, k: int) -> torch.Tensor:
    """[N, S, H2] in feat.dtype; the arguments as sa_select_first_plain's."""
    dt = feat.dtype
    if dt not in _cuda.DTYPE_CODE:
        raise ValueError(f"feat: unsupported dtype {dt}")
    if feat.ndim != 3:
        raise ValueError(f"feat: expected [N, P, C], got {tuple(feat.shape)}")
    n, p, c = feat.shape
    s = centers.shape[1]
    h1, h2 = w1.shape[1], w2.shape[1]
    _cuda.check(feat, "feat", dtype=dt)
    _cuda.check(pos, "pos", dtype=torch.float32, shape=(n, p, 3))
    _cuda.check(centers, "centers", dtype=torch.float32, shape=(n, s, 3))
    _cuda.check(w1, "w1", dtype=dt, shape=(c, h1))
    _cuda.check(wp, "wp", dtype=dt, shape=(3, h1))
    _cuda.check(ab1, "ab1", dtype=torch.float32, shape=(2, h1))
    _cuda.check(w2, "w2", dtype=dt, shape=(h1, h2))
    _cuda.check(ab2, "ab2", dtype=torch.float32, shape=(2, h2))
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k}: the kernel keeps at most {MAX_K} neighbours")
    if h2 % 32 or h2 > 1024:
        raise ValueError(f"H2={h2}: must be a multiple of 32 and at most 1024")
    g_per = max(1, _THREADS // h2)
    lib = _cuda.library()
    smem = lib.t2l_sa_select_smem(p, h1, g_per)
    if smem > _cuda.SMEM_LIMIT:
        raise ValueError(f"SA level needs {smem} B of shared memory per block")
    out = torch.empty((n, s, h2), dtype=dt, device=feat.device)
    if n and s:
        _cuda.launch(
            KERNEL, "t2l_sa_select_first",
            *(_cuda.ptr(t) for t in (feat, pos, centers, w1, wp, ab1, w2, ab2, out)),
            n, p, s, c, h1, h2, k, ctypes.c_float(radius * radius), g_per,
            _cuda.DTYPE_CODE[dt],
        )
    return out
