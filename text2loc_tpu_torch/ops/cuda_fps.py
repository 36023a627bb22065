"""Wrapper of the FPS kernel (csrc/fps.cu)."""

from __future__ import annotations

import torch

from text2loc_tpu_torch.ops import _cuda

KERNEL = _cuda.Kernel(
    name="fps",
    source="text2loc_tpu_torch/csrc/fps.cu",
    replaces="text2loc_tpu/ops/pallas_fps.py:89",
)


def farthest_point_sampling_cuda(points: torch.Tensor, num_samples: int):
    """[N, P, 3] f32 CUDA -> (idx [N, S] int32, coords [N, S, 3] f32)."""
    _cuda.check(points, "points", dtype=torch.float32)
    if points.ndim != 3 or points.shape[-1] != 3:
        raise ValueError(f"points: expected [N, P, 3], got {tuple(points.shape)}")
    n, p, _ = points.shape
    if not 1 <= num_samples <= p:
        raise ValueError(f"num_samples {num_samples} not in [1, {p}]")
    if 4 * 4 * p > _cuda.SMEM_LIMIT:
        raise ValueError(f"{p} points per cloud exceed the block's shared memory")
    idx = torch.empty((n, num_samples), dtype=torch.int32, device=points.device)
    coords = torch.empty((n, num_samples, 3), dtype=torch.float32,
                         device=points.device)
    if n:
        _cuda.launch(KERNEL, "t2l_fps", _cuda.ptr(points), _cuda.ptr(idx),
                     _cuda.ptr(coords), n, p, num_samples)
    return idx, coords
