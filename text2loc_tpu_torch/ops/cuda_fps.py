"""Wrapper of the FPS kernel (csrc/fps.cu) and its launch plan."""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from text2loc_tpu_torch.ops import _cuda

KERNEL = _cuda.Kernel(
    name="fps",
    source="text2loc_tpu_torch/csrc/fps.cu",
    replaces="text2loc_tpu/ops/pallas_fps.py:89",
)

MAX_PER_LANE = 16      # csrc/fps.cu kMaxPerLane: the warp variant to P = 512
WARPS_PER_BLOCK = 2    # clouds a block of the warp variant
BLOCK_STATIC_SMEM = 512  # the block variant's winners, double buffered


@dataclass(frozen=True)
class FpsPlan:
    """per_lane: points a lane of the warp variant (one warp a cloud), 0 for
    the block variant (one block a cloud); warps: clouds a block (warp
    variant); smem: dynamic shared memory bytes of one block."""

    per_lane: int
    warps: int
    smem: int


@functools.lru_cache(maxsize=256)
def fps_plan(p: int, s: int) -> FpsPlan:
    """The kernel variant for clouds of p points and s samples: the warp
    variant with the least power-of-two points a lane that holds p, else the
    block variant; ValueError where the block variant's shared memory (the
    minima, 4 bytes a point, beside its static winners) exceeds one
    block's."""
    if not 1 <= s <= p:
        raise ValueError(f"num_samples {s} not in [1, {p}]")
    lanes = -(-p // 32)
    if lanes <= MAX_PER_LANE:
        per_lane = 1 << (lanes - 1).bit_length()
        return FpsPlan(per_lane, WARPS_PER_BLOCK, 4 * WARPS_PER_BLOCK * (3 * p + s))
    smem = 4 * p
    if smem + BLOCK_STATIC_SMEM > _cuda.SMEM_LIMIT:
        raise ValueError(f"{p} points per cloud exceed the block's shared memory")
    return FpsPlan(0, 0, smem)


def farthest_point_sampling_cuda(points: torch.Tensor, num_samples: int):
    """[N, P, 3] f32 CUDA -> (idx [N, S] int32, coords [N, S, 3] f32)."""
    _cuda.check(points, "points", dtype=torch.float32)
    if points.ndim != 3 or points.shape[-1] != 3:
        raise ValueError(f"points: expected [N, P, 3], got {tuple(points.shape)}")
    n, p, _ = points.shape
    plan = fps_plan(p, num_samples)
    idx = torch.empty((n, num_samples), dtype=torch.int32, device=points.device)
    coords = torch.empty((n, num_samples, 3), dtype=torch.float32,
                         device=points.device)
    if n:
        _cuda.launch(KERNEL, "t2l_fps", _cuda.ptr(points), _cuda.ptr(idx),
                     _cuda.ptr(coords), n, p, num_samples, plan.per_lane, plan.warps)
    return idx, coords
