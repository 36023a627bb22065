"""Farthest-point sampling: the plain PyTorch version and the dispatch
(port of text2loc_tpu/ops/fps.py).

Deterministic start at point 0; ties in the argmax go to the first maximum.
One pass at the largest ladder size serves every SA level: FPS is
prefix-stable, so fps(pts, S1)[:, :S2] == fps(pts, S2) for S2 <= S1.
"""

from __future__ import annotations

import torch

from text2loc_tpu_torch.ops import cuda_fps


def farthest_point_sampling_plain(points: torch.Tensor, num_samples: int):
    """[N, P, 3] -> (idx [N, S] int32, coords [N, S, 3] f32).

    Mirrors text2loc_tpu/ops/fps.py:_farthest_point_sampling_xla. The
    distance is (dx*dx + dy*dy) + dz*dz as separate tensor ops (each
    product and sum rounded on its own, no FMA), the rounding the CUDA
    kernel reproduces bit for bit."""
    n, p, _ = points.shape
    if num_samples > p:
        raise ValueError(f"num_samples {num_samples} > points {p}")
    pts = points.float()
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    rows = torch.arange(n, device=points.device)
    min_d = torch.full((n, p), float("inf"), device=points.device)
    idx = torch.zeros((n, num_samples), dtype=torch.long, device=points.device)
    last = torch.zeros((n,), dtype=torch.long, device=points.device)
    for i in range(1, num_samples):
        dx = x - x[rows, last][:, None]
        dy = y - y[rows, last][:, None]
        dz = z - z[rows, last][:, None]
        d = dx * dx + dy * dy + dz * dz
        min_d = torch.minimum(min_d, d)
        last = torch.argmax(min_d, dim=1)
        idx[:, i] = last
    coords = torch.gather(pts, 1, idx[:, :, None].expand(n, num_samples, 3))
    return idx.to(torch.int32), coords


def farthest_point_sampling(points: torch.Tensor, num_samples: int):
    """FPS on the tensor's device: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor. Returns (idx int32, coords f32)."""
    if points.is_cuda:
        return cuda_fps.farthest_point_sampling_cuda(points, num_samples)
    if points.device.type != "cpu":
        raise ValueError(f"no FPS for device {points.device}")
    return farthest_point_sampling_plain(points, num_samples)


def fps_gather(points: torch.Tensor, num_samples: int):
    """(sub_points [N, S, 3] in points.dtype, idx [N, S] int32)."""
    idx, coords = farthest_point_sampling(points, num_samples)
    return coords.to(points.dtype), idx
