"""Voxel-grid downsampling on the device (the port of
text2loc_tpu/prep/voxel.py: voxel_downsample_indices, voxel_downsample;
it replaces both the numpy path there and the C++ one of
text2loc_tpu/native).

Contract: one representative per occupied voxel, the point of lowest
original index, returned in ascending order. Keys are
floor((p - min) / v) in float64 (the same IEEE operations as numpy); a
stable sort over (segment, flattened key) puts each voxel's lowest index
first. `voxel_keep` runs many clouds at once, each with its own minimum and
voxel size, so a whole PLY window is one pass.
"""

from __future__ import annotations

import numpy as np
import torch

from text2loc_tpu_torch.prep.exact import resolve_device, to_numpy


def voxel_keep(xyz: torch.Tensor, seg: torch.Tensor, voxel: torch.Tensor) -> torch.Tensor:
    """Boolean mask [N] of the representatives of xyz [N, 3] (float64),
    grouped by segment id seg [N] (int64, any order) with voxel[s] the grid
    size of segment s (float64 [S])."""
    n = len(xyz)
    keep = torch.zeros(n, dtype=torch.bool, device=xyz.device)
    if n == 0:
        return keep
    idx3 = seg[:, None].expand(n, 3)
    mins = torch.full((len(voxel), 3), float("inf"), dtype=xyz.dtype, device=xyz.device)
    mins = mins.scatter_reduce(0, idx3, xyz, "amin")
    keys = torch.floor((xyz - mins[seg]) / voxel[seg, None]).to(torch.int64)
    spans = torch.zeros((len(voxel), 3), dtype=torch.int64, device=xyz.device)
    spans = spans.scatter_reduce(0, idx3, keys, "amax")[seg] + 1
    flat = (keys[:, 0] * spans[:, 1] + keys[:, 1]) * spans[:, 2] + keys[:, 2]
    order = torch.argsort(flat, stable=True)
    order = order[torch.argsort(seg[order], stable=True)]
    sk, ss = flat[order], seg[order]
    first = torch.ones(n, dtype=torch.bool, device=xyz.device)
    first[1:] = (sk[1:] != sk[:-1]) | (ss[1:] != ss[:-1])
    keep[order[first]] = True
    return keep


def voxel_downsample_indices(points, voxel_size: float, device="cuda") -> np.ndarray:
    """Ascending indices of one representative point per occupied voxel."""
    assert voxel_size > 0
    dev = resolve_device(device)
    pts = torch.as_tensor(np.asarray(points, np.float64), device=dev)
    keep = voxel_keep(pts, torch.zeros(len(pts), dtype=torch.int64, device=dev),
                      torch.tensor([float(voxel_size)], dtype=torch.float64, device=dev))
    return to_numpy(torch.nonzero(keep)[:, 0])



def voxel_downsample(points, voxel_size: float, device="cuda"):
    """(points[idx], idx): the representatives of voxel_downsample_indices,
    computed on `device` (the card unless "cpu" is asked for)."""
    idx = voxel_downsample_indices(points, voxel_size, device=device)
    return points[idx], idx
