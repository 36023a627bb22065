"""Eval-mode point-cloud transform (port of the augment=False branch of
text2loc_tpu/data/augment.py:point_cloud_transform, and normalize_scale)."""

from __future__ import annotations

import numpy as np
import torch


def normalize_scale(xyz: torch.Tensor) -> torch.Tensor:
    """PyG NormalizeScale: center to the mean, scale max |coord| to ~1."""
    centered = xyz - xyz.mean(dim=-2, keepdim=True)
    peak = centered.abs().amax(dim=(-2, -1), keepdim=True)
    scale = (1.0 / torch.clamp(peak, min=1e-12)) * 0.999999
    return centered * scale


def point_cloud_transform_eval(xyz: torch.Tensor, rgb: torch.Tensor,
                               num_points: int):
    """Deterministic eval transform: all stored points when the counts
    match, else an even stride; then NormalizeScale on xyz."""
    p = xyz.shape[-2]
    if p != num_points:
        idx = torch.as_tensor(
            (np.arange(num_points) * p // max(num_points, 1)).astype(np.int64),
            device=xyz.device)
        xyz = xyz.index_select(-2, idx)
        rgb = rgb.index_select(-2, idx)
    return normalize_scale(xyz), rgb
