"""Point-cloud transforms and training augmentations (port of
text2loc_tpu/data/augment.py). Random draws come from an explicit
torch.Generator on the tensors' device: the same distributions as the JAX
package's, not the same draws.

Batches are dicts of tensors ([B, ...] leading axis), as gathered by
MultiSceneArrays and moved to the device. Under a data-parallel `mesh` a
batch holds this rank's rows, and every draw is made at the global batch's
shape and cut to them (parallel/mesh.local_draw): a rank augments its rows
as a single device augments the same rows of the global batch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from text2loc_tpu_torch import constants as C
from text2loc_tpu_torch.parallel.mesh import local_draw


def normalize_scale(xyz: torch.Tensor) -> torch.Tensor:
    """PyG NormalizeScale: center to the mean, scale max |coord| to ~1."""
    centered = xyz - xyz.mean(dim=-2, keepdim=True)
    peak = centered.abs().amax(dim=(-2, -1), keepdim=True)
    scale = (1.0 / torch.clamp(peak, min=1e-12)) * 0.999999
    return centered * scale


def resample_points(xyz, rgb, generator, num_points: int, mesh=None):
    """Random point resampling with replacement (FixedPoints semantics):
    [..., P, 3] -> [..., num_points, 3]."""
    p = xyz.shape[-2]
    lead = xyz.shape[:-2]
    idx = local_draw(lambda shape: torch.randint(0, p, shape, generator=generator,
                                                 device=xyz.device),
                     lead + (num_points,), mesh)
    sel = idx[..., None].expand(lead + (num_points, 3))
    return torch.gather(xyz, -2, sel), torch.gather(rgb, -2, sel)


def random_rotate_z(xyz, generator, max_degrees: float = 120.0, mesh=None):
    """Per-object random rotation about z (PyG RandomRotate(., axis=2)),
    angle uniform in [-max_degrees, max_degrees)."""
    lead = xyz.shape[:-2]
    u = _rand(lead, generator, xyz.device, mesh)
    ang = (u * (2 * max_degrees) - max_degrees) * (math.pi / 180.0)
    cos, sin = torch.cos(ang)[..., None], torch.sin(ang)[..., None]
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    return torch.stack([cos * x - sin * y, sin * x + cos * y, z], dim=-1)


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


def point_cloud_transform(xyz, rgb, generator, num_points: int, augment: bool,
                          mesh=None):
    """train: FixedPoints -> RandomRotate(120, z) -> NormalizeScale;
    eval: point_cloud_transform_eval."""
    if not augment:
        return point_cloud_transform_eval(xyz, rgb, num_points)
    xyz, rgb = resample_points(xyz, rgb, generator, num_points, mesh)
    return normalize_scale(random_rotate_z(xyz, generator, mesh=mesh)), rgb


def _rand(shape, generator, device, mesh):
    return local_draw(lambda s: torch.rand(s, generator=generator, device=device),
                      shape, mesh)


def flip_coarse(batch: dict, generator, mesh=None) -> dict:
    """Random horizontal / vertical flip of cell, pose and hint directions,
    each with p = 0.5 per sample: x -> 1 - x (and/or y -> 1 - y) in
    normalized cell space, direction words remapped east<->west /
    north<->south."""
    b = batch["mask"].shape[0]
    dev = batch["mask"].device
    do_h = _rand((b,), generator, dev, mesh) < 0.5
    do_v = _rand((b,), generator, dev, mesh) < 0.5

    def flip_axis(coords, do, axis):
        flipped = coords.clone()
        flipped[..., axis] = 1.0 - coords[..., axis]
        cond = do.reshape((b,) + (1,) * (coords.ndim - 1))
        return torch.where(cond, flipped, coords)

    out = dict(batch)
    for name in ("xyz", "center", "pose_in_cell", "target"):
        if name in batch:
            out[name] = flip_axis(flip_axis(batch[name], do_h, 0), do_v, 1)
    h_map = torch.as_tensor(C.DIRECTION_H_FLIP, device=dev).long()
    v_map = torch.as_tensor(C.DIRECTION_V_FLIP, device=dev).long()
    d = batch["hint_dir"].long()
    d = torch.where(do_h[:, None], h_map[d], d)
    d = torch.where(do_v[:, None], v_map[d], d)
    out["hint_dir"] = d.to(batch["hint_dir"].dtype)
    return out


def shuffle_hints(batch: dict, generator, mesh=None) -> dict:
    """Per-sample random permutation of the hint axis, the same for every
    hint field."""
    noise = _rand(batch["hint_dir"].shape, generator, batch["hint_dir"].device, mesh)
    perm = torch.argsort(noise, dim=1)
    out = dict(batch)
    for name in ("hint_dir", "hint_color", "hint_label", "sentence_mask"):
        if name in batch:
            out[name] = torch.gather(batch[name], 1, perm)
    return out
