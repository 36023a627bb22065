"""Device-batch schemas: NamedTuples of fixed-shape tensors plus masks (port
of text2loc_tpu/data/batch.py). B = batch, O = objects per cell, P = points
per object, S = hints per pose, T = tokens per hint, E = token width."""

from __future__ import annotations

from typing import NamedTuple

import torch


class ObjectSet(NamedTuple):
    """All objects of a batch of cells, padded to O slots per cell."""

    xyz: torch.Tensor          # [B, O, P, 3] per-object point coords
    rgb: torch.Tensor          # [B, O, P, 3] per-point colours in [0, 1]
    center: torch.Tensor       # [B, O, 3]   object center, normalized cell coords
    color: torch.Tensor        # [B, O, 3]   mean rgb of the original cloud
    num_points: torch.Tensor   # [B, O]      original point count
    class_idx: torch.Tensor    # [B, O] int  class vocabulary index
    color_idx: torch.Tensor    # [B, O] int  nearest colour-centroid index
    mask: torch.Tensor         # [B, O] bool True = real object

    @property
    def batch_shape(self):
        return self.xyz.shape[:2]


class TextSet(NamedTuple):
    """A batch of hint sets embedded by the frozen text table."""

    token_embeds: torch.Tensor   # [B, S, T, E]
    token_mask: torch.Tensor     # [B, S, T] bool
    sentence_mask: torch.Tensor  # [B, S] bool (True = hint present)


class CoarseBatch(NamedTuple):
    """One training batch of the coarse retrieval model (O = object_size)."""

    objects: ObjectSet
    text: TextSet
    cell_index: torch.Tensor    # [B] int gallery index of the positive cell


class FineBatch(NamedTuple):
    """One training batch of the fine regressor (O = pad_size). `target` is
    the pose normalized in the candidate cell."""

    objects: ObjectSet
    text: TextSet
    target: torch.Tensor        # [B, 2]
    pose_in_cell: torch.Tensor  # [B, 2] ground-truth normalized pose
