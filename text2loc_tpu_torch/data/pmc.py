"""Prototype-based Map Cloning (PMC): the precomputed tables and the
train-time draw (the port's own copy of text2loc_tpu/data/pmc.py:
build_pmc_tables with its numpy rematch, and sample_pmc).

With probability `pmc_prob` a training pose swaps its best cell for one of
the 8 compass neighbours, provided (a) the pose sits within `pmc_threshold`
(normalized, per-axis max) of the neighbour's center and (b) at most
`count_threshold` of the described objects fail to re-match in the
neighbour by (label, closest-point offset agreement < 1e-7). The clone is
drawn with inverse-square-distance weights, and the hints are re-matched
against the clone's objects.

The rematch is a pure function of static geometry, so it is computed once
per (pose, neighbour) into three arrays (pmc_valid / pmc_weight / pmc_match
on SceneArrays); the per-batch draw is a categorical draw and an integer
gather. The regression target in the cloned cell follows from
gather_fine's bbox arithmetic.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from text2loc_tpu_torch.constants import NEIGHBOR_KEYS
from text2loc_tpu_torch.data.structs import Cell, Pose


def _rematch(pose_w: np.ndarray, cell: Cell, descriptions,
             atol: float = 1e-7) -> List[int]:
    """Greedy hint -> object rematch in a candidate cell: a slot index per
    description, -1 where nothing matched. In description order, the first
    label-equal object (in storage order) whose closest-point offset agrees
    within `atol` wins; objects are not reused."""
    width = float(cell.bbox_w[3] - cell.bbox_w[0])
    new_pose = (np.asarray(pose_w) - np.asarray(cell.bbox_w[:3])) / width
    out: List[int] = []
    used = set()
    for d in descriptions:
        target = np.asarray(d.offset_closest, np.float64)[:2]
        hit = -1
        for oi, obj in enumerate(cell.objects):
            if obj.label != d.object_label or oi in used:
                continue
            cp = obj.get_closest_point(new_pose)
            off = (new_pose - cp)[:2]
            if np.linalg.norm(target - off) < atol:
                hit = oi
                used.add(oi)
                break
        out.append(hit)
    return out


def build_pmc_tables(
    cells: Sequence[Cell],
    poses: Sequence[Pose],
    neighbors_json: Dict,
    num_mentioned: int = 6,
    pmc_threshold: float = 0.4,
    count_threshold: int = 1,
    object_slots: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(valid [N, 8], weight [N, 8], match [N, 8, S]) for every pose.

    * candidate gate: per-axis max normalized distance < pmc_threshold and
      unmatched count <= count_threshold;
    * weight: 1 / (euclidean normalized distance)^2 (normalized over the
      valid set at sampling time).

    `object_slots` (0 = unbounded): matches beyond the dataset's per-cell
    slot cap cannot be gathered, so they are dropped to -1 before the
    count_threshold gate.
    """
    n, s = len(poses), num_mentioned
    cell_index = {c.id: i for i, c in enumerate(cells)}
    valid = np.zeros((n, 8), bool)
    weight = np.zeros((n, 8), np.float32)
    match = np.full((n, 8, s), -1, np.int32)
    for pi, pose in enumerate(poses):
        mapping = neighbors_json.get(pose.cell_id)
        if mapping is None:
            continue
        descrs = pose.descriptions[:s]
        for ki, key in enumerate(NEIGHBOR_KEYS):
            nid = mapping.get(key)
            if nid is None or nid not in cell_index:
                continue
            cell = cells[cell_index[nid]]
            width = float(cell.bbox_w[3] - cell.bbox_w[0])
            center = cell.get_center()[:2]
            delta = (np.asarray(pose.pose_w[:2]) - center) / width
            if np.max(np.abs(delta)) >= pmc_threshold:
                continue
            slots = _rematch(pose.pose_w, cell, descrs)
            if object_slots:
                slots = [x if 0 <= x < object_slots else -1 for x in slots]
            if sum(1 for x in slots if x < 0) > count_threshold:
                continue
            valid[pi, ki] = True
            weight[pi, ki] = 1.0 / max(float(np.linalg.norm(delta)) ** 2, 1e-12)
            # Short hint lists leave the trailing slots at -1.
            match[pi, ki, : len(slots)] = slots
    return valid, weight, match


def sample_pmc(
    data,
    pose_indices: np.ndarray,
    rng: np.random.Generator,
    pmc_prob: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """The train-time PMC draw for a batch of poses.

    Returns (cell_indices [B] global, hint_obj_idx [B, S]): the cell each
    pose trains against this step and the matching for the matched-first
    object order. Poses that do not clone (probability, no valid candidate,
    or no tables) keep their best cell and their own matching.
    """
    pi = np.asarray(pose_indices)
    b = len(pi)
    cell_idx = data.pose_cell_idx[pi].copy()
    hint_obj = data.hint_obj_idx[pi].copy()
    if pmc_prob <= 0.0 or data.pmc_valid is None or data.cell_neighbors is None:
        return cell_idx, hint_obj

    clone = rng.random(b) < pmc_prob
    valid = data.pmc_valid[pi]                      # [B, 8]
    weight = np.where(valid, data.pmc_weight[pi], 0.0)
    wsum = weight.sum(axis=1)
    ok = clone & (wsum > 0)
    for i in np.nonzero(ok)[0]:
        p = weight[i] / wsum[i]
        ki = int(rng.choice(8, p=p))
        nb = data.cell_neighbors[data.pose_cell_idx[pi[i]], ki]
        if nb < 0:
            continue
        cell_idx[i] = nb
        hint_obj[i] = data.pmc_match[pi[i], ki]
    return cell_idx, hint_obj
