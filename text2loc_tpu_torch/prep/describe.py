"""Pose descriptions and grounding (the port of text2loc_tpu/prep/describe.py:
direction_word, get_direction, get_direction_no_ontop, select_objects,
describe_pose_in_pose_cell, ground_pose_to_best_cell).

The closest-point queries run on the device, one pass over a cell's points
per pose (cells.CellPoints.closest_points). Everything after them is the
JAX package's numpy on the host, over at most a cell's objects:

* the direction word of the pose-minus-closest-point offset; "on-top"
  within 0.05; later conditions of the if-chain overwrite earlier ones, so
  south / north win axis ties;
* candidates within 0.5 (normalized) of the pose;
* the strategies closest / direction / class / random (round-robin over
  direction or class buckets in first-seen order);
* grounding into the best cell by instance id and the nearest closest-point
  offset, within sqrt(2) / 2, greedily without reuse.

Only the objects a description names are copied to the host (their mean
colour and centre are numpy means, as in the JAX package).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from text2loc_tpu_torch.data.structs import (
    DescriptionBestCell,
    DescriptionPoseCell,
    Object3d,
)
from text2loc_tpu_torch.prep.cells import CellPoints


def direction_word(offset_xy: np.ndarray, on_top_threshold: float = 0.05) -> str:
    ox, oy = float(offset_xy[0]), float(offset_xy[1])
    if np.hypot(ox, oy) < on_top_threshold:
        return "on-top"
    word = None
    if abs(ox) >= abs(oy) and ox >= 0:
        word = "east"
    if abs(ox) >= abs(oy) and ox <= 0:
        word = "west"
    if abs(ox) <= abs(oy) and oy >= 0:
        word = "north"
    if abs(ox) <= abs(oy) and oy <= 0:
        word = "south"
    return word


def get_direction(obj: Object3d, pose: np.ndarray) -> str:
    cp = obj.get_closest_point(pose)
    return direction_word((np.asarray(pose) - cp)[:2])


def get_direction_no_ontop(obj: Object3d, pose: np.ndarray) -> str:
    """Centre-based direction word without "on-top": the offset is the pose
    minus the object's centre."""
    offset = np.asarray(pose)[:2] - obj.get_center()[:2]
    return direction_word(offset, on_top_threshold=0.0)


def _select(labels: Sequence[str], closest: np.ndarray, pose: np.ndarray,
            num_mentioned: int, select_by: str,
            rng: Optional[np.random.Generator] = None) -> List[int]:
    """Positions picked by a strategy, over objects given by their labels and
    their closest points to the pose."""
    if select_by == "closest":
        dists = np.array([np.linalg.norm(cp - np.asarray(pose)) for cp in closest])
        return list(np.argsort(dists)[:num_mentioned])
    if select_by == "random":
        r = rng if rng is not None else np.random.default_rng()
        return list(r.choice(len(labels), size=num_mentioned, replace=False))
    if select_by in ("direction", "class"):
        key_of = (
            (lambda i: direction_word((np.asarray(pose) - closest[i])[:2]))
            if select_by == "direction"
            else (lambda i: labels[i])
        )
        buckets = {}
        for i in range(len(labels)):
            buckets.setdefault(key_of(i), []).append(i)
        picked: List[int] = []
        offset = 0
        while len(picked) < num_mentioned:
            for key in buckets:
                if len(buckets[key]) > offset:
                    picked.append(buckets[key][offset])
            offset += 1
        return picked[:num_mentioned]
    raise ValueError(select_by)


def select_objects(objects: Sequence[Object3d], pose: np.ndarray,
                   num_mentioned: int, select_by: str,
                   rng: Optional[np.random.Generator] = None) -> List[Object3d]:
    """The four selection strategies over host objects (the prep itself
    selects through `_select` with the device's closest points)."""
    closest = np.array([o.get_closest_point(pose) for o in objects])
    picked = _select([o.label for o in objects], closest, pose, num_mentioned, select_by, rng)
    return [objects[i] for i in picked]


def describe_pose_in_pose_cell(
    pose_w: np.ndarray,
    cell: CellPoints,
    select_by: str,
    num_mentioned: int,
    max_dist: float = 0.5,
    no_ontop: bool = False,
) -> Optional[List[DescriptionPoseCell]]:
    """Hints for a pose in its pose cell; None when fewer than num_mentioned
    objects are in range. `no_ontop` takes the centre-based direction word;
    the offsets stay closest-point-based."""
    pose = (np.asarray(pose_w) - cell.bbox_w[0:3]) / cell.cell_size
    closest = cell.closest_points(pose)
    dists = np.array([np.linalg.norm(cp - pose) for cp in closest])
    candidates = np.nonzero(dists <= max_dist)[0]
    if len(candidates) < num_mentioned:
        return None
    picked = _select([cell.labels[i] for i in candidates], closest[candidates], pose,
                     num_mentioned, select_by)

    out = []
    for i in candidates[picked]:
        obj, cp = cell.object(int(i)), closest[i]
        d = DescriptionPoseCell()
        d.object_id = obj.id
        d.object_instance_id = obj.instance_id
        d.object_label = obj.label
        d.object_color_rgb = obj.get_color_rgb()
        d.object_color_text = obj.get_color_text()
        d.direction = (
            get_direction_no_ontop(obj, pose)
            if no_ontop
            else direction_word((pose - cp)[:2])
        )
        d.offset_center = (pose - obj.get_center())[:2]
        d.offset_closest = (pose - cp)[:2]
        d.closest_point = cp[:2]
        out.append(d)
    return out


def ground_pose_to_best_cell(
    pose_w: np.ndarray,
    descriptions: Sequence[DescriptionPoseCell],
    cell: CellPoints,
    offset_tolerance: float = np.sqrt(2) / 2,
) -> Tuple[List[DescriptionBestCell], np.ndarray, int]:
    """Re-match pose-cell descriptions into the best cell. Returns
    (grounded, normalized pose, unmatched count)."""
    assert np.all(pose_w >= cell.bbox_w[0:3]) and np.all(pose_w <= cell.bbox_w[3:6])
    pose = (np.asarray(pose_w) - cell.bbox_w[0:3]) / cell.cell_size
    closest = cell.closest_points(pose)

    grounded: List[DescriptionBestCell] = []
    used = set()
    unmatched = 0
    for d in descriptions:
        cands = [i for i in range(len(cell))
                 if cell.instance_ids[i] == d.object_instance_id and i not in used]
        if not cands:
            grounded.append(DescriptionBestCell.unmatched(d))
            unmatched += 1
            continue
        offs = np.array([(pose - closest[c])[:2] for c in cands])
        best = int(np.argmin(np.linalg.norm(offs - d.offset_closest, axis=1)))
        if np.linalg.norm(d.offset_closest - offs[best]) > offset_tolerance:
            grounded.append(DescriptionBestCell.unmatched(d))
            unmatched += 1
            continue
        obj = cell.object(cands[best])
        used.add(obj.id)
        cp = closest[cands[best]]
        grounded.append(
            DescriptionBestCell.matched(
                d, obj.id, cp, pose - obj.get_center(), pose - cp
            )
        )
    return grounded, pose, unmatched
