"""Pose creation: sample, describe, ground, dedup (the port of
text2loc_tpu/prep/poses.py: create_poses).

Per sampled location: a random integer shift below cell_size / 2.1 drawn
from the caller's generator (as in the JAX package, so the draws are
equal), the nearest database cell as best cell (skipped beyond
cell_size / 2), a pose cell centred on the pose built on the device
(cells.create_cell over the scene's packed points), the description
strategies, grounding into the best cell, and no two poses of a location
with the same matched-mention set.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from text2loc_tpu_torch.data.structs import Pose
from text2loc_tpu_torch.prep.cells import CellPoints, ScenePoints, create_cell
from text2loc_tpu_torch.prep.describe import (
    describe_pose_in_pose_cell,
    ground_pose_to_best_cell,
)


def create_poses(
    scene: ScenePoints,
    locations: Sequence[np.ndarray],
    cells: Sequence[CellPoints],
    cell_size: float,
    num_mentioned: int = 6,
    describe_by: str = "all",
    pose_count: int = 1,
    shift_poses: bool = True,
    describe_best_cell: bool = False,
    no_ontop: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> List[Pose]:
    rng = rng if rng is not None else np.random.default_rng()
    locations = np.asarray(locations, np.float64)
    if pose_count > 1:
        assert shift_poses, "pose_count > 1 requires shift_poses"
        locations = np.repeat(locations, pose_count, axis=0)

    centers = np.array([0.5 * (c.bbox_w[0:3] + c.bbox_w[3:6]) for c in cells])
    methods = ("closest", "class", "direction") if describe_by == "all" else (describe_by,)

    poses: List[Pose] = []
    for loc in locations:
        loc = loc.copy()
        if shift_poses:
            loc[0:2] += np.floor(rng.random(2) * cell_size / 2.1)

        dists = np.linalg.norm(loc - centers, axis=1)
        best_cell = cells[int(np.argmin(dists))]
        if dists.min() > cell_size / 2:
            continue

        pose_cell_bbox = np.hstack([loc - cell_size / 2, loc + cell_size / 2])
        pose_cell = create_cell(
            -1, "pose", pose_cell_bbox, scene, num_mentioned=num_mentioned
        )
        if pose_cell is None:
            continue

        mentioned_sets = []
        for method in methods:
            describe_cell = best_cell if describe_best_cell else pose_cell
            descrs = describe_pose_in_pose_cell(
                loc, describe_cell, method, num_mentioned, no_ontop=no_ontop
            )
            if descrs is None or len(descrs) < num_mentioned:
                break  # no other strategy either
            grounded, pose_in_cell, _ = ground_pose_to_best_cell(
                loc, descrs, best_cell
            )
            mentioned = sorted(d.object_id for d in grounded if d.is_matched)
            if mentioned in mentioned_sets:
                continue  # the same mention set as an earlier strategy
            mentioned_sets.append(mentioned)
            poses.append(
                Pose(pose_in_cell, loc, best_cell.id, best_cell.scene_name,
                     grounded, described_by=method)
            )
    return poses
