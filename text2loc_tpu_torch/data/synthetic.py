"""Synthetic KITTI360Pose-like scenes (the port's own copy of
text2loc_tpu/data/synthetic.py: make_scene). The same seed gives the same
arrays as the JAX package's make_scene (tests/test_torch_port_data.py).

Grid-laid 30 m cells, per-cell object sets with cluster point clouds, and
poses described by their `num_mentioned` closest objects with the
reference's direction rule and hint template.
"""

from __future__ import annotations

import numpy as np

from text2loc_tpu_torch import constants as C
from text2loc_tpu_torch.data.arrays import SceneArrays, fill_padding_slots


def direction_index(offset_xy: np.ndarray) -> int:
    """Compass word from a pose-minus-closest-point offset. Later conditions
    win, as in the reference's if-chain (south/north over east/west)."""
    if np.linalg.norm(offset_xy[:2]) < 0.05:
        return C.DIRECTION_TO_INDEX["on-top"]
    x, y = float(offset_xy[0]), float(offset_xy[1])
    d = None
    if abs(x) >= abs(y) and x >= 0:
        d = "east"
    if abs(x) >= abs(y) and x <= 0:
        d = "west"
    if abs(x) <= abs(y) and y >= 0:
        d = "north"
    if abs(x) <= abs(y) and y <= 0:
        d = "south"
    return C.DIRECTION_TO_INDEX[d]


def make_scene(scene_name: str = "0000", num_cells: int = 12, num_poses: int = 24,
               object_slots: int = 12, num_points: int = 32, num_mentioned: int = 3,
               cell_size: float = 30.0, min_objects: int = 4, seed: int = 0,
               pose_seed=None) -> SceneArrays:
    """`pose_seed`: draw the poses from a separate stream while keeping the
    cells equal to a call with the same `seed` (a held-out query split)."""
    rng = np.random.default_rng(seed)
    o, p, s = object_slots, num_points, num_mentioned
    n_grid = int(np.ceil(np.sqrt(num_cells)))

    cell_ids = [f"{scene_name}_{i:05d}" for i in range(num_cells)]
    cell_bbox = np.zeros((num_cells, 6), np.float32)
    for i in range(num_cells):
        x0, y0 = (i % n_grid) * cell_size, (i // n_grid) * cell_size
        cell_bbox[i] = (x0, y0, 0.0, x0 + cell_size, y0 + cell_size, cell_size)

    obj_xyz = np.zeros((num_cells, o, p, 3), np.float32)
    obj_rgb = np.zeros((num_cells, o, p, 3), np.float32)
    obj_center = np.zeros((num_cells, o, 3), np.float32)
    obj_color = np.zeros((num_cells, o, 3), np.float32)
    obj_num = np.zeros((num_cells, o), np.float32)
    obj_class = np.zeros((num_cells, o), np.int32)
    obj_color_idx = np.zeros((num_cells, o), np.int32)
    obj_mask = np.zeros((num_cells, o), bool)

    non_pad_classes = [i for i in range(C.NUM_CLASSES) if i != C.PAD_CLASS_INDEX]
    for ci in range(num_cells):
        n_real = int(rng.integers(min_objects, o + 1))
        for oi in range(n_real):
            center = rng.uniform(0.05, 0.95, size=3).astype(np.float32)
            center[2] = rng.uniform(0.0, 0.3)
            spread = rng.uniform(0.02, 0.15)
            pts = center + rng.normal(0, spread, size=(p, 3)).astype(np.float32)
            pts = np.clip(pts, 0.0, 1.0)
            col_idx = int(rng.integers(0, C.NUM_COLORS))
            col = np.clip(C.COLORS[col_idx] + rng.normal(0, 0.02, size=3),
                          0.0, 1.0).astype(np.float32)
            obj_xyz[ci, oi] = pts
            obj_rgb[ci, oi] = col + rng.normal(0, 0.01, size=(p, 3)).astype(np.float32)
            obj_center[ci, oi] = pts.mean(axis=0)
            obj_color[ci, oi] = col
            obj_num[ci, oi] = float(rng.integers(50, 8000))
            obj_class[ci, oi] = int(rng.choice(non_pad_classes))
            obj_color_idx[ci, oi] = int(np.argmin(np.linalg.norm(col - C.COLORS, axis=1)))
            obj_mask[ci, oi] = True

    if pose_seed is not None:
        rng = np.random.default_rng(pose_seed)
    pose_cell_idx = rng.integers(0, num_cells, size=num_poses).astype(np.int32)
    pose_in_cell = rng.uniform(0.1, 0.9, size=(num_poses, 2)).astype(np.float32)
    pose_w = np.zeros((num_poses, 3), np.float32)
    hint_dir = np.zeros((num_poses, s), np.int32)
    hint_color = np.zeros((num_poses, s), np.int32)
    hint_label = np.zeros((num_poses, s), np.int32)
    hint_obj_idx = np.full((num_poses, s), -1, np.int32)
    hint_matched = np.zeros((num_poses, s), bool)
    offset_center = np.zeros((num_poses, s, 2), np.float32)
    offset_closest = np.zeros((num_poses, s, 2), np.float32)

    for pi in range(num_poses):
        ci = int(pose_cell_idx[pi])
        pose = pose_in_cell[pi]
        pose_w[pi, :2] = cell_bbox[ci, :2] + pose * cell_size
        pose3 = np.array([pose[0], pose[1], 0.0], np.float32)
        valid = np.where(obj_mask[ci])[0]
        closest_pts = np.zeros((len(valid), 3), np.float32)
        for j, oi in enumerate(valid):
            d = np.linalg.norm(obj_xyz[ci, oi] - pose3, axis=1)
            closest_pts[j] = obj_xyz[ci, oi, int(np.argmin(d))]
        dists = np.linalg.norm(closest_pts - pose3, axis=1)
        chosen = valid[np.argsort(dists)][:s]
        for k, oi in enumerate(chosen):
            off_closest = pose3 - closest_pts[np.where(valid == oi)[0][0]]
            off_center = pose3 - obj_center[ci, oi]
            hint_dir[pi, k] = direction_index(off_closest[:2])
            hint_color[pi, k] = obj_color_idx[ci, oi]
            hint_label[pi, k] = obj_class[ci, oi]
            hint_obj_idx[pi, k] = oi
            hint_matched[pi, k] = True
            offset_center[pi, k] = off_center[:2]
            offset_closest[pi, k] = off_closest[:2]

    scene = SceneArrays(
        scene_name=scene_name, cell_ids=cell_ids, cell_bbox=cell_bbox,
        cell_size=np.full((num_cells,), cell_size, np.float32),
        obj_xyz=obj_xyz, obj_rgb=obj_rgb, obj_center=obj_center, obj_color=obj_color,
        obj_num_points=obj_num, obj_class=obj_class, obj_color_idx=obj_color_idx,
        obj_mask=obj_mask, pose_cell_idx=pose_cell_idx, pose_w=pose_w,
        pose_in_cell=pose_in_cell, hint_dir=hint_dir, hint_color=hint_color,
        hint_label=hint_label, hint_obj_idx=hint_obj_idx, hint_matched=hint_matched,
        # Synthetic hints are all matched: the matched flags are the
        # valid-sentence mask (a cell with fewer objects gives fewer hints).
        hint_mask=hint_matched.copy(),
        offset_center=offset_center, offset_closest=offset_closest,
        best_offset_center=offset_center.copy(),
        best_offset_closest=offset_closest.copy(),
    )
    return fill_padding_slots(scene, rng)
