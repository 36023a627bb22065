"""Scene data as fixed-shape numpy arrays (the port's own copy of
text2loc_tpu/data/arrays.py: SceneArrays with its PMC fields and its npz
round trip, fill_padding_slots and the batch gathers of MultiSceneArrays that the
port's serve and trainers call).

Shapes: C cells, O object slots per cell, P stored points per object,
N poses, S hints per pose. Padding object slots carry the reference's
padding-object content: a tiny random cloud (x0.001), zero rgb, class "pad",
nearest colour "black", 8 points.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from text2loc_tpu_torch import constants as C


@dataclass
class SceneArrays:
    scene_name: str
    cell_ids: List[str]          # len C, "{scene}_{idx:05d}"
    cell_bbox: np.ndarray        # [C, 6] world bbox (xmin ymin zmin xmax ymax zmax)
    cell_size: np.ndarray        # [C]
    obj_xyz: np.ndarray          # [C, O, P, 3] normalized-in-cell coords
    obj_rgb: np.ndarray          # [C, O, P, 3]
    obj_center: np.ndarray       # [C, O, 3]
    obj_color: np.ndarray        # [C, O, 3] mean rgb of the original cloud
    obj_num_points: np.ndarray   # [C, O] original point counts (float32)
    obj_class: np.ndarray        # [C, O] int32
    obj_color_idx: np.ndarray    # [C, O] int32
    obj_mask: np.ndarray         # [C, O] bool
    pose_cell_idx: np.ndarray    # [N] int32 (best cell, scene-local index)
    pose_w: np.ndarray           # [N, 3] world coords
    pose_in_cell: np.ndarray     # [N, 2] normalized pose in its best cell
    hint_dir: np.ndarray         # [N, S] int32 direction vocabulary index
    hint_color: np.ndarray       # [N, S] int32
    hint_label: np.ndarray       # [N, S] int32
    hint_obj_idx: np.ndarray     # [N, S] int32 object slot in best cell, -1 unmatched
    hint_matched: np.ndarray     # [N, S] bool
    offset_center: np.ndarray    # [N, S, 2]
    offset_closest: np.ndarray   # [N, S, 2]
    best_offset_center: np.ndarray   # [N, S, 2]
    best_offset_closest: np.ndarray  # [N, S, 2]
    # PMC: the compass neighbour table ([C, 8] scene-local cell indices in
    # constants.NEIGHBOR_KEYS order, -1 = none) and the precomputed tables
    # of data/pmc.py; axis 1 indexes the 8 neighbour slots of the pose's
    # best cell. None: no PMC.
    cell_neighbors: Optional[np.ndarray] = None
    pmc_valid: Optional[np.ndarray] = None   # [N, 8] bool: clone candidate ok
    pmc_weight: Optional[np.ndarray] = None  # [N, 8] f32: 1/dist^2 sampling weight
    pmc_match: Optional[np.ndarray] = None   # [N, 8, S] int32: re-matched slots, -1
    hint_mask: Optional[np.ndarray] = None   # [N, S] bool; None = all real

    def __post_init__(self):
        if self.hint_mask is None:
            self.hint_mask = np.ones(self.hint_dir.shape, dtype=bool)

    @property
    def num_cells(self) -> int:
        return len(self.cell_ids)

    @property
    def num_poses(self) -> int:
        return self.pose_w.shape[0]

    def save_npz(self, path: str):
        arrays = dataclasses.asdict(self)
        arrays["cell_ids"] = np.array(self.cell_ids)
        for name in ("cell_neighbors", "pmc_valid", "pmc_weight", "pmc_match"):
            if arrays[name] is None:
                del arrays[name]
        np.savez_compressed(path, **arrays)

    @classmethod
    def load_npz(cls, path: str) -> "SceneArrays":
        with np.load(path, allow_pickle=False) as f:
            data = {k: f[k] for k in f.files}
        data["scene_name"] = str(data["scene_name"])
        data["cell_ids"] = [str(x) for x in data["cell_ids"]]
        return cls(**data)


def fill_padding_slots(scene: SceneArrays, rng: np.random.Generator) -> SceneArrays:
    """Write reference-style padding-object content into invalid object slots."""
    p = scene.obj_xyz.shape[2]
    pad = ~scene.obj_mask
    n_pad = int(pad.sum())
    if n_pad == 0:
        return scene
    pad_xyz = rng.random((n_pad, p, 3), dtype=np.float32) * 0.001
    scene.obj_xyz[pad] = pad_xyz
    scene.obj_rgb[pad] = 0.0
    scene.obj_center[pad] = pad_xyz.mean(axis=1)
    scene.obj_color[pad] = 0.0
    scene.obj_num_points[pad] = 8.0
    scene.obj_class[pad] = C.PAD_CLASS_INDEX
    # Nearest colour centroid to rgb (0, 0, 0) is "black".
    scene.obj_color_idx[pad] = int(np.argmin(np.linalg.norm(C.COLORS, axis=1)))
    return scene


_POSE_FIELDS = ("pose_w", "pose_in_cell", "hint_dir", "hint_color", "hint_label",
                "hint_obj_idx", "hint_matched", "hint_mask", "offset_center",
                "offset_closest", "best_offset_center", "best_offset_closest")


class MultiSceneArrays:
    """Concatenation of scenes with a global cell gallery (globally unique
    cell indices; pose cell indices re-based to it)."""

    def __init__(self, scenes: Sequence[SceneArrays]):
        if not scenes:
            raise ValueError("MultiSceneArrays needs at least one scene")
        self.scenes = list(scenes)
        self.cell_ids: List[str] = []
        scene_of_cell: List[int] = []
        offsets = []
        off = 0
        for si, s in enumerate(self.scenes):
            offsets.append(off)
            self.cell_ids.extend(s.cell_ids)
            scene_of_cell.extend([si] * s.num_cells)
            off += s.num_cells
        if len(set(self.cell_ids)) != len(self.cell_ids):
            raise ValueError("cell ids must be unique")

        def cat(name):
            return np.concatenate([getattr(s, name) for s in self.scenes], axis=0)

        self.cell_bbox = cat("cell_bbox")
        self.cell_size = cat("cell_size")
        self.obj_xyz = cat("obj_xyz")
        self.obj_rgb = cat("obj_rgb")
        self.obj_center = cat("obj_center")
        self.obj_color = cat("obj_color")
        self.obj_num_points = cat("obj_num_points")
        self.obj_class = cat("obj_class")
        self.obj_color_idx = cat("obj_color_idx")
        self.obj_mask = cat("obj_mask")
        self.cell_scene_idx = np.array(scene_of_cell, dtype=np.int32)
        self.pose_cell_idx = np.concatenate(
            [s.pose_cell_idx + offsets[si] for si, s in enumerate(self.scenes)]
        ).astype(np.int32)
        self.pose_scene_idx = np.concatenate(
            [np.full(s.num_poses, si, np.int32) for si, s in enumerate(self.scenes)])
        for name in _POSE_FIELDS:
            setattr(self, name, cat(name))
        # PMC: the neighbour table re-based to global cell indices; the
        # tables' slots are cell-local and need no re-basing.
        self.cell_neighbors = None
        if all(s.cell_neighbors is not None for s in self.scenes):
            self.cell_neighbors = np.concatenate([
                np.where(s.cell_neighbors >= 0, s.cell_neighbors + offsets[si], -1)
                for si, s in enumerate(self.scenes)], axis=0).astype(np.int32)
        self.pmc_valid = self.pmc_weight = self.pmc_match = None
        if all(s.pmc_valid is not None for s in self.scenes):
            self.pmc_valid = cat("pmc_valid")
            self.pmc_weight = cat("pmc_weight")
            self.pmc_match = cat("pmc_match")

    @property
    def num_cells(self) -> int:
        return len(self.cell_ids)

    @property
    def num_poses(self) -> int:
        return self.pose_w.shape[0]

    @property
    def object_slots(self) -> int:
        return self.obj_xyz.shape[1]

    @property
    def stored_points(self) -> int:
        return self.obj_xyz.shape[2]

    def gather_cell_objects(self, cell_indices, o_cap: int) -> Dict[str, np.ndarray]:
        """Object arrays of the given cells, truncated to `o_cap` slots (slots
        are stored real objects first, so a slice is the truncation)."""
        ci = np.asarray(cell_indices)
        if o_cap > self.object_slots:
            raise ValueError(f"o_cap {o_cap} > {self.object_slots} stored slots")
        return {
            "xyz": self.obj_xyz[ci, :o_cap],
            "rgb": self.obj_rgb[ci, :o_cap],
            "center": self.obj_center[ci, :o_cap],
            "color": self.obj_color[ci, :o_cap],
            "num_points": self.obj_num_points[ci, :o_cap],
            "class_idx": self.obj_class[ci, :o_cap],
            "color_idx": self.obj_color_idx[ci, :o_cap],
            "mask": self.obj_mask[ci, :o_cap],
        }

    @property
    def cell_centers(self) -> np.ndarray:
        """[C, 2] world-frame cell centers (bbox midpoints)."""
        return 0.5 * (self.cell_bbox[:, 0:2] + self.cell_bbox[:, 3:5])

    def close_cells(self, pose_idx: int) -> np.ndarray:
        """Cells of the pose's scene whose center is within cell_size/2."""
        d = np.linalg.norm(self.cell_centers - self.pose_w[pose_idx, :2], axis=1)
        ok = (d <= self.cell_size / 2) & (
            self.cell_scene_idx == self.pose_scene_idx[pose_idx])
        return np.nonzero(ok)[0]

    def gather_coarse(self, pose_indices, object_size: int,
                      sample_close_rng: Optional[np.random.Generator] = None,
                      negative_rng: Optional[np.random.Generator] = None,
                      ) -> Dict[str, np.ndarray]:
        """Per-pose coarse sample: positive cell objects + hint triples. With
        `sample_close_rng` the positive is a random close cell; with
        `negative_rng` each sample also carries a uniformly random other cell
        under `neg_*` keys (the triplet loss's negative)."""
        pi = np.asarray(pose_indices)
        cells = self.pose_cell_idx[pi]
        if sample_close_rng is not None:
            cells = cells.copy()
            for i, p in enumerate(pi):
                cand = self.close_cells(int(p))
                if len(cand):
                    cells[i] = cand[sample_close_rng.integers(len(cand))]
        out = self.gather_cell_objects(cells, object_size)
        if negative_rng is not None:
            if self.num_cells < 2:
                raise ValueError("triplet negatives need >= 2 cells")
            neg = negative_rng.integers(0, self.num_cells - 1, size=len(pi)).astype(np.int32)
            neg = np.where(neg >= cells, neg + 1, neg)
            out.update({f"neg_{k}": v for k, v in
                        self.gather_cell_objects(neg, object_size).items()})
            out["neg_cell_index"] = neg
        out.update(
            cell_index=cells.astype(np.int32),
            hint_dir=self.hint_dir[pi],
            hint_color=self.hint_color[pi],
            hint_label=self.hint_label[pi],
            sentence_mask=self.hint_mask[pi],
            pose_in_cell=self.pose_in_cell[pi],
            pose_w=self.pose_w[pi],
        )
        return out

    def fine_object_order(self, pose_indices, cell_indices, pad_size: int,
                          hint_obj_idx: Optional[np.ndarray] = None) -> np.ndarray:
        """[B, pad_size] slot order for the fine stage: the matched objects in
        hint order (in range, without repeats) first, then the other slots
        in storage order. `hint_obj_idx` ([B, S]) replaces the poses' own
        matches; `cell_indices` is unused, as in the JAX package."""
        matched_src = (self.hint_obj_idx[np.asarray(pose_indices)]
                       if hint_obj_idx is None else np.asarray(hint_obj_idx))
        o = self.object_slots
        order = np.zeros((len(matched_src), pad_size), dtype=np.int32)
        for i, row in enumerate(matched_src):
            matched, seen = [], set()
            for m in row:
                m = int(m)
                if 0 <= m < o and m not in seen:
                    matched.append(m)
                    seen.add(m)
            full = (matched + [j for j in range(o) if j not in seen])[:pad_size]
            full += [o - 1] * (pad_size - len(full))
            order[i] = full
        return order

    def fine_offset_targets(self, pose_indices, regressor_cell: str = "pose",
                            regressor_learn: str = "center") -> np.ndarray:
        """Legacy per-hint offset targets [B, S, 2]: the offsets within the
        pose's cell ("pose"), or within the best cell with the pose cell's
        for unmatched hints ("best"), to the object's center or closest
        point (`regressor_learn`). The published config trains on the
        absolute pose instead (gather_fine's `target`)."""
        if regressor_learn not in ("center", "closest"):
            raise ValueError(f"regressor_learn {regressor_learn!r}")
        if regressor_cell not in ("pose", "best"):
            raise ValueError(f"regressor_cell {regressor_cell!r}")
        pi = np.asarray(pose_indices)
        pose_arr = (self.offset_center if regressor_learn == "center"
                    else self.offset_closest)[pi]
        if regressor_cell == "pose":
            return pose_arr.astype(np.float32)
        best_arr = (self.best_offset_center if regressor_learn == "center"
                    else self.best_offset_closest)[pi]
        return np.where(self.hint_matched[pi][..., None], best_arr,
                        pose_arr).astype(np.float32)

    def gather_fine(self, pose_indices, pad_size: int, cell_indices=None,
                    hint_obj_idx: Optional[np.ndarray] = None,
                    match_first: bool = True) -> Dict[str, np.ndarray]:
        """Per-pose fine sample against its best cell (or the given
        `cell_indices`), matched objects first. `match_first=False` keeps
        the plain storage order truncated to pad_size: the evaluation order
        against retrieved cells, which have no matching. `target` is the pose
        normalized in the cell (both axes by the scalar cell size)."""
        pi = np.asarray(pose_indices)
        ci = self.pose_cell_idx[pi] if cell_indices is None else np.asarray(cell_indices)
        if match_first:
            order = self.fine_object_order(pi, ci, pad_size, hint_obj_idx=hint_obj_idx)
        else:
            order = np.broadcast_to(np.arange(pad_size, dtype=np.int32),
                                    (len(pi), pad_size))
        cc = ci[:, None]
        out = {
            "xyz": self.obj_xyz[cc, order],
            "rgb": self.obj_rgb[cc, order],
            "center": self.obj_center[cc, order],
            "color": self.obj_color[cc, order],
            "num_points": self.obj_num_points[cc, order],
            "class_idx": self.obj_class[cc, order],
            "color_idx": self.obj_color_idx[cc, order],
            "mask": self.obj_mask[cc, order],
        }
        bbox = self.cell_bbox[ci]
        size = np.maximum(self.cell_size[ci], 1e-9)
        target = np.stack([(self.pose_w[pi, 0] - bbox[:, 0]) / size,
                           (self.pose_w[pi, 1] - bbox[:, 1]) / size],
                          axis=-1).astype(np.float32)
        out.update(
            cell_index=ci.astype(np.int32),
            hint_dir=self.hint_dir[pi],
            hint_color=self.hint_color[pi],
            hint_label=self.hint_label[pi],
            sentence_mask=self.hint_mask[pi],
            target=target,
            pose_in_cell=self.pose_in_cell[pi].astype(np.float32),
            pose_w=self.pose_w[pi],
        )
        return out
