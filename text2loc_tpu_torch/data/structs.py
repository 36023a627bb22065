"""Reader structs for the published KITTI360Pose pickles (the port's own
copy of text2loc_tpu/data/structs.py: Object3d, DescriptionPoseCell,
DescriptionBestCell, Pose, Cell, CompatUnpickler, load_compat_pickle).

The pickles hold the reference's object graph; these classes carry the same
attribute schema, so the pickles deserialize without the reference's code
(pickle restores instance __dict__ directly; __init__ is never called), plus
the derived values that the PMC tables need. `CompatUnpickler` maps every
"datapreparation.*" module path onto this module.
"""

from __future__ import annotations

import pickle
from typing import List, Optional

import numpy as np

from text2loc_tpu_torch import constants as C


class Object3d:
    """One instance point cloud (reference imports.py:8-83).

    Attributes as pickled: id (cell-local, == list position), instance_id,
    xyz [n, 3] (normalized in cell), rgb [n, 3], label (class string).
    """

    def __init__(self, id: int, instance_id: int, xyz: np.ndarray,
                 rgb: np.ndarray, label: str):
        self.id = id
        self.instance_id = instance_id
        self.xyz = xyz
        self.rgb = rgb
        self.label = label

    def get_color_rgb(self) -> np.ndarray:
        return np.mean(self.rgb, axis=0)

    def get_color_idx(self) -> int:
        """Nearest fitted color centroid (imports.py:33-38)."""
        d = np.linalg.norm(self.get_color_rgb() - C.COLORS, axis=1)
        return int(np.argmin(d))

    def get_color_text(self) -> str:
        return C.COLOR_NAMES[self.get_color_idx()]

    def get_center(self) -> np.ndarray:
        return np.mean(self.xyz, axis=0)

    def get_closest_point(self, anchor) -> np.ndarray:
        d = np.linalg.norm(self.xyz - np.asarray(anchor), axis=1)
        return self.xyz[int(np.argmin(d))]

    @classmethod
    def merge(cls, a: "Object3d", b: "Object3d") -> "Object3d":
        assert a.label == b.label and a.id == b.id
        return cls(a.id, a.instance_id, np.vstack((a.xyz, b.xyz)),
                   np.vstack((a.rgb, b.rgb)), a.label)

    @classmethod
    def create_padding(cls, rng: Optional[np.random.Generator] = None) -> "Object3d":
        """Padding object: tiny random 8-point cloud, label "pad"
        (imports.py:74-83)."""
        r = rng if rng is not None else np.random.default_rng()
        return cls(-1, -1, r.random((8, 3)) * 0.001, np.zeros((8, 3)), "pad")

    def __repr__(self):
        return f"Object3d({self.label}, {len(self.xyz)} pts)"


class DescriptionPoseCell:
    """One hint in pose-cell context (imports.py:86-115). Attribute schema
    only — built by the prep ETL, read from pickles."""

    object_id: int
    object_instance_id: int
    object_label: str
    object_color_rgb: np.ndarray
    object_color_text: str
    direction: str
    offset_center: np.ndarray
    offset_closest: np.ndarray
    closest_point: np.ndarray

    def __repr__(self):
        return f"Pose is {self.direction} of a {self.object_color_text} {self.object_label}"


class DescriptionBestCell:
    """One hint grounded into the best cell (imports.py:119-175)."""

    is_matched: bool

    @classmethod
    def matched(cls, d: DescriptionPoseCell, object_id: int, closest_point,
                best_offset_center, best_offset_closest) -> "DescriptionBestCell":
        out = cls()
        out.object_instance_id = d.object_instance_id
        out.object_label = d.object_label
        out.object_color_rgb = d.object_color_rgb
        out.object_color_text = d.object_color_text
        out.direction = d.direction
        out.offset_center = d.offset_center
        out.offset_closest = d.offset_closest
        out.object_id = object_id
        out.closest_point = np.asarray(closest_point)[0:2]
        out.best_offset_center = np.asarray(best_offset_center)[0:2]
        out.best_offset_closest = np.asarray(best_offset_closest)[0:2]
        out.is_matched = True
        return out

    @classmethod
    def unmatched(cls, d: DescriptionPoseCell) -> "DescriptionBestCell":
        out = cls()
        out.object_instance_id = d.object_instance_id
        out.object_label = d.object_label
        out.object_color_rgb = d.object_color_rgb
        out.object_color_text = d.object_color_text
        out.direction = d.direction
        out.offset_center = d.offset_center
        out.offset_closest = d.offset_closest
        out.closest_point = d.closest_point
        out.is_matched = False
        return out

    def __repr__(self):
        mark = "matched" if self.is_matched else "unmatched"
        return (
            f"Pose is {self.direction} of a {self.object_color_text} "
            f"{self.object_label} ({mark})"
        )


class Pose:
    """One query pose (imports.py:178-218): normalized position in its best
    cell, world position, best-cell id, grounded descriptions."""

    def __init__(self, pose_in_cell, pose_w, cell_id, scene_name,
                 descriptions: List[DescriptionBestCell], described_by=None):
        self.pose = np.asarray(pose_in_cell)
        self.pose_w = np.asarray(pose_w)
        self.cell_id = cell_id
        self.scene_name = scene_name
        self.descriptions = descriptions
        self.described_by = described_by

    def get_text(self) -> str:
        return "".join(str(d) + ". " for d in self.descriptions)

    def __repr__(self):
        return f"Pose at {self.pose_w} in {self.cell_id}"


class Cell:
    """One 30 m map cell (imports.py:221-247)."""

    def __init__(self, idx, scene_name, objects: List[Object3d], cell_size, bbox_w):
        self.scene_name = scene_name
        self.id = f"{scene_name}_{idx:05.0f}"
        self.objects = objects
        self.cell_size = cell_size
        self.bbox_w = np.asarray(bbox_w)

    def get_center(self) -> np.ndarray:
        return 0.5 * (self.bbox_w[0:3] + self.bbox_w[3:6])

    def __repr__(self):
        return f"Cell {self.id}: {len(self.objects)} objects"


_CLASSES = {
    "Object3d": Object3d,
    "DescriptionPoseCell": DescriptionPoseCell,
    "DescriptionBestCell": DescriptionBestCell,
    "Pose": Pose,
    "Cell": Cell,
}


class CompatUnpickler(pickle.Unpickler):
    """Deserialize published pickles without importing the reference.

    Maps every "datapreparation.*" module path (both the current
    "kitti360pose" name and the legacy "kitti360" alias the reference shims in
    dataloading/__init__.py:8-10) onto the reader structs above.
    """

    def find_class(self, module: str, name: str):
        if module.startswith("datapreparation.") and name in _CLASSES:
            return _CLASSES[name]
        return super().find_class(module, name)


def load_compat_pickle(path: str):
    with open(path, "rb") as f:
        return CompatUnpickler(f).load()
