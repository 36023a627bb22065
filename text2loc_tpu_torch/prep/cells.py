"""Cells and locations on the device (the port of text2loc_tpu/prep/cells.py:
create_locations, get_close_locations, create_cell with its bbox crop and
DBSCAN pseudo-instances, create_cells with the shifted and grid layouts).

The scene's objects are packed once on the device (`ScenePoints`: every
point in float64, its object's index, each object's range). A cell is one
pass over that pack: the in-box mask, the per-object in-box counts as a
segmented sum, the DBSCAN of every stuff crop of the cell in one call
(prep/dbscan.py), and one gather that puts the cell's points in the
reference's object order (scene order, a stuff object's pseudo-instances in
cluster order). Its points stay on the device, normalized, in a
`CellPoints`, which answers the closest-point queries of description and
grounding and becomes the pickled `Cell` with one copy to the host.

The decisions over objects (thresholds, the greedy location sampling) are
the JAX package's expressions on the host.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from text2loc_tpu_torch import constants as C
from text2loc_tpu_torch.data.structs import Cell, Object3d
from text2loc_tpu_torch.prep.dbscan import dbscan
from text2loc_tpu_torch.prep.exact import div, norm3, resolve_device, sqrt, to_numpy

# Elements of one distance block of get_close_locations (locations x points).
_BLOCK = 1 << 22


def _ranges(starts: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Concatenated aranges [starts[k], starts[k] + lengths[k])."""
    seg = torch.repeat_interleave(torch.arange(len(lengths), device=lengths.device), lengths)
    first = torch.cumsum(lengths, 0) - lengths
    return starts[seg] + torch.arange(len(seg), device=lengths.device) - first[seg]


def _closest(xyz: torch.Tensor, seg: torch.Tensor, n: int, anchor) -> torch.Tensor:
    """[n, 3]: for each segment of xyz its point nearest to anchor by
    np.linalg.norm(xyz - anchor, axis=1), the first one among equals (as
    np.argmin). Every segment 0..n-1 must hold a point."""
    d = norm3(xyz - torch.as_tensor(np.asarray(anchor, np.float64), device=xyz.device))
    low = torch.full((n,), float("inf"), dtype=d.dtype, device=d.device)
    low = low.scatter_reduce(0, seg, d, "amin")
    at = torch.nonzero(d == low[seg])[:, 0]
    first = torch.full((n,), len(d), dtype=torch.int64, device=d.device)
    return xyz[first.scatter_reduce(0, seg[at], at, "amin")]


class ScenePoints:
    """A scene's objects packed on the device: xyz [N, 3] and rgb [N, 3] in
    object order, seg [N] the object index of each point, and per object
    its start and point count (host and device) and its metadata."""

    def __init__(self, objects: Sequence[Object3d], device="cuda"):
        dev = resolve_device(device)
        self.device = dev
        self.instance_ids = [o.instance_id for o in objects]
        self.labels = [o.label for o in objects]
        self.stuff = np.array([o.label in C.STUFF_CLASSES for o in objects], bool)
        self.counts = np.array([len(o.xyz) for o in objects], np.int64)
        self.starts = np.cumsum(self.counts) - self.counts
        # float64 as the JAX package's arithmetic promotes it (bbox, anchors).
        self.xyz = torch.as_tensor(np.concatenate([np.asarray(o.xyz, np.float64)
                                                   for o in objects])
                                   if objects else np.zeros((0, 3)), device=dev)
        self.rgb = torch.as_tensor(np.concatenate([o.rgb for o in objects])
                                   if objects else np.zeros((0, 3), np.float32), device=dev)
        self.counts_t = torch.as_tensor(self.counts, device=dev)
        self.starts_t = torch.as_tensor(self.starts, device=dev)
        self.seg = torch.repeat_interleave(torch.arange(len(objects), device=dev),
                                           self.counts_t)


class CellPoints:
    """One cell's objects with their normalized points on the device.

    `closest_points(pose)` is Object3d.get_closest_point for every object at
    once; `object(i)` copies one object to the host; `to_cell()` is the
    pickled Cell (every object copied to the host once)."""

    def __init__(self, idx, scene_name, bbox_w, cell_size, instance_ids, labels,
                 xyz, rgb, counts):
        self.idx = idx
        self.scene_name = scene_name
        self.id = f"{scene_name}_{idx:05.0f}"
        self.bbox_w = np.asarray(bbox_w)
        self.cell_size = cell_size
        self.instance_ids = instance_ids
        self.labels = labels
        self.xyz, self.rgb = xyz, rgb
        self.counts = counts
        self.starts = np.cumsum(counts) - counts
        self.seg = torch.repeat_interleave(torch.arange(len(counts), device=xyz.device),
                                           torch.as_tensor(counts, device=xyz.device))
        self._objects: dict = {}
        self._last = (None, None)
        self._cell: Optional[Cell] = None

    def __len__(self) -> int:
        return len(self.counts)

    def closest_points(self, anchor) -> np.ndarray:
        """[objects, 3]: Object3d.get_closest_point(anchor) of each object
        (the last anchor's answer is kept: a pose asks once per strategy)."""
        key = np.asarray(anchor, np.float64).tobytes()
        if self._last[0] != key:
            self._last = (key, to_numpy(_closest(self.xyz, self.seg, len(self.counts), anchor)))
        return self._last[1]

    def object(self, i: int) -> Object3d:
        if self._cell is not None:
            return self._cell.objects[i]
        if i not in self._objects:
            a, b = self.starts[i], self.starts[i] + self.counts[i]
            self._objects[i] = Object3d(i, self.instance_ids[i], to_numpy(self.xyz[a:b]),
                                        to_numpy(self.rgb[a:b]), self.labels[i])
        return self._objects[i]

    def to_cell(self) -> Cell:
        if self._cell is None:
            cut = self.starts[1:]
            objects = [Object3d(i, iid, x, r, label) for i, (iid, label, x, r) in enumerate(zip(
                self.instance_ids, self.labels, np.split(to_numpy(self.xyz), cut),
                np.split(to_numpy(self.rgb), cut)))]
            self._cell = Cell(self.idx, self.scene_name, objects, self.cell_size, self.bbox_w)
        return self._cell


def create_locations(path_input: str, scene_name: str, location_distance: float,
                     poses_txt: Optional[np.ndarray] = None) -> np.ndarray:
    """Greedy trajectory subsampling at >= location_distance spacing (host:
    each kept location depends on the ones before it)."""
    if poses_txt is None:
        path = os.path.join(path_input, "data_poses", scene_name, "poses.txt")
        poses_txt = np.loadtxt(path)
    mats = poses_txt[:, 1:].reshape((-1, 3, 4))
    locations = mats[:, :, -1]

    kept = [locations[0]]
    for loc in locations:
        if np.min(np.linalg.norm(loc - np.asarray(kept), axis=1)) >= location_distance:
            kept.append(loc)
    return np.asarray(kept)


def get_close_locations(locations: Sequence[np.ndarray], scene: ScenePoints,
                        cell_size: float) -> List[np.ndarray]:
    """Locations within cell_size / 2 (strictly) of the closest point of
    some instance-class object.

    The JAX package measures that distance with the norm of one vector (a
    dot product), which may round differently from the per-point norm by a
    few ulps. So the device tests every point at once, and a location whose
    nearest point lies within 1e-9 of the limit is decided by the JAX
    expression on the host, over each object's closest point."""
    half = cell_size / 2
    inst = torch.as_tensor(~scene.stuff, device=scene.device)
    compact = torch.cumsum(inst, 0) - 1
    pts = scene.xyz[inst[scene.seg]]
    pseg = compact[scene.seg[inst[scene.seg]]]
    locs = torch.as_tensor(np.asarray(locations, np.float64).reshape(-1, 3),
                           device=scene.device)
    nearest = torch.full((len(locs),), float("inf"), dtype=torch.float64,
                         device=scene.device)
    if len(pts):
        step = max(1, _BLOCK // len(pts))
        for b in range(0, len(locs), step):
            nearest[b:b + step] = norm3(pts[None] - locs[b:b + step, None]).amin(1)
    nearest = to_numpy(nearest)
    close = []
    for loc, d in zip(locations, nearest):
        if abs(d - half) <= 1e-9 * half:
            cps = to_numpy(_closest(pts, pseg, int(inst.sum()), loc))
            d = min(np.linalg.norm(np.asarray(loc) - cp) for cp in cps)
        if d < half:
            close.append(loc)
    return close


def create_cell(
    cell_idx: int,
    scene_name: str,
    bbox_w: np.ndarray,
    scene: ScenePoints,
    num_mentioned: int = 6,
    inside_fraction: float = 1 / 3,
    stuff_min: int = 250,
    all_cells: bool = False,
) -> Optional[CellPoints]:
    """One cell from a world bbox: stuff objects with at least stuff_min
    points in the box are cropped and split into DBSCAN (eps 0.75)
    pseudo-instances of at least stuff_min points; instance objects with at
    least inside_fraction of their points in the box are kept whole;
    coordinates normalized by the longest bbox edge."""
    bbox_w = np.asarray(bbox_w, np.float64)
    dev = scene.device
    lo = torch.as_tensor(bbox_w[0:3], device=dev)
    hi = torch.as_tensor(bbox_w[3:6], device=dev)
    inside = ((scene.xyz >= lo) & (scene.xyz <= hi)).all(1)
    total = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), torch.cumsum(inside, 0)])
    n_in = to_numpy(total[scene.starts_t + scene.counts_t] - total[scene.starts_t])

    stuff = [o for o in range(len(n_in)) if scene.stuff[o] and n_in[o] >= stuff_min]
    whole = [o for o in range(len(n_in)) if not scene.stuff[o]
             and not int(n_in[o]) / max(int(scene.counts[o]), 1) < inside_fraction]
    whole_t = torch.as_tensor(whole, dtype=torch.int64, device=dev)
    parts = [_ranges(scene.starts_t[whole_t], scene.counts_t[whole_t])]
    clusters = [torch.zeros(len(parts[0]), dtype=torch.int64, device=dev)]
    if stuff:
        crop_of = torch.full((len(n_in),), -1, dtype=torch.int64, device=dev)
        crop_of[torch.as_tensor(stuff, device=dev)] = torch.arange(len(stuff), device=dev)
        pidx = torch.nonzero(inside & (crop_of[scene.seg] >= 0))[:, 0]
        crop = crop_of[scene.seg[pidx]]
        label = dbscan(scene.xyz[pidx], crop)
        span = int(label.max()) + 2
        key = crop * span + label + 1
        big = torch.bincount(key, minlength=len(stuff) * span) >= stuff_min
        keep = (label >= 0) & big[key]
        parts.append(pidx[keep])
        clusters.append(label[keep])

    # The reference's object order: scene order, a stuff object's
    # pseudo-instances in cluster order, points in their original order.
    idx, cl = torch.cat(parts), torch.cat(clusters)
    width = int(cl.max()) + 1 if len(cl) else 1
    key = scene.seg[idx] * width + cl
    order = torch.argsort(key, stable=True)
    idx = idx[order]
    heads, counts = torch.unique_consecutive(key[order], return_counts=True)
    counts = to_numpy(counts)
    if len(counts) < 1:
        return None
    if len(counts) < num_mentioned and not all_cells:
        return None
    obj_of = to_numpy(torch.div(heads, width, rounding_mode="floor"))
    cell_size = float(np.max(bbox_w[3:6] - bbox_w[0:3]))
    xyz = div(scene.xyz[idx] - lo, cell_size)
    return CellPoints(cell_idx, scene_name, bbox_w, cell_size,
                      [scene.instance_ids[o] for o in obj_of],
                      [scene.labels[o] for o in obj_of], xyz, scene.rgb[idx], counts)


def create_cells(
    scene: ScenePoints,
    locations: np.ndarray,
    scene_name: str,
    cell_size: float,
    cell_dist: float,
    num_mentioned: int = 6,
    shift_cells: bool = False,
    grid_cells: bool = False,
    all_cells: bool = False,
) -> List[CellPoints]:
    """All cells of a scene: one per location (default), five shifted ones
    per location kept cell_dist apart (shift_cells), or a cell_dist grid
    over the trajectory's extent (grid_cells). Cell ids use the short scene
    number."""
    locations = np.asarray(locations, np.float64)
    scene_short = scene_name.split("_")[-2] if len(scene_name.split("_")) == 6 else scene_name

    if shift_cells:
        shifts = np.array(
            [[0, 0], [-cell_dist * 1.05, 0], [cell_dist * 1.05, 0],
             [0, -cell_dist * 1.05], [0, cell_dist * 1.05]]
        )
        locations = np.repeat(locations, 5, axis=0)
        locations[:, 0:2] += np.tile(shifts.T, len(locations) // 5).T
        taken = np.full_like(locations, np.inf)
    elif grid_cells:
        lo = np.floor(locations[:, :2].min(axis=0)).astype(int)
        hi = np.ceil(locations[:, :2].max(axis=0)).astype(int)
        gx, gy = np.mgrid[lo[0]:hi[0]:int(cell_dist), lo[1]:hi[1]:int(cell_dist)]
        centers = np.stack([gx.ravel(), gy.ravel()], axis=1).astype(np.float64)
        # scipy's cdist, as the JAX package computes it: sqrt(dx*dx + dy*dy).
        c = torch.as_tensor(centers, device=scene.device)
        p = torch.as_tensor(locations[:, :2], device=scene.device)
        dx, dy = c[:, None, 0] - p[None, :, 0], c[:, None, 1] - p[None, :, 1]
        d = sqrt(dx * dx + dy * dy)
        keep = to_numpy(d.min(dim=1).values <= cell_size)
        closest = to_numpy(d.argmin(dim=1))[keep]
        locations = np.hstack([centers[keep], locations[closest, 2:3]])

    cells: List[CellPoints] = []
    for i, loc in enumerate(locations):
        if shift_cells and np.min(np.linalg.norm(taken - loc, axis=1)) < cell_dist:
            continue
        bbox = np.hstack([loc - cell_size / 2, loc + cell_size / 2])
        cell = create_cell(
            i, scene_short, bbox, scene,
            num_mentioned=num_mentioned, all_cells=all_cells,
        )
        if cell is not None:
            cells.append(cell)
            if shift_cells:
                taken[i] = loc
    return cells
