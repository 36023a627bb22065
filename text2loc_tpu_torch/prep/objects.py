"""Scene objects from raw PLY windows, on the device (the port of
text2loc_tpu/prep/objects.py: extract_objects, gather_objects).

Each window is read on the host and its columns go to the device once.
There, points of known classes are grouped by a stable sort over
(semantic, instance) (numpy's lexsort order), each instance merges with what
earlier windows held of it, and every merged object of a class with a voxel
size is downsampled after the merge, all objects of a window in one packed
voxel pass (voxel.voxel_keep). Objects below their class's minimum point
count are dropped at the end. The returned Object3d hold float64 xyz and
float32 rgb in [0, 1], as the pickle schema does.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from text2loc_tpu_torch import constants as C
from text2loc_tpu_torch.data.structs import Object3d
from text2loc_tpu_torch.prep.exact import div, resolve_device, to_numpy
from text2loc_tpu_torch.prep.ply import load_points
from text2loc_tpu_torch.prep.voxel import voxel_keep


def _groups(xyz, rgb, semantic, instance, dev) -> Tuple:
    """One window on the device, grouped: (xyz f64, rgb f32 in [0, 1], both
    in group order, and per group (start, end, semantic id, instance id)
    on the host)."""
    sem = torch.as_tensor(np.asarray(semantic), device=dev).to(torch.int64)
    iid = torch.as_tensor(np.asarray(instance), device=dev).to(torch.int64)
    known = torch.as_tensor(sorted(C.SEMANTIC_ID_TO_CLASS), device=dev)
    keep = torch.nonzero(torch.isin(sem, known))[:, 0]
    # np.lexsort((instance, semantic)): stable by instance, then by semantic.
    order = keep[torch.argsort(iid[keep], stable=True)]
    order = order[torch.argsort(sem[order], stable=True)]
    sem_s, iid_s = sem[order], iid[order]
    boundary = torch.ones(len(order), dtype=torch.bool, device=dev)
    boundary[1:] = (sem_s[1:] != sem_s[:-1]) | (iid_s[1:] != iid_s[:-1])
    starts = torch.nonzero(boundary)[:, 0]
    heads = to_numpy(torch.stack([starts, sem_s[starts], iid_s[starts]]))
    ends = np.append(heads[0, 1:], len(order))
    xyz_t = torch.as_tensor(np.asarray(xyz), device=dev)[order].to(torch.float64)
    rgb_t = div(torch.as_tensor(np.asarray(rgb), device=dev)[order].to(torch.float32), 255.0)
    return xyz_t, rgb_t, list(zip(heads[0], ends, heads[1], heads[2]))


def _to_objects(entries) -> List[Object3d]:
    """Object3d of (instance id, label, xyz tensor, rgb tensor) entries, with
    one copy to the host for all of them."""
    if not entries:
        return []
    counts = [len(e[2]) for e in entries]
    xyz = np.split(to_numpy(torch.cat([e[2] for e in entries])), np.cumsum(counts)[:-1])
    rgb = np.split(to_numpy(torch.cat([e[3] for e in entries])), np.cumsum(counts)[:-1])
    return [Object3d(iid, iid, x, r, label)
            for (iid, label, _, _), x, r in zip(entries, xyz, rgb)]


def extract_objects(xyz, rgb, semantic, instance, device="cuda") -> List[Object3d]:
    """Per-(class, instance) objects of one point-cloud window."""
    xyz_t, rgb_t, groups = _groups(xyz, rgb, semantic, instance, resolve_device(device))
    return _to_objects([(int(i), C.SEMANTIC_ID_TO_CLASS[int(s)], xyz_t[a:b], rgb_t[a:b])
                        for a, b, s, i in groups])


def gather_objects(path_input: str, scene_name: str, device="cuda") -> List[Object3d]:
    """All objects of a scene: each static PLY window in name order, its
    instances merged with the earlier windows' and voxel-downsampled per
    class after the merge, then the per-class minimum point counts."""
    dev = resolve_device(device)
    path = os.path.join(path_input, "data_3d_semantics", scene_name, "static")
    assert os.path.isdir(path), path
    file_names = sorted(f for f in os.listdir(path) if not f.startswith("._"))

    # instance id -> [instance id, label, xyz, rgb] (first-seen order)
    scene: Dict[int, list] = {}
    for fname in file_names:
        xyz_t, rgb_t, groups = _groups(*load_points(os.path.join(path, fname)), dev)
        batch = []  # merged objects of this window that take a voxel grid
        for a, b, s, i in groups:
            iid, label = int(i), C.SEMANTIC_ID_TO_CLASS[int(s)]
            xyz, rgb = xyz_t[a:b], rgb_t[a:b]
            if iid in scene:
                assert scene[iid][1] == label, (iid, scene[iid][1], label)
                xyz = torch.cat([scene[iid][2], xyz])
                rgb = torch.cat([scene[iid][3], rgb])
            scene[iid] = [iid, label, xyz, rgb]
            if C.CLASS_TO_VOXELSIZE.get(label) is not None:
                batch.append(scene[iid])
        if not batch:
            continue
        lengths = torch.tensor([len(e[2]) for e in batch], device=dev)
        seg = torch.repeat_interleave(torch.arange(len(batch), device=dev), lengths)
        voxel = torch.tensor([C.CLASS_TO_VOXELSIZE[e[1]] for e in batch],
                             dtype=torch.float64, device=dev)
        packed = torch.cat([e[2] for e in batch])
        keep = voxel_keep(packed, seg, voxel)
        kept = to_numpy(torch.bincount(seg[keep], minlength=len(batch))).tolist()
        xyz = torch.split(packed[keep], kept)
        rgb = torch.split(torch.cat([e[3] for e in batch])[keep], kept)
        for e, x, r in zip(batch, xyz, rgb):
            e[2], e[3] = x, r

    return _to_objects([e for e in scene.values()
                        if len(e[2]) >= C.CLASS_TO_MINPOINTS.get(e[1], 25)])
