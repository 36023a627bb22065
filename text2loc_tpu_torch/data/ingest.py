"""One-shot converter: published KITTI360Pose pickles -> SceneArrays (npz)
(the port's own copy of text2loc_tpu/data/ingest.py: convert_scene,
convert_base_path, load_dataset and the CLI; held equal to it by
tests/test_torch_port_ingest.py).

Each scene's `cells/{scene}.pkl` + `poses/{scene}.pkl` (+ optional
`direction/{scene}.json` PMC neighbour maps) become one flat bundle of
fixed-shape arrays, cached as .npz. Everything downstream is integer gathers
and on-device compute.

Semantics kept from the reference loaders:
* object storage order == the cell's object list order, so slot truncation to
  `object_size` equals the reference's truncation;
* per-object point subsampling draws a random choice (with replacement iff
  the cloud is smaller than the budget);
* hint triples (direction, color, class) are the integer form of the rendered
  template "The pose is {direction} of a {color} {label}."; the colour index
  is the nearest fitted centroid of the description's stored mean RGB;
* matched-object slots come from DescriptionBestCell.object_id, the object's
  position in the best cell's list.

The PMC tables come from data/pmc.py's numpy rematch (the JAX package takes a
native rematch where it is built; the two agree on the tests' fixtures).

CLI:
    python -m text2loc_tpu_torch.data.ingest --base_path DATA --out_dir OUT \
        [--scenes name1 name2 ...] [--store_points 256] [--object_slots 0]
"""

from __future__ import annotations

import argparse
import json
import os
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np

from text2loc_tpu_torch import constants as C
from text2loc_tpu_torch.constants import NEIGHBOR_KEYS
from text2loc_tpu_torch.data.arrays import MultiSceneArrays, SceneArrays, fill_padding_slots
from text2loc_tpu_torch.data.structs import Cell, Pose, load_compat_pickle


def _subsample_points(xyz: np.ndarray, rgb: np.ndarray, p: int,
                      rng: np.random.Generator):
    n = len(xyz)
    if n == p:
        return xyz, rgb
    idx = rng.choice(n, p, replace=n < p)
    return xyz[idx], rgb[idx]


def convert_scene(
    cells: Sequence[Cell],
    poses: Sequence[Pose],
    scene_name: str,
    object_slots: int,
    store_points: int = 256,
    num_mentioned: int = 6,
    neighbors_json: Optional[Dict] = None,
    seed: int = 0,
    build_pmc: bool = True,
    pmc_threshold: float = 0.4,
    pmc_count_threshold: int = 1,
) -> SceneArrays:
    """Convert one scene's object graph into SceneArrays."""
    rng = np.random.default_rng(seed)
    # A pose with NO hints cannot be localized (its masked text embedding is
    # zero, making retrieval an argsort tie-break) — drop it rather than
    # silently score it. Short-but-nonempty hint lists are padded + masked.
    kept = [pp for pp in poses if len(pp.descriptions) > 0]
    if len(kept) < len(poses):
        print(
            f"warning: dropping {len(poses) - len(kept)} hint-less pose(s) "
            f"in {scene_name}",
            flush=True,
        )
    poses = kept
    nc, o, p, s = len(cells), object_slots, store_points, num_mentioned

    cell_ids = [c.id for c in cells]
    cell_index = {cid: i for i, cid in enumerate(cell_ids)}
    cell_bbox = np.stack([np.asarray(c.bbox_w, np.float32) for c in cells])
    cell_size = np.array([float(c.cell_size) for c in cells], np.float32)

    obj_xyz = np.zeros((nc, o, p, 3), np.float32)
    obj_rgb = np.zeros((nc, o, p, 3), np.float32)
    obj_center = np.zeros((nc, o, 3), np.float32)
    obj_color = np.zeros((nc, o, 3), np.float32)
    obj_num = np.zeros((nc, o), np.float32)
    obj_class = np.full((nc, o), C.PAD_CLASS_INDEX, np.int32)
    obj_color_idx = np.zeros((nc, o), np.int32)
    obj_mask = np.zeros((nc, o), bool)

    for ci, cell in enumerate(cells):
        for oi, obj in enumerate(cell.objects[:o]):
            xyz = np.asarray(obj.xyz, np.float32)
            rgb = np.asarray(obj.rgb, np.float32)
            sx, sr = _subsample_points(xyz, rgb, p, rng)
            obj_xyz[ci, oi] = sx
            obj_rgb[ci, oi] = sr
            obj_center[ci, oi] = xyz.mean(axis=0)
            obj_color[ci, oi] = rgb.mean(axis=0)
            obj_num[ci, oi] = float(len(xyz))
            # Tolerant lookup (the reference's known_classes.get(label, 0)
            # '<unk>' semantics, object_encoder.py:81): an unexpected label
            # maps to the pad class with a warning instead of killing the
            # whole scene conversion.
            if obj.label not in C.CLASS_TO_INDEX:
                warnings.warn(
                    f"scene {scene_name} cell {cell.id} object {oi}: "
                    f"unknown class {obj.label!r} -> pad class"
                )
            obj_class[ci, oi] = C.CLASS_TO_INDEX.get(
                obj.label, C.PAD_CLASS_INDEX
            )
            obj_color_idx[ci, oi] = int(
                np.argmin(np.linalg.norm(rgb.mean(axis=0) - C.COLORS, axis=1))
            )
            obj_mask[ci, oi] = True

    npose = len(poses)
    pose_cell_idx = np.zeros((npose,), np.int32)
    pose_w = np.zeros((npose, 3), np.float32)
    pose_in_cell = np.zeros((npose, 2), np.float32)
    hint_dir = np.zeros((npose, s), np.int32)
    hint_color = np.zeros((npose, s), np.int32)
    hint_label = np.full((npose, s), C.PAD_CLASS_INDEX, np.int32)
    hint_obj_idx = np.full((npose, s), -1, np.int32)
    hint_matched = np.zeros((npose, s), bool)
    hint_mask = np.zeros((npose, s), bool)
    offset_center = np.zeros((npose, s, 2), np.float32)
    offset_closest = np.zeros((npose, s, 2), np.float32)
    best_offset_center = np.zeros((npose, s, 2), np.float32)
    best_offset_closest = np.zeros((npose, s, 2), np.float32)

    for pi, pose in enumerate(poses):
        pose_cell_idx[pi] = cell_index[pose.cell_id]
        pw = np.asarray(pose.pose_w, np.float32)
        pose_w[pi, : len(pw)] = pw
        pose_in_cell[pi] = np.asarray(pose.pose, np.float32)[:2]
        # Truncate long hint lists; PAD + MASK short ones (the reference
        # asserts exactly num_mentioned per pose, training/coarse.py:229-233 —
        # a single malformed pose in a published pickle would kill the whole
        # conversion; the sentence_mask keeps padded slots out of attention
        # and pooling end to end).
        descrs = pose.descriptions[:s]
        hint_mask[pi, : len(descrs)] = True
        for si, d in enumerate(descrs):
            # A description whose label/direction falls outside the closed
            # hint vocabulary cannot be rendered as a template sentence:
            # leave the slot padded+masked (out of attention/pooling) with
            # a warning instead of killing the whole conversion.
            if (d.object_label not in C.CLASS_TO_INDEX
                    or d.direction not in C.DIRECTION_TO_INDEX):
                warnings.warn(
                    f"scene {scene_name} pose {pi} hint {si}: unknown "
                    f"label/direction ({d.object_label!r}, "
                    f"{d.direction!r}) -> slot masked"
                )
                hint_mask[pi, si] = False
                continue
            hint_dir[pi, si] = C.DIRECTION_TO_INDEX[d.direction]
            rgbm = np.asarray(d.object_color_rgb, np.float32)
            hint_color[pi, si] = int(
                np.argmin(np.linalg.norm(rgbm - C.COLORS, axis=1))
            )
            hint_label[pi, si] = C.CLASS_TO_INDEX[d.object_label]
            offset_center[pi, si] = np.asarray(d.offset_center, np.float32)[:2]
            offset_closest[pi, si] = np.asarray(d.offset_closest, np.float32)[:2]
            if getattr(d, "is_matched", False):
                oid = int(d.object_id)
                if 0 <= oid < o:
                    hint_obj_idx[pi, si] = oid
                    hint_matched[pi, si] = True
                best_offset_center[pi, si] = np.asarray(
                    d.best_offset_center, np.float32
                )[:2]
                best_offset_closest[pi, si] = np.asarray(
                    d.best_offset_closest, np.float32
                )[:2]
            else:
                best_offset_center[pi, si] = offset_center[pi, si]
                best_offset_closest[pi, si] = offset_closest[pi, si]

    cell_neighbors = None
    pmc_valid = pmc_weight = pmc_match = None
    if neighbors_json is not None:
        cell_neighbors = np.full((nc, len(NEIGHBOR_KEYS)), -1, np.int32)
        for cid, nbrs in neighbors_json.items():
            if cid not in cell_index:
                continue
            for ki, key in enumerate(NEIGHBOR_KEYS):
                nid = nbrs.get(key)
                if nid is not None and nid in cell_index:
                    cell_neighbors[cell_index[cid], ki] = cell_index[nid]
        if build_pmc:
            from text2loc_tpu_torch.data.pmc import build_pmc_tables

            pmc_valid, pmc_weight, pmc_match = build_pmc_tables(
                cells, poses, neighbors_json, num_mentioned=s,
                pmc_threshold=pmc_threshold, count_threshold=pmc_count_threshold,
                object_slots=o,
            )

    scene = SceneArrays(
        scene_name=scene_name,
        cell_ids=cell_ids,
        cell_bbox=cell_bbox,
        cell_size=cell_size,
        obj_xyz=obj_xyz,
        obj_rgb=obj_rgb,
        obj_center=obj_center,
        obj_color=obj_color,
        obj_num_points=obj_num,
        obj_class=obj_class,
        obj_color_idx=obj_color_idx,
        obj_mask=obj_mask,
        pose_cell_idx=pose_cell_idx,
        pose_w=pose_w,
        pose_in_cell=pose_in_cell,
        hint_dir=hint_dir,
        hint_color=hint_color,
        hint_label=hint_label,
        hint_obj_idx=hint_obj_idx,
        hint_matched=hint_matched,
        hint_mask=hint_mask,
        offset_center=offset_center,
        offset_closest=offset_closest,
        best_offset_center=best_offset_center,
        best_offset_closest=best_offset_closest,
        cell_neighbors=cell_neighbors,
        pmc_valid=pmc_valid,
        pmc_weight=pmc_weight,
        pmc_match=pmc_match,
    )
    return fill_padding_slots(scene, rng)


def convert_base_path(
    base_path: str,
    scene_names: Sequence[str],
    out_dir: Optional[str] = None,
    store_points: int = 256,
    object_slots: int = 0,
    num_mentioned: int = 6,
    seed: int = 0,
) -> List[SceneArrays]:
    """Convert (or load from npz cache) all requested scenes.

    object_slots=0 auto-sizes to the max object count across the scenes
    (>= 28 so the coarse truncation cap is representable).
    """
    raw = []
    # Cache filenames are keyed by the conversion parameters that change the
    # array shapes/content: a cache produced at store_points=256 must not be
    # silently reused for a store_points=128 request (the arrays would be
    # shape-incompatible with freshly converted scenes, or — if all scenes
    # were cached — simply stale).
    def cache_name(name):
        return f"{name}_p{store_points}_m{num_mentioned}.npz"

    for name in scene_names:
        if out_dir is not None:
            npz = os.path.join(out_dir, cache_name(name))
            if os.path.exists(npz):
                raw.append(SceneArrays.load_npz(npz))
                continue
        cells = load_compat_pickle(os.path.join(base_path, "cells", f"{name}.pkl"))
        poses = load_compat_pickle(os.path.join(base_path, "poses", f"{name}.pkl"))
        nb_path = os.path.join(base_path, "direction", f"{name}.json")
        neighbors = None
        if os.path.exists(nb_path):
            with open(nb_path) as f:
                neighbors = json.load(f)
        raw.append((name, cells, poses, neighbors))

    need = [r for r in raw if isinstance(r, tuple)]
    cached_slots = {r.obj_xyz.shape[1] for r in raw if isinstance(r, SceneArrays)}
    if need and object_slots == 0 and cached_slots:
        # Fresh scenes must concatenate with the cached ones: adopt the
        # cached O instead of re-deriving an auto size from the fresh
        # subset alone (which could differ and break MultiSceneArrays).
        if len(cached_slots) > 1:
            raise ValueError(
                f"cached scenes in {out_dir} have inconsistent object_slots "
                f"{sorted(cached_slots)} — clear the cache or pass "
                "object_slots explicitly"
            )
        object_slots = next(iter(cached_slots))
    if need and object_slots == 0:
        biggest = max(len(c.objects) for _, cells, _, _ in need for c in cells)
        # Auto-size to the real maximum, but cap: storage is [C, O, P, 6] and
        # a single outlier cell would inflate every scene. Objects beyond the
        # cap are dropped exactly like the reference's coarse truncation
        # (cell_retrieval.py:97); matched fine objects beyond it fall back to
        # unmatched. Pass --object_slots explicitly to override.
        cap = 64
        object_slots = max(28, min(biggest, cap))
        if biggest > cap:
            over = sum(
                1 for _, cells, _, _ in need for c in cells
                if len(c.objects) > cap
            )
            print(
                f"warning: {over} cells exceed the {cap}-object slot cap "
                f"(max {biggest}); overflow objects are dropped "
                f"(set object_slots to keep them)",
                flush=True,
            )

    out = []
    for r in raw:
        if isinstance(r, SceneArrays):
            out.append(r)
            continue
        name, cells, poses, neighbors = r
        scene = convert_scene(
            cells, poses, name,
            object_slots=object_slots,
            store_points=store_points,
            num_mentioned=num_mentioned,
            neighbors_json=neighbors,
            seed=seed,
        )
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            scene.save_npz(os.path.join(out_dir, cache_name(name)))
        out.append(scene)
    shapes = {(sc.obj_xyz.shape[1], sc.obj_xyz.shape[2]) for sc in out}
    if len(shapes) > 1:
        raise ValueError(
            f"scenes have inconsistent (object_slots, store_points) "
            f"{sorted(shapes)} — cached scenes were converted with "
            "different parameters; clear the cache or pass object_slots"
        )
    return out


def load_dataset(base_path: str, split: str = "train", out_dir: Optional[str] = None,
                 **kwargs) -> MultiSceneArrays:
    """Split-level loader (scene splits per reference
    datapreparation/kitti360pose/utils.py:17-31)."""
    names = {
        "train": C.SCENE_NAMES_TRAIN,
        "val": C.SCENE_NAMES_VAL,
        "test": C.SCENE_NAMES_TEST,
        "all": C.SCENE_NAMES,
    }[split]
    return MultiSceneArrays(convert_base_path(base_path, names, out_dir, **kwargs))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--base_path", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--scenes", nargs="*", default=list(C.SCENE_NAMES))
    ap.add_argument("--store_points", type=int, default=256)
    ap.add_argument("--object_slots", type=int, default=0)
    ap.add_argument("--num_mentioned", type=int, default=6)
    args = ap.parse_args(argv)
    scenes = convert_base_path(
        args.base_path, args.scenes, args.out_dir,
        store_points=args.store_points,
        object_slots=args.object_slots,
        num_mentioned=args.num_mentioned,
    )
    for s in scenes:
        print(f"{s.scene_name}: {s.num_cells} cells, {s.num_poses} poses")


if __name__ == "__main__":
    main()
