"""Prep CLI: raw KITTI-360 -> cells / poses pickles, direction maps and
(with --array_dir) the port's npz scene arrays, on the card (the port of
text2loc_tpu/prep/prepare.py: prepare_scene, build_argparser,
encode_output_name, main).

The pickles are written under the published schema's module path
(data/structs.REFERENCE_MODULE), so data/ingest reads them, and so does a
reader of the published dataset. --array_dir converts the scene with the
port's data/ingest.convert_scene, without a second read of the pickles.
Random draws come from one numpy generator seeded by --seed, as in the JAX
package, so the same flags give the same pickles on the card, on the CPU
and from the JAX package.

    python -m text2loc_tpu_torch.prep.prepare --path_in RAW --path_out OUT \
        --scene_name 2013_05_28_drive_0000_sync [--array_dir ARR] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from text2loc_tpu_torch.data.structs import dump_compat_pickle, load_compat_pickle
from text2loc_tpu_torch.prep.cells import (
    ScenePoints,
    create_cells,
    create_locations,
    get_close_locations,
)
from text2loc_tpu_torch.prep.exact import resolve_device
from text2loc_tpu_torch.prep.objects import gather_objects
from text2loc_tpu_torch.prep.poses import create_poses
from text2loc_tpu_torch.prep.relations import build_neighbor_map


def _elapsed(t0: float, dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def prepare_scene(args) -> dict:
    """Prepare one scene; returns the seconds of each stage (gather_objects,
    cells with the location filter, poses, ingest) and the counts of
    windows, points, objects, cells and poses."""
    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    stats = {"device": str(dev)}
    t0 = time.perf_counter()

    cell_locations = create_locations(args.path_in, args.scene_name, args.cell_dist)
    pose_locations = create_locations(args.path_in, args.scene_name, args.pose_dist)

    path_objects = os.path.join(args.path_in, "objects", f"{args.scene_name}.pkl")
    if os.path.isfile(path_objects):
        objects = load_compat_pickle(path_objects)
        print(f"loaded {len(objects)} cached objects")
    else:
        objects = gather_objects(args.path_in, args.scene_name, dev)
        os.makedirs(os.path.dirname(path_objects), exist_ok=True)
        dump_compat_pickle(objects, path_objects)
        print(f"gathered {len(objects)} objects in {time.perf_counter() - t0:.1f}s")
    stats["gather_objects_s"] = _elapsed(t0, dev)
    static = os.path.join(args.path_in, "data_3d_semantics", args.scene_name, "static")
    stats["windows"] = (len([f for f in os.listdir(static) if not f.startswith("._")])
                        if os.path.isdir(static) else 0)
    stats["objects"] = len(objects)

    t0 = time.perf_counter()
    scene = ScenePoints(objects, dev)
    stats["points"] = len(scene.xyz)
    cell_locations = get_close_locations(cell_locations, scene, args.cell_size)
    pose_locations = get_close_locations(pose_locations, scene, args.cell_size)

    cells = create_cells(
        scene, cell_locations, args.scene_name, args.cell_size, args.cell_dist,
        num_mentioned=args.num_mentioned, shift_cells=args.shift_cells,
        grid_cells=args.grid_cells, all_cells=args.all_cells,
    )
    cell_objects = [c.to_cell() for c in cells]
    stats["cells_s"] = _elapsed(t0, dev)
    stats["cells"] = len(cells)
    print(f"{len(cells)} cells")

    t0 = time.perf_counter()
    poses = create_poses(
        scene, pose_locations, cells, args.cell_size,
        num_mentioned=args.num_mentioned, describe_by=args.describe_by,
        pose_count=args.pose_count, shift_poses=args.shift_poses,
        describe_best_cell=args.describe_best_cell, no_ontop=args.no_ontop,
        rng=rng,
    )
    stats["poses_s"] = _elapsed(t0, dev)
    stats["poses"] = len(poses)
    print(f"{len(poses)} poses")

    for sub in ("cells", "poses", "direction"):
        os.makedirs(os.path.join(args.path_out, sub), exist_ok=True)
    dump_compat_pickle(cell_objects, os.path.join(args.path_out, "cells", f"{args.scene_name}.pkl"))
    dump_compat_pickle(poses, os.path.join(args.path_out, "poses", f"{args.scene_name}.pkl"))
    neighbors = build_neighbor_map(cells, stride=args.cell_dist)
    with open(os.path.join(args.path_out, "direction", f"{args.scene_name}.json"), "w") as f:
        json.dump(neighbors, f, indent=2)

    if args.array_dir:
        from text2loc_tpu_torch.data.ingest import convert_scene

        t0 = time.perf_counter()
        arrays = convert_scene(
            cell_objects, poses, args.scene_name,
            object_slots=max(28, max((len(c.objects) for c in cell_objects), default=28)),
            num_mentioned=args.num_mentioned,
            neighbors_json=neighbors,
            seed=args.seed,
        )
        os.makedirs(args.array_dir, exist_ok=True)
        arrays.save_npz(os.path.join(args.array_dir, f"{args.scene_name}.npz"))
        stats["ingest_s"] = time.perf_counter() - t0
        print(f"arrays: {arrays.num_cells} cells / {arrays.num_poses} poses")
    return stats


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--path_in", required=True)
    ap.add_argument("--path_out", required=True)
    ap.add_argument("--scene_name", required=True)
    ap.add_argument("--array_dir", default=None)
    ap.add_argument("--cell_size", type=float, default=30.0)
    ap.add_argument("--cell_dist", type=float, default=10.0)
    ap.add_argument("--pose_dist", type=float, default=10.0)
    ap.add_argument("--pose_count", type=int, default=4)
    ap.add_argument("--num_mentioned", type=int, default=6)
    ap.add_argument("--describe_by", default="all",
                    choices=["all", "closest", "class", "direction", "random"])
    ap.add_argument("--shift_poses", action="store_true", default=True)
    ap.add_argument("--shift_cells", action="store_true")
    ap.add_argument("--grid_cells", action="store_true")
    ap.add_argument("--all_cells", action="store_true")
    ap.add_argument("--describe_best_cell", action="store_true",
                    help="describe against the best (database) cell instead "
                         "of the pose-centered cell")
    ap.add_argument("--no_ontop", action="store_true",
                    help="center-based direction words without the "
                         "'on-top' class")
    ap.add_argument("--auto_name", action="store_true",
                    help="append the reference's config-encoded suffix to "
                         "path_out")
    ap.add_argument("--seed", type=int, default=4096)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the point work; 'cpu' runs it on the CPU")
    return ap


def encode_output_name(args) -> str:
    """The reference's config-encoded dataset directory name: path_out plus
    one attribute token per non-default prep option, '_'-joined."""
    def num(v):
        # Integral floats render as ints ("30-10", not "30.0-10.0").
        return int(v) if float(v).is_integer() else v

    attribs = [
        args.path_out,
        "allCells" if args.all_cells else None,
        f"{num(args.cell_size)}-{num(args.cell_dist)}",
        "gridCells" if args.grid_cells else (
            "shiftCells" if args.shift_cells else "noCellShift"),
        f"pd{num(args.pose_dist)}",
        f"pc{args.pose_count}",
        "shiftPoses" if args.shift_poses else None,
        args.describe_by,
        f"nm-{args.num_mentioned}",
        "bestCell" if args.describe_best_cell else None,
        "noOntop" if args.no_ontop else None,
    ]
    return "_".join(a for a in attribs if a is not None)


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    if args.auto_name:
        args.path_out = encode_output_name(args)
        print(f"output folder: {args.path_out}")
    return prepare_scene(args)


if __name__ == "__main__":
    main()
