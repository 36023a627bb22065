"""Real-image db/query extraction for image-based experiments (the port's
copy of text2loc_tpu/prep/images.py: sample_poses, create_poses_and_images,
main).

Samples db poses at >= db_dist spacing along the trajectory and query poses
at >= query_dist from the nearest db pose, and copies the matching
rectified camera frames into db/ and query/ folders. A side experiment,
host-side file copies: not part of the text-localization pipeline.

    python -m text2loc_tpu_torch.prep.images --path_poses P --path_images I --path_out O
"""

from __future__ import annotations

import argparse
import os
import pickle
from shutil import copyfile
from typing import Tuple

import numpy as np


def sample_poses(path_poses: str, pose_distance: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy >= pose_distance subsampling, returning (positions [N,3],
    orientations [N,3,3], frame ids [N])."""
    raw = np.loadtxt(path_poses)
    frame_ids = raw[:, 0].astype(np.int64)
    mats = raw[:, 1:].reshape((-1, 3, 4))
    positions = mats[:, :, -1]
    rotations = mats[:, :3, :3]

    keep = [0]
    for i in range(1, len(positions)):
        if np.min(np.linalg.norm(positions[i] - positions[keep], axis=1)) >= pose_distance:
            keep.append(i)
    keep = np.asarray(keep)
    return positions[keep], rotations[keep], frame_ids[keep]


def create_poses_and_images(path_poses: str, path_images: str, path_out: str,
                            db_dist: float = 25.0, query_dist: float = 5.0,
                            step: int = 4) -> Tuple[int, int]:
    """Split trajectory frames into a db gallery and query set by distance to
    the nearest db pose. Returns (num_db, num_query)."""
    raw = np.loadtxt(path_poses)
    frame_ids = raw[:, 0].astype(np.int64)
    positions = raw[:, 1:].reshape((-1, 3, 4))[:, :, -1]

    path_db = os.path.join(path_out, "real", "db")
    path_query = os.path.join(path_out, "real", "query")
    os.makedirs(path_db, exist_ok=True)
    os.makedirs(path_query, exist_ok=True)

    def frame_path(fid):
        return os.path.join(path_images, f"{fid:010d}.png")

    db_poses = [positions[0]]
    copyfile(frame_path(frame_ids[0]), os.path.join(path_db, "0000.png"))
    query_poses = []
    for idx in range(0, len(positions), step):
        pose, fid = positions[idx], frame_ids[idx]
        dmin = np.min(np.linalg.norm(pose - np.asarray(db_poses), axis=1))
        if dmin >= db_dist:
            db_poses.append(pose)
            copyfile(
                frame_path(fid),
                os.path.join(path_db, f"{len(db_poses) - 1:04d}.png"),
            )
        elif dmin >= query_dist:
            query_poses.append(pose)
            copyfile(
                frame_path(fid),
                os.path.join(path_query, f"{len(query_poses) - 1:04d}.png"),
            )

    with open(os.path.join(path_out, "poses_db.pkl"), "wb") as f:
        pickle.dump(np.asarray(db_poses), f)
    with open(os.path.join(path_out, "poses_query.pkl"), "wb") as f:
        pickle.dump(np.asarray(query_poses), f)
    return len(db_poses), len(query_poses)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--path_poses", required=True)
    ap.add_argument("--path_images", required=True)
    ap.add_argument("--path_out", required=True)
    ap.add_argument("--db_dist", type=float, default=25.0)
    ap.add_argument("--query_dist", type=float, default=5.0)
    ap.add_argument("--step", type=int, default=4)
    args = ap.parse_args(argv)
    n_db, n_q = create_poses_and_images(
        args.path_poses, args.path_images, args.path_out,
        args.db_dist, args.query_dist, args.step,
    )
    print(f"Saved {n_db} db / {n_q} query poses.")


if __name__ == "__main__":
    main()
