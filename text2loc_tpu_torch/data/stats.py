"""Duplicate-description statistics over a dataset (the port's copy of
text2loc_tpu/data/stats.py: description_stats, print_stats, main).

Identical hint sets describing different places put a hard ceiling on
retrieval recall: no encoder can split two queries whose texts are equal.
This reports, per split, how many poses share an identical (unordered)
mention set and how many of those collide across DIFFERENT cells (true
ambiguity, against harmless same-cell repeats). Host-side numpy over the
port's data/arrays.

Run: ``python -m text2loc_tpu_torch.data.stats --synthetic`` or with
``--base_path <dataset root>`` like the evaluation CLIs.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict


def description_stats(data) -> Dict[str, float]:
    """Ambiguity stats for one dataset view.

    A pose's key is its SORTED set of masked (direction, color, label)
    triples — hint order does not change the rendered description set (the
    reference shuffles hints at train time), so the unordered set is the
    right collision key.
    """
    groups = defaultdict(list)
    for i in range(data.num_poses):
        m = data.hint_mask[i]
        key = tuple(sorted(zip(
            data.hint_dir[i][m].tolist(),
            data.hint_color[i][m].tolist(),
            data.hint_label[i][m].tolist(),
        )))
        groups[key].append(i)

    n = data.num_poses
    dup_poses = 0
    cross_cell_poses = 0
    worst = 1
    for idxs in groups.values():
        if len(idxs) < 2:
            continue
        dup_poses += len(idxs)
        worst = max(worst, len(idxs))
        cells = {int(data.pose_cell_idx[i]) for i in idxs}
        if len(cells) > 1:
            cross_cell_poses += len(idxs)
    return {
        "num_poses": n,
        "num_unique_descriptions": len(groups),
        "duplicated_poses": dup_poses,
        "duplicated_frac": dup_poses / max(n, 1),
        "cross_cell_duplicated_poses": cross_cell_poses,
        "cross_cell_duplicated_frac": cross_cell_poses / max(n, 1),
        "worst_multiplicity": worst,
    }


def print_stats(stats: Dict[str, float], title: str) -> None:
    print(f"--- {title} ---")
    print(f"poses: {stats['num_poses']}, "
          f"unique descriptions: {stats['num_unique_descriptions']}")
    print(f"duplicated: {stats['duplicated_poses']} "
          f"({100 * stats['duplicated_frac']:.1f}%), "
          f"across different cells: {stats['cross_cell_duplicated_poses']} "
          f"({100 * stats['cross_cell_duplicated_frac']:.1f}%) "
          f"<- retrieval-recall ceiling")
    print(f"worst multiplicity: {stats['worst_multiplicity']}", flush=True)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--base_path", default=None)
    ap.add_argument("--array_cache", default=None)
    ap.add_argument("--synthetic", action="store_true")
    args = ap.parse_args(argv)

    if args.synthetic:
        from text2loc_tpu_torch.config import small_test_config
        from text2loc_tpu_torch.data.arrays import MultiSceneArrays
        from text2loc_tpu_torch.data.synthetic import make_scene

        cfg = small_test_config()
        data = MultiSceneArrays([
            make_scene("0000", num_cells=8, num_poses=64,
                       object_slots=cfg.model.object_size,
                       num_points=cfg.model.pointnet.num_points,
                       num_mentioned=cfg.model.num_mentioned)
        ])
        print_stats(description_stats(data), "synthetic")
        return

    assert args.base_path, "--base_path or --synthetic required"
    from text2loc_tpu_torch.data.ingest import load_dataset

    for split in ("train", "val", "test"):
        data = load_dataset(args.base_path, split, out_dir=args.array_cache)
        print_stats(description_stats(data), split)


if __name__ == "__main__":
    main()
