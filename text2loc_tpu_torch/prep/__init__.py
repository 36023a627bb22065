"""Offline data preparation: raw KITTI-360 -> cells / poses pickles and npz
arrays, on the card (the port of text2loc_tpu/prep/).

PLY reading and the greedy trajectory sampling stay on the host. The work
over points runs in float64 torch ops on the chosen device: the voxel grid,
the (semantic, instance) grouping, each cell's crop with its per-object
in-box counts, DBSCAN pseudo-instances for stuff classes, the closest-point
queries of description and grounding, and the grid layout's distances. The
decisions over objects (selection, direction words, grounding) run in the
same numpy expressions as the JAX package on values that are bit-equal to
its own, so the outputs are equal. No scikit-learn: `prep/dbscan.py` is the
port's DBSCAN.

    python -m text2loc_tpu_torch.prep.prepare --path_in RAW --path_out OUT \
        --scene_name 2013_05_28_drive_0000_sync [--array_dir ARR] [--device cpu]
"""
