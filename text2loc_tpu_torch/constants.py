"""Dataset constants for KITTI360Pose (the port's own copy of the parts of
text2loc_tpu/constants.py that the port uses: the class and colour
vocabularies, the direction vocabulary with its flip tables, the point-count
standardization, the prep's semantic ids and per-class thresholds, the PMC
neighbour order, the scene splits, the hint template and the hint-id
arithmetic). The values are the reference's public dataset constants; the
two copies must stay equal (tests/test_torch_port_data.py and
tests/test_torch_port_prep.py check that they do)."""

from __future__ import annotations

import numpy as np

# Scene names and their train / val / test splits.
SCENE_NAMES = [
    "2013_05_28_drive_0000_sync",
    "2013_05_28_drive_0002_sync",
    "2013_05_28_drive_0003_sync",
    "2013_05_28_drive_0004_sync",
    "2013_05_28_drive_0005_sync",
    "2013_05_28_drive_0006_sync",
    "2013_05_28_drive_0007_sync",
    "2013_05_28_drive_0009_sync",
    "2013_05_28_drive_0010_sync",
]
SCENE_NAMES_TRAIN = [
    "2013_05_28_drive_0000_sync",
    "2013_05_28_drive_0002_sync",
    "2013_05_28_drive_0004_sync",
    "2013_05_28_drive_0006_sync",
    "2013_05_28_drive_0007_sync",
]
SCENE_NAMES_VAL = ["2013_05_28_drive_0010_sync"]
SCENE_NAMES_TEST = [
    "2013_05_28_drive_0003_sync",
    "2013_05_28_drive_0005_sync",
    "2013_05_28_drive_0009_sync",
]

# Class vocabulary. Index 0..21; "pad" (index 21) marks padding objects.
CLASS_TO_INDEX = {
    "building": 0,
    "pole": 1,
    "traffic light": 2,
    "traffic sign": 3,
    "garage": 4,
    "stop": 5,
    "smallpole": 6,
    "lamp": 7,
    "trash bin": 8,
    "vending machine": 9,
    "box": 10,
    "road": 11,
    "sidewalk": 12,
    "parking": 13,
    "wall": 14,
    "fence": 15,
    "guard rail": 16,
    "bridge": 17,
    "tunnel": 18,
    "vegetation": 19,
    "terrain": 20,
    "pad": 21,
}
INDEX_TO_CLASS = {v: k for k, v in CLASS_TO_INDEX.items()}
KNOWN_CLASSES = sorted(CLASS_TO_INDEX.keys())  # alphabetical, as the reference's
NUM_CLASSES = len(CLASS_TO_INDEX)
PAD_CLASS_INDEX = CLASS_TO_INDEX["pad"]

# 8 fitted RGB colour centroids in [0, 1].
COLORS = (
    np.array(
        [
            [47.2579917, 49.75368454, 42.4153065],
            [136.32696657, 136.95241796, 126.02741229],
            [87.49822126, 91.69058836, 80.14558512],
            [213.91030679, 216.25033052, 207.24611073],
            [110.39218852, 112.91977458, 103.68638249],
            [27.47505158, 28.43996795, 25.16840296],
            [66.65951839, 70.22342483, 60.20395996],
            [171.00852191, 170.05737735, 155.00130334],
        ]
    )
    / 255.0
)
COLOR_NAMES = [
    "dark-green",
    "gray",
    "gray-green",
    "bright-gray",
    "gray",
    "black",
    "green",
    "beige",
]
NUM_COLORS = len(COLOR_NAMES)

# Compass direction words of the hint template; the order is the integer
# direction vocabulary.
DIRECTIONS = [
    "on-top",
    "north",
    "east",
    "south",
    "west",
    "north-east",
    "south-east",
    "south-west",
    "north-west",
]
DIRECTION_TO_INDEX = {d: i for i, d in enumerate(DIRECTIONS)}
NUM_DIRECTIONS = len(DIRECTIONS)

# Horizontal flip (x -> 1-x) swaps east<->west; vertical flip (y -> 1-y)
# swaps north<->south.
_H_FLIP = {
    "east": "west",
    "west": "east",
    "north-east": "north-west",
    "north-west": "north-east",
    "south-east": "south-west",
    "south-west": "south-east",
}
_V_FLIP = {
    "north": "south",
    "south": "north",
    "north-east": "south-east",
    "south-east": "north-east",
    "north-west": "south-west",
    "south-west": "north-west",
}
DIRECTION_H_FLIP = np.array(
    [DIRECTION_TO_INDEX[_H_FLIP.get(d, d)] for d in DIRECTIONS], dtype=np.int32
)
DIRECTION_V_FLIP = np.array(
    [DIRECTION_TO_INDEX[_V_FLIP.get(d, d)] for d in DIRECTIONS], dtype=np.int32
)

# Stuff classes: the prep crops them into a cell and splits the crop into
# DBSCAN pseudo-instances (text2loc_tpu/constants.py STUFF_CLASSES).
STUFF_CLASSES = [
    "sidewalk",
    "road",
    "parking",
    "wall",
    "fence",
    "guard rail",
    "bridge",
    "tunnel",
    "vegetation",
    "terrain",
]

# KITTI-360 semantic-label ids per class: the prep extracts instances of
# these labels from the raw semantic point clouds.
CLASS_TO_SEMANTIC_ID = {
    "building": 11,
    "pole": 17,
    "traffic light": 19,
    "traffic sign": 20,
    "garage": 34,
    "stop": 36,
    "smallpole": 37,
    "lamp": 38,
    "trash bin": 39,
    "vending machine": 40,
    "box": 41,
    "road": 7,
    "sidewalk": 8,
    "parking": 9,
    "wall": 12,
    "fence": 13,
    "guard rail": 14,
    "bridge": 15,
    "tunnel": 16,
    "vegetation": 21,
    "terrain": 22,
}
SEMANTIC_ID_TO_CLASS = {v: k for k, v in CLASS_TO_SEMANTIC_ID.items()}

# Per-class prep thresholds: the fewest points an object keeps, and the
# voxel grid applied after each merge (None: no grid).
CLASS_TO_MINPOINTS = {
    "building": 250, "pole": 25, "traffic light": 25, "traffic sign": 25,
    "garage": 250, "stop": 25, "smallpole": 25, "lamp": 25, "trash bin": 25,
    "vending machine": 25, "box": 25, "sidewalk": 1000, "road": 1000,
    "parking": 1000, "wall": 250, "fence": 250, "guard rail": 250,
    "bridge": 1000, "tunnel": 1000, "vegetation": 250, "terrain": 250,
}
CLASS_TO_VOXELSIZE = {
    "building": 0.25, "pole": None, "traffic light": None, "traffic sign": None,
    "garage": 0.125, "stop": None, "smallpole": None, "lamp": None,
    "trash bin": None, "vending machine": None, "box": None, "sidewalk": 0.25,
    "road": 0.25, "parking": 0.25, "wall": 0.125, "fence": 0.125,
    "guard rail": 0.125, "bridge": 0.25, "tunnel": 0.25, "vegetation": 0.25,
    "terrain": 0.25,
}

# Compass neighbour-slot order of the PMC tables ([C, 8] cell_neighbors,
# [N, 8] pmc_valid / pmc_weight, [N, 8, S] pmc_match).
NEIGHBOR_KEYS = (
    "east", "west", "north", "south",
    "northeast", "northwest", "southeast", "southwest",
)

HINT_TEMPLATE = "The pose is {direction} of a {color} {label}."


def render_hint(direction_idx: int, color_idx: int, label_idx: int) -> str:
    """The canonical hint sentence of an integer hint triple."""
    return HINT_TEMPLATE.format(direction=DIRECTIONS[direction_idx],
                                color=COLOR_NAMES[color_idx],
                                label=INDEX_TO_CLASS[label_idx])


# Standardization of the point-count ("num") feature.
NUM_POINTS_MEAN = 1826.6844940968194
NUM_POINTS_STD = 2516.8905096993817


def hint_vocab_size() -> int:
    """Total number of distinct hint triples (direction x colour x class)."""
    return NUM_DIRECTIONS * NUM_COLORS * NUM_CLASSES


def hint_id(direction_idx, color_idx, label_idx):
    """Flatten a hint triple into a single vocabulary id (vectorized)."""
    return (direction_idx * NUM_COLORS + color_idx) * NUM_CLASSES + label_idx
