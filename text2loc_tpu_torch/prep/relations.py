"""PMC neighbour maps: direction/{scene}.json (the port's copy of
text2loc_tpu/prep/relations.py: build_neighbor_map, write_neighbor_maps).

For each cell, the 8 compass neighbours whose bbox origin lies exactly one
stride (10 m in the published dataset) away, found through a dict of the
cells' origins. Host-side: one entry per cell.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Sequence

import numpy as np

from text2loc_tpu_torch.constants import NEIGHBOR_KEYS
from text2loc_tpu_torch.data.structs import Cell

# (dx, dy) per compass key at the fixed 10 m stride.
_OFFSETS = {
    "east": (10, 0), "west": (-10, 0), "north": (0, 10), "south": (0, -10),
    "northeast": (10, 10), "northwest": (-10, 10),
    "southeast": (10, -10), "southwest": (-10, -10),
}


def build_neighbor_map(cells: Sequence[Cell], stride: float = 10.0) -> Dict:
    """cell id -> {compass key: neighbor id | None}."""
    origins = np.array([c.bbox_w[:2] for c in cells])
    by_origin = {
        (round(float(x), 3), round(float(y), 3)): c.id
        for (x, y), c in zip(origins, cells)
    }
    out: Dict[str, Dict] = {}
    for (x, y), cell in zip(origins, cells):
        nbrs = {}
        for key in NEIGHBOR_KEYS:
            dx, dy = _OFFSETS[key]
            scale = stride / 10.0
            nbrs[key] = by_origin.get(
                (round(float(x + dx * scale), 3), round(float(y + dy * scale), 3))
            )
        out[cell.id] = nbrs
    return out


def write_neighbor_maps(cells_by_scene: Dict[str, Sequence[Cell]], out_dir: str,
                        stride: float = 10.0) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for scene_name, cells in cells_by_scene.items():
        path = os.path.join(out_dir, f"{scene_name}.json")
        with open(path, "w") as f:
            json.dump(build_neighbor_map(cells, stride), f, indent=2)
