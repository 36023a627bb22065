"""Localization-recall metrics and the published accuracy-table format (the
port's own copy of text2loc_tpu/evaluation/metrics.py, numpy only).

* prediction in world coords: bbox_w[0:2] + pos_in_cell * cell_size;
* retrievals from a different scene than the query are forced to infinite
  distance;
* success@k,t = min distance over the top-k candidates <= t;
* coarse top-k recall: target cell id in top-k; "close" recall: any top-k
  cell center within cell_size/2.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def localization_accuracies(
    pose_w: np.ndarray,            # [Q, 2] gt world positions
    pose_scene_idx: np.ndarray,    # [Q] scene of the gt (best) cell
    top_cell_bbox: np.ndarray,     # [Q, K, 6] bbox_w of retrieved cells
    top_cell_size: np.ndarray,     # [Q, K]
    top_cell_scene_idx: np.ndarray,  # [Q, K]
    pos_in_cells: np.ndarray,      # [Q, K, 2] predicted normalized positions
    top_k: Sequence[int],
    threshs: Sequence[float],
) -> Dict[int, Dict[float, float]]:
    """Batched calc_sample_accuracies over all queries."""
    pred_w = top_cell_bbox[..., 0:2] + pos_in_cells * top_cell_size[..., None]
    dists = np.linalg.norm(pose_w[:, None, :2] - pred_w, axis=-1)  # [Q, K]
    cross_scene = top_cell_scene_idx != pose_scene_idx[:, None]
    dists = np.where(cross_scene, np.inf, dists)

    out: Dict[int, Dict[float, float]] = {}
    for k in top_k:
        best = np.min(dists[:, :k], axis=1)
        out[k] = {t: float(np.mean(best <= t)) for t in threshs}
    return out


def retrieval_accuracies(
    retrieved_cell_idx: np.ndarray,  # [Q, K] gallery indices, best first
    target_cell_idx: np.ndarray,     # [Q]
    pose_w: np.ndarray,              # [Q, 2]
    cell_centers: np.ndarray,        # [C, 2] gallery cell centers (world)
    cell_size: float,
    top_k: Sequence[int],
):
    """Coarse recall + close-recall."""
    hit = retrieved_cell_idx == target_cell_idx[:, None]          # [Q, K]
    centers = cell_centers[retrieved_cell_idx]                    # [Q, K, 2]
    dist = np.linalg.norm(pose_w[:, None, :2] - centers, axis=-1)
    close = dist <= cell_size / 2

    accuracies = {k: float(np.mean(np.any(hit[:, :k], axis=1))) for k in top_k}
    accuracies_close = {k: float(np.mean(np.any(close[:, :k], axis=1))) for k in top_k}
    return accuracies, accuracies_close


def print_accuracies(accs: Dict[int, Dict[float, float]], name: str = "") -> str:
    """The k x thresh text table, printed and returned; the trailing blank
    lines follow the reference's output stream."""
    lines = []
    if name:
        lines.append(f"\t\t{name}:")
    top_k = list(accs.keys())
    threshs = list(accs[top_k[0]].keys())
    lines.append("".join(f"\t\t\t\t{k}" for k in top_k))
    row = "/".join(str(t) for t in threshs) + ":"
    for k in top_k:
        row += "\t" + "/".join(f"{accs[k][t]:0.4f}" for t in threshs)
    lines.append(row)
    text = "\n".join(lines) + "\n\n"
    print(text, flush=True)
    return text
