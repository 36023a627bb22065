"""Qualitative visualization: top-down cell renders + retrieval grids.

A copy of text2loc_tpu/evaluation/visualize.py (numpy on the host;
matplotlib and cv2 imported where they are used, as there). The evaluation
CLI's --plot_retrievals writes plot_retrieval_grid's PNG.

Parity with the reference's debug tooling: `plot_cell` top-down renders
(the reference's datapreparation/kitti360pose/drawing.py:72) and the
train-time retrieval grid with green/red success borders
(the reference's training/utils.py:36-95, success = retrieved-cell center
within 10 m of the query pose). Operates on SceneArrays instead of pickled
object graphs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def render_cell_topdown(data, cell_idx: int, size: int = 128) -> np.ndarray:
    """[size, size, 3] uint8 top-down scatter of a cell's object points."""
    img = np.zeros((size, size, 3), np.uint8)
    xyz = data.obj_xyz[cell_idx]      # [O, P, 3] normalized
    rgb = data.obj_rgb[cell_idx]
    mask = data.obj_mask[cell_idx]
    for oi in np.nonzero(mask)[0]:
        px = np.clip((xyz[oi, :, 0] * (size - 1)).astype(int), 0, size - 1)
        py = np.clip(((1.0 - xyz[oi, :, 1]) * (size - 1)).astype(int), 0, size - 1)
        img[py, px] = np.clip(rgb[oi] * 255.0, 0, 255).astype(np.uint8)
    return img


def render_cell_3d(data, cell_idx: int, out_path: Optional[str] = None,
                   elev: float = 35.0, azim: float = -60.0, max_points: int = 20000):
    """Headless 3D scatter of a cell — replaces the reference's interactive
    pptk viewers (datapreparation/kitti360pose/drawing.py:22-55,
    rendering.py:31-70), which need a display stack. Returns the matplotlib
    figure; writes a PNG when out_path is given.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xyz = data.obj_xyz[cell_idx]
    rgb = data.obj_rgb[cell_idx]
    mask = data.obj_mask[cell_idx]
    pts = xyz[mask].reshape(-1, 3)
    cols = np.clip(rgb[mask].reshape(-1, 3), 0.0, 1.0)
    if len(pts) > max_points:
        sel = np.random.default_rng(0).choice(len(pts), max_points, replace=False)
        pts, cols = pts[sel], cols[sel]

    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=cols, s=1, linewidths=0)
    ax.view_init(elev=elev, azim=azim)
    ax.set_box_aspect((1, 1, 0.4))
    ax.set_title(f"cell {cell_idx}")
    if out_path is not None:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def render_flythrough(data, cell_idx: int, out_dir: str, num_frames: int = 12,
                      elev: float = 35.0, size: int = 128) -> list:
    """Camera-orbit frame sequence around a cell — the headless equivalent of
    the reference's interactive pptk flythrough capture
    (datapreparation/kitti360pose/rendering.py:31-70, which drives a live
    viewer along a camera path and screenshots each step). Writes
    `frame_####.png` files along a full azimuth orbit and returns their paths;
    stitch with ffmpeg/imageio for a video.
    """
    import os

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    xyz = data.obj_xyz[cell_idx]
    rgb = data.obj_rgb[cell_idx]
    mask = data.obj_mask[cell_idx]
    pts = xyz[mask].reshape(-1, 3)
    cols = np.clip(rgb[mask].reshape(-1, 3), 0.0, 1.0)

    fig = plt.figure(figsize=(size / 32, size / 32))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=cols, s=1, linewidths=0)
    ax.set_box_aspect((1, 1, 0.4))
    ax.set_axis_off()
    for i, azim in enumerate(np.linspace(0.0, 360.0, num_frames, endpoint=False)):
        ax.view_init(elev=elev, azim=float(azim))
        p = os.path.join(out_dir, f"frame_{i:04d}.png")
        fig.savefig(p, dpi=64)
        paths.append(p)
    plt.close(fig)
    return paths


def render_pose_in_cell(data, pose_idx: int, size: int = 256,
                        pred_in_cell: Optional[np.ndarray] = None) -> np.ndarray:
    """Top-down render of a pose in its best cell: described (matched) objects
    circled, gt pose as a white cross, optional prediction as a magenta cross
    (reference drawing.py plot_pose_in_best_cell:123 + training/utils.py
    plot_matches:18 combined)."""
    ci = int(data.pose_cell_idx[pose_idx])
    img = render_cell_topdown(data, ci, size)

    def cross(img, xy, color, r=5):
        px = int(np.clip(xy[0] * (size - 1), 0, size - 1))
        py = int(np.clip((1.0 - xy[1]) * (size - 1), 0, size - 1))
        img[max(py - r, 0): py + r + 1, px] = color
        img[py, max(px - r, 0): px + r + 1] = color
        return img

    # Circle matched objects' centers.
    for si in range(data.hint_dir.shape[1]):
        oi = int(data.hint_obj_idx[pose_idx, si])
        if oi < 0:
            continue
        cx, cy = data.obj_center[ci, oi, :2]
        px = int(np.clip(cx * (size - 1), 0, size - 1))
        py = int(np.clip((1.0 - cy) * (size - 1), 0, size - 1))
        rr = 8
        for ang in np.linspace(0, 2 * np.pi, 40):
            qx = int(np.clip(px + rr * np.cos(ang), 0, size - 1))
            qy = int(np.clip(py + rr * np.sin(ang), 0, size - 1))
            img[qy, qx] = (255, 255, 0)

    img = cross(img, data.pose_in_cell[pose_idx], (255, 255, 255))
    if pred_in_cell is not None:
        img = cross(img, np.asarray(pred_in_cell), (255, 0, 255))
    return img


def _border(img: np.ndarray, color, width: int = 4) -> np.ndarray:
    out = img.copy()
    out[:width], out[-width:] = color, color
    out[:, :width], out[:, -width:] = color, color
    return out


def plot_retrieval_grid(
    data,
    retrievals: np.ndarray,
    path: str,
    max_queries: int = 8,
    success_dist: float = 10.0,
    tile: int = 128,
) -> Optional[str]:
    """Rows = queries: [gt cell | top-k retrieved], green border when the
    retrieved cell's center is within `success_dist` m of the query pose
    (reference training/utils.py:60-85)."""
    try:
        import cv2
    except Exception:
        return None
    q = min(max_queries, retrievals.shape[0])
    k = retrievals.shape[1]
    centers = data.cell_centers

    rows = []
    for qi in range(q):
        gt = render_cell_topdown(data, int(data.pose_cell_idx[qi]), tile)
        tiles = [_border(gt, (255, 255, 255))]
        for ki in range(k):
            ci = int(retrievals[qi, ki])
            dist = np.linalg.norm(data.pose_w[qi, :2] - centers[ci])
            ok = (dist <= success_dist) and (
                data.cell_scene_idx[ci] == data.pose_scene_idx[qi]
            )
            color = (0, 255, 0) if ok else (0, 0, 255)
            tiles.append(_border(render_cell_topdown(data, ci, tile), color))
        rows.append(np.concatenate(tiles, axis=1))
    grid = np.concatenate(rows, axis=0)
    cv2.imwrite(path, grid[:, :, ::-1])  # RGB -> BGR
    return path
