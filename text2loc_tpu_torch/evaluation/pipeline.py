"""End-to-end coarse-to-fine evaluation (port of
text2loc_tpu/evaluation/pipeline.py: run_coarse, run_fine, run_pipeline).

* run_coarse: full-gallery retrieval (eval_retrieval) scored as "predict
  the cell center" (pos_in_cells = 0.5);
* run_fine: every (pose, retrieved cell) pair refined by CrossMatch, either
  with each distinct retrieved cell encoded once through the split CCT the
  serve uses (cct_obj_pre per cell, cct_hints_pre per query, cct_tail per
  pair), or pair by pair through the whole model;
* run_pipeline: both, and the two k x thresh localization-recall tables.

    python -m text2loc_tpu_torch.evaluation.pipeline --synthetic --device cpu

The models are in eval mode on `device` (the CUDA card unless the caller
asks for the CPU); the options they were built with (convert.build_model:
sa_mode, approx_neighbors, vmem_gather, and the transformer gates
fused_attn / fused_ffn / fused_ln) select the kernels.
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np
import torch

from text2loc_tpu_torch import constants as C
from text2loc_tpu_torch.evaluation import metrics
from text2loc_tpu_torch.evaluation.retrieval import (
    build_vocab_sentence_table,
    encode_fine_gallery,
    eval_retrieval,
    object_set,
)


def _localization(data, retrievals, pos_in_cells, cfg):
    k = retrievals.shape[1]
    return metrics.localization_accuracies(
        pose_w=data.pose_w[:, :2], pose_scene_idx=data.pose_scene_idx,
        top_cell_bbox=data.cell_bbox[retrievals], top_cell_size=data.cell_size[retrievals],
        top_cell_scene_idx=data.cell_scene_idx[retrievals], pos_in_cells=pos_in_cells,
        top_k=[kk for kk in cfg.eval.top_k if kk <= k], threshs=cfg.eval.threshs)


def run_coarse(data, model, embedder, cfg, device="cuda"
               ) -> Tuple[Dict[int, Dict[float, float]], np.ndarray]:
    """Retrieval + center-guess accuracy table. Returns (table,
    retrievals [Q, K])."""
    _, _, retrievals = eval_retrieval(data, model, embedder, cfg, top_k=cfg.eval.top_k,
                                      device=device)
    center = np.full(retrievals.shape + (2,), 0.5, np.float32)
    return _localization(data, retrievals, center, cfg), retrievals


@torch.no_grad()
def _fine_cached(data, retrievals, model, embedder, cfg, chunk, device):
    """[Q*K, 2] predictions with each distinct cell and each query encoded
    once; only cct_tail runs per pair."""
    q, k = retrievals.shape
    pose_idx = np.repeat(np.arange(q), k)
    uniq, inv = np.unique(retrievals.reshape(-1), return_inverse=True)
    obj1, obj_mask = encode_fine_gallery(data, model, cfg, device, cell_indices=uniq)
    hint_mask = torch.as_tensor(data.hint_mask, device=device).bool()
    if cfg.eval.sentence_table:
        # The fine text path is the per-sentence trunk only, so over the
        # closed vocabulary it is a [V, D] table gather.
        table = build_vocab_sentence_table(embedder, model.encode_hints)
        ids = C.hint_id(*(torch.as_tensor(getattr(data, n), device=device).long()
                          for n in ("hint_dir", "hint_color", "hint_label")))
        hints = table[ids]
    else:
        rows = []
        for s in range(0, q, chunk):
            sl = slice(s, min(s + chunk, q))
            rows.append(model.encode_hints(embedder.embed(
                data.hint_dir[sl], data.hint_color[sl], data.hint_label[sl],
                hint_mask[sl])))
        hints = torch.cat(rows, dim=0)                                  # [Q, S, D]
    hints1 = model.cct_hints_pre(hints, hint_mask)
    inv_t = torch.as_tensor(inv, device=device)
    pose_t = torch.as_tensor(pose_idx, device=device)
    out = []
    for s in range(0, q * k, chunk):
        ci, pi = inv_t[s:s + chunk], pose_t[s:s + chunk]
        out.append(model.cct_tail(obj1[ci], obj_mask[ci], hints[pi], hints1[pi],
                                  hint_mask[pi]).float())
    return torch.cat(out, dim=0)


@torch.no_grad()
def _fine_recompute(data, retrievals, model, embedder, cfg, chunk, device):
    """[Q*K, 2] predictions pair by pair through the whole model, the
    retrieved cell's objects in storage order."""
    q, k = retrievals.shape
    pose_idx = np.repeat(np.arange(q), k)
    cell_idx = retrievals.reshape(-1)
    pad = cfg.model.pad_size
    out = []
    for s in range(0, q * k, chunk):
        sl = slice(s, min(s + chunk, q * k))
        batch = data.gather_fine(pose_idx[sl], pad, cell_indices=cell_idx[sl],
                                 match_first=False)
        objects = object_set(batch, cfg.model.pointnet.num_points, device)
        text = embedder.embed(batch["hint_dir"], batch["hint_color"], batch["hint_label"],
                              batch["sentence_mask"])
        out.append(model(objects, text).float())
    return torch.cat(out, dim=0)


def run_fine(data, retrievals: np.ndarray, model, embedder, cfg,
             precompute_cells: bool = True, device="cuda"):
    """Fine refinement of every (pose, candidate) pair, in chunks of at most
    128 pairs (queries for the hint encodings).

    Returns (table, pos_in_cells [Q, K, 2], queries per second). The rate
    counts the fine stage alone, with the device synchronized before the
    clock stops."""
    q, k = retrievals.shape
    chunk = min(cfg.eval.batch_size * max(cfg.eval.top_k), 128)
    fine = _fine_cached if precompute_cells else _fine_recompute
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    start = time.perf_counter()
    pred = fine(data, retrievals, model, embedder, cfg, chunk, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - start
    pos_in_cells = pred.cpu().numpy().reshape(q, k, 2)
    return (_localization(data, retrievals, pos_in_cells, cfg), pos_in_cells,
            q / max(elapsed, 1e-9))


def run_pipeline(data, coarse_model, fine_model, embedder, cfg, device="cuda",
                 verbose: bool = True) -> dict:
    """Coarse retrieval, fine refinement, both tables: {"coarse", "fine",
    "retrievals", "pos_in_cells", "fine_qps"}."""
    dev = torch.device(device)
    coarse_model = coarse_model.to(dev).eval()
    fine_model = fine_model.to(dev).eval()
    embedder = embedder.to(dev)
    coarse_accs, retrievals = run_coarse(data, coarse_model, embedder, cfg, dev)
    fine_accs, pos_in_cells, qps = run_fine(data, retrievals, fine_model, embedder, cfg,
                                            device=dev)
    if verbose:
        metrics.print_accuracies(coarse_accs, "Coarse")
        metrics.print_accuracies(fine_accs, "Fine")
        print(f"Fine matching: {qps:.1f} queries/sec", flush=True)
    return {"coarse": coarse_accs, "fine": fine_accs, "retrievals": retrievals,
            "pos_in_cells": pos_in_cells, "fine_qps": qps}


if __name__ == "__main__":
    from text2loc_tpu_torch.evaluation.cli import main_pipeline

    main_pipeline()
