"""Retrieval and matching losses, the matching metric and the pose-error
metric (port of text2loc_tpu/training/losses.py).

With a data-parallel `mesh` (parallel/mesh.py) the pair losses gather both
towers' rows of every rank (all_gather_rows), so each rank scores its
queries against the global batch of negatives, as the JAX package's
_maybe_global does. Each rank then returns its share of the global loss:
the terms of the rows it owns (the JAX `offset`), over the global batch
size. The shares sum to the single-device loss, and so do their
gradients once the step sums the parameter gradients over the ranks.
nt_xent does the same over the 2B views of both sides.
"""

from __future__ import annotations

import numpy as np
import torch

from text2loc_tpu_torch.ops.masked import l2_normalize
from text2loc_tpu_torch.parallel.mesh import all_gather_rows


def _maybe_global(anchor, positive, mesh):
    """Both towers' rows of every rank, in rank order, under a mesh."""
    if mesh is None:
        return anchor, positive
    return all_gather_rows(anchor, mesh), all_gather_rows(positive, mesh)


def _share(per_row, mesh, gathered: bool = True):
    """The mean of per-row terms [B]; under a mesh, this rank's share of
    the global mean: its rows' terms (rows [rank * b, (rank + 1) * b) of
    the gathered batch, or all of a local `per_row`) over the global B."""
    if mesh is None:
        return per_row.mean()
    if not gathered:
        return per_row.sum() / (per_row.shape[0] * mesh.size)
    b = per_row.shape[0] // mesh.size
    return per_row[mesh.rank * b:(mesh.rank + 1) * b].sum() / per_row.shape[0]


def contrastive_loss(anchor, positive, temperature: float = 0.1, mesh=None):
    """Symmetric InfoNCE: anchor [B, D] text, positive [B, D] cells; the
    positive pair on the diagonal, included in the denominator."""
    anchor, positive = _maybe_global(anchor, positive, mesh)
    a = l2_normalize(anchor.float())
    p = l2_normalize(positive.float())
    sim = (a @ p.t()) / temperature
    pos = torch.diagonal(sim)
    losses = (torch.logsumexp(sim, dim=0) - pos) + (torch.logsumexp(sim, dim=1) - pos)
    return _share(losses, mesh)


def _margin_costs(anchor, positive, margin: float):
    a = l2_normalize(anchor.float())
    p = l2_normalize(positive.float())
    scores = a @ p.t()
    diag = torch.diagonal(scores)
    off = 1.0 - torch.eye(scores.shape[0], dtype=scores.dtype, device=scores.device)
    cost_s = torch.clamp(margin - diag[None, :] + scores, min=0.0) * off
    cost_im = torch.clamp(margin - diag[:, None] + scores, min=0.0) * off
    return cost_s, cost_im


def pairwise_ranking_loss(anchor, positive, margin: float = 0.35, mesh=None):
    """Kiros et al. margin ranking, summed over negatives, / B."""
    cost_s, cost_im = _margin_costs(*_maybe_global(anchor, positive, mesh), margin)
    if mesh is None:
        return (cost_s.sum() + cost_im.sum()) / cost_s.shape[0]
    return _share(cost_s.sum(dim=1) + cost_im.sum(dim=1), mesh)


def hardest_ranking_loss(anchor, positive, margin: float = 0.35, scale: float = 64.0,
                         mesh=None):
    """Hardest-negative margin ranking x scale."""
    cost_s, cost_im = _margin_costs(*_maybe_global(anchor, positive, mesh), margin)
    if mesh is None:
        return (cost_s.amax(dim=1).mean() + cost_im.amax(dim=1).mean()) * scale
    return _share(cost_s.amax(dim=1) + cost_im.amax(dim=1), mesh) * scale


def triplet_margin_loss(anchor, positive, negative, margin: float = 0.35, mesh=None):
    """torch.nn.TripletMarginLoss semantics (L2 distances, mean); each row's
    term needs only its own triplet, so nothing is gathered under a mesh."""
    d_pos = torch.linalg.vector_norm(anchor - positive, dim=-1)
    d_neg = torch.linalg.vector_norm(anchor - negative, dim=-1)
    return _share(torch.clamp(d_pos - d_neg + margin, min=0.0), mesh, gathered=False)


def matching_loss(log_p, all_matches, match_mask):
    """SuperGlue NLL over a log-assignment matrix.

    log_p: [B, O+1, S+1] log assignment probabilities (with dustbins);
    all_matches: [B, M, 2] (object, hint) index pairs, padded;
    match_mask: [B, M] validity of each pair. Each sample's mean over its
    valid pairs, then the mean over the batch."""
    b = log_p.shape[0]
    bidx = torch.arange(b, device=log_p.device)[:, None]
    vals = -log_p[bidx, all_matches[..., 0].long(), all_matches[..., 1].long()]
    mask = match_mask.bool()
    per_sample = (torch.where(mask, vals, torch.zeros_like(vals)).sum(dim=1)
                  / mask.sum(dim=1).clamp(min=1))
    return per_sample.mean()


def make_retrieval_loss(cfg):
    """The pair loss selected by a LossConfig: f(anchor, positive, mesh=None)."""
    name = cfg.ranking_loss
    if name == "contrastive":
        return lambda a, p, mesh=None: contrastive_loss(a, p, cfg.temperature, mesh)
    if name == "pairwise":
        return lambda a, p, mesh=None: pairwise_ranking_loss(a, p, cfg.margin, mesh)
    if name == "hardest":
        return lambda a, p, mesh=None: hardest_ranking_loss(a, p, cfg.margin,
                                                            cfg.hardest_scale, mesh)
    raise ValueError(f"unsupported ranking_loss {name!r} for pair losses")


def nt_xent(z_i, z_j, temperature: float = 0.1, mesh=None):
    """SimCLR NT-Xent over the 2B augmented views z_i, z_j [B, D]: row r's
    positive is row r + B (mod 2B), every other row a negative. Under a
    `mesh` both views are gathered over the ranks (all_gather_rows), so
    each rank contrasts against the global 2B set, and each rank returns
    its share: the terms of its own rows of both views over the global 2B."""
    if mesh is not None:
        z_i, z_j = all_gather_rows(z_i, mesh), all_gather_rows(z_j, mesh)
    b = z_i.shape[0]
    z = l2_normalize(torch.cat([z_i, z_j], dim=0).float())
    sim = (z @ z.t()) / temperature
    eye = torch.eye(2 * b, dtype=torch.bool, device=sim.device)
    sim = sim.masked_fill(eye, float("-inf"))
    rows = torch.arange(2 * b, device=sim.device)
    pos = sim[rows, (rows + b) % (2 * b)]
    per_row = torch.logsumexp(sim, dim=1) - pos
    if mesh is None:
        return per_row.mean()
    return _share(per_row.reshape(2, b).sum(dim=0), mesh) / 2


def calc_recall_precision(gt_matches, pred_matches0, pred_matches1):
    """Matching recall and precision (numpy, as in the JAX package).

    gt_matches: [M, 2] (object, hint) ground-truth pairs, -1 on either side
    for a dustbin; pred_matches0: [O] each object's predicted hint (-1:
    none); pred_matches1: [S] each hint's predicted object (unused, as in
    the JAX package)."""
    gt = [tuple(m) for m in np.asarray(gt_matches)]
    true_pairs = {m for m in gt if m[0] >= 0 and m[1] >= 0}
    pred_pairs = {(o, int(h)) for o, h in enumerate(np.asarray(pred_matches0)) if h >= 0}
    recall = len(true_pairs & pred_pairs) / max(len(true_pairs), 1)
    precision = len(true_pairs & pred_pairs) / max(len(pred_pairs), 1)
    return recall, precision


def pose_error(pred_pos, gt_pose_in_cell):
    """Mean L2 error in normalized cell units, x-y plane."""
    return torch.linalg.vector_norm(pred_pos - gt_pose_in_cell[..., :2], dim=-1).mean()
