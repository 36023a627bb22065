"""Retrieval losses and the pose-error metric (port of
text2loc_tpu/training/losses.py, on one device: the all-gather of the
data-parallel InfoNCE comes with the parallel slice)."""

from __future__ import annotations

import torch

from text2loc_tpu_torch.ops.masked import l2_normalize


def contrastive_loss(anchor, positive, temperature: float = 0.1):
    """Symmetric InfoNCE: anchor [B, D] text, positive [B, D] cells; the
    positive pair on the diagonal, included in the denominator."""
    a = l2_normalize(anchor.float())
    p = l2_normalize(positive.float())
    sim = (a @ p.t()) / temperature
    pos = torch.diagonal(sim)
    losses = (torch.logsumexp(sim, dim=0) - pos) + (torch.logsumexp(sim, dim=1) - pos)
    return losses.mean()


def _margin_costs(anchor, positive, margin: float):
    a = l2_normalize(anchor.float())
    p = l2_normalize(positive.float())
    scores = a @ p.t()
    diag = torch.diagonal(scores)
    off = 1.0 - torch.eye(scores.shape[0], dtype=scores.dtype, device=scores.device)
    cost_s = torch.clamp(margin - diag[None, :] + scores, min=0.0) * off
    cost_im = torch.clamp(margin - diag[:, None] + scores, min=0.0) * off
    return cost_s, cost_im


def pairwise_ranking_loss(anchor, positive, margin: float = 0.35):
    """Kiros et al. margin ranking, summed over negatives, / B."""
    cost_s, cost_im = _margin_costs(anchor, positive, margin)
    return (cost_s.sum() + cost_im.sum()) / cost_s.shape[0]


def hardest_ranking_loss(anchor, positive, margin: float = 0.35, scale: float = 64.0):
    """Hardest-negative margin ranking x scale."""
    cost_s, cost_im = _margin_costs(anchor, positive, margin)
    return (cost_s.amax(dim=1).mean() + cost_im.amax(dim=1).mean()) * scale


def triplet_margin_loss(anchor, positive, negative, margin: float = 0.35):
    """torch.nn.TripletMarginLoss semantics (L2 distances, mean)."""
    d_pos = torch.linalg.vector_norm(anchor - positive, dim=-1)
    d_neg = torch.linalg.vector_norm(anchor - negative, dim=-1)
    return torch.clamp(d_pos - d_neg + margin, min=0.0).mean()


def make_retrieval_loss(cfg):
    """The pair loss selected by a LossConfig: f(anchor, positive)."""
    name = cfg.ranking_loss
    if name == "contrastive":
        return lambda a, p: contrastive_loss(a, p, cfg.temperature)
    if name == "pairwise":
        return lambda a, p: pairwise_ranking_loss(a, p, cfg.margin)
    if name == "hardest":
        return lambda a, p: hardest_ranking_loss(a, p, cfg.margin, cfg.hardest_scale)
    raise ValueError(f"unsupported ranking_loss {name!r} for pair losses")


def pose_error(pred_pos, gt_pose_in_cell):
    """Mean L2 error in normalized cell units, x-y plane."""
    return torch.linalg.vector_norm(pred_pos - gt_pose_in_cell[..., :2], dim=-1).mean()
