"""Masked reductions for fixed-shape padded tensors (port of
text2loc_tpu/ops/masked.py)."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _expand_mask(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    m = mask.to(torch.bool)
    while m.ndim < x.ndim:
        m = m[..., None]
    return m


def masked_max(x, mask, dim, keepdim=False, fallback=0.0):
    """Max over `dim` ignoring entries where mask is False; a position with
    no valid entry gives `fallback` (PyG scatter-max's zero fill)."""
    m = _expand_mask(mask, x)
    filled = torch.where(m, x, torch.full((), NEG_INF, dtype=x.dtype, device=x.device))
    out = filled.amax(dim=dim, keepdim=keepdim)
    any_valid = m.expand_as(x).any(dim=dim, keepdim=keepdim)
    return torch.where(any_valid, out, torch.full((), fallback, dtype=out.dtype,
                                                  device=out.device))


def masked_mean(x, mask, dim, keepdim=False, eps=1e-9):
    """Mean over `dim` counting only valid entries."""
    m = _expand_mask(mask, x)
    total = torch.where(m, x, torch.zeros((), dtype=x.dtype, device=x.device)).sum(
        dim=dim, keepdim=keepdim)
    count = m.expand_as(x).to(x.dtype).sum(dim=dim, keepdim=keepdim)
    return total / torch.clamp(count, min=eps)


def masked_softmax(logits, mask, dim=-1):
    """Softmax over `dim` with invalid entries excluded; a row with no valid
    entry is all zeros."""
    m = _expand_mask(mask, logits)
    neg = torch.full((), NEG_INF, dtype=logits.dtype, device=logits.device)
    filled = torch.where(m, logits, neg)
    filled = filled - filled.amax(dim=dim, keepdim=True)
    exp = torch.where(m, torch.exp(filled), torch.zeros_like(filled))
    denom = exp.sum(dim=dim, keepdim=True)
    return exp / torch.clamp(denom, min=1e-30)


def l2_normalize(x, dim=-1, eps=1e-12):
    """L2-normalize along `dim` (torch F.normalize semantics: eps-clamped)."""
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(norm, min=eps)
