"""Radius-limited neighbour query on fixed-shape point batches and the
neighbour gather (port of text2loc_tpu/ops/ballquery.py: ball_query_knn,
onehot_gather, gather_neighbors). The query is plain PyTorch; the gather
takes the row-gather kernel (ops/gather.py) when asked to."""

from __future__ import annotations

import torch

from text2loc_tpu_torch.ops.gather import gather_rows, gather_rows_grad

_BIG = 1e30


def squared_distances(src: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """[N, Q, P] squared distances by the |q|^2 - 2 q.p + |p|^2 expansion,
    clamped at 0. Every product and sum is its own tensor op, in a fixed
    order, so the CUDA SA kernel (csrc/sa_select.cu) reproduces the values
    bit for bit and the in-radius sets agree on boundary points."""
    q = query.float()
    s = src.float()
    qx, qy, qz = (q[..., i][:, :, None] for i in range(3))
    px, py, pz = (s[..., i][:, None, :] for i in range(3))
    sq = qx * qx + qy * qy + qz * qz
    sp = px * px + py * py + pz * pz
    cross = qx * px + qy * py + qz * pz
    return torch.clamp(sq - 2.0 * cross + sp, min=0.0)


def first_k(mask: torch.Tensor, k: int):
    """The first <= K set lanes of each row of `mask` [..., P], in lane
    order: (idx [..., K] int64, valid [..., K] bool); invalid slots point at
    slot 0's lane."""
    ir = mask.to(torch.int64)
    rank = torch.cumsum(ir, dim=-1) - ir
    key = torch.where(mask, rank.to(torch.float32),
                      torch.full((), _BIG, device=mask.device))
    vals, idx = torch.sort(key, dim=-1, stable=True)
    valid = vals[..., :k] < _BIG
    idx = idx[..., :k]
    return torch.where(valid, idx, idx[..., :1]), valid


def ball_query_knn(src: torch.Tensor, query: torch.Tensor, radius: float, k: int,
                   approx: bool = False, first: bool = False):
    """For each query point, K source points within `radius`.

    `first=False`: the K nearest in-radius points (ties: lowest index first,
    as lax.top_k). `first=True`: the FIRST <= K in-radius points in index
    order (torch-cluster radius() insertion order). `approx=True`: the K
    largest keys -d2 rounded to bf16, ties to the lowest index. The JAX
    package takes these keys through lax.approx_max_k, which returns the same
    key values but breaks ties in no fixed order; where a bf16 tie straddles
    the K-th slot the two index sets differ (ROADMAP, Queue 3).

    Returns idx [N, Q, K] int64 (invalid slots point at slot 0's neighbour)
    and mask [N, Q, K] bool (True = in radius).
    """
    if approx and first:
        raise ValueError("approx and first are mutually exclusive")
    d2 = squared_distances(src, query)
    in_radius = d2 <= radius * radius
    if first:
        return first_k(in_radius, k)
    key = torch.where(in_radius, d2, torch.full((), _BIG, device=d2.device))
    if approx:
        # Stable descending sort: equal bf16 keys keep index order.
        neg, idx = torch.sort((-key).to(torch.bfloat16), dim=-1, descending=True,
                              stable=True)
        vals = -neg[..., :k].float()
    else:
        # Stable ascending sort: equal keys keep index order (lax.top_k's ties).
        vals, idx = torch.sort(key, dim=-1, stable=True)
        vals = vals[..., :k]
    mask = vals < _BIG
    idx = idx[..., :k]
    idx = torch.where(mask, idx, idx[..., :1])
    return idx, mask


def onehot_gather(values: torch.Tensor, idx: torch.Tensor,
                  vmem_gather: bool = False) -> torch.Tensor:
    """values [N, P, C] gathered by idx [N, ...] -> [N, ..., C].

    Named after the JAX function, which gathers through a one-hot matmul;
    the result is exact either way, and here it is take-along-axis.
    `vmem_gather` (the JAX package's TEXT2LOC_VMEM_GATHER=1) routes it
    through the row-gather kernel: gather_rows_grad (the gather kernel, and
    the scatter-add kernel in the backward) when values carries a gradient,
    else gather_rows alone. The JAX package takes its kernel only where the
    cloud fits its VMEM budget (pallas_gather.fits_vmem); the port has no
    such budget and takes the kernel at every shape."""
    n, p, c = values.shape
    lead = idx.shape[1:]
    flat = idx.reshape(n, -1)
    if not vmem_gather:
        out = torch.gather(values, 1, flat.long()[..., None].expand(n, flat.shape[1], c))
    elif values.requires_grad and torch.is_grad_enabled():
        out = gather_rows_grad(values, flat)
    else:
        out = gather_rows(values, flat)
    return out.reshape((n,) + tuple(lead) + (c,))


def gather_neighbors(values: torch.Tensor, idx: torch.Tensor,
                     vmem_gather: bool = False) -> torch.Tensor:
    """values [N, P, C], idx [N, Q, K] -> [N, Q, K, C]."""
    return onehot_gather(values, idx, vmem_gather)
