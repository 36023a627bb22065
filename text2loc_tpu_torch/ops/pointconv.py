"""One set-abstraction level at inference: the plain PyTorch versions of the
three TPU SA kernels, their dispatch, and the BatchNorm fold (port of
text2loc_tpu/ops/pallas_pointconv.py: fused_sa_select with selection
"first" and "bisect", fused_sa_gather, fused_set_abstraction, and
fold_bn_affine).

Every level is a neighbour selection followed by one pooling tail (the TPU
kernels' _gather_mlp_pool): h1 = relu((u[j] + sv[i]) * a1 + b1) rounded to
the compute dtype, h2 = relu((h1 @ W2) * a2 + b2), the max over the
selected neighbours j of each center i (an empty row gives 0). a/b are the
folded eval BatchNorm, sv = -centers @ Wp. The kernels differ in the
selection and in u:

* fused_sa_select / fused_sa_gather: u = feat @ W1 over feat =
  concat(x, pos) in the compute dtype, summed in f32 and rounded to the
  compute dtype (the TPU kernels round u before their one-hot gather);
* fused_set_abstraction: u = x @ Wx + pos @ Wp, two f32 sums added, not
  rounded; pos stays f32.

A CUDA tensor takes the kernel (ops/cuda_pointconv.py), a CPU tensor the
plain version; any other device raises.
"""

from __future__ import annotations

import torch

from text2loc_tpu_torch.ops import cuda_pointconv
from text2loc_tpu_torch.ops.ballquery import ball_query_knn, first_k, squared_distances
from text2loc_tpu_torch.ops.masked import masked_max

SELECTIONS = ("first", "bisect")
INF = 3.0e38
# Edge activations the plain tail holds at once (elements): bounds the
# all-pairs levels, whose [N, S, P, H] tensors would not fit otherwise.
_CHUNK_ELEMS = 1 << 26


def fold_bn_affine(dense_bias, bn_scale, bn_bias, bn_mean, bn_var,
                   eps: float = 1e-5) -> torch.Tensor:
    """(Dense bias, eval BN params/stats) -> [2, C] f32 (scale, shift):
    ((z + b) - mean) / sqrt(var + eps) * scale + bias == z * a + shift."""
    a = bn_scale.float() * torch.rsqrt(bn_var.float() + eps)
    shift = dense_bias.float() * a + (bn_bias.float() - bn_mean.float() * a)
    return torch.stack([a, shift]).contiguous()


def pool_edges(u, sv, idx, mask, ab1, w2, ab2, dtype) -> torch.Tensor:
    """The shared tail: [N, S, H2] in `dtype`.

    u [N, P, H1] f32 per point; sv [N, S, H1] f32 per center; idx [N, S, K]
    the selected points (None: every point, K = P) and mask [N, S, K] their
    validity; ab1 [2, H1] / ab2 [2, H2] folded BN (f32); w2 [H1, H2]. Runs
    in chunks of clouds so that the edge activations stay bounded."""
    n, s, kk = mask.shape
    h1, h2 = w2.shape
    w2f = w2.float()
    step = max(1, _CHUNK_ELEMS // max(1, s * kk * max(h1, h2)))
    rows = []
    for a in range(0, n, step):
        b = min(n, a + step)
        if idx is None:
            g = u[a:b, None, :, :]
        else:
            flat = idx[a:b].reshape(b - a, s * kk, 1).expand(b - a, s * kk, h1)
            g = torch.gather(u[a:b], 1, flat.long()).reshape(b - a, s, kk, h1)
        hid = torch.relu((g + sv[a:b, :, None, :]) * ab1[0] + ab1[1])
        hid = hid.to(dtype).float()
        out = torch.relu((hid @ w2f) * ab2[0] + ab2[1])                   # [n,S,K,H2]
        rows.append(masked_max(out, mask[a:b], dim=2))
    if not rows:
        return torch.zeros((0, s, h2), dtype=dtype, device=u.device)
    return torch.cat(rows).to(dtype)


def _rounded_u(feat, w1):
    return (feat.float() @ w1.float()).to(feat.dtype).float()


def _center_term(centers, wp):
    return -(centers.float() @ wp.float())


def bisect_mask(d2, in_radius, r2: float, k: int, iters: int) -> torch.Tensor:
    """[N, S, P] bool: the in-radius points with d2 <= thr, where thr is the
    largest of `iters` bisection midpoints in [0, r2] with count(d2 <= thr)
    <= K, expanded to the next distance when the count falls short of K (the
    TPU kernel's tie expansion), or r2 when at most K points are in radius.
    Every step in f32, in the TPU kernel's order."""
    r2t = torch.tensor(r2, dtype=torch.float32, device=d2.device)
    shape = d2.shape[:-1] + (1,)

    def count(thr):
        return ((d2 <= thr) & in_radius).sum(dim=-1, keepdim=True)

    lo = torch.zeros(shape, dtype=torch.float32, device=d2.device)
    hi = r2t.expand(shape)
    for _ in range(iters):
        mid = (lo + hi) * 0.5
        ok = count(mid) <= k
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    nxt = torch.where((d2 > lo) & in_radius, d2,
                      torch.full((), INF, device=d2.device)).amin(dim=-1, keepdim=True)
    thr = torch.where(in_radius.sum(dim=-1, keepdim=True) <= k, r2t,
                      torch.where(count(lo) < k, nxt, lo))
    return (d2 <= thr) & in_radius


def sa_select_plain(feat, pos, centers, w1, wp, ab1, w2, ab2, radius: float, k: int,
                    selection: str = "first", bisect_iters: int = 12) -> torch.Tensor:
    """fused_sa_select's plain version: [N, S, H2] pooled features in
    feat.dtype.

    feat [N, P, C+3] = concat(x, pos) in the compute dtype; pos [N, P, 3];
    centers [N, S, 3]; w1 [C+3, H1] and its position rows wp [3, H1] in the
    compute dtype; ab1 [2, H1] / ab2 [2, H2] folded BN (f32); w2 [H1, H2].
    `selection`: "first" keeps the first <= K in-radius points in index
    order; "bisect" the <= K nearest up to the bisection's precision (see
    bisect_mask), again the first <= K of them in index order."""
    if selection == "first":
        idx, mask = ball_query_knn(pos, centers, radius, k, first=True)
    elif selection == "bisect":
        d2 = squared_distances(pos, centers)
        r2 = radius * radius
        idx, mask = first_k(bisect_mask(d2, d2 <= r2, r2, k, bisect_iters), k)
    else:
        raise ValueError(f"selection {selection!r}: expected one of {SELECTIONS}")
    return pool_edges(_rounded_u(feat, w1), _center_term(centers, wp), idx, mask,
                      ab1, w2, ab2, feat.dtype)


def sa_gather_plain(feat, centers, idx, mask, w1, wp, ab1, w2, ab2) -> torch.Tensor:
    """fused_sa_gather's plain version: the tail over precomputed neighbours
    idx [N, S, K] / mask [N, S, K] (a ball_query_knn result); the other
    arguments as sa_select_plain's."""
    return pool_edges(_rounded_u(feat, w1), _center_term(centers, wp), idx, mask,
                      ab1, w2, ab2, feat.dtype)


def set_abstraction_plain(x, pos, centers, wx, wp, ab1, w2, ab2, radius: float, k: int,
                          select_k: bool = True) -> torch.Tensor:
    """fused_set_abstraction's plain version: [N, S, H2] in x.dtype.

    x [N, P, C] in the compute dtype; pos [N, P, 3] f32; wx [C, H1] and
    wp [3, H1] in the compute dtype. `select_k`: the K nearest in-radius
    points (the TPU kernel's K masked-argmin rounds: ties to the lowest
    index); otherwise every in-radius point."""
    u = x.float() @ wx.float() + pos.float() @ wp.float()
    sv = _center_term(centers, wp)
    if select_k:
        idx, mask = ball_query_knn(pos, centers, radius, k)
    else:
        idx, mask = None, squared_distances(pos, centers) <= radius * radius
    return pool_edges(u, sv, idx, mask, ab1, w2, ab2, x.dtype)


def _on_cuda(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no SA level for device {t.device}")
    return False


def sa_select(feat, pos, centers, w1, wp, ab1, w2, ab2, radius: float, k: int,
              selection: str = "first", bisect_iters: int = 12) -> torch.Tensor:
    """The level on the tensors' device: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if _on_cuda(feat):
        return cuda_pointconv.sa_select_cuda(feat, pos, centers, w1, wp, ab1, w2, ab2,
                                             radius, k, selection, bisect_iters)
    return sa_select_plain(feat, pos, centers, w1, wp, ab1, w2, ab2, radius, k,
                           selection, bisect_iters)


def sa_gather(feat, centers, idx, mask, w1, wp, ab1, w2, ab2) -> torch.Tensor:
    if _on_cuda(feat):
        return cuda_pointconv.sa_gather_cuda(
            feat, centers, idx.to(torch.int32).contiguous(), mask.contiguous(),
            w1, wp, ab1, w2, ab2)
    return sa_gather_plain(feat, centers, idx, mask, w1, wp, ab1, w2, ab2)


def set_abstraction(x, pos, centers, wx, wp, ab1, w2, ab2, radius: float, k: int,
                    select_k: bool = True) -> torch.Tensor:
    if _on_cuda(x):
        return cuda_pointconv.set_abstraction_cuda(x, pos, centers, wx, wp, ab1, w2, ab2,
                                                   radius, k, select_k)
    return set_abstraction_plain(x, pos, centers, wx, wp, ab1, w2, ab2, radius, k,
                                 select_k)
