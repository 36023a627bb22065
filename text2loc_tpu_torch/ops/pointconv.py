"""One set-abstraction level with in-kernel "first" neighbour selection:
the plain PyTorch version, the dispatch, and the BatchNorm fold (port of
text2loc_tpu/ops/pallas_pointconv.py:fused_sa_select, selection="first",
and fold_bn_affine)."""

from __future__ import annotations

import torch

from text2loc_tpu_torch.ops import cuda_pointconv
from text2loc_tpu_torch.ops.ballquery import ball_query_knn
from text2loc_tpu_torch.ops.masked import masked_max


def fold_bn_affine(dense_bias, bn_scale, bn_bias, bn_mean, bn_var,
                   eps: float = 1e-5) -> torch.Tensor:
    """(Dense bias, eval BN params/stats) -> [2, C] f32 (scale, shift):
    ((z + b) - mean) / sqrt(var + eps) * scale + bias == z * a + shift."""
    a = bn_scale.float() * torch.rsqrt(bn_var.float() + eps)
    shift = dense_bias.float() * a + (bn_bias.float() - bn_mean.float() * a)
    return torch.stack([a, shift]).contiguous()


def sa_select_first_plain(feat, pos, centers, w1, wp, ab1, w2, ab2,
                          radius: float, k: int) -> torch.Tensor:
    """[N, S, H2] pooled features in feat.dtype.

    feat [N, P, C+3] = concat(x, pos) in the compute dtype; pos [N, P, 3];
    centers [N, S, 3]; w1 [C+3, H1] and its position rows wp [3, H1] in the
    compute dtype; ab1 [2, H1] / ab2 [2, H2] folded BN (f32); w2 [H1, H2].

    The TPU kernel's numerics: u = feat @ w1 summed in f32 and rounded to the
    compute dtype (its one-hot gather of u), sv = -centers @ wp in f32, the
    first <= K in-radius points (ball_query_knn(first=True)), the folded-BN
    ReLU rounded to the compute dtype, @ w2 in f32, folded BN + ReLU, and
    the max over valid slots (an empty row gives 0)."""
    dt = feat.dtype
    n, s = centers.shape[:2]
    h1 = w1.shape[1]
    idx, mask = ball_query_knn(pos, centers, radius, k, first=True)   # [N,S,K]
    u = (feat.float() @ w1.float()).to(dt).float()                      # [N,P,H1]
    sv = -(centers.float() @ wp.float())                                # [N,S,H1]
    flat = idx.reshape(n, s * k, 1).expand(n, s * k, h1)
    gathered = torch.gather(u, 1, flat).reshape(n, s, k, h1)
    hid = torch.relu((gathered + sv[:, :, None, :]) * ab1[0] + ab1[1])
    hid = hid.to(dt).float()
    out = torch.relu((hid @ w2.float()) * ab2[0] + ab2[1])             # [N,S,K,H2]
    return masked_max(out, mask, dim=2).to(dt)


def sa_select_first(feat, pos, centers, w1, wp, ab1, w2, ab2, radius: float,
                    k: int) -> torch.Tensor:
    """The level on the tensors' device: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if feat.is_cuda:
        return cuda_pointconv.sa_select_first_cuda(
            feat, pos, centers, w1, wp, ab1, w2, ab2, radius, k)
    if feat.device.type != "cpu":
        raise ValueError(f"no SA level for device {feat.device}")
    return sa_select_first_plain(feat, pos, centers, w1, wp, ab1, w2, ab2,
                                 radius, k)
