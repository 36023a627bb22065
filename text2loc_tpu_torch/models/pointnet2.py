"""PointNet++ object backbone on dense [N, P, 3] clouds (port of
text2loc_tpu/models/pointnet2.py).

One FPS pass at the first ladder size serves all three SA levels (FPS is
prefix-stable). In eval each SA level runs in one of the JAX package's
inference modes over one parameter set (its TEXT2LOC_FUSED_SA values, here a
constructor argument: one mode for every level, or one per level):

* "first" (default; the TPU inference default): the first <= K in-radius
  points in index order, the whole level fused (fused_sa_select,
  selection="first");
* "full": the <= K nearest in radius by threshold bisection
  (fused_sa_select, selection="bisect", `bisect_iters` rounds);
* "gather": ball_query_knn outside the kernel (approximate bf16 keys unless
  approx_neighbors=False), then fused_sa_gather;
* "exact" (alias "1"): fused_set_abstraction with K argmin rounds;
* "all": fused_set_abstraction over every in-radius point;
* "off": the K nearest in-radius points with the MLP as plain tensor ops -
  the JAX package's XLA path (approximate keys with approx_neighbors=True).

The fused modes run the CUDA kernel on the card and its plain version on
the CPU (ops/pointconv.py).

In training (module.train()) every level takes the K nearest in-radius
points and batch-statistic BatchNorm over the valid edges of real objects;
a level with fused_train=True runs ops/sa_train.py (the CUDA kernels on the
card, the hand-derived backward), the others the plain masked edge MLP.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from text2loc_tpu_torch.models.mlp import MaskedBatchNorm, get_mlp
from text2loc_tpu_torch.ops.ballquery import ball_query_knn
from text2loc_tpu_torch.ops.fps import fps_gather
from text2loc_tpu_torch.ops.masked import masked_max
from text2loc_tpu_torch.ops.pointconv import (
    fold_bn_affine,
    sa_gather,
    sa_select,
    set_abstraction,
)
from text2loc_tpu_torch.ops.sa_train import sa_train

SA_MODES = ("off", "first", "full", "gather", "exact", "all")


def sa_mode_list(mode, n_levels: int) -> tuple:
    """Per-level SA modes from one mode, a comma list ("full,full,all", the
    JAX package's TEXT2LOC_FUSED_SA form) or a sequence; "1" is "exact" and
    "" is "off". A wrong length or an unknown mode raises."""
    if isinstance(mode, str):
        if "," in mode:
            modes = [m.strip() for m in mode.split(",")]
        else:
            modes = [mode or "off"] * n_levels
    else:
        modes = list(mode)
    modes = ["exact" if m == "1" else m for m in modes]
    if len(modes) != n_levels:
        raise ValueError(f"SA modes {mode!r}: expected {n_levels} modes (one per SA "
                         f"level), got {len(modes)}")
    bad = [m for m in modes if m not in SA_MODES]
    if bad:
        raise ValueError(f"SA modes {mode!r}: unknown mode(s) {bad}; expected "
                         f"{'|'.join(SA_MODES)}|1")
    return tuple(modes)


class PointNetFeatures(NamedTuple):
    features0: torch.Tensor  # [N, 1024]
    features1: torch.Tensor  # [N, 512]
    features2: torch.Tensor  # [N, 256]
    class_pred: torch.Tensor
    color_pred: torch.Tensor


class SetAbstraction(nn.Module):
    """One SA level: ball query + two-layer edge MLP + BatchNorm + max over
    the neighbours, at precomputed FPS centers."""

    def __init__(self, num_samples: int, radius: float, mlp_channels,
                 max_neighbors: int, dtype=torch.float32, mode: str = "first",
                 fused_train: bool = False, approx_neighbors=None,
                 bisect_iters: int = 12):
        super().__init__()
        (mode,) = sa_mode_list(mode, 1)
        cin, h1, h2 = mlp_channels
        self.num_samples = num_samples
        self.radius = radius
        self.max_neighbors = max_neighbors
        self.dtype = dtype
        self.mode = mode
        self.fused_train = fused_train
        # None: the JAX default, approximate keys in "gather" mode only.
        self.approx_neighbors = (mode == "gather" if approx_neighbors is None
                                 else bool(approx_neighbors))
        self.bisect_iters = bisect_iters
        self.dense_0 = nn.Linear(cin, h1)
        self.bn_0 = MaskedBatchNorm(h1)
        self.dense_1 = nn.Linear(h1, h2)
        self.bn_1 = MaskedBatchNorm(h2)

    def forward(self, x, pos, centers, obj_mask=None):
        """x [N, P, C] (compute dtype), pos [N, P, 3] f32, centers [N, S, 3],
        obj_mask [N] real-object flags (training statistics) -> [N, S, H2]
        in the compute dtype."""
        c = x.shape[-1]
        dt = self.dtype
        if self.training:
            return self._train_forward(x, pos, centers, obj_mask)
        mode, r, k = self.mode, self.radius, self.max_neighbors
        if mode == "off":
            return self._plain_forward(x, pos, centers)
        ab = [fold_bn_affine(lin.bias, bn.weight, bn.bias, bn.running_mean,
                             bn.running_var, bn.eps)
              for lin, bn in ((self.dense_0, self.bn_0), (self.dense_1, self.bn_1))]
        w0 = self.dense_0.weight.t().to(dt).contiguous()           # [C+3, H1]
        wp = w0[c:].contiguous()
        w2 = self.dense_1.weight.t().to(dt).contiguous()
        pos32, ctr32 = pos.float().contiguous(), centers.float().contiguous()
        if mode in ("exact", "all"):
            return set_abstraction(x.to(dt).contiguous(), pos32, ctr32,
                                   w0[:c].contiguous(), wp, ab[0], w2, ab[1], r, k,
                                   select_k=mode == "exact")
        feat = torch.cat([x.to(dt), pos.to(dt)], dim=-1).contiguous()
        if mode == "gather":
            idx, mask = ball_query_knn(pos, centers, r, k, approx=self.approx_neighbors)
            return sa_gather(feat, ctr32, idx, mask, w0, wp, ab[0], w2, ab[1])
        return sa_select(feat, pos32, ctr32, w0, wp, ab[0], w2, ab[1], r, k,
                         selection="first" if mode == "first" else "bisect",
                         bisect_iters=self.bisect_iters)

    def _plain_forward(self, x, pos, centers):
        """Mode "off": the K nearest in-radius points, the edge MLP with the
        BN running statistics as plain tensor ops, the masked max."""
        c = x.shape[-1]
        dt = self.dtype
        idx, mask = ball_query_knn(pos, centers, self.radius, self.max_neighbors,
                                   approx=self.approx_neighbors)
        n, s, k = idx.shape
        both = torch.cat([x, pos.to(x.dtype)], dim=-1)
        nbr = torch.gather(both, 1, idx.reshape(n, s * k, 1).expand(n, s * k, c + 3))
        nbr = nbr.reshape(n, s, k, c + 3)
        rel = nbr[..., c:] - centers[:, :, None, :].to(x.dtype)
        h = torch.cat([nbr[..., :c], rel], dim=-1)
        for lin, bn in ((self.dense_0, self.bn_0), (self.dense_1, self.bn_1)):
            h = nn.functional.linear(h, lin.weight.to(dt), lin.bias.to(dt))
            h = torch.relu(bn(h))
        return masked_max(h, mask, dim=2)

    def _train_forward(self, x, pos, centers, obj_mask):
        """The JAX package's train branch: exact nearest-K neighbours, BN
        statistics over bn_mask = neighbour mask & object mask."""
        c = x.shape[-1]
        dt = self.dtype
        idx, nbr_mask = ball_query_knn(pos, centers, self.radius, self.max_neighbors)
        bn_mask = nbr_mask
        if obj_mask is not None:
            bn_mask = nbr_mask & obj_mask.to(torch.bool)[:, None, None]
        if self.fused_train:
            # Hoisted first layer: concat(x_j, pos_j - c_i) @ W1 + b1
            # == (concat(x_j, pos_j) @ W1 + b1) - c_i @ W1[pos rows].
            w1 = self.dense_0.weight.t()
            both = torch.cat([x, pos.to(x.dtype)], dim=-1).float()
            u = both @ w1 + self.dense_0.bias
            sv = centers.float() @ w1[c:]
            out, (m1, v1, m2, v2, n1) = sa_train(
                u, sv, self.dense_1.weight.t(), self.dense_1.bias, self.bn_0.weight,
                self.bn_0.bias, self.bn_1.weight, self.bn_1.bias, idx, nbr_mask, bn_mask,
                eps=self.bn_0.eps, compute_dtype=dt)
            self.bn_0.update_running(m1, v1, n1)
            self.bn_1.update_running(m2, v2, n1)
            return out.to(dt)
        n, s, k = idx.shape
        both = torch.cat([x, pos.to(x.dtype)], dim=-1)
        nbr = torch.gather(both, 1, idx.reshape(n, s * k, 1).expand(n, s * k, c + 3))
        nbr = nbr.reshape(n, s, k, c + 3)
        rel = nbr[..., c:] - centers[:, :, None, :].to(x.dtype)
        h = torch.cat([nbr[..., :c], rel], dim=-1)
        for lin, bn in ((self.dense_0, self.bn_0), (self.dense_1, self.bn_1)):
            h = nn.functional.linear(h, lin.weight.to(dt), lin.bias.to(dt))
            h = torch.relu(bn(h, bn_mask))
        return masked_max(h, nbr_mask, dim=2)


class GlobalAbstraction(nn.Module):
    """concat(x, pos) -> get_mlp -> max over points."""

    def __init__(self, mlp_channels, dtype=torch.float32):
        super().__init__()
        self.mlp = get_mlp(mlp_channels, dtype=dtype)

    def forward(self, x, pos, obj_mask=None):
        feat = torch.cat([x, pos.to(x.dtype)], dim=-1)
        mask = None
        if obj_mask is not None:
            mask = obj_mask.to(torch.bool)[:, None].expand(feat.shape[:2])
        return self.mlp(feat, mask).amax(dim=1)


class PointNet2(nn.Module):
    """Batched PointNet++ over [N, P, 3] xyz + [N, P, 3] rgb clouds.
    `sa_mode`: the inference mode of every SA level, a comma list or a
    sequence of one mode per level (sa_mode_list); `approx_neighbors` and
    `bisect_iters` as SetAbstraction's. `fused_train`: per SA level, whether
    training runs the fused kernel."""

    def __init__(self, cfg, num_classes: int, num_colors: int,
                 dtype=torch.float32, sa_mode="first", fused_train=None,
                 approx_neighbors=None, bisect_iters: int = 12):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        ladder = list(cfg.sa_num_points)
        if any(ladder[i + 1] > ladder[i] for i in range(len(ladder) - 1)):
            raise ValueError(f"SA ladder {ladder} must not grow")
        fused_train = tuple(fused_train) if fused_train is not None else (False,) * len(ladder)
        if len(fused_train) != len(ladder):
            raise ValueError(f"fused_train {fused_train}: one flag per SA level {ladder}")
        modes = sa_mode_list(sa_mode, len(ladder))
        for i in range(len(ladder)):
            setattr(self, f"sa{i + 1}", SetAbstraction(
                ladder[i], cfg.sa_radii[i], cfg.sa_mlps[i], cfg.sa_max_neighbors,
                dtype=dtype, mode=modes[i], fused_train=fused_train[i],
                approx_neighbors=approx_neighbors, bisect_iters=bisect_iters))
        self.ga = GlobalAbstraction(cfg.global_mlp, dtype=dtype)
        self.lin1 = nn.Linear(cfg.global_mlp[-1], cfg.head_dims[0])
        self.lin2 = nn.Linear(cfg.head_dims[0], cfg.head_dims[1])
        self.class_classifier = nn.Linear(cfg.head_dims[1], num_classes)
        self.color_classifier = nn.Linear(cfg.head_dims[1], num_colors)

    def _dense(self, lin, x):
        return nn.functional.linear(x, lin.weight.to(self.dtype), lin.bias.to(self.dtype))

    def forward(self, xyz, rgb, obj_mask=None) -> PointNetFeatures:
        """obj_mask [N]: real-object flags for the training statistics."""
        x, pos = rgb.to(self.dtype), xyz
        ladder = list(self.cfg.sa_num_points)
        centers_all, _ = fps_gather(pos.float().contiguous(), ladder[0])
        for i, s in enumerate(ladder):
            centers = centers_all[:, :s]
            x = getattr(self, f"sa{i + 1}")(x, pos, centers, obj_mask)
            pos = centers
        f0 = self.ga(x, pos, obj_mask)
        f1 = torch.relu(self._dense(self.lin1, f0))
        f2 = torch.relu(self._dense(self.lin2, f1))
        return PointNetFeatures(f0, f1, f2, self._dense(self.class_classifier, f2),
                                self._dense(self.color_classifier, f2))

    def features_at_level(self, feats: PointNetFeatures):
        return (feats.features0, feats.features1, feats.features2)[self.cfg.features_level]
