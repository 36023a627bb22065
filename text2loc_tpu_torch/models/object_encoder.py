"""Object encoder: one embedding per object from its PointNet++ features,
mean colour, position and point count (port of
text2loc_tpu/models/object_encoder.py, the published feature set)."""

from __future__ import annotations

import torch
from torch import nn

from text2loc_tpu_torch import constants as C
from text2loc_tpu_torch.data.batch import ObjectSet
from text2loc_tpu_torch.models.mlp import get_mlp
from text2loc_tpu_torch.models.pointnet2 import PointNet2
from text2loc_tpu_torch.ops.masked import l2_normalize


class ObjectEncoder(nn.Module):
    """`sa_mode`, `approx_neighbors`, `bisect_iters`, `vmem_gather`:
    PointNet2's SA options. `fused_train`: PointNet2's per-level training SA
    tokens."""

    def __init__(self, embed_dim: int, cfg, dtype=torch.float32,
                 sa_mode="first", fused_train=None, approx_neighbors=None,
                 bisect_iters: int = 12, vmem_gather: bool = False):
        super().__init__()
        if cfg.class_embed or cfg.color_embed:
            raise NotImplementedError(
                "the port encodes class and colour through PointNet and the "
                "colour MLP (the published features); embedding tables are "
                "not ported")
        self.cfg = cfg
        self.embed_dim = embed_dim
        self.dtype = dtype
        use = cfg.use_features
        n_feats = 0
        if "class" in use:
            self.pointnet = PointNet2(cfg.pointnet, C.NUM_CLASSES, C.NUM_COLORS,
                                      dtype=dtype, sa_mode=sa_mode,
                                      fused_train=fused_train,
                                      approx_neighbors=approx_neighbors,
                                      bisect_iters=bisect_iters,
                                      vmem_gather=vmem_gather)
            level = cfg.pointnet.features_level
            pn_dim = (cfg.pointnet.global_mlp[-1],) + tuple(cfg.pointnet.head_dims)
            self.mlp_pointnet = get_mlp([pn_dim[level], embed_dim], dtype=dtype)
            n_feats += 1
        if "color" in use:
            self.color_encoder = get_mlp([3, 64, embed_dim], dtype=dtype)
            n_feats += 1
        if "position" in use:
            self.pos_encoder = get_mlp([3, 64, embed_dim], dtype=dtype)
            n_feats += 1
        if "num" in use:
            self.num_encoder = get_mlp([1, 64, embed_dim], dtype=dtype)
            n_feats += 1
        self.n_feats = n_feats
        if n_feats > 1:
            self.mlp_merge = get_mlp([n_feats * embed_dim, embed_dim], dtype=dtype)

    def forward(self, objects: ObjectSet) -> torch.Tensor:
        """[B, O, embed_dim] object embeddings (not normalized). In training
        the BatchNorm statistics count the real objects only."""
        b, o = objects.xyz.shape[:2]
        use = self.cfg.use_features
        dt = self.dtype
        mask = objects.mask.reshape(b * o).to(torch.bool)
        embeddings = []
        if "class" in use:
            rgb = objects.rgb if "color" in use else torch.zeros_like(objects.rgb)
            xyz = objects.xyz.reshape(b * o, *objects.xyz.shape[2:])
            feats = self.pointnet(xyz, rgb.reshape(b * o, *rgb.shape[2:]), mask)
            pn_feat = self.pointnet.features_at_level(feats)
            if self.cfg.pointnet.freeze:
                pn_feat = pn_feat.detach()
            embeddings.append(l2_normalize(self.mlp_pointnet(pn_feat, mask)))
        if "color" in use:
            embeddings.append(l2_normalize(
                self.color_encoder(objects.color.reshape(b * o, 3).to(dt), mask)))
        if "position" in use:
            embeddings.append(l2_normalize(
                self.pos_encoder(objects.center.reshape(b * o, 3).to(dt), mask)))
        if "num" in use:
            num = objects.num_points.reshape(b * o, 1).to(dt)
            num = (num - C.NUM_POINTS_MEAN) / C.NUM_POINTS_STD
            embeddings.append(l2_normalize(self.num_encoder(num, mask)))
        if len(embeddings) > 1:
            merged = self.mlp_merge(torch.cat(embeddings, dim=-1), mask)
        else:
            merged = embeddings[0]
        return merged.reshape(b, o, self.embed_dim)
