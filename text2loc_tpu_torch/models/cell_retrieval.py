"""Coarse dual-encoder place-recognition towers (port of
text2loc_tpu/models/cell_retrieval.py).

* encode_text: LanguageEncoder (coarse) -> L2-normalize, split into
  encode_text_sentences (the per-sentence trunk) and
  encode_text_from_sentences (the cross-sentence head);
* encode_objects: ObjectEncoder -> L2-normalize -> zero the pad slots ->
  obj_inter EncoderLayers (D, ff=2D) -> masked max -> L2-normalize.
"""

from __future__ import annotations

import torch
from torch import nn

from text2loc_tpu_torch.data.batch import ObjectSet, TextSet
from text2loc_tpu_torch.models.language_encoder import LanguageEncoder
from text2loc_tpu_torch.models.object_encoder import ObjectEncoder
from text2loc_tpu_torch.models.transformer import EncoderLayer
from text2loc_tpu_torch.ops.masked import l2_normalize, masked_max

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def model_dtypes(cfg):
    """(tail dtype, body dtype) of a ModelConfig."""
    dtype = DTYPES[cfg.dtype]
    return dtype, DTYPES[cfg.body_dtype] if cfg.body_dtype else dtype


def default_fused_train(cfg, kind: str):
    """Which SA levels train through the fused kernel: the JAX package's
    measured per-stage defaults for an f32 body on the 3-level ladder
    (coarse all three, fine levels 2-3; training/steps.py), else the last
    level only."""
    n = len(cfg.pointnet.sa_num_points)
    body = cfg.body_dtype or cfg.train_dtype
    if n == 3 and body == "float32":
        return (True, True, True) if kind == "coarse" else (False, True, True)
    return (False,) * (n - 1) + (True,)


class CellRetrievalNetwork(nn.Module):
    """`fused_train`: per SA level, whether training runs the fused kernel
    (default: default_fused_train(cfg, "coarse")). `sa_mode`,
    `approx_neighbors`, `bisect_iters`: PointNet2's inference SA options."""

    def __init__(self, cfg, sa_mode="first", fused_train=None, approx_neighbors=None,
                 bisect_iters: int = 12):
        super().__init__()
        self.cfg = cfg
        self.dtype, body_dtype = model_dtypes(cfg)
        d = cfg.coarse_embed_dim
        self.embed_dim = d
        if fused_train is None:
            fused_train = default_fused_train(cfg, "coarse")
        self.object_encoder = ObjectEncoder(d, cfg, dtype=body_dtype, sa_mode=sa_mode,
                                            fused_train=fused_train,
                                            approx_neighbors=approx_neighbors,
                                            bisect_iters=bisect_iters)
        self.obj_inter = nn.ModuleList(
            EncoderLayer(d, cfg.object_inter_num_heads, 2 * d, dtype=self.dtype,
                         dropout_rate=cfg.dropout_rate)
            for _ in range(cfg.object_inter_num_layers))
        self.language_encoder = LanguageEncoder(
            d, cfg.text_embed_dim, is_fine=False,
            intra_num_layers=cfg.intra_num_layers,
            intra_num_heads=cfg.intra_num_heads,
            inter_num_layers=cfg.inter_num_layers,
            inter_num_heads=cfg.inter_num_heads,
            mask_padded=cfg.mask_padded, dtype=self.dtype, dropout_rate=cfg.dropout_rate)

    def forward(self, objects: ObjectSet, text: TextSet):
        """(cell embeddings [B, D], text embeddings [B, D]), both normalized."""
        return self.encode_objects(objects), self.encode_text(text)

    def encode_text(self, text: TextSet) -> torch.Tensor:
        return l2_normalize(self.language_encoder(text).float())

    def encode_text_sentences(self, text: TextSet) -> torch.Tensor:
        """Per-sentence trunk only: [B, S, T, E] -> [B, S, D]."""
        return self.language_encoder.encode_sentences(text)

    def encode_text_from_sentences(self, sent_emb, sentence_mask) -> torch.Tensor:
        """Cross-sentence head: [B, S, D] (+mask) -> normalized [B, D] f32."""
        enc = self.language_encoder.finish_coarse(sent_emb.to(self.dtype),
                                                  sentence_mask)
        return l2_normalize(enc.float())

    def encode_objects(self, objects: ObjectSet) -> torch.Tensor:
        x = self.object_encoder(objects).to(self.dtype)          # [B, O, D]
        x = l2_normalize(x)
        mask = objects.mask.to(torch.bool)
        if self.cfg.mask_padded:
            x = torch.where(mask[:, :, None], x, torch.zeros((), dtype=x.dtype,
                                                             device=x.device))
        attn_mask = mask if self.cfg.mask_padded else None
        for layer in self.obj_inter:
            x = layer(x, mask=attn_mask)
        pooled = masked_max(x, mask, dim=1) if self.cfg.mask_padded else x.amax(dim=1)
        return l2_normalize(pooled.float())                       # [B, D]
