"""Fine position regressor: cascaded cross-attention transformer (CCT) over
a cell's objects and a pose's hints (port of
text2loc_tpu/models/cross_matcher.py). forward() is the training forward
through the full cascade.

cct(obj, hints) == cct_tail(cct_obj_pre(obj), ..., hints, cct_hints_pre(hints))
exactly: the cascade's first self-attention blocks read one side only, so
the serve caches cct_obj_pre per gallery cell and runs cct_hints_pre once
per query; only cct_tail runs per (query, candidate) pair.
"""

from __future__ import annotations

import torch
from torch import nn

from text2loc_tpu_torch.data.batch import ObjectSet, TextSet
from text2loc_tpu_torch.models.cell_retrieval import default_fused_train, model_dtypes
from text2loc_tpu_torch.models.language_encoder import LanguageEncoder
from text2loc_tpu_torch.models.mlp import get_mlp_offset
from text2loc_tpu_torch.models.object_encoder import ObjectEncoder
from text2loc_tpu_torch.models.transformer import DecoderLayer
from text2loc_tpu_torch.ops.masked import l2_normalize, masked_max


class CrossMatch(nn.Module):
    """`fused_train`: per SA level, whether training runs the fused kernel
    (default: default_fused_train(cfg, "fine")). `sa_mode`,
    `approx_neighbors`, `bisect_iters`: PointNet2's inference SA options."""

    def __init__(self, cfg, sa_mode="first", fused_train=None, approx_neighbors=None,
                 bisect_iters: int = 12):
        super().__init__()
        self.cfg = cfg
        self.dtype, body_dtype = model_dtypes(cfg)
        d = cfg.fine_embed_dim
        self.embed_dim = d
        if fused_train is None:
            fused_train = default_fused_train(cfg, "fine")
        self.object_encoder = ObjectEncoder(d, cfg, dtype=body_dtype, sa_mode=sa_mode,
                                            fused_train=fused_train,
                                            approx_neighbors=approx_neighbors,
                                            bisect_iters=bisect_iters)
        self.language_encoder = LanguageEncoder(
            d, cfg.text_embed_dim, is_fine=True,
            intra_num_layers=cfg.fine_intra_num_layers,
            intra_num_heads=cfg.fine_intra_num_heads,
            mask_padded=cfg.mask_padded, dtype=self.dtype, dropout_rate=cfg.dropout_rate)
        n_layers = max(cfg.fine_num_decoder_layers, 1)

        def dec():
            return DecoderLayer(d, cfg.fine_num_decoder_heads, 4 * d, dtype=self.dtype,
                                dropout_rate=cfg.dropout_rate)

        self.cross_hints = nn.ModuleList(dec() for _ in range(n_layers))
        self.cross_objects = (nn.ModuleList(dec() for _ in range(n_layers))
                              if cfg.fine_num_decoder_layers > 0 else None)
        self.mlp_offsets = get_mlp_offset([d, d // 2, 2], dtype=self.dtype)

    def _masks(self, obj_mask, sentence_mask):
        if not self.cfg.mask_padded:
            return None, None
        return obj_mask, sentence_mask

    def _offsets(self, hints, sentence_mask):
        if self.cfg.mask_padded:
            pooled = masked_max(hints, sentence_mask, dim=1)          # [B, D]
        else:
            pooled = hints.amax(dim=1)
        return self.mlp_offsets(pooled.float())                        # [B, 2]

    def encode_objects(self, objects: ObjectSet) -> torch.Tensor:
        """[B, O, D] normalized object embeddings (per cell)."""
        return l2_normalize(self.object_encoder(objects).to(self.dtype))

    def encode_hints(self, text: TextSet) -> torch.Tensor:
        """[B, S, D] hint encodings (per query)."""
        return self.language_encoder(text)

    def cct(self, obj, obj_mask, hints, sentence_mask) -> torch.Tensor:
        """Cascaded cross-attention + offsets -> [B, 2]."""
        om, hm = self._masks(obj_mask, sentence_mask)
        if self.cross_objects is not None:
            for co, ch in zip(self.cross_objects, self.cross_hints):
                obj = co(obj, hints, tgt_mask=om, memory_mask=hm)
                hints = ch(hints, obj, tgt_mask=hm, memory_mask=om)
        else:
            hints = self.cross_hints[0](hints, obj, tgt_mask=hm, memory_mask=om)
        return self._offsets(hints, sentence_mask)

    def forward(self, objects: ObjectSet, text: TextSet) -> torch.Tensor:
        """[B, 2] predicted normalized positions: the objects and hints
        through the full cascade (the training forward)."""
        obj = self.encode_objects(objects)
        return self.cct(obj, objects.mask, self.encode_hints(text), text.sentence_mask)

    def cct_obj_pre(self, obj, obj_mask) -> torch.Tensor:
        """Per cell: the layer-0 object self-attention block."""
        if self.cross_objects is None:
            return obj
        om, _ = self._masks(obj_mask, None)
        return self.cross_objects[0](obj, tgt_mask=om, stage="self")

    def cct_hints_pre(self, hints, sentence_mask) -> torch.Tensor:
        """Per query: the layer-0 hint self-attention block."""
        _, hm = self._masks(None, sentence_mask)
        return self.cross_hints[0](hints, tgt_mask=hm, stage="self")

    def cct_tail(self, obj1, obj_mask, hints, hints1, sentence_mask) -> torch.Tensor:
        """Per pair: layer 0's cross + FFN blocks, the later layers, offsets.
        obj1 / hints1 are cct_obj_pre / cct_hints_pre outputs; `hints` are
        the original encodings (layer 0's object side attends to them)."""
        om, hm = self._masks(obj_mask, sentence_mask)
        if self.cross_objects is not None:
            obj = self.cross_objects[0](obj1, hints, memory_mask=hm, stage="rest")
            cur = self.cross_hints[0](hints1, obj, memory_mask=om, stage="rest")
            for co, ch in zip(self.cross_objects[1:], self.cross_hints[1:]):
                obj = co(obj, cur, tgt_mask=om, memory_mask=hm)
                cur = ch(cur, obj, tgt_mask=hm, memory_mask=om)
        else:
            cur = self.cross_hints[0](hints1, obj1, memory_mask=om, stage="rest")
        return self._offsets(cur, sentence_mask)
