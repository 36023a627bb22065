"""Hint-set language encoder over frozen token embeddings (port of
text2loc_tpu/models/language_encoder.py).

  token embeds [B*S, T, E] -> intra EncoderLayer(E, ff=4E) stack -> masked
  max over tokens -> inter_mlp (get_mlp2 [E, D]) -> [B, S, D]   (encode_sentences)
  coarse: x = x + layer(x) per inter layer (the reference's extra residual)
  -> masked max over sentences -> [B, D]                         (finish_coarse)

encode_sentences is a pure function of each sentence at eval, which is what
lets the serve precompute it over the closed hint vocabulary.
"""

from __future__ import annotations

import torch
from torch import nn

from text2loc_tpu_torch.data.batch import TextSet
from text2loc_tpu_torch.models.mlp import get_mlp2
from text2loc_tpu_torch.models.transformer import EncoderLayer, Gates
from text2loc_tpu_torch.ops.masked import masked_max


class LanguageEncoder(nn.Module):
    """`gates`: the fused-block gates of every transformer layer."""

    def __init__(self, embed_dim: int, token_dim: int, is_fine: bool = False,
                 intra_num_layers: int = 1, intra_num_heads: int = 4,
                 inter_num_layers: int = 1, inter_num_heads: int = 4,
                 mask_padded: bool = True, dtype=torch.float32,
                 dropout_rate: float = 0.1, gates: Gates = Gates()):
        super().__init__()
        self.embed_dim = embed_dim
        self.token_dim = token_dim
        self.is_fine = is_fine
        self.mask_padded = mask_padded
        self.dtype = dtype
        e = token_dim
        self.intra = nn.ModuleList(
            EncoderLayer(e, intra_num_heads, 4 * e, dtype=dtype,
                         dropout_rate=dropout_rate, gates=gates)
            for _ in range(intra_num_layers))
        self.inter_mlp = get_mlp2((e, embed_dim), dtype=dtype)
        if not is_fine:
            self.inter = nn.ModuleList(
                EncoderLayer(embed_dim, inter_num_heads, 4 * embed_dim, dtype=dtype,
                             dropout_rate=dropout_rate, gates=gates)
                for _ in range(inter_num_layers))

    def encode_sentences(self, text: TextSet) -> torch.Tensor:
        """Per-sentence trunk: [B, S, T, E] -> [B, S, D]."""
        b, s, t, e = text.token_embeds.shape
        if e != self.token_dim:
            raise ValueError(f"token width {e} != {self.token_dim}")
        x = text.token_embeds.reshape(b * s, t, e).to(self.dtype)
        token_mask = text.token_mask.reshape(b * s, t)
        for layer in self.intra:
            x = layer(x, mask=token_mask if self.mask_padded else None)
        x = masked_max(x, token_mask, dim=1) if self.mask_padded else x.amax(dim=1)
        sent_mask = text.sentence_mask.reshape(b * s) if self.mask_padded else None
        return self.inter_mlp(x, sent_mask).reshape(b, s, self.embed_dim)

    def finish_coarse(self, x: torch.Tensor, sentence_mask) -> torch.Tensor:
        """Cross-sentence head: [B, S, D] -> [B, D] (coarse path only)."""
        if self.is_fine:
            raise ValueError("finish_coarse is the coarse tower's head")
        smask = sentence_mask if self.mask_padded else None
        for layer in self.inter:
            x = x + layer(x, mask=smask)
        if self.mask_padded:
            return masked_max(x, sentence_mask, dim=1)
        return x.amax(dim=1)

    def forward(self, text: TextSet) -> torch.Tensor:
        x = self.encode_sentences(text)
        if self.is_fine:
            return x
        return self.finish_coarse(x, text.sentence_mask)
