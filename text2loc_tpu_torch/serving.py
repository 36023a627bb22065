"""The cached serve: hint triples -> world positions (port of
text2loc_tpu/serving.py:Localizer, dense, with the fine cache).

Built once per map and weights:

* the coarse gallery — every cell through PointNet2, ObjectEncoder and the
  obj_inter stack ([C, Dc]);
* the fine cache — every cell through PointNet2, ObjectEncoder and the
  CCT's layer-0 object self block ([C, pad, Df] + mask);
* the two sentence tables over the closed hint vocabulary ([V, Dc], [V, Df]).

Per request: the sentence-table gathers, the coarse inter head, full-gallery
top-k, the layer-0 hint self block, cct_tail over the B*K pairs, and the
world coordinates. Batches are padded to power-of-two buckets and sliced
back (see Localizer._padder).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from text2loc_tpu_torch import constants as C
from text2loc_tpu_torch.evaluation.retrieval import (
    build_vocab_sentence_table,
    encode_fine_gallery,
    encode_gallery,
    topk_retrieval,
)


class LocalizationResult(NamedTuple):
    position_w: np.ndarray       # [B, 2] top-1 world position per query
    candidates_w: np.ndarray     # [B, K, 2] per-candidate world positions
    cell_indices: np.ndarray     # [B, K] retrieved gallery cells
    scores: np.ndarray           # [B, K] retrieval similarities


class Localizer:
    """Query path over a fixed cell gallery. The caches are derived from the
    models and the map at construction; build a new Localizer for new
    weights. The options the models were built with (convert.build_model:
    sa_mode, vmem_gather, fused_attn / fused_ffn / fused_ln) select the
    kernels. `device` defaults to the CUDA card; pass "cpu" for the plain
    versions of the kernels."""

    def __init__(self, data, coarse_model, fine_model, embedder, cfg,
                 top_k: int = 10, device="cuda"):
        self.device = torch.device(device)
        self.data = data
        self.cfg = cfg
        self.top_k = min(top_k, data.num_cells)
        self.coarse_model = coarse_model.to(self.device).eval()
        self.fine_model = fine_model.to(self.device).eval()
        self.embedder = embedder.to(self.device)
        with torch.no_grad():
            self.gallery = encode_gallery(data, self.coarse_model, cfg, self.device)
            self.fine_emb, self.fine_mask = encode_fine_gallery(
                data, self.fine_model, cfg, self.device)
            self.coarse_sent_table = build_vocab_sentence_table(
                self.embedder, self.coarse_model.encode_text_sentences)
            self.fine_sent_table = build_vocab_sentence_table(
                self.embedder, self.fine_model.encode_hints)
        self.bbox = torch.as_tensor(data.cell_bbox, device=self.device).float()
        self.size = torch.as_tensor(data.cell_size, device=self.device).float()

    @staticmethod
    def _bucket(b: int) -> int:
        """Next power-of-two batch bucket."""
        n = 1
        while n < b:
            n *= 2
        return n

    def _padder(self, n_real: int):
        """Pads a [B, ...] host array to the batch's bucket by repeating its
        last row. The JAX serve pads to reuse one compiled program per
        bucket; eager PyTorch compiles nothing per shape, so here padding
        only costs the padded rows (a batch of 5 computes 8). It is kept so
        that the serve sees log2 many batch shapes, which capturing one CUDA
        graph per bucket needs (PERF.md, open questions)."""
        bucket = self._bucket(n_real)

        def pad(a):
            a = np.asarray(a)
            return np.concatenate(
                [a, np.repeat(a[-1:], bucket - n_real, axis=0)], axis=0
            ) if len(a) < bucket else a

        return pad

    @torch.no_grad()
    def serve(self, hint_dir, hint_color, hint_label, sentence_mask):
        """One batch on the device: [B, S] int64 hint triples and bool mask ->
        (cand_w [B, K, 2] f32, idx [B, K], scores [B, K])."""
        ids = C.hint_id(hint_dir, hint_color, hint_label)
        text_enc = self.coarse_model.encode_text_from_sentences(
            self.coarse_sent_table[ids], sentence_mask)
        hints = self.fine_sent_table[ids]
        hints1 = self.fine_model.cct_hints_pre(hints, sentence_mask)
        scores, idx = topk_retrieval(self.gallery, text_enc, self.top_k)
        b, k = idx.shape
        rep = torch.arange(b, device=self.device).repeat_interleave(k)
        flat = idx.reshape(-1)
        pred = self.fine_model.cct_tail(
            self.fine_emb[flat], self.fine_mask[flat], hints[rep], hints1[rep],
            sentence_mask[rep],
        ).reshape(b, k, 2)
        cand_w = self.bbox[idx][:, :, 0:2] + pred * self.size[idx][..., None]
        return cand_w, idx, scores

    def localize(self, hint_dir, hint_color, hint_label,
                 sentence_mask: Optional[np.ndarray] = None) -> LocalizationResult:
        """hint_*: [B, S] int hint triples -> positions. `sentence_mask`
        ([B, S] bool) marks real hints when a query carries fewer than S."""
        n_real = len(np.asarray(hint_dir))
        pad = self._padder(n_real)
        if sentence_mask is None:
            sentence_mask = np.ones(np.asarray(hint_dir).shape, bool)

        def dev(a, dtype):
            return torch.as_tensor(pad(a), device=self.device).to(dtype)

        cand_w, idx, scores = self.serve(
            dev(hint_dir, torch.long), dev(hint_color, torch.long),
            dev(hint_label, torch.long), dev(sentence_mask, torch.bool))
        cand_w = cand_w.float().cpu().numpy()[:n_real]
        return LocalizationResult(
            position_w=cand_w[:, 0],
            candidates_w=cand_w,
            cell_indices=idx.cpu().numpy()[:n_real],
            scores=scores.cpu().numpy()[:n_real],
        )
