"""Frozen text embeddings as a lookup table over the hint vocabulary (port of
text2loc_tpu/models/text_embedding.py: make_embedder, compositional,
from_npz, from_t5, embed, checksum).

The compositional stand-in is built by the same numpy recipe as the JAX
package's, so the two tables are byte-equal."""

from __future__ import annotations

import numpy as np
import torch

from text2loc_tpu_torch import constants as C
from text2loc_tpu_torch.data.batch import TextSet


def make_embedder(cfg, table_path=None):
    """(cfg, embedder) for a CLI: a prebuilt frozen table, whose [V, T, E]
    shape then sets the model's text dims, or the compositional stand-in at
    the configured dims (on the CPU; callers move it to their device)."""
    import dataclasses

    if table_path:
        emb = HintTextEmbedder.from_npz(table_path)
        model = dataclasses.replace(cfg.model, text_embed_dim=emb.embed_dim,
                                    max_hint_tokens=emb.max_tokens)
        return cfg.replace(model=model), emb
    return cfg, HintTextEmbedder.compositional(cfg.model.text_embed_dim,
                                               cfg.model.max_hint_tokens)


def compositional_table(embed_dim: int = 1024, max_tokens: int = 16,
                        seed: int = 17):
    """([V, T, E] f32 table, [V, T] bool mask) — the deterministic stand-in
    "frozen LLM": per-word embeddings composed through the hint template
    [The, pose, is, <dir>, of, a, <color>, <label>, .]."""
    template_words = ["The", "pose", "is", "of", "a", "."]
    # Colours keyed by NAME (COLOR_NAMES holds "gray" twice): identical
    # strings get identical embeddings, as from a frozen LLM.
    words = (
        template_words
        + [f"dir:{d}" for d in C.DIRECTIONS]
        + [f"col:{c}" for c in C.COLOR_NAMES]
        + [f"cls:{c}" for c in sorted(C.CLASS_TO_INDEX)]
    )
    word_to_id = {w: i for i, w in enumerate(words)}
    rng = np.random.default_rng(seed)
    word_emb = rng.standard_normal((len(words), embed_dim)).astype(np.float32)

    v = C.hint_vocab_size()
    table = np.zeros((v, max_tokens, embed_dim), dtype=np.float32)
    token_mask = np.zeros((v, max_tokens), dtype=bool)
    for d in range(C.NUM_DIRECTIONS):
        for col in range(C.NUM_COLORS):
            for lab in range(C.NUM_CLASSES):
                seq = [
                    word_to_id["The"], word_to_id["pose"], word_to_id["is"],
                    word_to_id[f"dir:{C.DIRECTIONS[d]}"], word_to_id["of"],
                    word_to_id["a"], word_to_id[f"col:{C.COLOR_NAMES[col]}"],
                    word_to_id[f"cls:{C.INDEX_TO_CLASS[lab]}"], word_to_id["."],
                ][:max_tokens]
                hid = int(C.hint_id(d, col, lab))
                table[hid, : len(seq)] = word_emb[seq]
                token_mask[hid, : len(seq)] = True
    return table, token_mask


class HintTextEmbedder:
    """Lookup-table embedder: table [V, T, E], token_mask [V, T]."""

    def __init__(self, table, token_mask, device=None):
        table = torch.as_tensor(table, dtype=torch.float32)
        token_mask = torch.as_tensor(token_mask, dtype=torch.bool)
        if table.shape[0] != C.hint_vocab_size() or token_mask.shape != table.shape[:2]:
            raise ValueError(f"table {tuple(table.shape)} / mask "
                             f"{tuple(token_mask.shape)} do not fit the vocabulary")
        self.table = table.to(device)
        self.token_mask = token_mask.to(device)

    @property
    def max_tokens(self) -> int:
        return self.table.shape[1]

    @property
    def embed_dim(self) -> int:
        return self.table.shape[2]

    def to(self, device) -> "HintTextEmbedder":
        return HintTextEmbedder(self.table, self.token_mask, device=device)

    def embed(self, hint_dir, hint_color, hint_label, sentence_mask=None) -> TextSet:
        """[B, S] integer hint triples -> TextSet with [B, S, T, E] embeds."""
        dev = self.table.device
        ids = C.hint_id(torch.as_tensor(hint_dir, device=dev).long(),
                        torch.as_tensor(hint_color, device=dev).long(),
                        torch.as_tensor(hint_label, device=dev).long())
        if sentence_mask is None:
            sentence_mask = torch.ones(ids.shape, dtype=torch.bool, device=dev)
        return TextSet(self.table[ids], self.token_mask[ids],
                       torch.as_tensor(sentence_mask, device=dev).bool())

    def checksum(self) -> str:
        """SHA-256 hex digest of the table's and the token mask's host bytes
        (f32, bool): the JAX embedder's digest for the same table."""
        import hashlib

        h = hashlib.sha256()
        h.update(np.ascontiguousarray(self.table.cpu().numpy()).tobytes())
        h.update(np.ascontiguousarray(self.token_mask.cpu().numpy()).tobytes())
        return h.hexdigest()

    @classmethod
    def compositional(cls, embed_dim: int = 1024, max_tokens: int = 16,
                      seed: int = 17, device=None) -> "HintTextEmbedder":
        return cls(*compositional_table(embed_dim, max_tokens, seed), device=device)

    @classmethod
    def from_npz(cls, path: str, device=None) -> "HintTextEmbedder":
        """A prebuilt frozen-text table (scripts/build_t5_table.py)."""
        with np.load(path) as data:
            return cls(data["table"], data["token_mask"], device=device)

    @classmethod
    def from_t5(cls, model_name_or_path=None, max_tokens: int = 32, batch_size: int = 64,
                cache_path=None, model=None, tokenizer=None,
                device="cuda") -> "HintTextEmbedder":
        """Build the table by running the frozen T5 encoder over the hint
        vocabulary once: the port's own `models.t5_encoder.T5Encoder`, given
        as `model` (with any `tokenizer` that speaks the HF call) or read
        from the local snapshot `model_name_or_path` on `device`. An
        existing `cache_path` npz is loaded instead; a missing one is
        written."""
        import os

        if cache_path is not None and os.path.exists(cache_path):
            return cls.from_npz(cache_path)

        from text2loc_tpu_torch.models.t5_encoder import T5OnlineEncoder, encode_sentences

        if model is None or tokenizer is None:
            online = T5OnlineEncoder.from_snapshot(model_name_or_path, max_tokens=max_tokens,
                                                   device=device)
            model, tokenizer = online.model, online.tokenizer
        sentences = [C.render_hint(d, col, lab)
                     for d in range(C.NUM_DIRECTIONS)
                     for col in range(C.NUM_COLORS)
                     for lab in range(C.NUM_CLASSES)]
        table = np.zeros((len(sentences), max_tokens, model.cfg.d_model), np.float32)
        token_mask = np.zeros((len(sentences), max_tokens), bool)
        for start in range(0, len(sentences), batch_size):
            chunk = sentences[start:start + batch_size]
            table[start:start + len(chunk)], token_mask[start:start + len(chunk)] = (
                encode_sentences(model, tokenizer, chunk, max_tokens))
        if cache_path is not None:
            np.savez_compressed(cache_path, table=table, token_mask=token_mask)
        return cls(table, token_mask)
