"""Frozen text embeddings as a lookup table over the hint vocabulary (port of
text2loc_tpu/models/text_embedding.py: make_embedder, compositional,
from_npz, embed).

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

    @classmethod
    def compositional(cls, embed_dim: int = 1024, max_tokens: int = 16,
                      seed: int = 17, device=None) -> "HintTextEmbedder":
        return cls(*compositional_table(embed_dim, max_tokens, seed), device=device)

    @classmethod
    def from_npz(cls, path: str, device=None) -> "HintTextEmbedder":
        """A prebuilt frozen-text table (scripts/build_t5_table.py)."""
        with np.load(path) as data:
            return cls(data["table"], data["token_mask"], device=device)
