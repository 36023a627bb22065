"""A reader of HF `tokenizer.json` files of the T5 kind, in plain Python: no
`transformers`, `tokenizers` or `sentencepiece` (the card's machine has none
of them).

It stands in for the `tokenizers` machinery that the JAX package reaches
through `transformers.AutoTokenizer` (text2loc_tpu/models/t5_encoder.py
T5OnlineEncoder._tokenize), and returns the same ids and masks for what it
reads. It reads one pipeline, the one of T5's tokenizer.json and of the
vendored tiny tokenizer (assets/tiny_t5_tokenizer):

* added tokens (the file's `added_tokens` plus the special tokens of a
  special_tokens_map.json / tokenizer_config.json beside it, as
  transformers adds them): split out of the raw text first, leftmost
  longest, each its own id;
* no normalizer;
* a Metaspace pre-tokenizer (`replacement`, `prepend_scheme` always / first
  / never, `split`): spaces become the replacement, which is prepended to
  each text segment and, with `split`, starts a new word; a run of
  replacements stays one word start;
* a Unigram model: the Viterbi best segmentation of each word over the
  pieces' log-probabilities; a character that starts no piece becomes an
  unknown node (score: the least piece score minus 10), and consecutive
  unknown nodes fuse into one `unk_id`;
* a TemplateProcessing post-processor (special tokens around the sequence,
  for T5 the `</s>` suffix), whose tokens truncation makes room for.

Anything else (another model type, byte fallback, any normalizer such as
t5-large's `Precompiled` charsmap, another pre-tokenizer or post-processor,
added tokens that strip or match single words) raises NotImplementedError
naming it.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# tokenizers' Unigram: an unknown character scores the least piece score
# minus this penalty (unigram/model.rs K_UNK_PENALTY).
UNK_PENALTY = 10.0
_WORD_CACHE = 10_000


def _types(spec) -> List[str]:
    """The component type names of a tokenizer.json section, nested
    Sequences included."""
    if spec is None:
        return []
    out = [spec.get("type", "?")]
    for key in ("normalizers", "pretokenizers", "processors"):
        for sub in spec.get(key, ()):
            out += _types(sub)
    return out


def _refuse(section: str, spec) -> None:
    raise NotImplementedError(
        f"tokenizer.json {section} {'/'.join(_types(spec))} is not supported "
        "(this reader takes a Unigram model, no normalizer, a Metaspace "
        "pre-tokenizer and a TemplateProcessing post-processor)")


def _special_tokens(directory: str) -> Dict[str, List[str]]:
    """The special tokens of the files beside tokenizer.json
    (special_tokens_map.json, then tokenizer_config.json), as transformers
    reads them: key (pad_token, eos_token, ...) -> strings."""
    out: Dict[str, List[str]] = {}
    for name in ("special_tokens_map.json", "tokenizer_config.json"):
        path = os.path.join(directory, name)
        if not os.path.exists(path):
            continue
        with open(path) as f:
            cfg = json.load(f)
        for key in ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token",
                    "cls_token", "mask_token", "additional_special_tokens"):
            vals = cfg.get(key)
            for v in (vals if isinstance(vals, list) else [vals]):
                v = v.get("content") if isinstance(v, dict) else v
                if isinstance(v, str) and v not in out.setdefault(key, []):
                    out[key].append(v)
    return out


class UnigramTokenizer:
    """`tokenizer(sentences, return_tensors="np", padding="max_length",
    truncation=True, max_length=T)` -> {"input_ids", "attention_mask"}
    ([N, T] int64), as transformers' fast tokenizer returns them."""

    def __init__(self, pieces: Sequence[Tuple[str, float]], unk_id: int, pad_id: int,
                 prefix_ids: Sequence[int] = (), suffix_ids: Sequence[int] = (),
                 added: Optional[Dict[str, int]] = None, replacement: str = "▁",
                 prepend_scheme: str = "always", split: bool = True):
        if prepend_scheme not in ("always", "first", "never"):
            raise NotImplementedError(f"Metaspace prepend_scheme {prepend_scheme!r}")
        self.scores = [float(s) for _, s in pieces]
        # A piece listed twice maps to its last id, as tokenizers' map does.
        self.piece_to_id = {p: i for i, (p, _) in enumerate(pieces)}
        self.max_piece = max(len(p) for p, _ in pieces)
        self.unk_score = min(self.scores) - UNK_PENALTY
        self.unk_id, self.pad_id = int(unk_id), int(pad_id)
        self.prefix_ids, self.suffix_ids = list(prefix_ids), list(suffix_ids)
        self.added = dict(added or {})
        self._added_re = (re.compile("|".join(re.escape(t) for t in sorted(
            self.added, key=len, reverse=True))) if self.added else None)
        self.replacement, self.prepend_scheme, self.split = replacement, prepend_scheme, split
        self._cache: Dict[str, List[int]] = {}

    @classmethod
    def from_file(cls, path: str) -> "UnigramTokenizer":
        """Read a tokenizer.json (and the special-token files beside it)."""
        with open(path, encoding="utf-8") as f:
            spec = json.load(f)
        model = spec.get("model") or {}
        if model.get("type") != "Unigram":
            raise NotImplementedError(f"tokenizer.json model {model.get('type')!r} is not "
                                      "supported (Unigram only)")
        if model.get("byte_fallback"):
            raise NotImplementedError("tokenizer.json Unigram byte_fallback is not supported")
        if model.get("unk_id") is None:
            raise NotImplementedError("tokenizer.json Unigram without an unk_id")
        if spec.get("normalizer") is not None:
            _refuse("normalizer", spec["normalizer"])
        pre = spec.get("pre_tokenizer")
        if pre is None or pre.get("type") != "Metaspace":
            _refuse("pre_tokenizer", pre)
        pieces = [(p, s) for p, s in model["vocab"]]
        vocab = {p: i for i, (p, _) in enumerate(pieces)}

        added: Dict[str, int] = {}
        for tok in spec.get("added_tokens") or ():
            if tok.get("lstrip") or tok.get("rstrip") or tok.get("single_word"):
                raise NotImplementedError(
                    f"added token {tok['content']!r} with lstrip / rstrip / single_word")
            added[tok["content"]] = int(tok["id"])
        special = _special_tokens(os.path.dirname(os.path.abspath(path)))
        for s in (t for tokens in special.values() for t in tokens):
            if s not in added:
                if s not in vocab:
                    raise NotImplementedError(f"special token {s!r} is not in the vocabulary")
                added[s] = vocab[s]

        prefix, suffix = [], []
        post = spec.get("post_processor")
        if post is not None:
            if post.get("type") != "TemplateProcessing":
                _refuse("post_processor", post)
            specials = post.get("special_tokens", {})
            seen_sequence = False
            for item in post["single"]:
                if "Sequence" in item:
                    seen_sequence = True
                elif "SpecialToken" in item:
                    ids = specials[item["SpecialToken"]["id"]]["ids"]
                    (suffix if seen_sequence else prefix).extend(int(i) for i in ids)
                else:
                    _refuse("post_processor item", {"type": next(iter(item))})

        if special.get("pad_token"):
            pad_id = vocab[special["pad_token"][0]]
        elif spec.get("padding"):
            pad_id = int(spec["padding"]["pad_id"])
        else:
            raise ValueError(f"{path}: no pad token (padding='max_length' needs one)")
        scheme = pre.get("prepend_scheme")
        if scheme is None:  # files written before prepend_scheme existed
            scheme = "always" if pre.get("add_prefix_space", True) else "never"
        return cls(pieces, model["unk_id"], pad_id, prefix, suffix, added,
                   replacement=pre.get("replacement", "▁"), prepend_scheme=scheme,
                   split=pre.get("split", True))

    # ------------------------------------------------------------ pipeline

    def _words(self, segment: str, at_start: bool) -> List[str]:
        """Metaspace over one text segment (between added tokens)."""
        rep = self.replacement
        s = segment.replace(" ", rep)
        if s and not s.startswith(rep) and (
                self.prepend_scheme == "always"
                or (self.prepend_scheme == "first" and at_start)):
            s = rep + s
        if not s:
            return []
        if not self.split:
            return [s]
        words: List[str] = []
        prev = False
        for ch in s:
            is_rep = ch == rep
            if (is_rep and not prev) or not words:
                words.append(ch)
            else:
                words[-1] += ch
            prev = is_rep
        return words

    def _viterbi(self, word: str) -> List[int]:
        """The Unigram best path over `word`; unknown runs fused."""
        n = len(word)
        score = [0.0] * (n + 1)
        start: List[Optional[int]] = [None] * (n + 1)
        node = [0] * (n + 1)
        for i in range(n):
            base = score[i]
            single = False
            for ln in range(1, min(self.max_piece, n - i) + 1):
                pid = self.piece_to_id.get(word[i:i + ln])
                if pid is None:
                    continue
                cand = self.scores[pid] + base
                j = i + ln
                if start[j] is None or cand > score[j]:
                    score[j], start[j], node[j] = cand, i, pid
                single = single or ln == 1
            if not single:
                cand = self.unk_score + base
                if start[i + 1] is None or cand > score[i + 1]:
                    score[i + 1], start[i + 1], node[i + 1] = cand, i, self.unk_id
        ids: List[int] = []
        end, in_unk = n, False
        while end > 0:
            s = start[end]
            if node[end] == self.unk_id:
                if not in_unk:
                    ids.append(self.unk_id)
                in_unk = True
            else:
                ids.append(self.piece_to_id.get(word[s:end], self.unk_id))
                in_unk = False
            end = s
        return ids[::-1]

    def _word_ids(self, word: str) -> List[int]:
        ids = self._cache.get(word)
        if ids is None:
            ids = self._viterbi(word)
            if len(self._cache) < _WORD_CACHE:
                self._cache[word] = ids
        return ids

    def tokenize(self, text: str) -> List[int]:
        """The ids of `text` before truncation and the template's tokens."""
        ids: List[int] = []
        pos = 0
        matches = list(self._added_re.finditer(text)) if self._added_re else []
        for m in matches + [None]:
            end = m.start() if m is not None else len(text)
            if end > pos:
                for w in self._words(text[pos:end], at_start=pos == 0):
                    ids += self._word_ids(w)
            if m is not None:
                ids.append(self.added[m.group()])
                pos = m.end()
        return ids

    def encode(self, text: str, max_length: Optional[int] = None) -> List[int]:
        """Ids with the template's tokens, the sequence first cut so that
        the whole fits `max_length`."""
        ids = self.tokenize(text)
        if max_length is not None:
            ids = ids[:max(max_length - len(self.prefix_ids) - len(self.suffix_ids), 0)]
        return self.prefix_ids + ids + self.suffix_ids

    def __call__(self, sentences: Sequence[str], return_tensors: str = "np",
                 padding: str = "max_length", truncation: bool = True,
                 max_length: int = 32) -> Dict[str, np.ndarray]:
        if return_tensors != "np" or padding != "max_length" or truncation is not True:
            raise NotImplementedError("only return_tensors='np', padding='max_length', "
                                      "truncation=True")
        if isinstance(sentences, str):
            raise TypeError("pass a list of sentences")
        ids = np.full((len(sentences), max_length), self.pad_id, np.int64)
        mask = np.zeros((len(sentences), max_length), np.int64)
        for i, s in enumerate(sentences):
            row = self.encode(s, max_length)
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        return {"input_ids": ids, "attention_mask": mask}
