"""A reader of HF `tokenizer.json` files of the T5 kind, in plain Python: no
`transformers`, `tokenizers` or `sentencepiece` (the card's machine has none
of them).

It stands in for the `tokenizers` machinery that the JAX package reaches
through `transformers.AutoTokenizer` (text2loc_tpu/models/t5_encoder.py
T5OnlineEncoder._tokenize), and returns the same ids and masks for what it
reads. It reads the pipelines of t5-large's tokenizer.json and of the
vendored tiny tokenizer (assets/tiny_t5_tokenizer):

* added tokens (the file's `added_tokens` plus the special tokens of a
  special_tokens_map.json / tokenizer_config.json beside it, as
  transformers adds them): those not `normalized` split out of the raw text
  first, the `normalized` ones out of the normalized text, leftmost
  longest, each its own id (its piece's id, or the next one after the
  vocabulary, as tokenizers assigns them);
* no normalizer, or a `Precompiled` one (SentencePiece's compiled rule set,
  `PrecompiledCharsmap`), alone or in a `Sequence` with `Replace` normalizers
  of a String pattern or of the Regex " {2,}";
* a Metaspace pre-tokenizer (`replacement`, `prepend_scheme` always / first
  / never or the older `add_prefix_space`, `split`), alone or after a
  `WhitespaceSplit` in a `Sequence`: spaces become the replacement, which
  is prepended to each text segment (each whitespace-split word) and, with
  `split`, starts a new word; a run of replacements stays one word start;
* a Unigram model: the Viterbi best segmentation of each word over the
  pieces' log-probabilities; a character that starts no piece becomes an
  unknown node (score: the least piece score minus 10), and consecutive
  unknown nodes fuse into one `unk_id`;
* a TemplateProcessing post-processor (special tokens around the sequence,
  for T5 the `</s>` suffix), whose tokens truncation makes room for.

Anything else (another model type, byte fallback, another normalizer or
pre-tokenizer, `prepend_scheme` first after a WhitespaceSplit, another
post-processor, added tokens that strip or match single words) raises
NotImplementedError naming it.
"""

from __future__ import annotations

import base64
import json
import os
import re
import struct
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from text2loc_tpu_torch.graphemes import clusters

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
        "(this reader takes a Unigram model, no normalizer or Precompiled with "
        "Replace, a Metaspace pre-tokenizer after an optional WhitespaceSplit "
        "and a TemplateProcessing post-processor)")


class PrecompiledCharsmap:
    """SentencePiece's compiled normalization rules, as `tokenizers`'
    `Precompiled` normalizer applies them.

    The blob: a little-endian u32 byte size of the trie, the trie as
    darts-clone double-array units (u32 each; from unit p with offset o the
    child of byte c sits at p ^ o ^ c, and a node with a leaf holds its
    value at p ^ o), then a pool of NUL-terminated UTF-8 replacements, each
    leaf's value the offset of its replacement in the pool.

    `normalize` walks the text by extended grapheme clusters (graphemes.py).
    A cluster of fewer than 6 UTF-8 bytes is looked up whole first: if any
    key is a prefix of it, the whole cluster becomes the replacement of the
    SHORTEST such key. Otherwise each character is looked up alone and kept
    where no key matches it."""

    def __init__(self, blob: bytes):
        if len(blob) < 4:
            raise ValueError("precompiled_charsmap: shorter than its 4-byte header")
        (size,) = struct.unpack_from("<I", blob, 0)
        if size == 0 or size % 4 or 4 + size > len(blob):
            raise ValueError(f"precompiled_charsmap: trie size {size} does not fit "
                             f"a blob of {len(blob)} bytes")
        self.units = struct.unpack_from(f"<{size // 4}I", blob, 4)
        self.pool = blob[4 + size:]
        self._cache: Dict[str, Optional[str]] = {}

    @classmethod
    def from_base64(cls, text: str) -> "PrecompiledCharsmap":
        return cls(base64.b64decode(text))

    @staticmethod
    def _offset(unit: int) -> int:
        return (unit >> 10) << ((unit & (1 << 9)) >> 6)

    def prefix_values(self, key: bytes) -> List[int]:
        """The leaf values of every key that is a prefix of `key`, shortest
        first (the search stops at a NUL byte)."""
        units, out = self.units, []
        pos = self._offset(units[0])
        for c in key:
            if c == 0:
                break
            pos ^= c
            if pos >= len(units):
                break
            unit = units[pos]
            if unit & ((1 << 31) | 0xFF) != c:
                break
            pos ^= self._offset(unit)
            if (unit >> 8) & 1:
                out.append(units[pos] & ((1 << 31) - 1))
        return out

    def transform(self, chunk: str) -> Optional[str]:
        """The replacement of the shortest key that prefixes `chunk`, or None."""
        if chunk in self._cache:
            return self._cache[chunk]
        found = self.prefix_values(chunk.encode("utf-8"))
        out = None
        if found:
            end = self.pool.find(b"\0", found[0])
            out = self.pool[found[0]:end if end >= 0 else len(self.pool)].decode("utf-8")
        if len(self._cache) < 65536:
            self._cache[chunk] = out
        return out

    def normalize(self, text: str) -> str:
        out: List[str] = []
        for g in clusters(text):
            if len(g.encode("utf-8")) < 6:
                rep = self.transform(g)
                if rep is not None:
                    out.append(rep)
                    continue
            for ch in g:
                rep = self.transform(ch)
                out.append(ch if rep is None else rep)
        return "".join(out)


def _normalizer(spec) -> Optional[Callable[[str], str]]:
    """The normalizer of a tokenizer.json's `normalizer` section, or None."""
    if spec is None:
        return None
    parts = spec.get("normalizers") if spec.get("type") == "Sequence" else [spec]
    steps: List[Callable[[str], str]] = []
    for part in parts:
        kind = part.get("type")
        if kind == "Precompiled" and part.get("precompiled_charsmap"):
            steps.append(PrecompiledCharsmap.from_base64(part["precompiled_charsmap"]).normalize)
        elif kind == "Replace":
            pattern, content = part.get("pattern", {}), part.get("content", "")
            if "String" in pattern and pattern["String"]:
                steps.append(lambda s, a=pattern["String"], b=content: s.replace(a, b))
            elif pattern.get("Regex") == " {2,}":
                steps.append(lambda s, b=content: re.sub(" {2,}", lambda _: b, s))
            else:
                raise NotImplementedError(
                    f"tokenizer.json normalizer Replace of pattern {pattern!r} is not "
                    "supported (a String, or the Regex ' {2,}')")
        else:
            _refuse("normalizer", spec)

    def run(text: str) -> str:
        for step in steps:
            text = step(text)
        return text
    return run


# Rust's char::is_whitespace (the White_Space property), which
# tokenizers' WhitespaceSplit splits on; Python's str.isspace also takes
# U+001C..U+001F.
_WHITESPACE = frozenset("\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004"
                        "\u2005\u2006\u2007\u2008\u2009\u200a\u2028\u2029\u202f"
                        "\u205f\u3000")


def _whitespace_split(text: str) -> List[str]:
    words, cur = [], []
    for ch in text:
        if ch in _WHITESPACE:
            if cur:
                words.append("".join(cur))
                cur = []
        else:
            cur.append(ch)
    if cur:
        words.append("".join(cur))
    return words


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


def _alternation(tokens: Dict[str, int]):
    """A regex of `tokens`, longest first (leftmost longest match), or None."""
    if not tokens:
        return None
    return re.compile("|".join(re.escape(t) for t in sorted(tokens, key=len, reverse=True)))


def _split_added(text: str, pattern) -> List[Tuple[str, Optional[str], bool]]:
    """`text` cut at the matches of `pattern`: (text, None, starts the text)
    for the pieces between matches, (match, match, False) for each match."""
    out: List[Tuple[str, Optional[str], bool]] = []
    pos = 0
    for m in (pattern.finditer(text) if pattern is not None else ()):
        if m.start() > pos:
            out.append((text[pos:m.start()], None, pos == 0))
        out.append((m.group(), m.group(), False))
        pos = m.end()
    if pos < len(text):
        out.append((text[pos:], None, pos == 0))
    return out


class UnigramTokenizer:
    """`tokenizer(sentences, return_tensors="np", padding="max_length",
    truncation=True, max_length=T)` -> {"input_ids", "attention_mask"}
    ([N, T] int64), as transformers' fast tokenizer returns them."""

    def __init__(self, pieces: Sequence[Tuple[str, float]], unk_id: int, pad_id: int,
                 prefix_ids: Sequence[int] = (), suffix_ids: Sequence[int] = (),
                 added: Optional[Dict[str, int]] = None, replacement: str = "▁",
                 prepend_scheme: str = "always", split: bool = True,
                 normalizer: Optional[Callable[[str], str]] = None,
                 normalized_added: Optional[Dict[str, int]] = None,
                 whitespace_split: bool = False):
        if prepend_scheme not in ("always", "first", "never"):
            raise NotImplementedError(f"Metaspace prepend_scheme {prepend_scheme!r}")
        if whitespace_split and prepend_scheme == "first":
            raise NotImplementedError("Metaspace prepend_scheme 'first' after a "
                                      "WhitespaceSplit is not supported")
        self.scores = [float(s) for _, s in pieces]
        # A piece listed twice maps to its last id, as tokenizers' map does.
        self.piece_to_id = {p: i for i, (p, _) in enumerate(pieces)}
        self.max_piece = max(len(p) for p, _ in pieces)
        self.unk_score = min(self.scores) - UNK_PENALTY
        self.unk_id, self.pad_id = int(unk_id), int(pad_id)
        self.prefix_ids, self.suffix_ids = list(prefix_ids), list(suffix_ids)
        self.added = dict(added or {})
        self.normalized_added = dict(normalized_added or {})
        self._added_re = _alternation(self.added)
        self._normalized_added_re = _alternation(self.normalized_added)
        self.replacement, self.prepend_scheme, self.split = replacement, prepend_scheme, split
        self.normalizer = normalizer
        self.whitespace_split = whitespace_split
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
        normalizer = _normalizer(spec.get("normalizer"))
        pre = spec.get("pre_tokenizer")
        whitespace_split = False
        if pre is not None and pre.get("type") == "Sequence":
            kinds = [p.get("type") for p in pre.get("pretokenizers", ())]
            if kinds == ["WhitespaceSplit", "Metaspace"]:
                whitespace_split, pre = True, pre["pretokenizers"][1]
            elif kinds == ["Metaspace"]:
                pre = pre["pretokenizers"][0]
        if pre is None or pre.get("type") != "Metaspace":
            _refuse("pre_tokenizer", pre)
        pieces = [(p, s) for p, s in model["vocab"]]
        vocab = {p: i for i, (p, _) in enumerate(pieces)}

        added: Dict[str, int] = {}
        normalized_added: Dict[str, int] = {}
        for tok in spec.get("added_tokens") or ():
            if tok.get("lstrip") or tok.get("rstrip") or tok.get("single_word"):
                raise NotImplementedError(
                    f"added token {tok['content']!r} with lstrip / rstrip / single_word")
            # As tokenizers assigns them: a token of the vocabulary keeps its
            # piece's id, another takes the next id after the vocabulary and
            # the added ids so far (the file's `id` is not read).
            content = tok["content"]
            new_id = vocab.get(content, max([len(pieces) - 1, *added.values(),
                                             *normalized_added.values()]) + 1)
            into = normalized_added if tok.get("normalized") and normalizer else added
            into[content] = new_id
        special = _special_tokens(os.path.dirname(os.path.abspath(path)))
        for s in (t for tokens in special.values() for t in tokens):
            if s not in added and s not in normalized_added:
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
                   split=pre.get("split", True), normalizer=normalizer,
                   normalized_added=normalized_added, whitespace_split=whitespace_split)

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

    def _segment_ids(self, segment: str, at_start: bool) -> List[int]:
        """The ids of one normalized text segment (between added tokens)."""
        ids: List[int] = []
        parts = _whitespace_split(segment) if self.whitespace_split else [segment]
        for part in parts:
            for w in self._words(part, at_start=at_start):
                ids += self._word_ids(w)
        return ids

    def tokenize(self, text: str) -> List[int]:
        """The ids of `text` before truncation and the template's tokens."""
        ids: List[int] = []
        for piece, token, at_start in _split_added(text, self._added_re):
            if token is not None:
                ids.append(self.added[token])
                continue
            if self.normalizer is not None:
                piece = self.normalizer(piece)
            for sub, sub_token, sub_start in _split_added(piece, self._normalized_added_re):
                if sub_token is not None:
                    ids.append(self.normalized_added[sub_token])
                else:
                    ids += self._segment_ids(sub, at_start and sub_start)
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
