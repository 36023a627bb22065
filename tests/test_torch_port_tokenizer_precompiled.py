"""The port's `Precompiled` normalizer (text2loc_tpu_torch/tokenizer.py
PrecompiledCharsmap, graphemes.py) and the t5-large tokenizer.json layout,
against `tokenizers` and transformers' AutoTokenizer (the JAX package's
route, text2loc_tpu/models/t5_encoder.py).

The charsmap is built by scripts/build_precompiled_charsmap.py (NFKC rules
over compatibility blocks, combining sequences, Hangul jamo pairs, a key
with a shorter key as its prefix, deletions). Its reader is held against
`tokenizers.normalizers.Precompiled` on every rule; the grapheme segmenter
against the `regex` module's \\X; whole tokenizers, id for id, on a fixed
corpus of the hint vocabulary and hard Unicode classes and on hypothesis
strings drawn from those classes.

Unicode versions: the vendored break table comes from `regex` (Unicode 17)
cut to Unicode 16, which tokenizers' `unicode-segmentation` 1.12 knows. The
exhaustive probe holds the port equal to tokenizers on every codepoint; the
characters first assigned in Unicode 17 that extend a cluster
(UNICODE_17_EXTENDERS) are where the port's clusters differ from `regex`'s.
"""

import base64
import importlib.util
import json
import os
import shutil

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from tokenizers import Tokenizer, normalizers
from transformers import AutoTokenizer

from text2loc_tpu import constants as JC
from text2loc_tpu_torch import graphemes
from text2loc_tpu_torch.assets import tiny_t5_tokenizer_path
from text2loc_tpu_torch.tokenizer import PrecompiledCharsmap, UnigramTokenizer

_SCRIPT = os.path.join(os.path.dirname(__file__), "..", "scripts",
                       "build_precompiled_charsmap.py")
_spec = importlib.util.spec_from_file_location("build_precompiled_charsmap", _SCRIPT)
charsmap_script = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(charsmap_script)

# Extenders (Grapheme_Cluster_Break Extend or SpacingMark) first assigned in
# Unicode 17.0: Combining Diacritical Marks Extended, Arabic Extended-C,
# Sharada Supplement and Tai Yo marks. regex (Unicode 17) joins them to the
# character before; unicode-segmentation 1.12 (Unicode 16) and the port's
# table see unassigned codepoints and break.
UNICODE_17_EXTENDERS = frozenset(
    list(range(0x1ACF, 0x1ADE)) + list(range(0x1AE0, 0x1AEC))
    + [0x10EFA, 0x10EFB] + list(range(0x11B60, 0x11B68))
    + [0x1E6E3, 0x1E6E6, 0x1E6EE, 0x1E6EF, 0x1E6F5])

SPECIALS = [{"id": i, "content": c, "single_word": False, "lstrip": False,
             "rstrip": False, "normalized": False, "special": True}
            for i, c in enumerate(["<pad>", "</s>", "<unk>"])]

NORMALIZED_ADDED = [
    {"id": 10, "content": "qz", "single_word": False, "lstrip": False, "rstrip": False,
     "normalized": True, "special": False},
    {"id": 11, "content": "<x>", "single_word": False, "lstrip": False, "rstrip": False,
     "normalized": False, "special": False}]

CORPUS = {
    "hints": [JC.render_hint(d, c, l) for d in range(JC.NUM_DIRECTIONS)
              for c in range(0, JC.NUM_COLORS, 3) for l in range(0, JC.NUM_CLASSES, 4)],
    "full_width": ["ＴＨＥ ｐｏｓｅ ｉｓ ｗｅｓｔ", "ｒｅｄ\u3000ｃａｒ！", "ﾃｽﾄ ｶﾀｶﾅ", "１２３ａｂｃ"],
    "ligatures": ["ﬁsh ﬂag ﬀ ﬃ ﬄ ﬅ ﬆ", "oﬃce ﬁeld"],
    "compat": ["Ⅻ ½ ㍿ ™ ① ⑳ ℃ ㎞ ² ³ µ", "𝐀𝐁𝐂 𝑥𝑦", "ª º ¼ ¾ ℡"],
    "combining": ["e\u0301", "cafe\u0301 nai\u0308ve", "A\u030a n\u0303 c\u0327",
                  "Ａ\u0301b", "x\u0301\u0302", "\u0301lead", "e\u0301\u0327"],
    "hangul": ["한국어 각 가", "\u1100\u1161 \u1103\u1165\u11a8", "\u1112\u1175 갃"],
    "regional": ["🇩🇪🇫🇷🇩 flag", "🇺🇸 a 🇯", "🇦🇧🇨"],
    "zwj_emoji": ["👩\u200d👩\u200d👧 fam", "👍🏽 ok", "©\u200d© a\u200d", "🏳\ufe0f\u200d🌈"],
    "spaces": ["a   b    c", "  lead", "tail   ", "\t tab\n new", "\u3000wide\u3000space",
               "a\u2003b\u00a0c", "\u200bhello", "a\u200b b", "soft\u00adhyphen", "\r\n x"],
    "unmapped": ["日本語 ☃", "Ελληνικά Русский", "العربية עברית", "द\u0947वन\u093eगर\u0940 क\u094dष",
                 "ไทย", "\u0600a ൎക", "x</s>y <unk> <pad>z"],
}


@pytest.fixture(scope="module")
def charsmap():
    return charsmap_script.build_charsmap(charsmap_script.nfkc_rules())


def write_t5_large_layout(directory, charsmap: bytes, normalizer="sequence",
                          pre_tokenizer="sequence", metaspace=None, extra_added=()):
    """A copy of the vendored tiny tokenizer in t5-large's component layout:
    a Precompiled normalizer (alone, or in a Sequence with Replace " {2,}"),
    WhitespaceSplit then Metaspace (or Metaspace alone), the three special
    added tokens and `extra_added`. Returns the tokenizer.json path."""
    shutil.copytree(tiny_t5_tokenizer_path(), directory, dirs_exist_ok=True)
    path = os.path.join(directory, "tokenizer.json")
    with open(path) as f:
        spec = json.load(f)
    pre = {"type": "Precompiled",
           "precompiled_charsmap": base64.b64encode(charsmap).decode()}
    if normalizer == "sequence":
        spec["normalizer"] = {"type": "Sequence", "normalizers": [
            pre, {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]}
    elif normalizer == "string":
        spec["normalizer"] = {"type": "Sequence", "normalizers": [
            pre, {"type": "Replace", "pattern": {"String": "  "}, "content": " "}]}
    else:
        spec["normalizer"] = pre
    meta = metaspace or {"type": "Metaspace", "replacement": "▁",
                         "add_prefix_space": True}
    spec["pre_tokenizer"] = ({"type": "Sequence", "pretokenizers": [
        {"type": "WhitespaceSplit"}, meta]} if pre_tokenizer == "sequence" else meta)
    spec["added_tokens"] = SPECIALS + list(extra_added)
    with open(path, "w") as f:
        json.dump(spec, f)
    return path


def _ids_equal(hf, fast, port, sentences, length=24):
    want = hf(sentences, return_tensors="np", padding="max_length", truncation=True,
              max_length=length)
    got = port(sentences, return_tensors="np", padding="max_length", truncation=True,
               max_length=length)
    for key in ("input_ids", "attention_mask"):
        bad = np.flatnonzero((got[key] != want[key]).any(axis=1))
        assert bad.size == 0, (key, [sentences[i] for i in bad[:3]])
    for s in sentences:
        assert port.encode(s) == fast.encode(s).ids, s


@pytest.fixture(scope="module")
def layouts(charsmap, tmp_path_factory):
    out = {}
    for name, kw in {
        "sequence": {},
        "precompiled_alone": {"normalizer": "alone"},
        "replace_string": {"normalizer": "string"},
        "metaspace_alone": {"pre_tokenizer": "alone"},
        "prepend_scheme": {"metaspace": {"type": "Metaspace", "replacement": "▁",
                                         "prepend_scheme": "always", "split": True}},
        "normalized_added": {"extra_added": NORMALIZED_ADDED},
    }.items():
        path = write_t5_large_layout(str(tmp_path_factory.mktemp(name)), charsmap, **kw)
        out[name] = (AutoTokenizer.from_pretrained(os.path.dirname(path)),
                     Tokenizer.from_file(path), UnigramTokenizer.from_file(path))
    return out


def test_every_rule_reads_as_precompiled(charsmap):
    rules = charsmap_script.nfkc_rules()
    assert len(rules) > 1000
    oracle = normalizers.Precompiled(charsmap)
    port = PrecompiledCharsmap(charsmap)
    for key, rep in rules.items():
        assert port.normalize(key) == oracle.normalize_str(key), key
        # The trie holds every key: its own lookup ends on its replacement.
        values = port.prefix_values(key.encode("utf-8"))
        end = port.pool.index(b"\0", values[-1])
        assert port.pool[values[-1]:end].decode() == rep, key


def test_shortest_prefix_and_the_six_byte_rule(charsmap):
    """A cluster under 6 bytes becomes the replacement of its SHORTEST key
    prefix (the accent after a full-width A is dropped, though the longer
    key exists); a cluster of 6 bytes or more (two jamo) goes character by
    character, so the jamo pair's own rule never fires."""
    oracle = normalizers.Precompiled(charsmap)
    port = PrecompiledCharsmap(charsmap)
    for text, want in [("Ａ\u0301", "A"), ("\u1100\u1161", "\u1100\u1161"),
                       ("e\u0301", "é"), ("a\u200bb", "ab")]:
        assert oracle.normalize_str(text) == want
        assert port.normalize(text) == want


@pytest.mark.parametrize("kind", sorted(CORPUS))
def test_corpus_normalizes_as_precompiled(charsmap, kind):
    oracle = normalizers.Precompiled(charsmap)
    port = PrecompiledCharsmap(charsmap)
    for text in CORPUS[kind]:
        assert port.normalize(text) == oracle.normalize_str(text), text


@pytest.mark.parametrize("layout", ["sequence", "precompiled_alone", "replace_string",
                                    "metaspace_alone", "prepend_scheme", "normalized_added"])
def test_corpus_ids_equal_autotokenizer(layouts, layout):
    """Every layout over the corpus; "normalized_added" adds a token matched
    in the normalized text ("qz", which full-width "ｑｚ" becomes) beside a
    raw one ("<x>", whose full-width form is not it)."""
    hf, fast, port = layouts[layout]
    for kind in sorted(CORPUS):
        _ids_equal(hf, fast, port, CORPUS[kind])
    _ids_equal(hf, fast, port, ["aｑｚb qz", "ｑｚ", "x<x>y ＜ｘ＞", "qz<x>qz", "q z"])


def test_clusters_equal_regex(charsmap):
    regex = pytest.importorskip("regex")
    texts = [t for ts in CORPUS.values() for t in ts]
    for t in texts:
        assert graphemes.clusters(t) == regex.findall(r"\X", t), t


_POOL = "".join(sorted(set(
    "aeiouAEIOUncy TheposiwtfdrgbklvmA.,!?" + "ＡＢａｂｃ１！ﾃｽ" + "ﬁﬂﬀ" + "Ⅻ½㍿™①℃²µ𝐀"
    + "\u0300\u0301\u0308\u0327\u0903\u093f" + "\u1100\u1161\u11a8한각"
    + "\U0001F1E9\U0001F1EA\U0001F1EB" + "\u200d\u200b\u00ad\U0001F469\U0001F3FD©"
    + "   \t\n\r\u3000\u00a0\u2003" + "日本☃Ελα\u0600क\u094dष")))


@settings(max_examples=80, deadline=None, database=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(st.text(alphabet=_POOL, max_size=24))
def test_hypothesis_strings_equal(layouts, charsmap, text):
    regex = pytest.importorskip("regex")
    assert graphemes.clusters(text) == regex.findall(r"\X", text)
    assert PrecompiledCharsmap(charsmap).normalize(text) == \
        normalizers.Precompiled(charsmap).normalize_str(text)
    hf, fast, port = layouts["sequence"]
    _ids_equal(hf, fast, port, [text])


def _probe_codepoints():
    return [c for c in list(range(0x80, 0x20000)) + list(range(0xE0000, 0xE1000))
            if not 0xD800 <= c <= 0xDFFF]


def test_extenders_probe_every_codepoint():
    """"a" + c for every codepoint c of planes 0, 1 and 14 under a charsmap
    of the one rule a -> A: where c extends the cluster, the whole cluster
    becomes "A" and c is gone. The port and tokenizers agree everywhere."""
    blob = charsmap_script.build_charsmap({"a": "A"})
    cps = _probe_codepoints()
    text = "\n".join("a" + chr(c) for c in cps)
    want = normalizers.Precompiled(blob).normalize_str(text).split("\n")
    got = PrecompiledCharsmap(blob).normalize(text).split("\n")
    assert len(want) == len(got) == len(cps)
    assert [c for c, w, g in zip(cps, want, got) if w != g] == []
    assert sum(w == "A" for w in want) > 2000          # extenders seen at all


def test_clusters_differ_from_regex_only_after_unicode_16():
    """"a" + c for the same codepoints, segmented by the port and by
    `regex`'s \\X: they differ exactly on the Unicode 17 extenders, which the
    table leaves out as tokenizers' Unicode 16 does."""
    regex = pytest.importorskip("regex")
    cps = _probe_codepoints()
    differ = {c for c in cps
              if graphemes.clusters("a" + chr(c)) != regex.findall(r"\X", "a" + chr(c))}
    assert differ == UNICODE_17_EXTENDERS


def test_breakers_and_prepends_probe():
    """Every Control / CR / LF and Prepend codepoint of the table (planes 0
    and 1), each mapped to X: Control breaks before a following combining
    mark, Prepend joins the letter after it, exactly as tokenizers does."""
    tables = json.load(open(graphemes._TABLE))
    cps = []
    for name in ("Control", "CR", "LF", "Prepend"):
        for lo, hi in tables["gcb"][name]:
            cps += [c for c in range(lo, hi + 1) if c < 0x20000 and c != 0]
    blob = charsmap_script.build_charsmap({chr(c): "X" for c in cps})
    oracle, port = normalizers.Precompiled(blob), PrecompiledCharsmap(blob)
    for follow in ("\u0301", "a"):
        text = "|".join(chr(c) + follow for c in cps)
        assert port.normalize(text) == oracle.normalize_str(text)


@pytest.mark.parametrize("edit,match", [
    ({"normalizer": {"type": "NFKC"}}, "NFKC"),
    ({"normalizer": {"type": "Sequence", "normalizers": [
        {"type": "Precompiled", "precompiled_charsmap": "CHARSMAP"}, {"type": "Strip"}]}},
     "Sequence/Precompiled/Strip"),
    ({"normalizer": {"type": "Replace", "pattern": {"Regex": "\\s+"}, "content": " "}},
     "Replace of pattern"),
    ({"pre_tokenizer": {"type": "Sequence", "pretokenizers": [
        {"type": "WhitespaceSplit"}, {"type": "Metaspace", "replacement": "▁",
                                      "prepend_scheme": "first", "split": True}]}},
     "first"),
    ({"pre_tokenizer": {"type": "Sequence", "pretokenizers": [
        {"type": "Whitespace"}, {"type": "Metaspace"}]}}, "Sequence/Whitespace/Metaspace"),
])
def test_other_components_still_raise(edit, match, charsmap, tmp_path):
    path = write_t5_large_layout(str(tmp_path), charsmap)
    spec = json.load(open(path))
    text = json.dumps(edit).replace("CHARSMAP", base64.b64encode(charsmap).decode())
    spec.update(json.loads(text))
    with open(path, "w") as f:
        json.dump(spec, f)
    with pytest.raises(NotImplementedError, match=match):
        UnigramTokenizer.from_file(path)
