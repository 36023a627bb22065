"""The port's tokenizer.json reader (text2loc_tpu_torch/tokenizer.py) against
transformers' AutoTokenizer over the vendored tiny tokenizer (the JAX
package's text2loc_tpu/assets/tiny_t5_tokenizer): input_ids and
attention_mask equal, element for element, at T = 8, 16 and 32, for every
canonical hint sentence, every paraphrase-bank sentence, novel words and
runs of unknown characters; the Metaspace variants on edited copies of the
file; the asset copy byte for byte; unsupported components refused by name.
"""

import json
import os
import shutil

import numpy as np
import pytest
from transformers import AutoTokenizer

from text2loc_tpu import constants as JC
from text2loc_tpu import text_styles as jstyles
from text2loc_tpu.assets import tiny_t5_tokenizer_path as jax_tokenizer_dir
from text2loc_tpu_torch.assets import load_tiny_tokenizer, tiny_t5_tokenizer_path
from text2loc_tpu_torch.tokenizer import UnigramTokenizer

LENGTHS = [8, 16, 32]
NOVEL = [
    "A zeppelin hovers nearby.", "Take me to the big glowing obelisk.", "qqqq zzz xylophone",
    "ünïcödé ☃☃ snow", "日本語 text ☃", "a  b", "a   b  ", " lead", "tail ", "", " ", "  ",
    "x</s>y", "</s>", "<unk>", "The pose is<pad>west", "a\tb\nc", "....", "!!?? ;;",
    "The pose is on-top of a dark-green box, which serves as its base. " * 3,
]


def _canonical():
    return [JC.render_hint(d, c, l) for d in range(JC.NUM_DIRECTIONS)
            for c in range(JC.NUM_COLORS) for l in range(JC.NUM_CLASSES)]


def _bank_sentences():
    rng = np.random.default_rng(0)
    out = []
    for direction, bank in jstyles.SENTENCE_STYLES.items():
        d = JC.DIRECTION_TO_INDEX[direction]
        for i in range(len(bank)):
            c, l = int(rng.integers(JC.NUM_COLORS)), int(rng.integers(JC.NUM_CLASSES))
            out.append(jstyles.render_styled_hint(d, c, l, rng, style_idx=i))
    return out


def _assert_equal(hf, port, sentences, length):
    want = hf(sentences, return_tensors="np", padding="max_length", truncation=True,
              max_length=length)
    got = port(sentences, return_tensors="np", padding="max_length", truncation=True,
               max_length=length)
    for key in ("input_ids", "attention_mask"):
        assert got[key].dtype == np.int64 and got[key].shape == (len(sentences), length)
        bad = np.flatnonzero((got[key] != want[key]).any(axis=1))
        assert bad.size == 0, (key, [sentences[i] for i in bad[:3]])


@pytest.fixture(scope="module")
def hf():
    return AutoTokenizer.from_pretrained(jax_tokenizer_dir())


@pytest.fixture(scope="module")
def port():
    return load_tiny_tokenizer()


@pytest.mark.parametrize("length", LENGTHS)
def test_canonical_hints_equal(hf, port, length):
    sentences = _canonical()
    assert len(sentences) == 1584
    _assert_equal(hf, port, sentences, length)


@pytest.mark.parametrize("length", LENGTHS)
def test_paraphrase_banks_equal(hf, port, length):
    sentences = _bank_sentences()
    assert len(sentences) == sum(len(b) for b in jstyles.SENTENCE_STYLES.values())
    _assert_equal(hf, port, sentences, length)


@pytest.mark.parametrize("length", LENGTHS)
def test_novel_words_and_unknown_runs_equal(hf, port, length):
    _assert_equal(hf, port, NOVEL, length)
    # A run of unknown characters fuses into one <unk>: two runs, two ids.
    ids = port(["☃☃☃ a ☃"], max_length=length)["input_ids"][0]
    assert list(ids).count(port.unk_id) == 2


def test_truncation_keeps_room_for_the_eos_and_pads(hf, port):
    long = " ".join(_canonical()[:6])
    for length in (1, 2, 5, 8, 16, 32, 64):
        _assert_equal(hf, port, [long, "a"], length)
        got = port([long, "a"], max_length=length)
        n = int(got["attention_mask"][0].sum())
        assert got["input_ids"][0, n - 1] == 1                  # </s> last
        assert (got["input_ids"][:, n:][got["attention_mask"][:, n:] == 0] == 0).all()


@pytest.mark.parametrize("variant", [{"prepend_scheme": "first"},
                                     {"prepend_scheme": "never"}, {"split": False}])
def test_metaspace_variants_equal(variant, tmp_path):
    shutil.copytree(tiny_t5_tokenizer_path(), tmp_path, dirs_exist_ok=True)
    spec_path = tmp_path / "tokenizer.json"
    spec = json.loads(spec_path.read_text())
    spec["pre_tokenizer"].update(variant)
    spec_path.write_text(json.dumps(spec))
    sentences = _bank_sentences()[:20] + NOVEL + ["</s>z", "<unk> a"]
    _assert_equal(AutoTokenizer.from_pretrained(str(tmp_path)),
                  UnigramTokenizer.from_file(str(spec_path)), sentences, 16)


@pytest.mark.parametrize("name", ["tokenizer.json", "tokenizer_config.json",
                                  "special_tokens_map.json"])
def test_asset_copy_is_byte_equal(name):
    with open(os.path.join(tiny_t5_tokenizer_path(), name), "rb") as a, \
            open(os.path.join(jax_tokenizer_dir(), name), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("edit,match", [
    ({"normalizer": {"type": "Precompiled", "precompiled_charsmap": ""}}, "Precompiled"),
    ({"normalizer": {"type": "Sequence", "normalizers": [
        {"type": "Precompiled", "precompiled_charsmap": ""},
        {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]}},
     "Sequence/Precompiled/Replace"),
    ({"pre_tokenizer": {"type": "Whitespace"}}, "Whitespace"),
    ({"post_processor": {"type": "BertProcessing"}}, "BertProcessing"),
    ({"model": {"type": "BPE", "vocab": {}, "merges": []}}, "BPE"),
])
def test_unsupported_components_raise(edit, match, tmp_path):
    with open(os.path.join(tiny_t5_tokenizer_path(), "tokenizer.json")) as f:
        spec = json.load(f)
    spec.update(edit)
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps(spec))
    with pytest.raises(NotImplementedError, match=match):
        UnigramTokenizer.from_file(str(path))


def test_only_the_hf_call_of_the_encoders_is_taken(port):
    with pytest.raises(NotImplementedError):
        port(["a"], return_tensors="pt", max_length=8)
    with pytest.raises(NotImplementedError):
        port(["a"], padding="longest", max_length=8)
    with pytest.raises(TypeError):
        port("a", max_length=8)
