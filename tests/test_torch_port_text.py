"""The port's copy of text.py against the JAX package's: the whole closed
hint vocabulary round-trips through both the same way, parse_descriptions
and split_description give equal arrays on rendered and ragged
descriptions, render_description gives equal strings, and the same
out-of-vocabulary sentences raise."""

import numpy as np
import pytest

from text2loc_tpu import constants as JC
from text2loc_tpu import text as JT
from text2loc_tpu_torch import constants as C
from text2loc_tpu_torch import text as T


def test_round_trip_whole_vocabulary_equals_jax():
    first_color_idx = {name: C.COLOR_NAMES.index(name) for name in C.COLOR_NAMES}
    n = 0
    for d in range(C.NUM_DIRECTIONS):
        for c in range(C.NUM_COLORS):
            for lab in range(C.NUM_CLASSES):
                s = C.render_hint(d, c, lab)
                assert s == JC.render_hint(d, c, lab)
                got = T.parse_hint(s)
                assert got == JT.parse_hint(s), s
                assert (got[0], got[2]) == (d, lab)
                assert got[1] == first_color_idx[C.COLOR_NAMES[c]]
                assert C.render_hint(*got) == s
                n += 1
    assert n == C.hint_vocab_size() == 1584


def _descriptions(seed, n, s_max):
    """n rendered descriptions of 1..s_max random hints, with stray spaces."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(1, s_max + 1))
        hints = [C.render_hint(int(rng.integers(C.NUM_DIRECTIONS)),
                               int(rng.integers(C.NUM_COLORS)),
                               int(rng.integers(C.NUM_CLASSES))) for _ in range(k)]
        out.append((" " * int(rng.integers(3))).join(hints) + " " * int(rng.integers(2)))
    return out


@pytest.mark.parametrize("num_mentioned", [None, 3, 6])
def test_parse_descriptions_equals_jax(num_mentioned):
    descs = _descriptions(num_mentioned or 1, 12, 6)
    for d in descs:
        assert T.split_description(d) == JT.split_description(d)
    got = T.parse_descriptions(descs, num_mentioned=num_mentioned)
    want = JT.parse_descriptions(descs, num_mentioned=num_mentioned)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for i in range(len(descs)):
        row = [got[k][i] for k in ("hint_dir", "hint_color", "hint_label", "sentence_mask")]
        assert T.render_description(*row) == JT.render_description(*row)


@pytest.mark.parametrize("bad", [
    "The pose is nowhere of a gray building.",
    "The pose is east of a purple building.",
    "The pose is east of a gray spaceship.",
    "Meet me at the gray building.",
    "",
])
def test_the_same_oov_sentences_raise(bad):
    with pytest.raises(T.HintParseError):
        T.parse_hint(bad)
    with pytest.raises(JT.HintParseError):
        JT.parse_hint(bad)
    desc = [C.render_hint(1, 2, 3) + " " + bad]
    if bad:
        with pytest.raises(T.HintParseError):
            T.parse_descriptions(desc)
    with pytest.raises(T.HintParseError, match="empty description"):
        T.parse_descriptions([C.render_hint(1, 2, 3), " "])
    assert issubclass(T.HintParseError, ValueError)
