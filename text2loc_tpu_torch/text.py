"""Free-text query front end: hint strings -> integer hint triples (the
port's own copy of text2loc_tpu/text.py: HintParseError, split_description,
parse_hint, parse_descriptions, render_description; held equal to it by
tests/test_torch_port_text.py).

Every hint sentence is rendered from the closed template
"The pose is {direction} of a {color} {label}.", so this module is the exact
inverse of `constants.render_hint`:

* `split_description`: sentence splitting on the template boundaries (every
  sentence ends with ".").
* `parse_hint`: one sentence -> (direction_idx, color_idx, label_idx).
* `parse_descriptions`: a batch of description strings -> padded [B, S]
  triple arrays and a sentence mask, ready for `HintTextEmbedder.embed`.

Sentences outside the closed template vocabulary raise `HintParseError`.
Callers that hold an online sentence encoder catch it and fall back; see
`serving.Localizer.localize_text`.

COLOR_NAMES holds "gray" twice (indices 1 and 4), so two distinct triples
render to the same string. Parsing returns the first index: round trips are
exact at the string level (render(parse(s)) == s) and at the triple level
for every other colour.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

from text2loc_tpu_torch import constants as C


class HintParseError(ValueError):
    """A sentence is outside the closed hint-template vocabulary."""


_HINT_RE = re.compile(
    r"^\s*The pose is\s+(?P<direction>[\w-]+)\s+of\s+a\s+(?P<rest>.+?)\s*\.?\s*$"
)

# Longest-first so multi-word matches win (no current color/label is a prefix
# of another, but this keeps the parser correct if vocabularies grow).
_COLORS_BY_LEN = sorted(
    {name: C.COLOR_NAMES.index(name) for name in C.COLOR_NAMES}.items(),
    key=lambda kv: -len(kv[0]),
)


def split_description(description: str) -> List[str]:
    """Split a multi-hint description into sentences.

    Equivalent to the reference's nltk sent_tokenize for the closed template
    vocabulary (language_encoder.py:108-110): every hint is one sentence
    terminated by ".".
    """
    return [s.strip() + "." for s in description.split(".") if s.strip()]


def parse_hint(sentence: str) -> Tuple[int, int, int]:
    """Inverse of `constants.render_hint`: sentence -> integer triple.

    Raises HintParseError for anything outside the template vocabulary.
    """
    m = _HINT_RE.match(sentence)
    if not m:
        raise HintParseError(
            f"sentence does not match the hint template "
            f"{C.HINT_TEMPLATE!r}: {sentence!r}"
        )
    direction = m.group("direction")
    if direction not in C.DIRECTION_TO_INDEX:
        raise HintParseError(
            f"unknown direction {direction!r} (known: {C.DIRECTIONS})"
        )
    rest = m.group("rest")
    for color, color_idx in _COLORS_BY_LEN:
        if rest.startswith(color + " "):
            label = rest[len(color) + 1 :].strip()
            break
    else:
        raise HintParseError(
            f"no known color at the start of {rest!r} (known: {C.COLOR_NAMES})"
        )
    if label not in C.CLASS_TO_INDEX:
        raise HintParseError(
            f"unknown object class {label!r} (known: {sorted(C.CLASS_TO_INDEX)})"
        )
    return (
        C.DIRECTION_TO_INDEX[direction],
        color_idx,
        C.CLASS_TO_INDEX[label],
    )


def parse_descriptions(
    descriptions: Sequence[str],
    num_mentioned: Optional[int] = None,
):
    """Batch of free-text descriptions -> padded triple arrays + mask.

    Args:
        descriptions: B strings, each 1..S template sentences.
        num_mentioned: pad/truncate each hint set to this many slots;
            defaults to the longest description in the batch.

    Returns:
        dict with hint_dir/hint_color/hint_label [B, S] int32 and
        sentence_mask [B, S] bool (False = padded slot). Padded slots hold
        triple (0, 0, 0); the mask keeps them out of attention/pooling.
    """
    parsed = [
        [parse_hint(s) for s in split_description(d)] for d in descriptions
    ]
    if any(len(p) == 0 for p in parsed):
        raise HintParseError("empty description")
    s_max = num_mentioned or max(len(p) for p in parsed)
    b = len(parsed)
    out = {
        "hint_dir": np.zeros((b, s_max), np.int32),
        "hint_color": np.zeros((b, s_max), np.int32),
        "hint_label": np.zeros((b, s_max), np.int32),
        "sentence_mask": np.zeros((b, s_max), bool),
    }
    for i, hints in enumerate(parsed):
        for j, (d, c, l) in enumerate(hints[:s_max]):
            out["hint_dir"][i, j] = d
            out["hint_color"][i, j] = c
            out["hint_label"][i, j] = l
            out["sentence_mask"][i, j] = True
    return out


def render_description(hint_dir, hint_color, hint_label, sentence_mask=None) -> str:
    """Join rendered hint sentences back into one description string."""
    hints = []
    for j in range(len(hint_dir)):
        if sentence_mask is not None and not sentence_mask[j]:
            continue
        hints.append(C.render_hint(int(hint_dir[j]), int(hint_color[j]),
                                   int(hint_label[j])))
    return " ".join(hints)
