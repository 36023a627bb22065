"""Extended grapheme clusters (Unicode UAX #29), in plain Python.

`tokenizers`' `Precompiled` normalizer walks its text by extended grapheme
clusters (the `unicode-segmentation` crate); the port's tokenizer
(tokenizer.py) does the same here. Python's `unicodedata` has no
Grapheme_Cluster_Break property, so the properties come from the vendored
table assets/grapheme_breaks.json (built by scripts/build_grapheme_table.py
from the `regex` module's Unicode data, cut to Unicode 16.0 as
`unicode-segmentation` 1.12 knows it).

The rules, in order: GB3 CR x LF; GB4/GB5 break after and before Control,
CR and LF; GB6-GB8 Hangul syllable sequences; GB9 x (Extend | ZWJ); GB9a
x SpacingMark; GB9b Prepend x; GB9c Indic conjuncts (Consonant
[Extend Linker]* Linker [Extend Linker]* x Consonant); GB11
Extended_Pictographic Extend* ZWJ x Extended_Pictographic; GB12/GB13
regional-indicator pairs; GB999 break everywhere else.
"""

from __future__ import annotations

import bisect
import json
import os
from functools import lru_cache
from typing import List, Tuple

OTHER = "Other"
_TABLE = os.path.join(os.path.dirname(__file__), "assets", "grapheme_breaks.json")


class _Ranges:
    """Sorted, disjoint [first, last] codepoint ranges -> a value."""

    def __init__(self, by_value):
        rows = sorted((lo, hi, v) for v, rs in by_value.items() for lo, hi in rs)
        self.starts = [r[0] for r in rows]
        self.rows = rows

    def get(self, cp: int, default):
        i = bisect.bisect_right(self.starts, cp) - 1
        if i >= 0 and cp <= self.rows[i][1]:
            return self.rows[i][2]
        return default


@lru_cache(maxsize=1)
def _tables() -> Tuple[_Ranges, _Ranges, _Ranges]:
    with open(_TABLE) as f:
        t = json.load(f)
    return (_Ranges(t["gcb"]), _Ranges({True: t["extended_pictographic"]}),
            _Ranges(t["incb"]))


@lru_cache(maxsize=65536)
def properties(ch: str) -> Tuple[str, bool, str]:
    """(Grapheme_Cluster_Break, Extended_Pictographic, Indic_Conjunct_Break)
    of one character; "Other" / False / "None" where the table has none."""
    gcb, pict, incb = _tables()
    cp = ord(ch)
    return gcb.get(cp, OTHER), pict.get(cp, False), incb.get(cp, "None")


_CONTROLS = ("Control", "CR", "LF")


def clusters(text: str) -> List[str]:
    """`text` cut into extended grapheme clusters."""
    out: List[str] = []
    start = 0
    prev = None
    ri_run = 0      # regional indicators just before this character
    emoji = 0       # 1: after ExtPict Extend*; 2: after ExtPict Extend* ZWJ
    conjunct = 0    # 1: after Consonant [Extend Linker]*; 2: a Linker seen too
    for i, ch in enumerate(text):
        cls, pict, incb = properties(ch)
        if prev is not None:
            if prev == "CR" and cls == "LF":
                join = True
            elif prev in _CONTROLS or cls in _CONTROLS:
                join = False
            elif prev == "L" and cls in ("L", "V", "LV", "LVT"):
                join = True
            elif prev in ("LV", "V") and cls in ("V", "T"):
                join = True
            elif prev in ("LVT", "T") and cls == "T":
                join = True
            elif cls in ("Extend", "ZWJ", "SpacingMark") or prev == "Prepend":
                join = True
            elif conjunct == 2 and incb == "Consonant":
                join = True
            elif emoji == 2 and pict:
                join = True
            elif prev == "Regional_Indicator" and cls == "Regional_Indicator":
                join = ri_run % 2 == 1
            else:
                join = False
            if not join:
                out.append(text[start:i])
                start = i
        ri_run = ri_run + 1 if cls == "Regional_Indicator" else 0
        if pict:
            emoji = 1
        elif emoji == 1 and cls == "Extend":
            emoji = 1
        elif emoji == 1 and cls == "ZWJ":
            emoji = 2
        else:
            emoji = 0
        if incb == "Consonant":
            conjunct = 1
        elif conjunct and incb == "Linker":
            conjunct = 2
        elif not (conjunct and incb == "Extend"):
            conjunct = 0
        prev = cls
    if start < len(text):
        out.append(text[start:])
    return out
