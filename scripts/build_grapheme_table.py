#!/usr/bin/env python
"""Build the grapheme-cluster break table of the port's tokenizer.

`tokenizers`' `Precompiled` normalizer walks its text by extended grapheme
clusters (Unicode UAX #29, the `unicode-segmentation` crate). Python's
`unicodedata` has no Grapheme_Cluster_Break property, and the port must not
need the `regex` module at run time, so this script derives the properties
once with `regex` and writes them as sorted codepoint ranges:

* `gcb`: each Grapheme_Cluster_Break value other than Other (CR, LF,
  Control, Extend, ZWJ, Regional_Indicator, Prepend, SpacingMark, L, V, T,
  LV, LVT) -> [[first, last], ...];
* `extended_pictographic`: the Extended_Pictographic ranges (rule GB11);
* `incb`: each Indic_Conjunct_Break value other than None (Consonant,
  Extend, Linker; rule GB9c).

The reference is `tokenizers`' `unicode-segmentation` 1.12, which knows
Unicode 16.0. `regex` may know a later version, so the codepoints first
assigned after 16.0 that carry a break class (AFTER_UNICODE_16) are left out
of `gcb` and `incb`: they read as Other and None, as an unassigned codepoint
does under Unicode 16. Extended_Pictographic needs no cut: its reserved
emoji ranges were already in it before their codepoints were assigned.

Output: text2loc_tpu_torch/assets/grapheme_breaks.json (committed; the
version of `regex` and the ranges left out are recorded in it). Run from
the repo root:

    python scripts/build_grapheme_table.py
"""

from __future__ import annotations

import argparse
import json
import os

GCB = ("CR", "LF", "Control", "Extend", "ZWJ", "Regional_Indicator", "Prepend",
       "SpacingMark", "L", "V", "T", "LV", "LVT")
INCB = ("Consonant", "Extend", "Linker")
# First assigned in Unicode 17.0 (DerivedAge.txt), with a break class in
# `regex`'s tables: Combining Diacritical Marks Extended, Arabic Extended-C,
# Sharada Supplement and Tai Yo marks (Extend, SpacingMark, InCB Extend).
AFTER_UNICODE_16 = ((0x1ACF, 0x1ADD), (0x1AE0, 0x1AEB), (0x10EFA, 0x10EFB),
                    (0x11B60, 0x11B67), (0x1E6E3, 0x1E6E3), (0x1E6E6, 0x1E6E6),
                    (0x1E6EE, 0x1E6EF), (0x1E6F5, 0x1E6F5))
DEFAULT_OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "text2loc_tpu_torch", "assets", "grapheme_breaks.json")


def _after_unicode_16(cp: int) -> bool:
    return any(lo <= cp <= hi for lo, hi in AFTER_UNICODE_16)


def ranges(pattern, skip=lambda cp: False) -> list:
    """Sorted [first, last] codepoint ranges that `pattern` matches, less
    the codepoints `skip` names."""
    out = []
    for cp in range(0x110000):
        if 0xD800 <= cp <= 0xDFFF or skip(cp):
            continue
        if pattern.match(chr(cp)):
            if out and out[-1][1] == cp - 1:
                out[-1][1] = cp
            else:
                out.append([cp, cp])
    return out


def build() -> dict:
    import regex

    table = {"source": f"regex {regex.__version__}",
             "left_out": [list(r) for r in AFTER_UNICODE_16], "gcb": {}, "incb": {}}
    for name in GCB:
        table["gcb"][name] = ranges(regex.compile(rf"\p{{Grapheme_Cluster_Break={name}}}"),
                                    _after_unicode_16)
    table["extended_pictographic"] = ranges(regex.compile(r"\p{Extended_Pictographic}"))
    for name in INCB:
        table["incb"][name] = ranges(regex.compile(rf"\p{{Indic_Conjunct_Break={name}}}"),
                                     _after_unicode_16)
    return table


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    table = build()
    with open(args.out, "w") as f:
        json.dump(table, f, separators=(",", ":"))
        f.write("\n")
    print(args.out, {k: len(v) for k, v in table["gcb"].items()},
          len(table["extended_pictographic"]), {k: len(v) for k, v in table["incb"].items()})


if __name__ == "__main__":
    main()
