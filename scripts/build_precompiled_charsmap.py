#!/usr/bin/env python
"""Build a SentencePiece `precompiled_charsmap` without `sentencepiece`.

t5-large's tokenizer.json normalizes with a `Precompiled` normalizer whose
blob is SentencePiece's compiled `nmt_nfkc` rule set. This script writes a
blob of the same format over rules of its own, derived from NFKC with
Python's `unicodedata`, so that the port's reader (text2loc_tpu_torch/
tokenizer.py) can be held against `tokenizers.normalizers.Precompiled` on a
charsmap whose every rule is known.

The format: a little-endian u32 byte size of the trie; the trie, a
darts-clone double array of u32 units over the UTF-8 bytes of each rule's
key, whose leaf value is the byte offset of the replacement in the pool;
then the pool of NUL-terminated UTF-8 replacements.

A unit: bits 0-7 the label (bit 31 set marks a leaf, whose bits 0-30 are
the value), bit 8 "has a leaf", bits 10-31 the offset (bit 9 set: the
offset is shifted left by 8). From the unit at position p with offset o,
the child of byte c sits at p ^ o ^ c and the leaf at p ^ o.

The rules (`nfkc_rules`): every codepoint of a set of compatibility blocks
whose NFKC differs from itself (full-width and half-width forms, ligatures,
letter-like symbols, number forms, enclosed and circled forms, CJK
compatibility, Latin-1 compatibility characters, the wide spaces,
mathematical alphanumerics), base letters followed by a combining mark
(keys of two characters, NFC-composed), Hangul L+V jamo pairs, a full-width
letter with an acute accent (a key that has a shorter key as its prefix),
and two deletions (U+200B, U+00AD map to nothing).

Run from the repo root; writes the blob (or its base64 with --base64):

    python scripts/build_precompiled_charsmap.py --out charsmap.bin
"""

from __future__ import annotations

import argparse
import base64
import struct
import sys
import unicodedata
from typing import Dict, List

# Blocks whose NFKC rules the fixture takes.
NFKC_BLOCKS = (
    (0x00A0, 0x00BF),    # no-break space, ordinals, superscripts, fractions
    (0x2000, 0x200A),    # wide spaces
    (0x2100, 0x218B),    # letter-like symbols, number forms (Roman numerals)
    (0x2460, 0x24FF),    # enclosed alphanumerics
    (0x3000, 0x3000),    # ideographic space
    (0x3200, 0x33FF),    # enclosed CJK, CJK compatibility (multi-character results)
    (0xFB00, 0xFB06),    # Latin ligatures
    (0xFE30, 0xFE4F),    # CJK compatibility forms
    (0xFF01, 0xFFEE),    # full-width and half-width forms
    (0x1D400, 0x1D4FF),  # mathematical alphanumerics (four-byte keys)
)
BASES = "aeiouyncAEIOUYNC"
MARKS = "\u0300\u0301\u0302\u0303\u0308\u030a\u030c\u0327"
DELETE = ("\u200b", "\u00ad")


def nfkc_rules() -> Dict[str, str]:
    """key -> replacement, as described in the module docstring."""
    rules: Dict[str, str] = {}
    for lo, hi in NFKC_BLOCKS:
        for cp in range(lo, hi + 1):
            s = chr(cp)
            t = unicodedata.normalize("NFKC", s)
            if t != s:
                rules[s] = t
    for b in BASES:
        for m in MARKS:
            t = unicodedata.normalize("NFKC", b + m)
            if len(t) == 1:
                rules[b + m] = t
    for lead in range(0x1100, 0x1113, 3):
        for vowel in range(0x1161, 0x1176, 4):
            rules[chr(lead) + chr(vowel)] = unicodedata.normalize(
                "NFKC", chr(lead) + chr(vowel))
    rules["\uff21\u0301"] = "\u00c1"
    for s in DELETE:
        rules[s] = ""
    return rules


def build_double_array(keys: Dict[bytes, int]) -> List[int]:
    """darts-clone units of a trie over `keys` (byte strings without NUL,
    value < 2^31 each)."""
    trie: dict = {}
    for key, value in keys.items():
        if not key or 0 in key:
            raise ValueError(f"key {key!r}: empty or holds a NUL byte")
        node = trie
        for c in key:
            node = node.setdefault(c, {})
        node[None] = value
    units: List[int] = [0]
    used = {0}
    used_bases = set()
    search_from = 1

    def place(node: dict, pos: int) -> None:
        nonlocal search_from
        labels = sorted(0 if k is None else k for k in node)
        while search_from in used:
            search_from += 1
        q = search_from
        while True:
            base = q ^ labels[0]
            offset = pos ^ base
            if (base not in used_bases and offset < (1 << 21)
                    and all((base ^ c) not in used for c in labels)):
                break
            q += 1
        used_bases.add(base)
        need = max(base ^ c for c in labels) + 1
        if need > len(units):
            units.extend([0] * (need - len(units)))
        units[pos] |= offset << 10
        children = []
        for c in labels:
            child = base ^ c
            used.add(child)
            if c == 0:
                units[pos] |= 1 << 8
                units[child] = node[None] | (1 << 31)
            else:
                units[child] = c
                children.append((node[c], child))
        for sub, child in children:
            place(sub, child)

    place(trie, 0)
    # Whole blocks of 256 units, as darts-clone writes them: a lookup reads
    # p ^ c for any byte c without a bounds check.
    units.extend([0] * (-len(units) % 256))
    return units


def build_charsmap(rules: Dict[str, str]) -> bytes:
    """The precompiled_charsmap blob of `rules` (key -> replacement)."""
    pool = bytearray()
    offsets: Dict[str, int] = {}
    keys: Dict[bytes, int] = {}
    for key in sorted(rules):
        rep = rules[key]
        if rep not in offsets:
            offsets[rep] = len(pool)
            pool += rep.encode("utf-8") + b"\0"
        keys[key.encode("utf-8")] = offsets[rep]
    units = build_double_array(keys)
    trie = struct.pack(f"<{len(units)}I", *units)
    return struct.pack("<I", len(trie)) + trie + bytes(pool)


def charsmap_base64(rules: Dict[str, str] = None) -> str:
    """The blob as tokenizer.json stores it (`precompiled_charsmap`)."""
    return base64.b64encode(build_charsmap(nfkc_rules() if rules is None else rules)).decode()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the blob here (default: stdout as base64)")
    ap.add_argument("--base64", action="store_true", help="write base64 text")
    args = ap.parse_args(argv)
    blob = build_charsmap(nfkc_rules())
    data = base64.b64encode(blob) if args.base64 or not args.out else blob
    if args.out:
        with open(args.out, "wb") as f:
            f.write(data)
    else:
        sys.stdout.write(data.decode() + "\n")


if __name__ == "__main__":
    main()
