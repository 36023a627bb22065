"""Report what the port's kernels compiled to: their SASS, by cuobjdump.

    python3 scripts/sass_report.py [--root DIR] [--against DIR] [--match REGEX]

Builds the kernel library of the checkout at `--root` (default: the one
holding this script) and, with `--against`, of another checkout (e.g. a
parent unpacked with `git archive`), dumps each with `cuobjdump -sass` and
prints one JSON line per kernel whose mangled name matches `--match`
(default: every kernel): its instruction count, its tensor-core
instructions by opcode (`HMMA...` of mma.sync, `HGMMA...` of wgmma, with
one example line each), and with
`--against` whether its instruction sequence equals the other build's
(the hash of an anonymous namespace taken out of the names). A last line
sums them. Needs the CUDA toolkit (nvcc, cuobjdump); run it where the
kernels build.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_(\w+?)_cu_[0-9a-f]+")
_INSN = re.compile(r"\s*/\*[0-9a-f]+\*/\s*(.*?)\s*;")
_TC = re.compile(r"\bH(?:G)?MMA\.\S+")   # mma.sync (HMMA) and wgmma (HGMMA)


def build(root: str) -> str:
    """The checkout's kernel library, built in its own build directory."""
    out = subprocess.run(
        [sys.executable, "-c", "from text2loc_tpu_torch.ops import _cuda; print(_cuda.build())"],
        cwd=root, capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[-1]


def kernels(lib: str) -> dict:
    """{kernel name, anonymous-namespace hash removed: [instructions]}."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _ANON.sub(r"ANON_\1", m.group(1))
            out[name] = []
            continue
        m = _INSN.match(line)
        if name and m:
            out[name].append(m.group(1))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--against", default=None)
    ap.add_argument("--match", default="")
    args = ap.parse_args()
    mine = kernels(build(os.path.abspath(args.root)))
    other = kernels(build(os.path.abspath(args.against))) if args.against else None
    pattern = re.compile(args.match)
    total = collections.Counter()
    for name in sorted(n for n in mine if pattern.search(n)):
        insns = mine[name]
        hmma = collections.Counter(_TC.search(i).group(0) for i in insns if _TC.search(i))
        row = {"kernel": name, "instructions": len(insns), "hmma": dict(hmma),
               "hmma_example": {op: next(i for i in insns if op in i) for op in hmma}}
        total["kernels"] += 1
        total["instructions"] += len(insns)
        if other is not None:
            row["same_as_against"] = None if name not in other else other[name] == insns
            total["same_as_against"] += row["same_as_against"] is True
            total["absent_in_against"] += name not in other
        print(json.dumps(row), flush=True)
    print(json.dumps({"total": dict(total)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
