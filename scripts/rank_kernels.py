"""Rank the port's kernels for redesign, from a chip_smoke.py run.

    python3 chip_smoke.py > smoke.txt; python3 scripts/rank_kernels.py smoke.txt

Reads the smoke's `kernels` line (one JSON object per run) and prints the
kernels in the order to redesign them, one JSON line each:

1. first, every kernel slower than the one PyTorch call that computes the
   same function (`library_ms` not null and `ms` > `library_ms`), by
   ms / library_ms;
2. then the rest by launches x (ms - bound_ms): `launches` is the count on
   the smoke's main paths and `ms` / `bound_ms` the kernel's time and bound
   summed over its main-path cases, so the product weighs the time above
   the bound by how often the paths launch the kernel.

It needs no card and imports nothing of the port.
"""

from __future__ import annotations

import json
import sys


def kernels_line(path: str) -> list:
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith('{"kernels"'):
                return json.loads(line)["kernels"]
    raise SystemExit(f"{path}: no kernels line")


def rank(kernels: list) -> list:
    slower = [k for k in kernels if k["library_ms"] is not None and k["ms"] > k["library_ms"]]
    slower.sort(key=lambda k: k["ms"] / k["library_ms"], reverse=True)
    rest = [k for k in kernels if k not in slower]
    rest.sort(key=lambda k: k["launches"] * (k["ms"] - k["bound_ms"]), reverse=True)
    rows = []
    for k in slower + rest:
        rows.append({"name": k["name"], "slower_than_library": k in slower,
                     "ms": k["ms"], "library_ms": k["library_ms"], "bound_ms": k["bound_ms"],
                     "launches": k["launches"],
                     "launches_x_excess_ms": k["launches"] * (k["ms"] - k["bound_ms"]),
                     "share_of_bound": k["bound_ms"] / k["ms"] if k["ms"] else None})
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__.strip().splitlines()[2].strip(), file=sys.stderr)
        return 2
    for i, row in enumerate(rank(kernels_line(argv[0])), 1):
        print(json.dumps({"rank": i, **row}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
