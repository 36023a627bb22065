"""Minimal PLY reader for KITTI-360 semantic point clouds (the port's copy
of text2loc_tpu/prep/ply.py: read_ply_vertices, load_points).

Reads the formats KITTI-360 ships (binary little- / big-endian, ascii) with
arbitrary vertex properties, and returns the four arrays the prep needs:
xyz, rgb (raw uint8), semantic label id, instance id. Host-side numpy: the
file is parsed once and its columns go to the device in objects.py.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply_vertices(path: str) -> Dict[str, np.ndarray]:
    """Parse the `vertex` element of a PLY file into named column arrays."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        assert magic == b"ply", f"not a PLY file: {path}"
        fmt = None
        elements = []  # [(name, count, [(prop_name, dtype_str)])]
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"unexpected EOF in header: {path}")
            tokens = line.decode("ascii", "replace").strip().split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                elements.append((tokens[1], int(tokens[2]), []))
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    elements[-1][2].append((tokens[-1], "list", tokens[2], tokens[3]))
                else:
                    elements[-1][2].append((tokens[-1], tokens[1]))
            elif tokens[0] == "end_header":
                break

        assert fmt in ("binary_little_endian", "binary_big_endian", "ascii"), fmt
        endian = ">" if fmt == "binary_big_endian" else "<"

        out: Dict[str, np.ndarray] = {}
        for name, count, props in elements:
            if name != "vertex":
                # Vertex data always precedes face lists in KITTI-360 files;
                # stop once read.
                break
            assert all(len(p) == 2 for p in props), (
                "list properties unsupported in vertex element"
            )
            if fmt == "ascii":
                rows = np.loadtxt(
                    [f.readline() for _ in range(count)], ndmin=2
                )
                for i, (pname, ptype) in enumerate(props):
                    out[pname] = rows[:, i].astype(_PLY_DTYPES[ptype])
            else:
                dt = np.dtype(
                    [(p, endian + _PLY_DTYPES[t]) for p, t in props]
                )
                data = np.frombuffer(f.read(count * dt.itemsize), dtype=dt)
                for pname, _ in props:
                    out[pname] = np.ascontiguousarray(data[pname])
        return out


def load_points(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(xyz [N,3] as stored, rgb [N,3] raw, semantic [N], instance [N])."""
    cols = read_ply_vertices(path)
    xyz = np.stack([cols["x"], cols["y"], cols["z"]], axis=1)
    rgb = np.stack([cols["red"], cols["green"], cols["blue"]], axis=1)
    return xyz, rgb, cols["semantic"], cols["instance"]
