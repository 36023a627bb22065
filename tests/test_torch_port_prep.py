"""The port's prep (text2loc_tpu_torch/prep, on the CPU here) against the JAX
package's prep, and its DBSCAN against scikit-learn's.

* The whole prep CLI on two raw scenes in the KITTI-360 layout (the layout
  of tests/test_prep.py's `raw_scene`; a second scene with two windows that
  share instances, four stuff classes, an unknown class and negative
  coordinates), once per option case: the objects cache, the cells (crops,
  normalisation, pseudo-instances and their order), the poses (every
  description field), the direction JSON and the --array_dir npz arrays are
  equal. The JAX run takes its numpy paths (voxel grid, PMC rematch), which
  are the port's contract.
* DBSCAN label for label with `sklearn.cluster.DBSCAN(eps=0.75)` on seeded
  clouds, a 0.75 m lattice (neighbours at exactly eps), border points
  between two clusters, all noise and a single point, each cloud alone and
  all of them packed into one call.
* The voxel grid against the JAX numpy path at every class's voxel size,
  one cloud and many packed.
* Closest points, close locations and single cells against the JAX
  functions; the constants and data/stats.py against the JAX copies.
* A subprocess: prepare -> ingest -> Localizer on the CPU imports no jax,
  no text2loc_tpu and no sklearn. Without a card the prep raises for
  "cuda".
"""

import io
import json
import os
import shutil
import subprocess
import sys
import textwrap
from contextlib import contextmanager, redirect_stdout
from unittest import mock

import joblib
import numpy as np
import pytest
import threadpoolctl
import torch

import test_prep as tp
from text2loc_tpu import constants as JC
from text2loc_tpu import native
from text2loc_tpu.data import stats as jstats
from text2loc_tpu.data.structs import Object3d as JObject3d
from text2loc_tpu.data.structs import load_compat_pickle as jload
from text2loc_tpu.prep import cells as jcells
from text2loc_tpu.prep import prepare as jprepare
from text2loc_tpu.prep.voxel import voxel_downsample_indices as jvoxel
from text2loc_tpu_torch import constants as PC
from text2loc_tpu_torch.data import stats as pstats
from text2loc_tpu_torch.data.structs import Object3d
from text2loc_tpu_torch.data.structs import load_compat_pickle as pload
from text2loc_tpu_torch.prep import cells as pcells
from text2loc_tpu_torch.prep import prepare as pprepare
from text2loc_tpu_torch.prep.dbscan import dbscan
from text2loc_tpu_torch.prep.exact import resolve_device
from text2loc_tpu_torch.prep.voxel import voxel_downsample_indices, voxel_keep

SCENE = tp.SCENE
SID = JC.CLASS_TO_SEMANTIC_ID


def _scene_strip(base):
    """The objects of tests/test_prep.py's raw_scene: buildings and poles
    along a 90 m strip and a terrain blanket of two dense patches, one
    window."""
    rng = np.random.default_rng(5)
    static = os.path.join(base, "data_3d_semantics", SCENE, "static")
    os.makedirs(static)
    parts = []

    def add(center, n, sem, iid, spread=1.5):
        parts.append((center + rng.normal(0, spread, (n, 3)), rng.integers(0, 255, (n, 3)),
                      np.full(n, sem), np.full(n, iid)))

    iid = 1
    for cx in range(0, 90, 10):
        add(np.array([cx, 5.0, 2.0]), 400, SID["building"], iid); iid += 1
        add(np.array([cx, -5.0, 1.0]), 60, SID["pole"], iid); iid += 1
    add(np.array([20.0, 0.0, 0.0]), 800, SID["terrain"], iid, spread=3.0)
    add(np.array([60.0, 0.0, 0.0]), 800, SID["terrain"], iid, spread=3.0)
    tp._write_ply(os.path.join(static, "0000_0001.ply"),
                  *(np.concatenate(c) for c in zip(*parts)))
    # The trajectory of raw_scene, its y swaying by 0.3 m so the grid layout
    # has a row of cells.
    _write_poses(base, [(x, 0.3 * np.sin(x / 5.0), 1.0) for x in np.arange(0.0, 90.0, 2.0)])


def _scene_windows(base):
    """Two overlapping windows over a 70 m strip at negative coordinates:
    road, sidewalk, terrain and vegetation sheets (stuff, their instances
    split across both windows), buildings and poles (some in both windows),
    cars (no known class)."""
    rng = np.random.default_rng(11)
    static = os.path.join(base, "data_3d_semantics", SCENE, "static")
    os.makedirs(static)
    windows = [[], []]

    def add(w, center, n, sem, iid, spread):
        pts = center + rng.normal(0, 1, (n, 3)) * spread
        windows[w].append((pts, rng.integers(0, 255, (n, 3)), np.full(n, sem),
                           np.full(n, iid)))

    x0, y0 = -140.0, -60.0
    for k, (name, dy) in enumerate((("road", 0.0), ("sidewalk", 4.5),
                                    ("terrain", -5.0), ("vegetation", 9.0))):
        for w, xs in enumerate(((0, 40), (30, 70))):
            n = 1400
            pts = np.column_stack([x0 + rng.uniform(*xs, n), y0 + dy + rng.uniform(-1.5, 1.5, n),
                                   rng.normal(0, 0.05 if name != "vegetation" else 1.0, n)])
            windows[w].append((pts, rng.integers(0, 255, (n, 3)), np.full(n, SID[name]),
                               np.full(n, 900 + k)))
    iid = 1
    for cx in range(0, 70, 8):
        both = cx % 16 == 0
        for w in ((0, 1) if both else ((0,) if cx < 35 else (1,))):
            add(w, np.array([x0 + cx, y0 + 13.0, 3.0]), 200, SID["building"], iid,
                np.array([2.0, 1.0, 2.0]))
            add(w, np.array([x0 + cx + 3, y0 - 9.0, 1.5]), 40, SID["pole"], iid + 1,
                np.array([0.2, 0.2, 1.5]))
            add(w, np.array([x0 + cx + 1, y0 + 1.0, 0.8]), 80, 26, 5000 + iid,
                np.array([1.5, 0.8, 0.5]))
        iid += 2
    for w, parts in enumerate(windows):
        tp._write_ply(os.path.join(static, f"000{w}_0001.ply"),
                      *(np.concatenate(c) for c in zip(*parts)))
    _write_poses(base, [(x0 + x, y0 + 0.5 * np.sin(x / 7.0), 1.0)
                        for x in np.arange(0.0, 70.0, 1.5)])


def _write_poses(base, xyz):
    pose_dir = os.path.join(base, "data_poses", SCENE)
    os.makedirs(pose_dir)
    rows = [np.r_[i, np.hstack([np.eye(3), np.array(p).reshape(3, 1)]).ravel()]
            for i, p in enumerate(xyz)]
    np.savetxt(os.path.join(pose_dir, "poses.txt"), np.array(rows))


SCENES = {"strip": _scene_strip, "windows": _scene_windows}


@pytest.fixture(scope="module")
def raw_scenes(tmp_path_factory):
    out = {}
    for name, make in SCENES.items():
        base = str(tmp_path_factory.mktemp(name))
        make(base)
        out[name] = base
    return out


def _assert_same(got, want, where="") -> None:
    """Equal object graphs: the same classes by name, equal attributes,
    arrays equal with equal dtypes."""
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    elif hasattr(want, "__dict__"):
        assert type(got).__name__ == type(want).__name__, where
        _assert_same(vars(got), vars(want), where)
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


@contextmanager
def _one_thread():
    """One thread for torch, OpenMP and BLAS: the test workers share the
    machine, and thread pools of small ops oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpoolctl.threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(n)


def _unseeded_rng():
    """np.random.default_rng with a fixed seed where it is called with none
    (the "random" strategy draws from such a generator), so the two
    packages draw the same."""
    real = np.random.default_rng
    return mock.patch("numpy.random.default_rng",
                      side_effect=lambda seed=None: real(17 if seed is None else seed))


CASES = {
    "defaults": [],
    "closest": ["--describe_by", "closest"],
    "class": ["--describe_by", "class"],
    "direction": ["--describe_by", "direction"],
    "random": ["--describe_by", "random"],
    "shift_cells": ["--shift_cells"],
    "grid_cells": ["--grid_cells"],
    "all_cells": ["--all_cells", "--num_mentioned", "6"],
    "describe_best_cell": ["--describe_best_cell"],
    "no_ontop": ["--no_ontop", "--pose_count", "2"],
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_prepare_equals_the_jax_prep(raw_scenes, tmp_path, scene, case):
    argv = ["--scene_name", SCENE, "--num_mentioned", "4", *CASES[case]]
    runs = {}
    for who in ("jax", "port"):
        raw = str(tmp_path / who / "raw")
        shutil.copytree(raw_scenes[scene], raw)
        out, arrays = str(tmp_path / who / "out"), str(tmp_path / who / "arrays")
        full = ["--path_in", raw, "--path_out", out, "--array_dir", arrays, *argv]
        with _unseeded_rng(), _one_thread(), redirect_stdout(io.StringIO()):
            if who == "jax":
                # Its numpy paths, and scikit-learn's n_jobs=-1 run inline.
                with mock.patch.object(native, "available", return_value=False), \
                        joblib.parallel_config(backend="sequential"):
                    jprepare.main(full)
            else:
                pprepare.main(full + ["--device", "cpu"])
        load = jload if who == "jax" else pload
        runs[who] = {
            "objects": load(os.path.join(raw, "objects", f"{SCENE}.pkl")),
            "cells": load(os.path.join(out, "cells", f"{SCENE}.pkl")),
            "poses": load(os.path.join(out, "poses", f"{SCENE}.pkl")),
            "direction": json.load(open(os.path.join(out, "direction", f"{SCENE}.json"))),
            "arrays": dict(np.load(os.path.join(arrays, f"{SCENE}.npz"))),
        }
    got, want = runs["port"], runs["jax"]
    assert len(want["cells"]) >= 2 and len(want["poses"]) >= 2, (len(want["cells"]),
                                                                 len(want["poses"]))
    for key in ("objects", "cells", "poses", "direction"):
        _assert_same(got[key], want[key], key)
    assert sorted(got["arrays"]) == sorted(want["arrays"])
    for name, w in want["arrays"].items():
        assert got["arrays"][name].dtype == w.dtype, name
        np.testing.assert_array_equal(got["arrays"][name], w, err_msg=name)


# ------------------------------------------------------------------ DBSCAN


def _blobs(seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(0, rng.uniform(0.2, 1.5), (int(rng.integers(20, 400)), 3))
                           + rng.uniform(-60, 60, 3) for _ in range(int(rng.integers(2, 6)))])


def _lattice():
    """6 x 6 x 2 points 0.75 m apart (multiples of 0.75 are exact binary
    fractions, so neighbours lie at exactly eps), plus a line of points
    0.75 apart (3 neighbours each: noise)."""
    grid = np.stack(np.meshgrid(np.arange(6), np.arange(6), np.arange(2), indexing="ij"),
                    -1).reshape(-1, 3) * 0.75 - 30.0
    line = np.column_stack([np.arange(10) * 0.75 + 15.0, np.zeros(10), np.zeros(10)])
    return np.concatenate([grid, line])


def _border(b_first):
    """Two clusters and, between them, a non-core point 0.7 m from one core
    point of each: it takes the cluster of lower id."""
    rng = np.random.default_rng(3)
    a = np.concatenate([rng.normal(0, 0.01, (5, 3)), [[0.5, 0, 0]]])
    b = np.concatenate([rng.normal(0, 0.01, (5, 3)) + [2.4, 0, 0], [[1.9, 0, 0]]])
    middle = [[1.2, 0, 0]]
    return np.concatenate([b, middle, a] if b_first else [a, middle, b])


CLOUDS = {
    **{f"blobs{s}": (lambda s=s: _blobs(s)) for s in range(4)},
    "uniform": lambda: np.random.default_rng(9).uniform(-5, 5, (3000, 3)) * [1, 1, 0.2],
    "lattice": _lattice,
    "border_a_first": lambda: _border(False),
    "border_b_first": lambda: _border(True),
    "duplicates": lambda: np.repeat(np.random.default_rng(4).uniform(-9, 9, (8, 3)), 5, axis=0),
    "all_noise": lambda: np.column_stack([np.arange(20) * 2.0, np.zeros(20), np.zeros(20)]),
    "single": lambda: np.array([[1.0, 2.0, 3.0]]),
}


@pytest.mark.parametrize("name", sorted(CLOUDS))
def test_dbscan_labels_equal_sklearn(name):
    DBSCAN = pytest.importorskip("sklearn.cluster").DBSCAN

    xyz = CLOUDS[name]()
    want = DBSCAN(eps=0.75).fit(xyz).labels_
    got = dbscan(torch.from_numpy(xyz), torch.zeros(len(xyz), dtype=torch.int64))
    np.testing.assert_array_equal(got.numpy(), want)
    if name == "lattice":
        assert (want[:72] == 0).all() and (want[72:] == -1).all()
    if name.startswith("border"):
        middle = 6
        assert want[middle] == 0 and (want[:6] != want[7:]).all()


def test_dbscan_packs_clouds_into_one_call():
    """Every cloud of CLOUDS in one call, each with its own ids from 0, and
    with chunks of candidate pairs far below a cloud's."""
    DBSCAN = pytest.importorskip("sklearn.cluster").DBSCAN
    clouds = [CLOUDS[n]() for n in sorted(CLOUDS)]
    cloud = np.concatenate([np.full(len(c), i) for i, c in enumerate(clouds)])
    got = dbscan(torch.from_numpy(np.concatenate(clouds)), torch.from_numpy(cloud),
                 max_pairs=5000).numpy()
    for i, c in enumerate(clouds):
        np.testing.assert_array_equal(got[cloud == i], DBSCAN(eps=0.75).fit(c).labels_)
    with pytest.raises(ValueError, match="nondecreasing"):
        dbscan(torch.zeros(2, 3, dtype=torch.float64), torch.tensor([1, 0]))


# -------------------------------------------------------------- voxel grid


def _jax_numpy_voxel(points, size):
    with mock.patch.object(native, "available", return_value=False):
        return jvoxel(points, size)


@pytest.mark.parametrize("label", sorted(k for k, v in JC.CLASS_TO_VOXELSIZE.items() if v))
def test_voxel_grid_equals_the_jax_numpy_path(label):
    size = JC.CLASS_TO_VOXELSIZE[label]
    rng = np.random.default_rng(sorted(JC.CLASS_TO_VOXELSIZE).index(label))
    pts = rng.normal(0, 3, (5000, 3)) - [400.0, -250.0, 3.0]
    pts[::7] = pts[1::7][: len(pts[::7])]          # shared voxels by construction
    np.testing.assert_array_equal(voxel_downsample_indices(pts, size, "cpu"),
                                  _jax_numpy_voxel(pts, size))


def test_voxel_keep_packs_clouds():
    """Many clouds in one pass, each with its own minimum and size, their
    points interleaved (each cloud's in its own order): the representatives
    of each are the JAX numpy path's."""
    rng = np.random.default_rng(0)
    sizes = [0.25, 0.125, 0.25, 0.5]
    clouds = [rng.normal(0, 2, (int(rng.integers(1, 900)), 3)) * (k + 1) + rng.uniform(-99, 99, 3)
              for k in range(len(sizes))]
    seg = rng.permutation(np.concatenate([np.full(len(c), k) for k, c in enumerate(clouds)]))
    xyz = np.zeros((len(seg), 3))
    for k, c in enumerate(clouds):
        xyz[seg == k] = c
    keep = voxel_keep(torch.from_numpy(xyz), torch.from_numpy(seg),
                      torch.tensor(sizes, dtype=torch.float64)).numpy()
    for k, c in enumerate(clouds):
        np.testing.assert_array_equal(np.nonzero(keep[seg == k])[0],
                                      _jax_numpy_voxel(c, sizes[k]))


# ------------------------------------------------ objects, cells, describe


def _scene_objects(seed, n=12):
    """Objects of both packages with equal arrays: instance classes and
    stuff sheets around the origin, negative coordinates included."""
    rng = np.random.default_rng(seed)
    labels = ["building", "pole", "road", "terrain", "vegetation", "lamp"]
    out = {"port": [], "jax": []}
    for i in range(n):
        label = labels[i % len(labels)]
        if label in JC.STUFF_CLASSES:   # a sheet dense enough for clusters
            k = int(rng.integers(600, 2000))
            xyz = rng.normal(0, 1, (k, 3)) * [3.0, 3.0, 0.05]
        else:
            k = int(rng.integers(30, 400))
            xyz = rng.normal(0, 1.5, (k, 3))
        xyz = xyz + rng.uniform(-20, 20, 3)
        rgb = rng.random((k, 3)).astype(np.float32)
        out["port"].append(Object3d(100 + i, 100 + i, xyz.copy(), rgb.copy(), label))
        out["jax"].append(JObject3d(100 + i, 100 + i, xyz.copy(), rgb.copy(), label))
    return out


def test_extract_objects_equals_the_jax_package():
    from text2loc_tpu.prep.objects import extract_objects as jextract
    from text2loc_tpu_torch.prep.objects import extract_objects

    rng = np.random.default_rng(2)
    n = 3000
    xyz = rng.normal(0, 20, (n, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    sem = rng.choice([7, 8, 11, 17, 26, 21], n).astype(np.int32)
    iid = rng.integers(0, 6, n).astype(np.int32) + 1000 * sem
    _assert_same(extract_objects(xyz, rgb, sem, iid, "cpu"), jextract(xyz, rgb, sem, iid))


def test_closest_points_equal_get_closest_point():
    """One pass over a cell's points against Object3d.get_closest_point per
    object, ties (equal distances) to the first point."""
    objs = _scene_objects(4)["port"]
    tie = Object3d(0, 0, np.array([[1.0, 0, 0], [0, -1.0, 0], [-1.0, 0, 0]]),
                   np.zeros((3, 3), np.float32), "pole")
    objs = objs + [tie]
    scene = pcells.ScenePoints(objs, "cpu")
    cell = pcells.CellPoints(0, "s", np.r_[-50.0, -50, -50, 50, 50, 50], 100.0,
                             scene.instance_ids, scene.labels, scene.xyz, scene.rgb,
                             scene.counts)
    for anchor in (np.zeros(3), np.array([3.5, -2.25, 1.0]), np.array([-19.0, 7.0, -3.0])):
        want = np.array([o.get_closest_point(anchor) for o in objs])
        np.testing.assert_array_equal(cell.closest_points(anchor), want)
    assert cell.closest_points(np.zeros(3))[-1].tolist() == [1.0, 0.0, 0.0]


def test_close_locations_equal_the_jax_package():
    """Including a location whose nearest instance point lies at exactly
    cell_size / 2 (an offset of (9, 12, 0) is 15.0 exactly: not close), and
    one just inside."""
    objs = _scene_objects(5)
    far = np.array([200.0, 200.0, 0.0]) - np.arange(40)[:, None] * [0.1, 0.1, 0.0]
    for who, cls in (("port", Object3d), ("jax", JObject3d)):
        objs[who].append(cls(999, 999, far.copy(), np.zeros((40, 3), np.float32), "pole"))
    rng = np.random.default_rng(6)
    edge = far[0] + [9.0, 12.0, 0.0]
    locs = np.concatenate([rng.uniform(-45, 45, (60, 3)), [edge, edge - [0, 1e-9, 0]]])
    scene = pcells.ScenePoints(objs["port"], "cpu")
    got = pcells.get_close_locations(locs, scene, 30.0)
    want = jcells.get_close_locations(locs, objs["jax"], 30.0)
    assert 0 < len(want) < len(locs) - 1
    assert not any(np.array_equal(w, edge) for w in want)
    assert np.array_equal(want[-1], edge - [0, 1e-9, 0])
    np.testing.assert_array_equal(np.array(got), np.array(want))


@pytest.mark.parametrize("half", [6.0, 12.0, 25.0])
@pytest.mark.parametrize("all_cells", [False, True])
def test_create_cell_equals_the_jax_package(half, all_cells):
    objs = _scene_objects(7, n=18)
    scene = pcells.ScenePoints(objs["port"], "cpu")
    bbox = np.r_[np.array([-3.0, 2.0, -1.0]) - half, np.array([-3.0, 2.0, -1.0]) + half]
    got = pcells.create_cell(3, "0003", bbox, scene, num_mentioned=6, all_cells=all_cells)
    want = jcells.create_cell(3, "0003", bbox, objs["jax"], num_mentioned=6,
                              all_cells=all_cells)
    assert (got is None) == (want is None)
    if want is not None:
        _assert_same(got.to_cell(), want)


def test_select_and_direction_equal_the_jax_package():
    from text2loc_tpu.prep import describe as jdescribe
    from text2loc_tpu_torch.prep import describe as pdescribe

    objs = _scene_objects(8, n=10)
    pose = np.array([0.5, -1.0, 0.0])
    for strategy in ("closest", "class", "direction"):
        got = pdescribe.select_objects(objs["port"], pose, 6, strategy)
        want = jdescribe.select_objects(objs["jax"], pose, 6, strategy)
        assert [o.id for o in got] == [o.id for o in want], strategy
    for g, w in zip(objs["port"], objs["jax"]):
        assert pdescribe.get_direction(g, pose) == jdescribe.get_direction(w, pose)
        assert (pdescribe.get_direction_no_ontop(g, pose)
                == jdescribe.get_direction_no_ontop(w, pose))
    for off in ([0.01, 0.01], [0.3, 0.1], [-0.3, 0.1], [0.2, 0.2], [0.2, -0.2], [0.0, 0.0]):
        assert pdescribe.direction_word(np.array(off)) == jdescribe.direction_word(np.array(off))


def test_neighbor_map_and_output_name_equal_the_jax_package():
    from text2loc_tpu.data.structs import Cell as JCell
    from text2loc_tpu.prep.relations import build_neighbor_map as jmap
    from text2loc_tpu_torch.data.structs import Cell
    from text2loc_tpu_torch.prep.relations import build_neighbor_map

    boxes = [np.r_[x, y, 0.0, x + 30, y + 30, 30] for x in (0.0, 10.0, 20.0) for y in (-10.0, 0.0)]
    got = build_neighbor_map([Cell(i, "s", [], 30.0, b) for i, b in enumerate(boxes)])
    assert got == jmap([JCell(i, "s", [], 30.0, b) for i, b in enumerate(boxes)])
    argv = ["--path_in", "x", "--path_out", "k360", "--scene_name", "s", "--shift_cells",
            "--no_ontop", "--all_cells", "--describe_best_cell", "--cell_size", "20.5"]
    assert (pprepare.encode_output_name(pprepare.build_argparser().parse_args(argv))
            == jprepare.encode_output_name(jprepare.build_argparser().parse_args(argv)))


# ------------------------------------------------------- constants, stats


@pytest.mark.parametrize("name", ["STUFF_CLASSES", "CLASS_TO_SEMANTIC_ID",
                                  "SEMANTIC_ID_TO_CLASS", "CLASS_TO_MINPOINTS",
                                  "CLASS_TO_VOXELSIZE"])
def test_prep_constants_equal_the_jax_package(name):
    assert getattr(PC, name) == getattr(JC, name)


def test_stats_equal_the_jax_package():
    from text2loc_tpu.config import small_test_config as jcfg
    from text2loc_tpu.data.arrays import MultiSceneArrays as JMulti
    from text2loc_tpu.data.synthetic import make_scene as jmake
    from text2loc_tpu_torch.data.arrays import MultiSceneArrays
    from text2loc_tpu_torch.data.synthetic import make_scene

    m = jcfg().model
    kw = dict(num_cells=6, num_poses=40, object_slots=m.object_size,
              num_points=m.pointnet.num_points, num_mentioned=m.num_mentioned)
    assert (pstats.description_stats(MultiSceneArrays([make_scene("0000", **kw)]))
            == jstats.description_stats(JMulti([jmake("0000", **kw)])))
    outs = []
    for mod in (pstats, jstats):
        buf = io.StringIO()
        with redirect_stdout(buf):
            mod.main(["--synthetic"])
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "duplicated" in outs[0]


# ---------------------------------------------------- device, imports


def test_prep_raises_without_a_card(raw_scenes, tmp_path):
    with mock.patch("torch.cuda.is_available", return_value=False):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            resolve_device("cuda")
        with pytest.raises(RuntimeError, match="no CUDA card"):
            voxel_downsample_indices(np.zeros((3, 3)), 0.25)
        with pytest.raises(RuntimeError, match="no CUDA card"):
            pprepare.main(["--path_in", raw_scenes["strip"], "--path_out", str(tmp_path),
                           "--scene_name", SCENE])
    assert pprepare.build_argparser().get_default("device") == "cuda"


CHILD = textwrap.dedent("""
    import json, sys
    import numpy as np
    from text2loc_tpu_torch.config import small_test_config
    from text2loc_tpu_torch.convert import build_model, init_weights
    import torch
    from text2loc_tpu_torch.data.arrays import MultiSceneArrays
    from text2loc_tpu_torch.data.ingest import convert_base_path
    from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
    from text2loc_tpu_torch.prep.prepare import main
    from text2loc_tpu_torch.serving import Localizer

    raw, out, scene = sys.argv[1:4]
    stats = main(["--path_in", raw, "--path_out", out, "--scene_name", scene,
                  "--num_mentioned", "3", "--device", "cpu"])
    cfg = small_test_config()
    data = MultiSceneArrays(convert_base_path(
        out, [scene], store_points=cfg.model.pointnet.num_points,
        object_slots=cfg.model.object_size, num_mentioned=cfg.model.num_mentioned))
    gen = torch.Generator().manual_seed(0)
    coarse = init_weights(build_model(cfg, "coarse"), gen)
    fine = init_weights(build_model(cfg, "fine"), gen)
    emb = HintTextEmbedder.compositional(cfg.model.text_embed_dim, cfg.model.max_hint_tokens)
    loc = Localizer(data, coarse, fine, emb, cfg, top_k=2, device="cpu")
    q = np.arange(3) % data.num_poses
    res = loc.localize(data.hint_dir[q], data.hint_color[q], data.hint_label[q],
                       data.hint_mask[q])
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "text2loc_tpu", "sklearn"))
    print(json.dumps({"bad": bad, "cells": data.num_cells, "poses": data.num_poses,
                      "finite": bool(np.isfinite(res.position_w).all()),
                      "stats": stats}))
""")


def test_prepare_ingest_serve_imports_no_jax_nor_sklearn(raw_scenes, tmp_path):
    raw = str(tmp_path / "raw")
    shutil.copytree(raw_scenes["strip"], raw)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", CHILD, raw, str(tmp_path / "out"), SCENE],
                          capture_output=True, text=True, env=env, timeout=600, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["bad"] == [], report["bad"][:10]
    assert report["cells"] >= 3 and report["poses"] >= 3 and report["finite"], report
    assert report["stats"]["device"] == "cpu" and report["stats"]["objects"] > 0
