"""The port's copy of data/ingest.py against the JAX package's, on
tests/test_ingest.py's published-schema pickles: every SceneArrays field
equal exactly (the point subsample drawn from the same seed, the PMC
tables), the npz round trip and its parameter-keyed cache, short hint sets,
the object-slot cap, and the CLIs that load --base_path: the evaluation
CLI's _load and the trainers' _load_data give the JAX loaders' arrays, and
main_pipeline and one train_coarse epoch run on the ingested map.

The JAX ingest builds its PMC tables with its native rematch where that is
built; the port has only the numpy rematch. The tables are held against the
JAX numpy path, and against the JAX default path too (the two agree on
these fixtures).
"""

import dataclasses
import json
import os
from unittest import mock

import numpy as np
import pytest

import test_ingest as ti
from text2loc_tpu import native
from text2loc_tpu.data import ingest as jingest
from text2loc_tpu.data.structs import Cell, Pose
from text2loc_tpu_torch import constants as PC
from text2loc_tpu_torch.data import ingest
from text2loc_tpu_torch.data.arrays import MultiSceneArrays, SceneArrays

FIELDS = [f.name for f in dataclasses.fields(SceneArrays)]


def _assert_scenes_equal(got, want):
    assert [f.name for f in dataclasses.fields(want)] == FIELDS
    for name in FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        if w is None or isinstance(w, (str, list)):
            assert g == w, name
        else:
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)


def _write_scene(base, name, seed, num_cells=3, num_poses=4):
    """One scene in the published schema under `base` (the pickles of
    tests/test_ingest.py's helpers, renamed to `name`), with a compass
    neighbour map."""
    rng = np.random.default_rng(seed)
    cells = [Cell(i, name, ti._make_objects(rng, 4 + i), 30.0,
                  np.array([i * 30.0, 0, 0, i * 30.0 + 30, 30, 30]))
             for i in range(num_cells)]
    poses = []
    for pi in range(num_poses):
        ci = pi % num_cells
        pose_in_cell = rng.uniform(0.2, 0.8, 2).astype(np.float32)
        pose3 = np.array([pose_in_cell[0], pose_in_cell[1], 0.0])
        pose_w = cells[ci].bbox_w[:3] + np.r_[pose_in_cell * 30.0, 0.0]
        descrs = [ti._make_descr(cells[ci].objects[j % len(cells[ci].objects)], pose3,
                                 matched=(j % 3 != 2)) for j in range(6)]
        poses.append(Pose(pose_in_cell, pose_w, cells[ci].id, name, descrs))
    ti._dump_reference_pickles(base, cells, poses)
    for kind in ("cells", "poses"):
        os.replace(base / kind / f"{ti.SCENE}.pkl", base / kind / f"{name}.pkl")
    neighbors = {c.id: {"east": cells[i + 1].id if i + 1 < num_cells else None,
                        "west": cells[i - 1].id if i > 0 else None}
                 for i, c in enumerate(cells)}
    with open(base / "direction" / f"{name}.json", "w") as f:
        json.dump(neighbors, f)


@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    """Every scene of the published splits, three cells and four poses each."""
    base = tmp_path_factory.mktemp("kitti360pose")
    # The helpers pickle under test_ingest.SCENE, the first scene's name,
    # and _write_scene renames: so that scene is written last.
    for i, name in reversed(list(enumerate(PC.SCENE_NAMES))):
        _write_scene(base, name, seed=10 + i)
    return base


def _npz_name(scene, store_points):
    return f"{scene}_p{store_points}_m6.npz"


def _numpy_rematch():
    return mock.patch.object(native, "available", return_value=False)


@pytest.mark.parametrize("jax_path", ["numpy", "default"])
def test_convert_base_path_equals_jax(kitti, jax_path):
    names = PC.SCENE_NAMES[:3]
    got = ingest.convert_base_path(str(kitti), names, store_points=16)
    if jax_path == "numpy":
        with _numpy_rematch():
            want = jingest.convert_base_path(str(kitti), names, store_points=16)
    else:
        want = jingest.convert_base_path(str(kitti), names, store_points=16)
    for g, w in zip(got, want):
        _assert_scenes_equal(g, w)
        assert g.pmc_valid is not None and g.pmc_match is not None


@pytest.mark.parametrize("store_points,object_slots,with_neighbors",
                         [(16, 8, True), (40, 6, False), (8, 28, True)])
def test_convert_scene_equals_jax(kitti, store_points, object_slots, with_neighbors):
    """convert_scene on the loaded object graph: clouds subsampled with and
    without replacement, slots that truncate a cell, with and without PMC."""
    from text2loc_tpu.data.structs import load_compat_pickle as jload
    from text2loc_tpu_torch.data.structs import load_compat_pickle

    name = PC.SCENE_NAMES[1]
    neighbors = None
    if with_neighbors:
        with open(kitti / "direction" / f"{name}.json") as f:
            neighbors = json.load(f)
    args = dict(object_slots=object_slots, store_points=store_points, num_mentioned=6,
                neighbors_json=neighbors, seed=3)
    got = ingest.convert_scene(load_compat_pickle(str(kitti / "cells" / f"{name}.pkl")),
                               load_compat_pickle(str(kitti / "poses" / f"{name}.pkl")),
                               name, **args)
    with _numpy_rematch():
        want = jingest.convert_scene(jload(str(kitti / "cells" / f"{name}.pkl")),
                                     jload(str(kitti / "poses" / f"{name}.pkl")),
                                     name, **args)
    _assert_scenes_equal(got, want)


def test_npz_round_trip_reads_the_cache_and_the_jax_files(kitti, tmp_path):
    names = PC.SCENE_NAMES[:2]
    out = tmp_path / "arrays"
    fresh = ingest.convert_base_path(str(kitti), names, out_dir=str(out), store_points=16)
    with mock.patch.object(ingest, "load_compat_pickle",
                           side_effect=AssertionError("read a pickle")):
        cached = ingest.convert_base_path(str(kitti), names, out_dir=str(out),
                                          store_points=16)
    jout = tmp_path / "jax_arrays"
    with _numpy_rematch():
        jingest.convert_base_path(str(kitti), names, out_dir=str(jout), store_points=16)
    for i, name in enumerate(names):
        _assert_scenes_equal(cached[i], fresh[i])
        # The two packages' npz files hold the same arrays.
        _assert_scenes_equal(
            SceneArrays.load_npz(str(jout / _npz_name(name, 16))), fresh[i])


def test_npz_cache_keyed_by_conversion_params(kitti, tmp_path):
    out = tmp_path / "arrays"
    name = [PC.SCENE_NAMES[0]]
    a = ingest.convert_base_path(str(kitti), name, out_dir=str(out), store_points=16)[0]
    b = ingest.convert_base_path(str(kitti), name, out_dir=str(out), store_points=8)[0]
    assert a.obj_xyz.shape[2] == 16 and b.obj_xyz.shape[2] == 8
    names = sorted(os.listdir(out))
    assert names == sorted(_npz_name(name[0], p) for p in (16, 8))


def _one_cell_scene(tmp_path, rng, num_objects, hint_counts, descr_of):
    objs = ti._make_objects(rng, num_objects)
    cell = Cell(0, ti.SCENE, objs, 30.0, np.array([0.0, 0, 0, 30, 30, 30]))
    pose3 = np.array([0.4, 0.6, 0.0])
    poses = [Pose(np.array([0.4, 0.6], np.float32), np.array([12.0, 18.0, 0.0]),
                  cell.id, ti.SCENE, [descr_of(objs, j, pose3) for j in range(n)])
             for n in hint_counts]
    ti._dump_reference_pickles(tmp_path, [cell], poses)


def test_short_hint_sets_pad_and_mask(tmp_path):
    _one_cell_scene(tmp_path, np.random.default_rng(5), 5, (6, 3, 1, 0),
                    lambda objs, j, p: ti._make_descr(objs[j % 5], p))
    got = MultiSceneArrays(ingest.convert_base_path(str(tmp_path), [ti.SCENE],
                                                    store_points=16))
    with _numpy_rematch():
        want = jingest.convert_base_path(str(tmp_path), [ti.SCENE], store_points=16)
    _assert_scenes_equal(got.scenes[0], want[0])
    assert got.num_poses == 3
    np.testing.assert_array_equal(got.hint_mask.sum(axis=1), [6, 3, 1])
    pad = ~got.hint_mask
    assert (got.hint_label[pad] == PC.PAD_CLASS_INDEX).all()
    assert (got.hint_obj_idx[pad] == -1).all()
    np.testing.assert_array_equal(got.gather_coarse(np.arange(3), 8)["sentence_mask"],
                                  got.hint_mask)


def test_object_overflow_cap_warns_and_truncates(tmp_path, capsys):
    _one_cell_scene(tmp_path, np.random.default_rng(6), 70, (6,),
                    lambda objs, j, p: ti._make_descr(objs[0], p))
    scenes = ingest.convert_base_path(str(tmp_path), [ti.SCENE], store_points=16)
    assert "exceed the 64-object slot cap" in capsys.readouterr().out
    assert scenes[0].obj_xyz.shape[1] == 64 and scenes[0].obj_mask.sum() == 64
    with _numpy_rematch():
        want = jingest.convert_base_path(str(tmp_path), [ti.SCENE], store_points=16)
    _assert_scenes_equal(scenes[0], want[0])
    wide = ingest.convert_base_path(str(tmp_path), [ti.SCENE], store_points=16,
                                    object_slots=70)
    assert wide[0].obj_mask.sum() == 70


def test_ingest_cli(kitti, tmp_path, capsys):
    out = tmp_path / "arrays"
    ingest.main(["--base_path", str(kitti), "--out_dir", str(out), "--scenes",
                 PC.SCENE_NAMES[0], "--store_points", "16"])
    assert f"{PC.SCENE_NAMES[0]}: 3 cells, 4 poses" in capsys.readouterr().out
    assert os.listdir(out) == [_npz_name(PC.SCENE_NAMES[0], 16)]


def _multi_equal(got, want):
    assert len(got.scenes) == len(want.scenes)
    for g, w in zip(got.scenes, want.scenes):
        _assert_scenes_equal(g, w)


@pytest.mark.parametrize("use_test_set", [False, True])
def test_eval_cli_load_equals_jax(kitti, tmp_path, use_test_set):
    from text2loc_tpu.evaluation import cli as jcli
    from text2loc_tpu_torch.config import Config
    from text2loc_tpu_torch.evaluation import cli

    argv = ["--base_path", str(kitti), "--array_cache", str(tmp_path / "arrays")]
    argv += ["--use_test_set"] if use_test_set else []
    cfg, data = cli._load(cli._parse(argv))
    assert cfg == Config().validate()
    with _numpy_rematch():
        _, want = jcli._load(jcli.build_argparser().parse_args(argv))
    _multi_equal(data, want)
    split = PC.SCENE_NAMES_TEST if use_test_set else PC.SCENE_NAMES_VAL
    assert [s.scene_name for s in data.scenes] == split


@pytest.mark.parametrize("trainer", ["coarse", "fine"])
def test_trainers_load_data_equals_jax(kitti, tmp_path, trainer):
    from text2loc_tpu.training import coarse as jcoarse
    from text2loc_tpu_torch.config import Config
    from text2loc_tpu_torch.training import coarse

    argv = ["--base_path", str(kitti), "--array_cache", str(tmp_path / "arrays"),
            "--epochs", "3"]
    ap = coarse.build_argparser()
    if trainer == "fine":
        ap.add_argument("--pmc_prob", type=float, default=None)
    args = coarse._parse(ap, argv)
    cfg = coarse._apply_overrides(Config().validate(), args)
    got_cfg, *got = coarse._load_data(cfg, args)
    assert got_cfg == cfg and got_cfg.train.epochs == 3
    with _numpy_rematch():
        _, *want = jcoarse._load_data(None, jcoarse.build_argparser().parse_args(argv))
    for g, w in zip(got, want):
        _multi_equal(g, w)
    assert [len(d.scenes) for d in got] == [5, 1, 3]


def test_main_pipeline_and_train_coarse_on_the_ingested_map(kitti, tmp_path):
    """The port's entry points at the default Config() over the ingested
    splits, on the CPU: the evaluation pipeline, then one train_coarse epoch
    (two steps of 8) with its validation and test evaluations."""
    from text2loc_tpu_torch.evaluation.cli import main_pipeline
    from text2loc_tpu_torch.training import coarse

    cache = str(tmp_path / "arrays")
    out = main_pipeline(["--base_path", str(kitti), "--array_cache", cache,
                         "--device", "cpu", "--top_k", "1", "3"])
    assert out["retrievals"].shape == (4, 3)
    assert np.isfinite(out["pos_in_cells"]).all()
    _, _, logger = coarse.main(["--base_path", str(kitti), "--array_cache", cache,
                                "--device", "cpu", "--epochs", "1", "--batch_size", "8"])
    assert len(logger.steps) == 2
    assert all(np.isfinite(row["loss"]) for row in logger.steps)
