"""The port's copies of the JAX package's PMC host layer (data/structs.py,
data/pmc.py, the PMC fields of data/arrays.py) and of data/prefetch.py,
against the originals: the same tables on tests/test_pmc.py's fixtures and
on seeded random geometry, bit-equal sample_pmc draws from the same seed,
the same global neighbour table, and the prefetcher's contract (order,
exceptions, early exit, bounded depth, the serial path)."""

import dataclasses
import pickle
import threading

import numpy as np
import pytest

from test_pmc import _setup as pmc_fixture
from text2loc_tpu.data import pmc as jpmc
from text2loc_tpu.data import structs as jstructs
from text2loc_tpu.data.arrays import MultiSceneArrays as JaxMultiScene
from text2loc_tpu.data.synthetic import make_scene as jax_make_scene
from text2loc_tpu_torch import constants as PC
from text2loc_tpu_torch.data import pmc, structs
from text2loc_tpu_torch.data.arrays import MultiSceneArrays
from text2loc_tpu_torch.data.prefetch import maybe_prefetch, prefetch
from text2loc_tpu_torch.data.synthetic import make_scene

SCENE = dict(num_cells=9, num_poses=20, object_slots=7, num_points=12, num_mentioned=4)


def test_neighbor_keys_equal_the_jax_package():
    from text2loc_tpu import constants as JC

    assert PC.NEIGHBOR_KEYS == JC.NEIGHBOR_KEYS


def _objects(mod, rng):
    return [mod.Object3d(i, 100 + i, rng.random((9, 3)), rng.random((9, 3)),
                         ["building", "pole", "car"][i % 3]) for i in range(4)]


def test_structs_equal_the_jax_package():
    got, want = _objects(structs, np.random.default_rng(1)), _objects(
        jstructs, np.random.default_rng(1))
    anchor = np.array([0.3, 0.6, 0.1])
    for g, w in zip(got, want):
        assert g.get_color_idx() == w.get_color_idx()
        assert g.get_color_text() == w.get_color_text()
        np.testing.assert_array_equal(g.get_center(), w.get_center())
        np.testing.assert_array_equal(g.get_closest_point(anchor), w.get_closest_point(anchor))
        assert repr(g) == repr(w)
    merged = structs.Object3d.merge(got[0], got[0])
    np.testing.assert_array_equal(merged.xyz, jstructs.Object3d.merge(want[0], want[0]).xyz)
    pad_g = structs.Object3d.create_padding(np.random.default_rng(2))
    pad_w = jstructs.Object3d.create_padding(np.random.default_rng(2))
    np.testing.assert_array_equal(pad_g.xyz, pad_w.xyz)
    bbox = [0.0, 30.0, 0.0, 30.0, 60.0, 30.0]
    cg, cw = structs.Cell(7, "s", got, 30.0, bbox), jstructs.Cell(7, "s", want, 30.0, bbox)
    assert cg.id == cw.id and repr(cg) == repr(cw)
    np.testing.assert_array_equal(cg.get_center(), cw.get_center())


@pytest.mark.parametrize("module", ["datapreparation.kitti360pose.imports",
                                    "datapreparation.kitti360.imports"])
def test_compat_unpickler_maps_reference_paths(module, tmp_path):
    cell = structs.Cell(3, "s", _objects(structs, np.random.default_rng(3)), 30.0,
                        [0, 0, 0, 30, 30, 30])
    blob = pickle.dumps(cell, protocol=0).replace(
        b"text2loc_tpu_torch.data.structs", module.encode())
    path = tmp_path / "cells.pkl"
    path.write_bytes(blob)
    got, want = structs.load_compat_pickle(str(path)), jstructs.load_compat_pickle(str(path))
    assert type(got) is structs.Cell and type(want) is jstructs.Cell
    assert got.id == want.id == cell.id
    for g, w in zip(got.objects, want.objects):
        assert type(g) is structs.Object3d
        np.testing.assert_array_equal(g.xyz, w.xyz)


def _random_geometry(mod, seed):
    """Overlapping 10 m-stride cells sharing objects, poses near their
    neighbours, hints built as the reference grounds them (some of another
    label, so they fail to re-match)."""
    rng = np.random.default_rng(seed)
    size = 30.0
    world = [(rng.uniform(0, 50, (12, 3)), rng.random((12, 3)),
              ["building", "pole", "car", "vegetation"][i % 4]) for i in range(8)]
    cells, bboxes = [], []
    for ci, (x0, y0) in enumerate([(0, 0), (10, 0), (0, 10), (10, 10)]):
        bbox = np.array([x0, y0, 0.0, x0 + size, y0 + size, size])
        objs = [mod.Object3d(oi, 500 + oi, (pts - bbox[:3]) / size, rgb, label)
                for oi, (pts, rgb, label) in enumerate(world[ci % 2:])]
        cells.append(mod.Cell(ci, "scene", objs, size, bbox))
        bboxes.append(bbox)
    keys = {"east": 1, "north": 2, "northeast": 3}
    neighbors = {cells[0].id: {k: cells[v].id for k, v in keys.items()},
                 cells[1].id: {"west": cells[0].id, "north": cells[3].id},
                 cells[2].id: {"south": cells[0].id, "east": cells[3].id}}
    poses = []
    for pi in range(10):
        ci = pi % 3
        pose_w = np.array([*(bboxes[ci][:2] + rng.uniform(12, 24, 2)), 0.0])
        pose_in = (pose_w - bboxes[ci][:3]) / size
        descrs = []
        for oi in rng.choice(len(cells[ci].objects), 3, replace=False):
            obj = cells[ci].objects[oi]
            d = mod.DescriptionPoseCell()
            d.object_label = obj.label if rng.random() < 0.8 else "car"
            cp = obj.get_closest_point(pose_in)
            d.offset_closest = (pose_in - cp)[:2]
            d.object_instance_id, d.object_id = obj.instance_id, obj.id
            d.object_color_rgb, d.object_color_text = obj.get_color_rgb(), obj.get_color_text()
            d.direction, d.offset_center = "east", (pose_in - obj.get_center())[:2]
            d.closest_point = cp[:2]
            descrs.append(mod.DescriptionBestCell.matched(d, int(oi), cp, d.offset_center,
                                                          d.offset_closest))
        poses.append(mod.Pose(pose_in[:2], pose_w, cells[ci].id, "scene", descrs))
    return cells, poses, neighbors


@pytest.mark.parametrize("kw", [
    dict(num_mentioned=1, pmc_threshold=0.4, count_threshold=0),
    dict(num_mentioned=1, pmc_threshold=0.05, count_threshold=0),
    dict(num_mentioned=3, pmc_threshold=0.4, count_threshold=0),
    dict(num_mentioned=1, count_threshold=0, object_slots=1),
    dict(num_mentioned=1, count_threshold=1, object_slots=1),
])
def test_build_pmc_tables_equal_on_the_pmc_fixtures(kw):
    cells, poses, neighbors = pmc_fixture()
    for g, w in zip(pmc.build_pmc_tables(cells, poses, neighbors, **kw),
                    jpmc.build_pmc_tables(cells, poses, neighbors, **kw)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kw", [dict(num_mentioned=3, count_threshold=1),
                                dict(num_mentioned=4, count_threshold=2, object_slots=5),
                                dict(num_mentioned=3, pmc_threshold=0.3, count_threshold=2)])
def test_build_pmc_tables_equal_on_random_geometry(kw):
    """Against the JAX package's numpy rematch (its native one is not
    ported; on this geometry the two JAX paths disagree on a few slots)."""
    from unittest import mock

    from text2loc_tpu import native

    got = pmc.build_pmc_tables(*_random_geometry(structs, 5), **kw)
    with mock.patch.object(native, "available", return_value=False):
        want = jpmc.build_pmc_tables(*_random_geometry(jstructs, 5), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].any() and not got[0].all()


def _pmc_scene(make, i, with_tables=True):
    scene = make(f"00{i}", seed=i, **SCENE)
    if not with_tables:
        return scene
    rng = np.random.default_rng(40 + i)
    c, n, s = scene.num_cells, scene.num_poses, scene.hint_obj_idx.shape[1]
    neighbors = np.where(rng.random((c, 8)) < 0.6, rng.integers(0, c, (c, 8)), -1)
    valid = rng.random((n, 8)) < 0.5
    return dataclasses.replace(
        scene, cell_neighbors=neighbors.astype(np.int32), pmc_valid=valid,
        pmc_weight=np.where(valid, rng.uniform(0.1, 5, (n, 8)), 0).astype(np.float32),
        pmc_match=rng.integers(-1, SCENE["object_slots"], (n, 8, s)).astype(np.int32))


def _both(with_tables=(True, True)):
    return (MultiSceneArrays([_pmc_scene(make_scene, i, t) for i, t in enumerate(with_tables)]),
            JaxMultiScene([_pmc_scene(jax_make_scene, i, t) for i, t in enumerate(with_tables)]))


def test_arrays_pmc_fields_equal_the_jax_package():
    got, want = _both()
    for name in ("cell_neighbors", "pmc_valid", "pmc_weight", "pmc_match"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert got.cell_neighbors.max() >= SCENE["num_cells"]      # re-based to the gallery
    got, want = _both((True, False))
    for name in ("cell_neighbors", "pmc_valid", "pmc_weight", "pmc_match"):
        assert getattr(got, name) is None and getattr(want, name) is None


@pytest.mark.parametrize("prob", [0.0, 0.5, 1.0])
def test_sample_pmc_draws_are_bit_equal(prob):
    got_data, want_data = _both()
    rg, rw = np.random.default_rng(9), np.random.default_rng(9)
    n_clones = 0
    for b in range(6):
        idx = np.random.default_rng(b).permutation(got_data.num_poses)[:8]
        g = pmc.sample_pmc(got_data, idx, rg, prob)
        w = jpmc.sample_pmc(want_data, idx, rw, prob)
        for x, y in zip(g, w):
            np.testing.assert_array_equal(x, y)
        n_clones += int((g[0] != got_data.pose_cell_idx[idx]).sum())
        batch_g = got_data.gather_fine(idx, 5, cell_indices=g[0], hint_obj_idx=g[1])
        batch_w = want_data.gather_fine(idx, 5, cell_indices=w[0], hint_obj_idx=w[1])
        for k in batch_w:
            np.testing.assert_array_equal(batch_g[k], batch_w[k], err_msg=k)
    assert rg.random() == rw.random()                       # the streams stay in step
    assert (n_clones > 0) == (prob > 0)


# ---------------------------------------------------------------- prefetch


def _rng_batches(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(4,)) for _ in range(n))


def test_prefetch_preserves_stateful_order():
    serial = list(_rng_batches(3, 12))
    staged = list(prefetch(_rng_batches(3, 12)))
    assert len(staged) == 12
    for s, p in zip(serial, staged):
        np.testing.assert_array_equal(s, p)


def test_prefetch_generator_exception_propagates():
    def bad():
        yield 1
        yield 2
        raise RuntimeError("gather failed")

    it = prefetch(bad())
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(RuntimeError, match="gather failed"):
        list(it)


def test_prefetch_early_exit_joins_worker():
    before = set(threading.enumerate())
    it = prefetch(iter(range(1000)))
    assert next(it) == 0
    it.close()
    leaked = [t for t in threading.enumerate()
              if t not in before and t.name == "text2loc-prefetch" and t.is_alive()]
    assert not leaked


def test_prefetch_depth_bounds_staging():
    produced, consumed, lead = [], [], []

    def gen():
        for i in range(50):
            produced.append(i)
            yield i

    for item in prefetch(gen()):
        lead.append(len(produced) - len(consumed))
        consumed.append(item)
    assert consumed == list(range(50))
    assert max(lead) <= 2 + 2       # the queue of 2, one being gathered, one yielded


def test_maybe_prefetch_serial_spawns_no_thread(monkeypatch):
    spawned = []
    orig = threading.Thread.start

    def spy(self, *a, **k):
        spawned.append(self.name)
        return orig(self, *a, **k)

    monkeypatch.setattr(threading.Thread, "start", spy)
    assert list(maybe_prefetch(iter([1, 2, 3]), enabled=False)) == [1, 2, 3]
    assert "text2loc-prefetch" not in spawned
    assert list(maybe_prefetch(iter([1, 2, 3]))) == [1, 2, 3]
    assert "text2loc-prefetch" in spawned
