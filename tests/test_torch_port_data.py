"""The port's own copies of the JAX package's host-side modules (constants,
config, data.arrays, data.synthetic) against the originals: the same values,
the same synthetic scenes from the same seed, the same gathered batches
(exact equality: both are numpy on the same inputs)."""

import dataclasses

import numpy as np
import pytest

from text2loc_tpu import config as jconfig
from text2loc_tpu import constants as JC
from text2loc_tpu.data.arrays import MultiSceneArrays as JaxMultiScene
from text2loc_tpu.data.synthetic import make_scene as jax_make_scene
from text2loc_tpu_torch import config as pconfig
from text2loc_tpu_torch import constants as PC
from text2loc_tpu_torch.data.arrays import MultiSceneArrays
from text2loc_tpu_torch.data.synthetic import make_scene

SCENE = dict(num_cells=5, num_poses=9, object_slots=7, num_points=12, num_mentioned=4)


@pytest.mark.parametrize("name", [
    "CLASS_TO_INDEX", "INDEX_TO_CLASS", "NUM_CLASSES", "PAD_CLASS_INDEX", "COLORS",
    "COLOR_NAMES", "NUM_COLORS", "DIRECTIONS", "DIRECTION_TO_INDEX", "NUM_DIRECTIONS",
    "DIRECTION_H_FLIP", "DIRECTION_V_FLIP", "NUM_POINTS_MEAN", "NUM_POINTS_STD",
    "SCENE_NAMES", "SCENE_NAMES_TRAIN", "SCENE_NAMES_VAL", "SCENE_NAMES_TEST",
    "HINT_TEMPLATE"])
def test_constants_equal_the_jax_package(name):
    got, want = getattr(PC, name), getattr(JC, name)
    if isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want
    assert PC.hint_vocab_size() == JC.hint_vocab_size()
    ids = np.arange(4)
    np.testing.assert_array_equal(PC.hint_id(ids, ids, ids), JC.hint_id(ids, ids, ids))


@pytest.mark.parametrize("make", ["Config", "small_test_config"])
def test_config_defaults_equal_the_jax_package(make):
    got = getattr(pconfig, make)()
    want = getattr(jconfig, make)()
    for part in ("model", "train", "eval"):
        g, w = dataclasses.asdict(getattr(got, part)), dataclasses.asdict(getattr(want, part))
        assert g == {k: w[k] for k in g}, part


def _scenes(make):
    return [make(f"00{i}", seed=i, pose_seed=None if i == 0 else 7, **SCENE) for i in range(2)]


def test_make_scene_equals_the_jax_package():
    for got, want in zip(_scenes(make_scene), _scenes(jax_make_scene)):
        for field in dataclasses.fields(got):
            g, w = getattr(got, field.name), getattr(want, field.name)
            if isinstance(w, np.ndarray):
                np.testing.assert_array_equal(g, w, err_msg=field.name)
            else:
                assert g == w, field.name


@pytest.mark.parametrize("gather", ["coarse", "coarse_rngs", "fine", "cells"])
def test_gathers_equal_the_jax_package(gather):
    got_data = MultiSceneArrays(_scenes(make_scene))
    want_data = JaxMultiScene(_scenes(jax_make_scene))
    idx = np.array([3, 0, 17, 5, 9])
    if gather == "coarse":
        got, want = (d.gather_coarse(idx, 6) for d in (got_data, want_data))
    elif gather == "coarse_rngs":
        got, want = (d.gather_coarse(idx, 6, sample_close_rng=np.random.default_rng(1),
                                     negative_rng=np.random.default_rng(2))
                     for d in (got_data, want_data))
    elif gather == "fine":
        got, want = (d.gather_fine(idx, 5) for d in (got_data, want_data))
    else:
        got, want = (d.gather_cell_objects(np.array([4, 1, 8]), 7)
                     for d in (got_data, want_data))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
