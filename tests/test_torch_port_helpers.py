"""The last of the JAX package's public functions in the port, against the
JAX ones on the CPU: the matching losses and metric (training/losses.py),
the legacy position estimators (models/cross_matcher.py), voxel_downsample
(prep/voxel.py), profile_trace and StageTimer.rate (utils/profiling.py),
and the small members the port had left out (CrossMatch.refine,
MultiSceneArrays.stored_points / fine_offset_targets, ObjectSet.batch_shape,
CoarseBatch).

Inputs are made from seeded numpy; the JAX side runs as tests/test_losses.py
runs it. Tolerances: matching_loss and nt_xent (values, and nt_xent's
gradient as one vector) within rel 1e-5 in f32, both packages summing in
their own order; nt_xent over a world-2 gloo mesh (the ranks of
tests/test_torch_port_dp.py): the ranks' shares summed, and their rows'
gradients, within rel 1e-5 of the one-rank call on the gathered batch.
The numpy copies and the voxel grid are equal exactly.
"""

import glob
import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_ranks as R
from text2loc_tpu import native
from text2loc_tpu.data.arrays import MultiSceneArrays as JaxMultiScene
from text2loc_tpu.data.batch import CoarseBatch as JaxCoarseBatch
from text2loc_tpu.data.synthetic import make_scene as jax_make_scene
from text2loc_tpu.models import cross_matcher as JM
from text2loc_tpu.prep import voxel as JV
from text2loc_tpu.training import losses as JL
from text2loc_tpu.utils import profiling as JP
from text2loc_tpu_torch.config import small_test_config
from text2loc_tpu_torch.convert import build_model, init_weights
from text2loc_tpu_torch.data.arrays import MultiSceneArrays
from text2loc_tpu_torch.data.batch import CoarseBatch, ObjectSet
from text2loc_tpu_torch.data.synthetic import make_scene
from text2loc_tpu_torch.dryrun import run_ranks
from text2loc_tpu_torch.models import cross_matcher as PM
from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
from text2loc_tpu_torch.prep import voxel as PV
from text2loc_tpu_torch.training import losses as PL
from text2loc_tpu_torch.training import steps
from text2loc_tpu_torch.utils import profiling as PP

REL = 1e-5
WORLD = 2
RANKS_TIMEOUT = 120


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def _matching_inputs(seed, b=4, o=6, s=5, m=7):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, o + 1, s + 1)).astype(np.float32)
    log_p = logits - np.log(np.exp(logits).sum(axis=(1, 2), keepdims=True))
    matches = np.stack([rng.integers(0, o + 1, (b, m)), rng.integers(0, s + 1, (b, m))],
                       -1).astype(np.int32)
    mask = rng.random((b, m)) > 0.3
    mask[1] = False                               # a sample with no valid pair
    return log_p.astype(np.float32), matches, mask


@pytest.mark.parametrize("seed", [0, 1])
def test_matching_loss_matches_jax(seed):
    log_p, matches, mask = _matching_inputs(seed)
    want = float(JL.matching_loss(jnp.asarray(log_p), jnp.asarray(matches), jnp.asarray(mask)))
    got = PL.matching_loss(torch.from_numpy(log_p), torch.from_numpy(matches),
                           torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=REL)


def _views(seed, b=8, d=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, d)).astype(np.float32),
            rng.standard_normal((b, d)).astype(np.float32))


@pytest.mark.parametrize("temperature", [0.1, 0.5])
def test_nt_xent_matches_jax(temperature):
    zi, zj = _views(3)
    want, (gi, gj) = jax.value_and_grad(
        lambda a, b: JL.nt_xent(a, b, temperature), argnums=(0, 1))(jnp.asarray(zi),
                                                                   jnp.asarray(zj))
    got = R.nt_xent_rank(None, zi, zj, temperature)
    np.testing.assert_allclose(float(got["loss"]), float(want), rtol=REL)
    assert _rel(np.concatenate([got["grad_i"], got["grad_j"]]),
                np.concatenate([np.asarray(gi), np.asarray(gj)])) <= REL


def test_nt_xent_over_two_ranks_equals_one_rank():
    """Each rank's share over the gathered 2B views: the shares sum to the
    one-rank loss on the gathered batch (and to the JAX loss), and each
    rank's rows get that call's gradient of those rows."""
    zi, zj = _views(4)
    one = R.nt_xent_rank(None, zi, zj, 0.1)
    got = run_ranks(R.nt_xent_rank, WORLD, args=(zi, zj, 0.1), timeout=RANKS_TIMEOUT,
                    threads=1)
    total = sum(float(r["loss"]) for r in got)
    np.testing.assert_allclose(total, float(one["loss"]), rtol=REL)
    np.testing.assert_allclose(total, float(JL.nt_xent(jnp.asarray(zi), jnp.asarray(zj), 0.1)),
                               rtol=REL)
    for key in ("grad_i", "grad_j"):
        assert _rel(torch.cat([r[key] for r in got]), one[key]) <= REL, key


@pytest.mark.parametrize("seed", range(4))
def test_calc_recall_precision_equals_jax(seed):
    rng = np.random.default_rng(seed)
    o, s, m = 9, 6, 8
    gt = np.stack([rng.integers(-1, o, m), rng.integers(-1, s, m)], -1)
    pred0 = rng.integers(-1, s, o)
    pred1 = rng.integers(-1, o, s)
    got = PL.calc_recall_precision(gt, pred0, pred1)
    assert got == JL.calc_recall_precision(gt, pred0, pred1)
    assert all(isinstance(v, float) for v in got)


@pytest.mark.parametrize("matched", [0, 1, 2, 5])
def test_position_helpers_equal_jax(matched):
    """Both estimators at 0, 1 (fewer than the intersection's two), 2 and
    5 matched objects of 7."""
    rng = np.random.default_rng(matched)
    o, s = 7, 6
    centers = rng.random((o, 3))
    matches0 = np.full(o, -1)
    matches0[rng.choice(o, matched, replace=False)] = rng.integers(0, s, matched)
    offsets = rng.normal(0, 0.1, (s, 2))
    directions = rng.normal(0, 1, (s, 2))
    for name, extra in (("get_pos_in_cell", offsets),
                        ("get_pos_in_cell_intersect", directions)):
        got = getattr(PM, name)(centers, matches0, extra)
        want = getattr(JM, name)(centers, matches0, extra)
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("size", [0.05, 0.3])
def test_voxel_downsample_equals_jax(size):
    """The port's voxel_downsample on the CPU against the JAX one (its numpy
    path, as tests/test_torch_port_prep.py takes it)."""
    rng = np.random.default_rng(11)
    pts = (rng.normal(0, 2, (4000, 3)) + [100.0, -50.0, 2.0]).astype(np.float32)
    pts[::5] = pts[1::5][: len(pts[::5])]
    got_pts, got_idx = PV.voxel_downsample(pts, size, device="cpu")
    with mock.patch.object(native, "available", return_value=False):
        want_pts, want_idx = JV.voxel_downsample(pts, size)
    np.testing.assert_array_equal(got_idx, want_idx)
    np.testing.assert_array_equal(got_pts, want_pts)
    assert got_pts.dtype == pts.dtype


def test_voxel_downsample_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        PV.voxel_downsample(np.zeros((4, 3)), 0.1)


def test_profile_trace_none_yields_none_and_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with PP.profile_trace(None) as prof:
        torch.ones(8, 8).sum()
    assert prof is None
    assert os.listdir(tmp_path) == []


def test_profile_trace_writes_a_trace_of_the_ops_inside(tmp_path):
    log_dir = tmp_path / "trace"
    a = torch.ones(32, 32)
    with PP.profile_trace(str(log_dir)) as prof:
        torch.mm(a, a)
    assert "aten::mm" in {e.key for e in prof.key_averages()}
    files = glob.glob(str(log_dir / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" and e.get("name") == "aten::mm" for e in events)


def test_profile_trace_raises_where_a_card_cannot_be_traced(tmp_path, monkeypatch):
    """A card is present and the profiler records the CPU only: it raises
    before tracing, and writes nothing."""
    from torch.profiler import ProfilerActivity

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {ProfilerActivity.CPU})
    with pytest.raises(RuntimeError, match="CUDA"):
        with PP.profile_trace(str(tmp_path / "trace")):
            pass
    assert not (tmp_path / "trace").exists()


def test_stage_timer_rate_equals_jax():
    got, want = PP.StageTimer(), JP.StageTimer()
    for t in (got, want):
        with t.stage("eval"):
            pass
        t.totals["eval"] = 0.37
    assert got.rate("eval", 1000) == want.rate("eval", 1000)
    assert got.rate("never", 5) == want.rate("never", 5) == 5 / 1e-9
    assert got.report() == want.report()


SCENE = dict(num_cells=5, num_poses=9, object_slots=7, num_points=12, num_mentioned=4)


@pytest.mark.parametrize("cell,learn", [("pose", "center"), ("pose", "closest"),
                                        ("best", "center"), ("best", "closest")])
def test_fine_offset_targets_equal_jax(cell, learn):
    got = MultiSceneArrays([make_scene(f"00{i}", seed=i, **SCENE) for i in range(2)])
    want = JaxMultiScene([jax_make_scene(f"00{i}", seed=i, **SCENE) for i in range(2)])
    pi = np.array([0, 3, 8, 11, 17])
    out = got.fine_offset_targets(pi, cell, learn)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, want.fine_offset_targets(pi, cell, learn))
    assert got.stored_points == want.stored_points == SCENE["num_points"]
    with pytest.raises(ValueError):
        got.fine_offset_targets(pi, "all", learn)


def test_coarse_batch_and_batch_shape():
    assert CoarseBatch._fields == JaxCoarseBatch._fields
    objects = ObjectSet(*(torch.zeros(3, 5, 4, 3) for _ in ObjectSet._fields))
    assert tuple(objects.batch_shape) == (3, 5)


def test_cross_match_refine_is_the_forward_past_the_objects():
    cfg = small_test_config()
    model = init_weights(build_model(cfg, "fine", sa_mode="off"),
                         torch.Generator().manual_seed(0)).eval()
    data = MultiSceneArrays([make_scene("0000", seed=0, object_slots=cfg.model.object_size,
                                        num_points=cfg.model.pointnet.num_points,
                                        num_mentioned=cfg.model.num_mentioned,
                                        num_cells=4, num_poses=6)])
    emb = HintTextEmbedder.compositional(cfg.model.text_embed_dim, cfg.model.max_hint_tokens)
    batch = steps.to_device(data.gather_fine(np.arange(4), cfg.model.pad_size), "cpu")
    gen = torch.Generator().manual_seed(1)
    fb = steps.prepare_fine_batch(batch, emb, cfg, gen, train=False)
    with torch.no_grad():
        want = model(fb.objects, fb.text)
        got = model.refine(model.encode_objects(fb.objects), fb.objects.mask, fb.text)
    assert torch.equal(got, want)
