"""The port's parallel layer in one process, on the CPU: the local top-k
and merge of parallel/retrieval.py on simulated shards against the JAX
package's dense top-k, batch sharding and the global draws (augmentation,
dropout) against the single-device draws, a world of one rank (gloo over a
FileStore, destroyed after each test), utils/debug.py, and the imports.
The multi-rank paths are in tests/test_torch_port_dp.py."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from text2loc_tpu.evaluation.retrieval import topk_retrieval as jax_topk
from text2loc_tpu.parallel.retrieval import pad_gallery as jax_pad_gallery
from text2loc_tpu_torch.config import small_test_config
from text2loc_tpu_torch.convert import build_model, init_weights
from text2loc_tpu_torch.data import augment
from text2loc_tpu_torch.data.arrays import MultiSceneArrays
from text2loc_tpu_torch.data.synthetic import make_scene
from text2loc_tpu_torch.evaluation.retrieval import topk_retrieval
from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
from text2loc_tpu_torch.models.transformer import Dropout
from text2loc_tpu_torch.parallel import mesh as pmesh
from text2loc_tpu_torch.parallel import retrieval as pret
from text2loc_tpu_torch.parallel.train import replicate_state
from text2loc_tpu_torch.training import losses, steps
from text2loc_tpu_torch.utils import debug

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fake(rank, size):
    """A Mesh without a process group: enough for what computes no
    collective (shard_batch, local_draw)."""
    return pmesh.Mesh(group=None, rank=rank, size=size, device=torch.device("cpu"),
                      backend="gloo")


# -------------------------------------------------------- local top-k, merge


@pytest.mark.parametrize("shards,k", [(1, 4), (2, 1), (2, 6), (3, 4), (4, 11)])
def test_local_topk_and_merge_equal_the_dense_top_k(shards, k):
    rng = np.random.default_rng(shards * 10 + k)
    gallery = rng.normal(size=(11, 8)).astype(np.float32)
    gallery[7], gallery[10], gallery[4] = gallery[2], gallery[5], gallery[9]   # ties
    texts = rng.normal(size=(9, 8)).astype(np.float32)
    texts[3] = 0.0                                          # every cell ties
    padded, c = pret.pad_gallery(gallery, shards)
    want_pad, want_c = jax_pad_gallery(gallery, shards)
    np.testing.assert_array_equal(padded, want_pad)
    assert c == want_c == 11
    per = padded.shape[0] // shards
    parts = [pret.shard_local_topk(torch.from_numpy(padded[r * per:(r + 1) * per]),
                                   torch.from_numpy(texts), k, c, r * per)
             for r in range(shards)]
    scores = torch.cat([p[0] for p in parts], dim=1)
    ids = torch.cat([p[2] for p in parts], dim=1)
    got_s, (got_i,) = pret.merge_shard_topk(scores, (ids,), k)
    want_s, want_i = jax_topk(jnp.asarray(gallery), jnp.asarray(texts), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-6)
    assert got_i[3].tolist() == list(range(k))              # ties: the lowest id first
    dense_s, dense_i = topk_retrieval(torch.from_numpy(gallery), torch.from_numpy(texts), k)
    assert torch.equal(dense_i, got_i)


def test_merge_carries_payloads_of_any_width():
    scores = torch.tensor([[0.5, 0.75, 0.75, 0.25]])
    pos = torch.arange(8, dtype=torch.float32).reshape(1, 4, 2)
    s, (p,) = pret.merge_shard_topk(scores, (pos,), 3)
    assert s.tolist() == [[0.75, 0.75, 0.5]]
    assert p.tolist() == [[[2.0, 3.0], [4.0, 5.0], [0.0, 1.0]]]


# ---------------------------------------------- sharding and global draws


def test_shard_batch_keeps_each_ranks_rows_and_checks_divisibility():
    batch = {"a": np.arange(12).reshape(6, 2), "b": torch.arange(6)}
    got = [pmesh.shard_batch(batch, _fake(r, 3)) for r in range(3)]
    np.testing.assert_array_equal(np.concatenate([g["a"] for g in got]), batch["a"])
    assert torch.equal(torch.cat([g["b"] for g in got]), batch["b"])
    with pytest.raises(ValueError, match="divisible"):
        pmesh.shard_batch(batch, _fake(0, 4))


def _rows(fn, size, b):
    """fn(mesh or None) on every rank of a fake mesh of `size`, and once
    without a mesh, each from a generator seeded alike."""
    got = [fn(_fake(r, size), torch.Generator().manual_seed(11)) for r in range(size)]
    return got, fn(None, torch.Generator().manual_seed(11))


@pytest.mark.parametrize("size", [2, 3])
def test_augmentation_and_dropout_draw_the_global_batch(size):
    b = 6
    rng = np.random.default_rng(2)
    xyz = torch.from_numpy(rng.random((b, 3, 20, 3)).astype(np.float32))
    rgb = torch.from_numpy(rng.random((b, 3, 20, 3)).astype(np.float32))
    batch = {"xyz": xyz, "center": torch.from_numpy(rng.random((b, 3, 3)).astype(np.float32)),
             "mask": torch.ones(b, 3, dtype=torch.bool),
             "hint_dir": torch.from_numpy(rng.integers(0, 9, (b, 5))),
             "hint_color": torch.from_numpy(rng.integers(0, 8, (b, 5)))}

    def local(mesh, key):
        return batch if mesh is None else pmesh.shard_batch(batch, mesh)

    def drop(mesh, gen):
        mod = Dropout(0.5)
        mod.generator, mod.mesh = gen, mesh
        return {"out": mod(local(mesh, "xyz")["xyz"])}

    cases = {
        "flip": lambda mesh, gen: augment.flip_coarse(local(mesh, None), gen, mesh),
        "shuffle": lambda mesh, gen: augment.shuffle_hints(local(mesh, None), gen, mesh),
        "points": lambda mesh, gen: dict(zip(("xyz", "rgb"), augment.point_cloud_transform(
            *(pmesh.shard_batch({"x": xyz, "r": rgb}, mesh).values() if mesh else (xyz, rgb)),
            gen, num_points=8, augment=True, mesh=mesh))),
        "dropout": drop,
    }
    for name, fn in cases.items():
        got, want = _rows(fn, size, b)
        for key, w in want.items():
            assert torch.equal(torch.cat([g[key] for g in got]), w), (name, key)


def test_local_draw_advances_the_generator_as_one_device():
    gens = [torch.Generator().manual_seed(4) for _ in range(3)]
    pmesh.local_draw(lambda s: torch.rand(s, generator=gens[0]), (4, 2), _fake(1, 2))
    torch.rand((8, 2), generator=gens[1])
    assert torch.equal(torch.rand(3, generator=gens[0]), torch.rand(3, generator=gens[1]))


# ------------------------------------------------------ a world of one rank


@pytest.fixture
def world1(tmp_path):
    mesh = pmesh.make_mesh(1, device="cpu", init_method=f"file://{tmp_path / 'store'}",
                           rank=0, world_size=1)
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def test_make_mesh_checks_its_arguments(world1):
    assert (world1.rank, world1.size, world1.backend) == (0, 1, "gloo")
    with pytest.raises(ValueError, match="world of 1"):
        pmesh.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        pmesh.make_mesh(device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="runs gloo"):
        pmesh.make_mesh(device="cuda:0", backend="nccl")


def test_collectives_of_one_rank_and_their_gradients(world1):
    x = torch.arange(6.0).reshape(3, 2).requires_grad_()
    y = pmesh.all_gather_rows(x, world1)
    (s,) = pmesh.global_sums(world1, x.sum(0))
    ((y * 2).sum() + (s * 3).sum()).backward()
    assert torch.equal(y, x) and torch.equal(x.grad, torch.full((3, 2), 5.0))
    assert pmesh.shard_batch_multihost({"a": torch.ones(3)}, world1)["a"].shape == (3,)
    pmesh.barrier(world1)
    assert world1.calls["all_gather"] == 1 and world1.calls["all_reduce"] >= 3


def test_losses_of_one_rank_equal_no_mesh(world1):
    rng = np.random.default_rng(9)
    a, p, n = (torch.from_numpy(rng.normal(size=(7, 16)).astype(np.float32))
               for _ in range(3))
    for name in ("contrastive", "pairwise", "hardest"):
        cfg = dataclasses.replace(small_test_config().train.loss, ranking_loss=name)
        fn = losses.make_retrieval_loss(cfg)
        np.testing.assert_allclose(float(fn(a, p, mesh=world1)), float(fn(a, p)), rtol=1e-6)
    np.testing.assert_allclose(float(losses.triplet_margin_loss(a, p, n, mesh=world1)),
                               float(losses.triplet_margin_loss(a, p, n)), rtol=1e-6)


def _small_step_setup(seed=0):
    cfg = small_test_config()
    data = MultiSceneArrays([make_scene("0000", num_cells=6, num_poses=8,
                                        object_slots=cfg.model.object_size,
                                        num_points=cfg.model.pointnet.num_points,
                                        num_mentioned=cfg.model.num_mentioned)])
    emb = HintTextEmbedder.compositional(cfg.model.text_embed_dim, cfg.model.max_hint_tokens)
    model = init_weights(build_model(cfg, "coarse"), torch.Generator().manual_seed(seed))
    opt = steps.make_optimizer(model.parameters(), cfg, steps_per_epoch=1)
    return cfg, data, emb, model, opt


def test_replicate_state_of_one_rank_keeps_the_state(world1):
    cfg, data, emb, model, opt = _small_step_setup()
    state = steps.TrainState(model, opt)
    step = steps.make_coarse_train_step(model, emb, cfg, opt, torch.Generator().manual_seed(0),
                                        mesh=world1)
    step(data.gather_coarse(np.arange(4), cfg.model.object_size))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    replicate_state(state, world1)
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    assert world1.calls["broadcast"] > len(before)          # model and Adam tensors


# ------------------------------------------------------------------ debug


def test_debug_nans_names_the_parameter_with_a_nan_gradient():
    cfg, data, emb, model, opt = _small_step_setup()
    name = "object_encoder.pointnet.sa2.dense_1.weight"
    dict(model.named_parameters())[name].register_hook(lambda g: g * float("nan"))
    step = steps.make_coarse_train_step(model, emb, cfg, opt, torch.Generator().manual_seed(0))
    batch = data.gather_coarse(np.arange(4), cfg.model.object_size)
    debug.enable_nan_debugging()
    try:
        assert torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError, match=f"gradient of parameter {name}"):
            step(batch)
    finally:
        debug.enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled() and not debug.nan_debugging()
    step(batch)                                             # unchecked: no raise


def test_checkify_step_raises_on_a_non_finite_output():
    ok = debug.checkify_step(lambda x: {"loss": torch.tensor(x), "n": 3})
    assert float(ok(1.0)["loss"]) == 1.0
    with pytest.raises(FloatingPointError, match="'loss'"):
        ok(float("inf"))


# ---------------------------------------------------------------- imports


def test_parallel_and_dryrun_import_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            "import text2loc_tpu_torch.parallel, text2loc_tpu_torch.parallel.train\n"
            "import text2loc_tpu_torch.parallel.retrieval, text2loc_tpu_torch.dryrun\n"
            "import text2loc_tpu_torch.utils.debug\n"
            "bad = [m for m in sys.modules if m in ('jax', 'text2loc_tpu')"
            " or m.startswith(('jax.', 'text2loc_tpu.'))]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=300)
