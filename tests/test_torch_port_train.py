"""The port's train steps against the JAX package's, on the CPU, and the
port's augmentations, losses and coarse trainer.

Whole steps follow tests/test_training_dynamics.py's protocol: dropout 0,
no augmentation, all-valid masks, the same weights carried over with
convert.from_jax_params, the same batches. The JAX step runs its CPU path
(the XLA SA levels); the port runs its fused SA levels (ops/sa_train.py,
plain versions with the hand-derived backward) where the stage's defaults
fuse them, which agree with the XLA path to ~2e-4. Compared, with the
dynamics test's gates: the loss at every step (rtol 1e-4), every gradient
leaf at step 0 (rel-L2 < 5e-3 and cosine > 0.9999 above a floor of 1e-6 x
the global gradient norm; leaves below it are the BN-shift and
softmax-shift directions whose exact gradient is 0), the parameters after
the steps (Adam step-size envelope, update cosine > 0.999 above the floor)
and the BN running statistics (rel-L2 < 2e-2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2loc_tpu import constants as JC
from text2loc_tpu.config import small_test_config as jax_small_config
from text2loc_tpu.data import augment as jaug
from text2loc_tpu.models.cell_retrieval import CellRetrievalNetwork as JaxCoarse
from text2loc_tpu.models.cross_matcher import CrossMatch as JaxFine
from text2loc_tpu.models.text_embedding import HintTextEmbedder as JaxEmbedder
from text2loc_tpu.training import losses as jlosses
from text2loc_tpu.training import steps as jsteps
from text2loc_tpu_torch.config import small_test_config
from text2loc_tpu_torch.convert import build_model, convert_tree, from_jax_params
from text2loc_tpu_torch.data import augment
from text2loc_tpu_torch.data.arrays import MultiSceneArrays
from text2loc_tpu_torch.data.synthetic import make_scene
from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
from text2loc_tpu_torch.training import losses, steps
from text2loc_tpu_torch.training.coarse import train_coarse

B = 6
N_STEPS = 3
LR = 1e-3


def _plain(cfg, ranking_loss):
    model = dataclasses.replace(cfg.model, dropout_rate=0.0)
    train = dataclasses.replace(
        cfg.train, batch_size=B, flip_poses=False, shuffle_hints=False,
        pc_augment=False, fine_flip_poses=False,
        loss=dataclasses.replace(cfg.train.loss, ranking_loss=ranking_loss))
    return cfg.replace(model=model, train=train)


def _batch(seed, mcfg, fine):
    rng = np.random.default_rng(seed)
    o = mcfg.pad_size if fine else mcfg.object_size
    p, s = mcfg.pointnet.num_points, mcfg.num_mentioned
    b = dict(
        xyz=rng.random((B, o, p, 3)).astype(np.float32),
        rgb=rng.random((B, o, p, 3)).astype(np.float32),
        center=rng.random((B, o, 3)).astype(np.float32),
        color=rng.random((B, o, 3)).astype(np.float32),
        num_points=rng.integers(10, 5000, (B, o)).astype(np.float32),
        class_idx=rng.integers(0, 21, (B, o)).astype(np.int32),
        color_idx=rng.integers(0, 8, (B, o)).astype(np.int32),
        mask=np.ones((B, o), bool),
        hint_dir=rng.integers(0, 9, (B, s)).astype(np.int32),
        hint_color=rng.integers(0, 8, (B, s)).astype(np.int32),
        hint_label=rng.integers(0, 21, (B, s)).astype(np.int32),
        sentence_mask=np.ones((B, s), bool),
    )
    if fine:
        b["target"] = rng.random((B, 2)).astype(np.float32)
        b["pose_in_cell"] = b["target"].copy()
    return b


def _flatten(state: dict) -> dict:
    return {k: v.detach().numpy().astype(np.float64) for k, v in state.items()}


def _jax_grads(model, cfg, state, b, kind):
    emb = JaxEmbedder.compositional(cfg.model.text_embed_dim, cfg.model.max_hint_tokens)
    key = jax.random.PRNGKey(7)
    if kind == "coarse":
        objects, text = jsteps.prepare_coarse_batch(b, emb, cfg, key, train=True)
        pair = jlosses.make_retrieval_loss(cfg.train.loss)

        def loss_of(p):
            (cell, text_emb), _ = model.apply(
                {"params": p, "batch_stats": state.batch_stats}, objects, text,
                train=True, mutable=["batch_stats"], rngs={"dropout": key})
            return pair(text_emb, cell)
    else:
        fb = jsteps.prepare_fine_batch(b, emb, cfg, key, train=True)

        def loss_of(p):
            pred, _ = model.apply(
                {"params": p, "batch_stats": state.batch_stats}, fb.objects, fb.text,
                train=True, mutable=["batch_stats"], rngs={"dropout": key})
            return cfg.train.offset_lambda * jnp.mean((pred - fb.target) ** 2)

    return jax.device_get(jax.jit(jax.grad(loss_of))(state.params))


def _run(kind, ranking_loss, tables=()):
    jcfg = _plain(jax_small_config(), ranking_loss)
    pcfg = _plain(small_test_config(), ranking_loss)
    if tables:
        on = {f"{t}_embed": True for t in tables}
        jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, **on))
        pcfg = pcfg.replace(model=dataclasses.replace(pcfg.model, **on))
    fine = kind == "fine"
    jmodel = (JaxFine if fine else JaxCoarse)(jcfg.model)
    jemb = JaxEmbedder.compositional(jcfg.model.text_embed_dim, jcfg.model.max_hint_tokens)
    jopt = jsteps.make_optimizer(jcfg, steps_per_epoch=1, lr=LR)
    b0 = _batch(100, jcfg.model, fine)
    key = jax.random.PRNGKey(0)
    if fine:
        fb = jsteps.prepare_fine_batch(b0, jemb, jcfg, key, train=False)
        state = jsteps.init_train_state(jmodel, jopt, key, fb.objects, fb.text)
    else:
        state = jsteps.init_train_state(
            jmodel, jopt, key, *jsteps.prepare_coarse_batch(b0, jemb, jcfg, key, train=False))
    params0, stats0 = jax.device_get(state.params), jax.device_get(state.batch_stats)
    jgrads = convert_tree(_jax_grads(jmodel, jcfg, state, b0, kind), {})
    make = jsteps.make_fine_train_step if fine else jsteps.make_coarse_train_step
    jstep = jax.jit(make(jmodel, jemb, jcfg, jopt))

    model = build_model(pcfg, kind)
    model.load_state_dict(from_jax_params(params0, stats0, pcfg, kind))
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    emb = HintTextEmbedder.compositional(pcfg.model.text_embed_dim,
                                         pcfg.model.max_hint_tokens)
    opt = steps.make_optimizer(model.parameters(), pcfg, steps_per_epoch=1, lr=LR)
    pmake = steps.make_fine_train_step if fine else steps.make_coarse_train_step
    pstep = pmake(model, emb, pcfg, opt, torch.Generator().manual_seed(0))

    jl, pl, pgrads = [], [], None
    for i in range(N_STEPS):
        b = b0 if i == 0 else _batch(100 + i, jcfg.model, fine)
        state, jm = jstep(state, b, jax.random.PRNGKey(1))
        jl.append(float(jm["loss"]))
        pl.append(float(pstep(b)["loss"]))
        if i == 0:
            pgrads = {k: p.grad.detach().clone() for k, p in model.named_parameters()
                      if p.grad is not None}
    jstate = convert_tree(jax.device_get(state.params), jax.device_get(state.batch_stats))
    return jl, pl, jgrads, pgrads, p0, jstate, model


@pytest.mark.parametrize("kind,ranking_loss", [("coarse", "contrastive"),
                                               ("coarse", "pairwise"),
                                               ("fine", "contrastive")])
def test_train_steps_match_jax(kind, ranking_loss):
    _check_steps(*_run(kind, ranking_loss))


@pytest.mark.parametrize("kind,tables", [("coarse", ("class",)), ("fine", ("color",)),
                                         ("coarse", ("class", "color")),
                                         ("fine", ("class", "color"))])
def test_train_steps_with_embedding_tables_match_jax(kind, tables):
    """class_embed / color_embed: the tables' rows take the JAX gradients,
    by the same gates."""
    jl, pl, jgrads, pgrads, p0, jstate, model = _run(kind, "contrastive", tables)
    for t in tables:
        assert f"object_encoder.{t}_embedding.weight" in pgrads
    assert not hasattr(model.object_encoder, "pointnet") or "class" not in tables
    _check_steps(jl, pl, jgrads, pgrads, p0, jstate, model)


def _check_steps(jl, pl, jgrads, pgrads, p0, jstate, model):
    np.testing.assert_allclose(pl, jl, rtol=1e-4, atol=1e-6)

    want, got = _flatten(jgrads), _flatten(pgrads)
    floor = 1e-6 * np.sqrt(sum(np.sum(v ** 2) for v in want.values()))
    n_real = 0
    for k, w in want.items():
        g = got.get(k, np.zeros_like(w))
        nw = np.linalg.norm(w)
        if nw < floor:
            assert np.linalg.norm(g) < 10 * floor, k
            continue
        n_real += 1
        assert np.linalg.norm(g - w) / nw < 5e-3, k
        assert float(np.dot(g.ravel(), w.ravel()) / (np.linalg.norm(g) * nw)) > 0.9999, k
    assert n_real > 10

    params = dict(model.named_parameters())
    envelope = 4 * N_STEPS * LR
    for k, v0 in p0.items():
        dj = jstate[k].numpy().astype(np.float64) - v0.numpy()
        dt = params[k].detach().numpy().astype(np.float64) - v0.numpy()
        assert np.abs(dj - dt).max() <= envelope, k
        w = want.get(k)
        if w is None or np.linalg.norm(w) < floor or np.linalg.norm(dj) == 0:
            continue
        # Components of a real leaf whose exact gradient is 0 (a bias unit
        # that is active for every sample before a BatchNorm) carry f32
        # noise that Adam turns into full-size steps of either sign on both
        # sides: the direction is compared on the other components.
        live = np.abs(w) > 1e-4 * np.abs(w).max()
        dj, dt = dj[live], dt[live]
        cos = float(np.dot(dj, dt) / (np.linalg.norm(dj) * np.linalg.norm(dt) + 1e-30))
        assert cos > 0.999, (k, cos)

    state = model.state_dict()
    stats = [k for k in jstate if "running_" in k]
    assert stats
    for k in stats:
        w = jstate[k].numpy().astype(np.float64)
        rel = np.linalg.norm(state[k].numpy() - w) / (np.linalg.norm(w) + 1e-30)
        assert rel < 2e-2, (k, rel)


# ----------------------------------------------------------- augmentation


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_flip_swaps_direction_words_with_the_coordinates():
    rng = np.random.default_rng(1)
    b, s = 64, 6
    batch = {"xyz": torch.rand(b, 3, 5, 3), "center": torch.rand(b, 3, 3),
             "pose_in_cell": torch.rand(b, 2), "target": torch.rand(b, 2),
             "mask": torch.ones(b, 3, dtype=torch.bool),
             "hint_dir": torch.from_numpy(rng.integers(0, 9, (b, s)).astype(np.int32))}
    out = augment.flip_coarse(batch, _gen(3))
    h_map, v_map = JC.DIRECTION_H_FLIP, JC.DIRECTION_V_FLIP
    seen = set()
    for i in range(b):
        fh = bool(torch.allclose(out["xyz"][i, ..., 0], 1 - batch["xyz"][i, ..., 0]))
        fv = bool(torch.allclose(out["xyz"][i, ..., 1], 1 - batch["xyz"][i, ..., 1]))
        seen.add((fh, fv))
        d = batch["hint_dir"][i].numpy()
        d = h_map[d] if fh else d
        d = v_map[d] if fv else d
        np.testing.assert_array_equal(out["hint_dir"][i].numpy(), d)
        for name in ("center", "pose_in_cell", "target"):
            x = batch[name][i]
            want = torch.stack([1 - x[..., 0] if fh else x[..., 0],
                                1 - x[..., 1] if fv else x[..., 1]], -1)
            torch.testing.assert_close(out[name][i][..., :2], want)
        torch.testing.assert_close(out["xyz"][i, ..., 2], batch["xyz"][i, ..., 2])
    assert seen == {(False, False), (False, True), (True, False), (True, True)}
    assert out["hint_dir"].dtype == batch["hint_dir"].dtype


def test_shuffle_hints_permutes_every_hint_field_alike():
    b, s = 16, 6
    pos = torch.arange(s).repeat(b, 1)
    batch = {"hint_dir": pos % 9, "hint_color": pos, "hint_label": pos + 100,
             "sentence_mask": pos < 4}
    out = augment.shuffle_hints(batch, _gen(4))
    col = out["hint_color"]
    assert torch.equal(out["hint_dir"], col % 9)
    assert torch.equal(out["hint_label"], col + 100)
    assert torch.equal(out["sentence_mask"], col < 4)
    assert torch.equal(col.sort(dim=1).values, pos)
    assert not torch.equal(col, pos)


def test_point_transforms_bound_and_keep_points():
    rng = np.random.default_rng(5)
    xyz = (rng.random((4, 3, 40, 3)) * 7 + 2).astype(np.float32)
    rgb = rng.random((4, 3, 40, 3)).astype(np.float32)
    got = augment.normalize_scale(torch.from_numpy(xyz))
    np.testing.assert_allclose(got.numpy(), np.asarray(jaug.normalize_scale(xyz)),
                               rtol=1e-6, atol=1e-6)
    assert got.abs().max() <= 1.0
    np.testing.assert_allclose(got.mean(dim=-2).numpy(), 0.0, atol=1e-6)

    out_xyz, out_rgb = augment.point_cloud_transform(
        torch.from_numpy(xyz), torch.from_numpy(rgb), _gen(6), num_points=16, augment=True)
    assert out_xyz.shape == (4, 3, 16, 3) and out_rgb.shape == (4, 3, 16, 3)
    assert out_xyz.dtype == torch.float32 and out_xyz.abs().max() <= 1.0
    rows = {tuple(r) for r in rgb.reshape(-1, 3).round(6)}
    assert all(tuple(r) in rows for r in out_rgb.numpy().reshape(-1, 3).round(6))
    # z survives the rotation up to NormalizeScale's per-cloud affine map.
    pts, _ = augment.resample_points(torch.from_numpy(xyz), torch.from_numpy(rgb),
                                     _gen(7), 16)
    rot = augment.random_rotate_z(pts, _gen(8))
    torch.testing.assert_close(rot[..., 2], pts[..., 2])
    torch.testing.assert_close(rot[..., :2].norm(dim=-1), pts[..., :2].norm(dim=-1))


# ------------------------------------------------------------------ losses


@pytest.mark.parametrize("name", ["contrastive", "pairwise", "hardest"])
def test_retrieval_losses_match_jax(name):
    rng = np.random.default_rng(11)
    a = rng.normal(size=(7, 16)).astype(np.float32)
    p = rng.normal(size=(7, 16)).astype(np.float32)
    cfg = dataclasses.replace(small_test_config().train.loss, ranking_loss=name)
    got = losses.make_retrieval_loss(cfg)(torch.from_numpy(a), torch.from_numpy(p))
    want = jlosses.make_retrieval_loss(cfg)(jnp.asarray(a), jnp.asarray(p))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_triplet_and_pose_error_match_jax():
    rng = np.random.default_rng(12)
    a, p, n = (rng.normal(size=(5, 8)).astype(np.float32) for _ in range(3))
    got = losses.triplet_margin_loss(*(torch.from_numpy(x) for x in (a, p, n)), 0.35)
    want = jlosses.triplet_margin_loss(a, p, n, 0.35)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    pred, gt = rng.random((5, 2)).astype(np.float32), rng.random((5, 3)).astype(np.float32)
    np.testing.assert_allclose(float(losses.pose_error(torch.from_numpy(pred),
                                                       torch.from_numpy(gt))),
                               float(jlosses.pose_error(pred, gt)), rtol=1e-6)
    with pytest.raises(ValueError):
        losses.make_retrieval_loss(dataclasses.replace(
            small_test_config().train.loss, ranking_loss="triplet"))


# ---------------------------------------------------------------- trainer


def test_lr_schedule_is_a_staircase_per_epoch():
    cfg = small_test_config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, lr_gamma=0.5))
    f = steps.make_lr_schedule(cfg, steps_per_epoch=3)
    assert [f(i) for i in range(7)] == [1, 1, 1, 0.5, 0.5, 0.5, 0.25]
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, lr_scheduler="step", lr_step=2))
    f = steps.make_lr_schedule(cfg, steps_per_epoch=3)
    assert [f(i) for i in (0, 5, 6, 12)] == [1, 1, 0.5, 0.25]


def test_train_coarse_takes_steps_on_the_cpu():
    cfg = small_test_config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=4, epochs=1))
    data = MultiSceneArrays([make_scene("0000", num_cells=6, num_poses=8,
                                        object_slots=cfg.model.object_size,
                                        num_points=cfg.model.pointnet.num_points,
                                        num_mentioned=cfg.model.num_mentioned)])
    emb = HintTextEmbedder.compositional(cfg.model.text_embed_dim,
                                         cfg.model.max_hint_tokens)
    model = build_model(cfg, "coarse")
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    _, model, logger = train_coarse(cfg, data, None, emb, device="cpu", model=model)
    history = logger.steps
    assert [h["step"] for h in history] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in history)
    sa = "object_encoder.pointnet.sa1.dense_1.weight"
    assert not torch.equal(dict(model.named_parameters())[sa], before[sa])
    changed = sum(not torch.equal(p, before[k]) for k, p in model.named_parameters())
    assert changed > len(before) // 2
