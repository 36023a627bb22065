"""The port's trainers (training/fine.py, training/coarse.py), their
optimizer, checkpoints, PointNet graft and CLIs, against the JAX package
on the CPU.

Weights: the JAX trainer's own initialization (PRNGKey(seed), as its
train_fine / train_coarse make it), carried to the port with
convert.from_jax_params. Where whole trainings are compared, dropout is 0
and augmentation off, as in tests/test_torch_port_train.py; the JAX path
runs its XLA SA levels, the port its fused training levels (plain versions
with the hand-derived backward) and its "off" inference SA mode, as the
JAX package picks on the CPU. Tolerances: the epoch rows of training
(loss, pose error) within rtol 1e-4, the step test's loss tolerance; the
validation pose error within rtol 1e-2: it runs in eval mode on the BN
running statistics, which the step test holds at rel-L2 2e-2 (the fused
training level and the XLA path take the statistics' sums in other
orders, and Adam turns near-zero gradient components into full steps of
either sign); eval_fine on the same weights within rtol 1e-5; learning
rates, the draws, the batches' indices, checkpoints and prefetched runs
bit for bit.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_pointnet_convert import make_pointnet_state_dict
from text2loc_tpu.config import small_test_config as jax_small_config
from text2loc_tpu.data.arrays import MultiSceneArrays as JaxMultiScene
from text2loc_tpu.data.synthetic import make_scene as jax_make_scene
from text2loc_tpu.evaluation.retrieval import eval_retrieval as jax_eval_retrieval
from text2loc_tpu.models import torch_convert as jtc
from text2loc_tpu.models.cell_retrieval import CellRetrievalNetwork as JaxCoarse
from text2loc_tpu.models.cross_matcher import CrossMatch as JaxFine
from text2loc_tpu.models.text_embedding import HintTextEmbedder as JaxEmbedder
from text2loc_tpu.training import fine as jfine
from text2loc_tpu.training import steps as jsteps
from text2loc_tpu_torch.config import small_test_config
from text2loc_tpu_torch.convert import (_convert_leaf, build_model, convert_tree,
                                        from_jax_params, init_weights)
from text2loc_tpu_torch.data.arrays import MultiSceneArrays
from text2loc_tpu_torch.data.synthetic import make_scene
from text2loc_tpu_torch.evaluation import cli as eval_cli
from text2loc_tpu_torch.evaluation.retrieval import object_set
from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
from text2loc_tpu_torch.torch_checkpoint import load_pretrained_pointnet
from text2loc_tpu_torch.training import coarse, fine, steps
from text2loc_tpu_torch.utils.checkpoint import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS_RTOL = 1e-4
VAL_RTOL = 1e-2


def _cfg(small, plain=True, **train):
    cfg = small()
    model = cfg.model
    tr = dataclasses.replace(cfg.train, **{"batch_size": 8, "epochs": 2, **train})
    if plain:
        model = dataclasses.replace(model, dropout_rate=0.0)
        tr = dataclasses.replace(tr, flip_poses=False, shuffle_hints=False,
                                 pc_augment=False, fine_flip_poses=False)
    return cfg.replace(model=model, train=tr)


def _scene(make, i, pmc=False, num_poses=12, pose_seed=None):
    m = small_test_config().model
    scene = make(f"000{i}", num_cells=6, num_poses=num_poses, object_slots=m.object_size,
                 num_points=m.pointnet.num_points, num_mentioned=m.num_mentioned, seed=i,
                 pose_seed=pose_seed)
    if not pmc:
        return scene
    rng = np.random.default_rng(30 + i)
    c, n, s = scene.num_cells, scene.num_poses, m.num_mentioned
    valid = rng.random((n, 8)) < 0.5
    return dataclasses.replace(
        scene, cell_neighbors=np.where(rng.random((c, 8)) < 0.7, rng.integers(0, c, (c, 8)),
                                       -1).astype(np.int32),
        pmc_valid=valid,
        pmc_weight=np.where(valid, rng.uniform(0.5, 4, (n, 8)), 0).astype(np.float32),
        pmc_match=rng.integers(-1, m.object_size, (n, 8, s)).astype(np.int32))


def _splits(pmc=False):
    """(port train, port val, JAX train, JAX val): two scenes to train on,
    their cells with other poses to validate on."""
    def train(make, cls):
        return cls([_scene(make, i, pmc) for i in range(2)])

    def val(make, cls):
        return cls([_scene(make, i, num_poses=12, pose_seed=50 + i) for i in range(2)])

    return (train(make_scene, MultiSceneArrays), val(make_scene, MultiSceneArrays),
            train(jax_make_scene, JaxMultiScene), val(jax_make_scene, JaxMultiScene))


def _embedders(cfg):
    m = cfg.model
    return (HintTextEmbedder.compositional(m.text_embed_dim, m.max_hint_tokens),
            JaxEmbedder.compositional(m.text_embed_dim, m.max_hint_tokens))


def _jax_init(jcfg, jdata, jemb, kind):
    """The JAX trainer's initial (model, state), made as its train_fine /
    train_coarse make them."""
    t = jcfg.train
    cfg = jcfg.replace(model=dataclasses.replace(jcfg.model, dtype=jcfg.model.train_dtype))
    n = jdata.num_poses
    spe = max(n // t.batch_size, 1)
    rng = jax.random.PRNGKey(t.seed)
    rng, init_rng = jax.random.split(rng)
    idx = np.arange(t.batch_size) % n
    if kind == "fine":
        model, opt = JaxFine(cfg.model), jfine.make_fine_optimizer(cfg, spe)
        fb = jsteps.prepare_fine_batch(jdata.gather_fine(idx, cfg.model.pad_size), jemb, cfg,
                                       init_rng, train=False)
        inputs = (fb.objects, fb.text)
    else:
        model, opt = JaxCoarse(cfg.model), jsteps.make_optimizer(cfg, spe)
        inputs = jsteps.prepare_coarse_batch(jdata.gather_coarse(idx, cfg.model.object_size),
                                             jemb, cfg, init_rng, train=False)
    return model, jsteps.init_train_state(model, opt, init_rng, *inputs)


def _port_model(pcfg, state, kind):
    cfg = pcfg.replace(model=dataclasses.replace(pcfg.model, dtype=pcfg.model.train_dtype))
    model = build_model(cfg, kind, sa_mode="off")
    model.load_state_dict(from_jax_params(jax.device_get(state.params),
                                          jax.device_get(state.batch_stats), cfg, kind))
    return model


def _to_jax(tree, state: dict, path=()):
    """A JAX tree of the layout of `tree` holding the port state dict's
    values: convert.convert_tree's layout rules run backwards (each leaf's
    index permutation through _convert_leaf)."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _to_jax(v, state, path + (k,))
            continue
        shape = np.shape(v)
        key, perm = _convert_leaf(path + (k,),
                                  np.arange(int(np.prod(shape)), dtype=np.float64).reshape(shape))
        flat = np.empty(int(np.prod(shape)), np.float32)
        flat[perm.astype(np.int64).ravel()] = state[key].numpy().ravel()
        out[k] = flat.reshape(shape)
    return out


def _equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.cpu(), b.cpu())
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


# ---------------------------------------------------------------- optimizer


def _schedule_cfg(small, sched, warmup):
    cfg = small()
    return cfg.replace(train=dataclasses.replace(
        cfg.train, lr_gamma=0.5, lr_scheduler=sched, lr_step=2, warmup_epochs=warmup,
        warmup_lr=3e-5, learning_rate=2e-3))


@pytest.mark.parametrize("sched,warmup", [("exponential", 2), ("step", 1),
                                          ("exponential", 0)])
def test_fine_learning_rate_equals_optax(sched, warmup):
    """The rate of every update through the warm-up and two epochs after it:
    the port's schedule value equal, as f32, to the optax schedule the JAX
    make_fine_optimizer joins; and the update of a constant gradient equal
    to the JAX optimizer's within rtol 2e-5 (optax takes Adam's bias
    corrections in f32, where 1 - 0.999 rounds by 1.3e-5 relative; torch
    in float64)."""
    spe = 3
    jcfg, pcfg = _schedule_cfg(jax_small_config, sched, warmup), _schedule_cfg(
        small_test_config, sched, warmup)
    main = jsteps.make_lr_schedule(jcfg, spe)
    want_sched = (optax.join_schedules([optax.constant_schedule(3e-5), main], [warmup * spe])
                  if warmup else main)
    jopt = jfine.make_fine_optimizer(jcfg, spe)
    jparam = jnp.zeros(4)
    jstate = jopt.init(jparam)
    p = torch.zeros(4, requires_grad=True)
    opt = steps.make_fine_optimizer([p], pcfg, spe)
    n = (warmup + 2) * spe
    rates = []
    for i in range(n):
        lr = opt.adam.param_groups[0]["lr"]
        rates.append(lr)
        assert np.float32(lr) == np.float32(want_sched(i)), (i, lr, want_sched(i))
        jup, jstate = jopt.update(jnp.ones(4), jstate, jparam)
        before = p.detach().clone()
        p.grad = torch.ones(4)
        opt.step()
        np.testing.assert_allclose((p.detach() - before).numpy(), np.asarray(jup), rtol=2e-5)
    assert len(set(rates)) == (3 if warmup and sched == "exponential" else 2)


# ---------------------------------------------------------------- fine


def test_eval_fine_equals_the_jax_package():
    jcfg, pcfg = _cfg(jax_small_config), _cfg(small_test_config)
    pdata, pval, jdata, jval = _splits()
    pemb, jemb = _embedders(pcfg)
    jmodel, state = _jax_init(jcfg, jdata, jemb, "fine")
    model = _port_model(pcfg, state, "fine")
    jc = jcfg.replace(model=dataclasses.replace(jcfg.model, dtype=jcfg.model.train_dtype))
    pc = pcfg.replace(model=dataclasses.replace(pcfg.model, dtype=pcfg.model.train_dtype))
    for bs in (64, 10):      # one padded batch; a last batch of 4 of 10
        got = fine.eval_fine(pval, model, pemb, pc, batch_size=bs)
        want = jfine.eval_fine(jval, state, jmodel, jemb, jc, batch_size=bs)
        np.testing.assert_allclose(got, want, rtol=1e-5)


def _record(monkeypatch, module, log):
    orig = module.sample_pmc

    def spy(data, idx, rng, prob):
        out = orig(data, idx, rng, prob)
        log.append((np.array(idx), *(np.array(x) for x in out)))
        return out

    monkeypatch.setattr(module, "sample_pmc", spy)


def test_train_fine_matches_the_jax_trainer(monkeypatch):
    """Two epochs (3 steps each, the first at the warm-up rate) with
    pmc_prob 0.5: the same pose / cell / hint-object indices in every
    batch, the epoch rows within ROWS_RTOL (validation VAL_RTOL), the same
    best epoch."""
    jcfg = _cfg(jax_small_config, pmc_prob=0.5, warmup_epochs=1)
    pcfg = _cfg(small_test_config, pmc_prob=0.5, warmup_epochs=1)
    pdata, pval, jdata, jval = _splits(pmc=True)
    pemb, jemb = _embedders(pcfg)
    _, state = _jax_init(jcfg, jdata, jemb, "fine")
    model = _port_model(pcfg, state, "fine")
    jlog_batches, plog_batches = [], []
    _record(monkeypatch, jfine, jlog_batches)
    _record(monkeypatch, fine, plog_batches)
    _, _, jlog = jfine.train_fine(jcfg, jdata, jval, jemb)
    best, model, plog = fine.train_fine(pcfg, pdata, pval, pemb, device="cpu", model=model)

    assert len(plog_batches) == len(jlog_batches) == 6
    n_clones = 0
    for got, want in zip(plog_batches, jlog_batches):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        n_clones += int((got[1] != pdata.pose_cell_idx[got[0]]).sum())
    assert n_clones > 0
    for name, rtol in (("loss", ROWS_RTOL), ("pose_error", ROWS_RTOL),
                       ("val_pose_error", VAL_RTOL)):
        np.testing.assert_allclose(plog.history[name], jlog.history[name], rtol=rtol,
                                   err_msg=name)
    assert (int(np.argmin(plog.history["val_pose_error"]))
            == int(np.argmin(jlog.history["val_pose_error"])))
    assert _equal(best, model.state_dict())
    assert [r["step"] for r in plog.steps] == list(range(6))


def test_train_fine_resumes_gated_by_the_restored_best(tmp_path):
    cfg = _cfg(small_test_config, pmc_prob=0.5, epochs=1)
    pdata, pval, _, _ = _splits(pmc=True)
    emb, _ = _embedders(cfg)
    fine.train_fine(cfg, pdata, pval, emb, workdir=str(tmp_path), device="cpu")
    mgr = CheckpointManager(str(tmp_path / "fine_ckpt"), mode="min")
    best_before, saved = mgr.best_metric, mgr.restore()
    cfg3 = cfg.replace(train=dataclasses.replace(cfg.train, epochs=3))
    restored = []
    orig = CheckpointManager.restore

    def spy(self, state_like=None, step=None):
        out = orig(self, state_like, step)
        restored.append(_equal(state_like.state_dict(), saved))
        return out

    try:
        CheckpointManager.restore = spy
        best, _, log = fine.train_fine(cfg3, pdata, pval, emb, workdir=str(tmp_path),
                                       resume=True, device="cpu")
    finally:
        CheckpointManager.restore = orig
    assert restored == [True]
    assert log.epochs["loss"] == [1, 2]
    best, last = best_before, 0
    for epoch, val in zip((1, 2), log.history["val_pose_error"]):
        if val < best:
            best, last = val, epoch
    after = CheckpointManager(str(tmp_path / "fine_ckpt"), mode="min")
    assert after.best_metric == best and after.latest_step() == last
    assert os.path.exists(tmp_path / "fine_metrics.jsonl")


# ---------------------------------------------------------------- coarse


def test_train_coarse_eval_rows_equal_jax_eval_retrieval(tmp_path):
    """After one epoch, the logged validation (and training) recall equals
    the JAX eval_retrieval on the trained weights."""
    cfg = _cfg(small_test_config, plain=False, epochs=1)
    jcfg = _cfg(jax_small_config, plain=False, epochs=1)
    pdata, pval, jdata, jval = _splits()
    pemb, jemb = _embedders(cfg)
    jmodel, state = _jax_init(jcfg, jdata, jemb, "coarse")
    model = _port_model(cfg, state, "coarse")
    best, model, log = coarse.train_coarse(cfg, pdata, pval, pemb, device="cpu",
                                           model=model, eval_train=True,
                                           workdir=str(tmp_path))
    trained = state._replace(params=_to_jax(state.params, best),
                             batch_stats=_to_jax(state.batch_stats, best))
    jc = jcfg.replace(model=dataclasses.replace(jcfg.model, dtype=jcfg.model.train_dtype))
    for split, data in (("val", jval), ("train", jdata)):
        acc, _, _ = jax_eval_retrieval(data, trained, jmodel, jemb, jc)
        got = {int(k.split("@")[1]): v[0] for k, v in log.history.items()
               if k.startswith(f"{split}_recall@")}
        assert got == acc, split
    assert log.history["val_acc"] == [float(np.mean(list(
        jax_eval_retrieval(jval, trained, jmodel, jemb, jc)[0].values())))]
    assert os.path.exists(tmp_path / "coarse_ckpt" / "metrics.json")


def test_train_coarse_resumes(tmp_path):
    cfg = _cfg(small_test_config, plain=False, epochs=1)
    pdata, pval, _, _ = _splits()
    emb, _ = _embedders(cfg)
    coarse.train_coarse(cfg, pdata, pval, emb, workdir=str(tmp_path), device="cpu")
    cfg2 = cfg.replace(train=dataclasses.replace(cfg.train, epochs=2))
    _, _, log = coarse.train_coarse(cfg2, pdata, pval, emb, workdir=str(tmp_path),
                                    resume=True, device="cpu")
    assert log.epochs["loss"] == [1] and "val_acc" in log.history


@pytest.mark.parametrize("trainer", ["coarse", "fine"])
def test_trainers_bitwise_equal_with_and_without_prefetch(trainer):
    cfg = _cfg(small_test_config, plain=False, sample_close_cell=True, pmc_prob=0.5)
    pdata, pval, _, _ = _splits(pmc=True)
    emb, _ = _embedders(cfg)
    train = coarse.train_coarse if trainer == "coarse" else fine.train_fine
    runs = [train(cfg, pdata, pval, emb, device="cpu", prefetch=p) for p in (True, False)]
    (s1, _, l1), (s0, _, l0) = runs
    assert dict(l1.history) == dict(l0.history)
    assert [r["loss"] for r in l1.steps] == [r["loss"] for r in l0.steps]
    assert _equal(s1, s0)


def test_trainers_refuse_a_mesh_and_default_to_the_card():
    import inspect

    for fn in (coarse.train_coarse, fine.train_fine):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
        with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
            fn(small_test_config(), None, None, None, mesh=object())
    assert coarse.build_argparser().parse_args([]).device == "cuda"


# ---------------------------------------------------------------- checkpoints


def _trained_state(seed=0, steps_taken=2):
    cfg = small_test_config()
    model = init_weights(build_model(cfg, "fine"), torch.Generator().manual_seed(seed))
    opt = steps.make_fine_optimizer(model.parameters(), cfg, steps_per_epoch=2)
    torch.manual_seed(seed)
    for _ in range(steps_taken):
        opt.zero_grad()
        sum((p ** 2).sum() for p in model.parameters()).backward()
        opt.step()
    return steps.TrainState(model, opt)


def test_checkpoint_manager_gates_keeps_and_round_trips(tmp_path):
    state = _trained_state()
    mgr = CheckpointManager(str(tmp_path / "ck"), keep_latest=1, mode="max")
    assert mgr.save(0, state, 0.5)
    assert not mgr.save(1, state, 0.4)
    assert mgr.save(2, state, 0.6)
    state.optimizer.zero_grad()
    sum((p ** 3).sum() for p in state.model.parameters()).backward()
    state.optimizer.step()
    assert mgr.save(3, state, 0.7)
    assert sorted(os.listdir(tmp_path / "ck")) == ["metrics.json", "step_2.pt", "step_3.pt"]
    assert mgr.latest_step() == 3 and mgr.best_metric == 0.7
    mgr.close()

    fresh = _trained_state(seed=1, steps_taken=0)
    assert not _equal(fresh.state_dict(), state.state_dict())
    CheckpointManager(str(tmp_path / "ck")).restore(fresh)
    assert _equal(fresh.state_dict(), state.state_dict())
    adam = fresh.optimizer.adam.state_dict()["state"]
    assert all(float(s["step"]) == 3 and s["exp_avg"].abs().sum() > 0 for s in adam.values())
    assert fresh.optimizer.schedule.last_epoch == 3
    assert fresh.optimizer.adam.param_groups[0]["lr"] == state.optimizer.adam.param_groups[0]["lr"]
    older = CheckpointManager(str(tmp_path / "ck")).restore(step=2)
    assert not _equal(older["model"], state.state_dict()["model"])

    # A new manager over the directory (the resume path) keeps the gate.
    mgr2 = CheckpointManager(str(tmp_path / "ck"), mode="max")
    assert mgr2.best_metric == 0.7
    assert not mgr2.save(4, state, 0.65)
    assert mgr2.save(5, state, 0.8)

    low = CheckpointManager(str(tmp_path / "low"), keep_latest=0, mode="min")
    assert low.save(0, state, 1.0) and not low.save(1, state, 1.2) and low.save(2, state, 0.9)
    assert low.latest_step() == 2 and sorted(os.listdir(tmp_path / "low")) == [
        "metrics.json", "step_2.pt"]
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()
    with pytest.raises(ValueError):
        CheckpointManager(str(tmp_path / "x"), mode="best")


def test_fine_ckpt_loads_the_best_of_a_min_mode_directory(tmp_path):
    """A fine directory (mode "min") that kept two improving saves: the
    evaluation CLI's --fine_ckpt loads the newer, lower-error one."""
    older, newer = _trained_state(seed=2), _trained_state(seed=3)
    mgr = CheckpointManager(str(tmp_path / "fine_ckpt"), mode="min")
    assert mgr.save(0, older, 0.3) and mgr.save(1, newer, 0.2)
    assert sorted(os.listdir(tmp_path / "fine_ckpt")) == [
        "metrics.json", "step_0.pt", "step_1.pt"]
    args = eval_cli._parse(["--synthetic", "--device", "cpu",
                            "--fine_ckpt", str(tmp_path / "fine_ckpt")])
    cfg, _ = eval_cli._load(args)
    tower = eval_cli._model(cfg, "fine", args, None, torch.Generator().manual_seed(0))
    assert _equal(tower.state_dict(), newer.model.state_dict())
    assert not _equal(tower.state_dict(), older.model.state_dict())


# ---------------------------------------------------------------- PointNet graft


def test_load_pretrained_pointnet_matches_the_jax_graft(tmp_path):
    """The same reference-layout .pth (random weights) grafted by both
    packages: bit-equal state, and the same object-encoder output
    (atol 1e-5, f32 sums in another order)."""
    jcfg, pcfg = jax_small_config(), small_test_config()
    sd = make_pointnet_state_dict(jcfg.model.pointnet, nested=True, seed=4)
    path = str(tmp_path / "pointnet.pth")
    torch.save(sd, path)
    pdata, _, jdata, _ = _splits()
    pemb, jemb = _embedders(pcfg)
    jmodel, state = _jax_init(jcfg, jdata, jemb, "coarse")
    params, stats = jtc.load_pretrained_pointnet(jax.device_get(state.params),
                                                 jax.device_get(state.batch_stats), path)
    model = _port_model(pcfg, state, "coarse")
    load_pretrained_pointnet(model, path)
    want = convert_tree(params, stats)
    got = model.state_dict()
    assert set(want) == set(got)
    for k in want:
        assert torch.equal(got[k], want[k]), k

    cells = np.arange(4)
    batch = pdata.gather_cell_objects(cells, pcfg.model.object_size)
    objects = object_set(batch, pcfg.model.pointnet.num_points, "cpu")
    with torch.no_grad():
        out = model.eval().encode_objects(objects)
    jc = jcfg.replace(model=dataclasses.replace(jcfg.model, dtype=jcfg.model.train_dtype))
    jb = jdata.gather_coarse(np.arange(4), jcfg.model.object_size)
    jb = {**jb, **jdata.gather_cell_objects(cells, jcfg.model.object_size)}
    jobj, _ = jsteps.prepare_coarse_batch(jb, jemb, jc, jax.random.PRNGKey(0), train=False)
    ref = jmodel.apply({"params": params, "batch_stats": stats}, jobj, train=False,
                       method=jmodel.encode_objects)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


# ---------------------------------------------------------------- CLIs


@pytest.mark.parametrize("trainer", ["coarse", "fine"])
def test_training_cli_runs_without_jax(trainer, tmp_path):
    code = (
        "import sys\n"
        f"from text2loc_tpu_torch.training.{trainer} import main\n"
        f"best, model, log = main(['--synthetic', '--device', 'cpu', '--epochs', '1',"
        f" '--workdir', {str(tmp_path)!r}])\n"
        "bad = [m for m in sys.modules if m in ('jax', 'text2loc_tpu')"
        " or m.startswith(('jax.', 'text2loc_tpu.'))]\n"
        "assert not bad, bad\n"
        "assert len(log.history['loss']) == 1 and len(log.steps) == 8, log.steps\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env, check=True,
                   timeout=600)
    assert os.path.exists(tmp_path / f"{trainer}_ckpt" / "metrics.json")
    assert os.path.exists(tmp_path / f"{trainer}_metrics.jsonl")
    # The evaluation CLI loads the trainer's checkpoint into its tower.
    args = eval_cli._parse(["--synthetic", "--device", "cpu",
                            f"--{trainer}_ckpt", str(tmp_path / f"{trainer}_ckpt")])
    cfg, _ = eval_cli._load(args)
    tower = eval_cli._model(cfg, trainer, args, None, torch.Generator().manual_seed(0))
    saved = CheckpointManager(str(tmp_path / f"{trainer}_ckpt")).restore()["model"]
    assert _equal(tower.state_dict(), saved)


@pytest.mark.parametrize("trainer", ["coarse", "fine"])
@pytest.mark.parametrize("flag,item", [(["--dp", "2"], "item 7"),
                                       (["--debug_nans"], "item 8")])
def test_training_cli_flags_the_port_lacks_raise(trainer, flag, item, monkeypatch):
    """The flags the port once refused (ROADMAP Queue 1 `item`): --dp outside
    torchrun raises and names it; --debug_nans raises on a NaN injected into
    a parameter and names the parameter."""
    main = coarse.main if trainer == "coarse" else fine.main
    argv = ["--synthetic", "--device", "cpu", "--epochs", "1"] + flag
    if flag[0] == "--dp":
        monkeypatch.delenv("WORLD_SIZE", raising=False)
        with pytest.raises(ValueError, match="torchrun"):
            main(argv)
        return
    from text2loc_tpu_torch.training import loop

    poisoned = "object_encoder.pointnet.sa1.dense_0.weight"
    build = loop.train_model

    def with_nan(*args, **kw):
        model = build(*args, **kw)
        with torch.no_grad():
            dict(model.named_parameters())[poisoned][0, 0] = float("nan")
        return model

    monkeypatch.setattr(loop, "train_model", with_nan)
    with pytest.raises(FloatingPointError, match=poisoned):
        main(argv)
    assert not torch.is_anomaly_enabled()


# ---------------------------------------------------------------- logging, timing


def test_metric_logger_and_stage_timer_equal_the_jax_package(tmp_path, monkeypatch, capsys):
    import itertools

    from text2loc_tpu.utils import logging as jlogging
    from text2loc_tpu.utils import profiling as jprofiling
    from text2loc_tpu_torch.utils import logging as plogging
    from text2loc_tpu_torch.utils import profiling as pprofiling

    rows = [(0, dict(loss=1.5, val_acc=0.25)), (1, dict(loss=1.25)),
            (2, dict(loss=1.0, val_acc=0.5))]
    out = {}
    for name, mod in (("port", plogging), ("jax", jlogging)):
        logger = mod.MetricLogger(str(tmp_path / name / "metrics.jsonl"))
        for epoch, row in rows:
            logger.log(epoch, **row)
        plotted = logger.plot(str(tmp_path / name / "metrics.png"))
        out[name] = (dict(logger.history), dict(logger.epochs),
                     (tmp_path / name / "metrics.jsonl").read_text(), capsys.readouterr().out,
                     plotted is None)
    assert out["port"] == out["jax"]

    reports = {}
    for name, mod in (("port", pprofiling), ("jax", jprofiling)):
        clock = itertools.count(0.0, 0.25)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        timer = mod.StageTimer()
        for stage in ("train_epoch", "eval_val", "train_epoch"):
            with timer.stage(stage):
                pass
        reports[name] = (timer.totals, timer.counts, timer.report())
        monkeypatch.undo()
    assert reports["port"] == reports["jax"]


def test_block_on_returns_its_argument_on_the_cpu():
    from text2loc_tpu_torch.utils.profiling import block_on

    tree = {"loss": torch.ones(2), "rows": [torch.zeros(1), (torch.ones(3), None)]}
    assert block_on(tree) is tree and block_on(None) is None
