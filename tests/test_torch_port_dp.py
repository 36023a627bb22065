"""The port's data-parallel paths at 2 ranks (parallel/, the DP steps, the
global BatchNorm and training SA statistics, the sharded retrieval and
serve, the trainers over a mesh), against one rank of the port and the
JAX package's single-chip functions, on the CPU.

The ranks are spawned processes of a gloo group over a FileStore in a
temporary directory (text2loc_tpu_torch.dryrun.run_ranks, one thread
each, every join bounded by RANKS_TIMEOUT; a rank past it is killed and
the test fails). They run tests/torch_dp_ranks.py, which imports no JAX:
no JAX collective runs here. The JAX side is the single-chip step, which
tests/test_parallel.py holds equal to the JAX package's sharded one.

Tolerances: against the port's single-device step (dropout and
augmentation on, the same generator seed), the loss within rel 1e-5 and
the gradient (every leaf, as one vector) within rel-L2 1e-5, or within
F32_GRAD_REL = 5e-5 where the single-device step's own f32 error exceeds
1e-5: the training SA level takes its BatchNorm variance in one pass
(E[x^2] - mean^2, the TPU kernel's formula), which cancels, and with
augmentation on the single-device step's gradient moves by rel-L2 1.9e-5
(pairwise) and 2.9e-5 (contrastive) when the level's sums are taken in
f64 (f32_error below), while the DP step lies 1.1e-5 and 1.6e-5 from it.
Single leaves are not held to 1e-5 either: where a sum cancels (the first
layer of the object count's MLP before its BatchNorm) f32 alone moves a
leaf by up to 3e-3 when the single-device step takes the same batch in
another row order. Each leaf is held by its scale and direction instead:
its norm within LEAF_NORM_REL = 1e-3 of the single-device leaf's and its
cosine above 0.9999 (measured: 4.5e-5 and 1 - 7e-9 at worst), which a
leaf counted twice fails by far. Against the JAX single-chip step,
tests/test_torch_port_train.py's protocol (dropout 0, no augmentation,
the JAX initialization carried over: loss rtol 1e-4, leaves rel-L2 < 5e-3
and cosine > 0.9999, BN running statistics rel-L2 < 2e-2). Rows of one
rank's collectives against one process's arithmetic: rel 1e-5; retrieval
ids and serve top-1 ids equal; positions within 1e-5 m.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_ranks as R
from test_torch_port_train import B as JAX_B
from test_torch_port_train import _batch, _jax_grads, _plain
from text2loc_tpu.config import small_test_config as jax_small_config
from text2loc_tpu.evaluation.retrieval import topk_retrieval as jax_topk
from text2loc_tpu.models.cell_retrieval import CellRetrievalNetwork as JaxCoarse
from text2loc_tpu.models.cross_matcher import CrossMatch as JaxFine
from text2loc_tpu.models.text_embedding import HintTextEmbedder as JaxEmbedder
from text2loc_tpu.training import steps as jsteps
from text2loc_tpu_torch.config import small_test_config
from text2loc_tpu_torch.convert import convert_tree, from_jax_params
from text2loc_tpu_torch.dryrun import dryrun_multichip, run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
RANKS_TIMEOUT = 120
F32_GRAD_REL = 5e-5
LEAF_NORM_REL = 1e-3


def _ranks(fn, *args):
    return run_ranks(fn, WORLD, args=args, timeout=RANKS_TIMEOUT, threads=1)


def _rel(got, want) -> float:
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float((got - want).norm() / (want.norm() + 1e-30))


def _check_grads(got: dict, want: dict, rel_l2, cos=None):
    """Every leaf of `want` within rel_l2 (and above cosine `cos`), leaves
    below the floor of 1e-6 x the global gradient norm below 10 x it."""
    want = {k: w.double() for k, w in want.items()}
    floor = 1e-6 * float(torch.sqrt(sum(w.pow(2).sum() for w in want.values())))
    real = 0
    for k, w in want.items():
        g = got[k].double() if k in got else torch.zeros_like(w)   # no gradient: 0
        if float(w.norm()) < floor:
            assert float(g.norm()) < 10 * floor, k
            continue
        real += 1
        assert _rel(g, w) < rel_l2, (k, _rel(g, w))
        if cos is not None:
            c = float((g * w).sum() / (g.norm() * w.norm()))
            assert c > cos, (k, c)
    assert real > 10
    return real


def _check_leaf_scale(got: dict, want: dict, norm_rel=LEAF_NORM_REL, cos=0.9999):
    """Every leaf of `want` above the floor of 1e-6 x the global gradient
    norm: its norm within norm_rel of want's and its cosine above `cos`."""
    want = {k: w.double() for k, w in want.items()}
    floor = 1e-6 * float(torch.sqrt(sum(w.pow(2).sum() for w in want.values())))
    for k, w in want.items():
        if float(w.norm()) < floor:
            continue
        g = got[k].double()
        assert abs(float(g.norm() / w.norm()) - 1) <= norm_rel, (k, float(g.norm() / w.norm()))
        c = float((g * w).sum() / (g.norm() * w.norm()))
        assert c > cos, (k, c)


def _flat(grads, names):
    return torch.cat([grads[k].reshape(-1) for k in names])


def _f32_error(one, cfg, kind, batch, fused_train, monkeypatch) -> float:
    """rel-L2 between the single-device step's gradient `one` and the same
    step with the training SA level's statistics summed in f64."""
    from text2loc_tpu_torch.ops import sa_train

    def stats64(x, mf, n1, mesh=None):
        dims = tuple(range(x.ndim - 1))
        x, mf, n1 = x.double(), mf.double(), n1.double()
        m = (x * mf).sum(dims) / n1
        return m.float(), torch.clamp((x * x * mf).sum(dims) / n1 - m * m, min=0.0).float()

    with monkeypatch.context() as m:
        m.setattr(sa_train, "_stats", stats64)
        exact = R.train_step(cfg, kind, batch, fused_train)
    names = sorted(one["grads"])
    return _rel(_flat(one["grads"], names), _flat(exact["grads"], names))


def _same_ranks(results):
    """Every rank ends the step with the same loss and gradients."""
    for r in results[1:]:
        for a, b in zip(results[0], r):
            assert a["loss"] == b["loss"]
            assert all(torch.equal(a["grads"][k], b["grads"][k]) for k in a["grads"])


# ------------------------------------------------------------------ steps


def _jax_case(kind, ranking_loss):
    """(port cfg, the JAX protocol's batch, the port state dict of the JAX
    initialization, JAX loss, JAX gradients as port names, JAX BN running
    statistics after the step) of tests/test_torch_port_train.py's step 0."""
    jcfg = _plain(jax_small_config(), ranking_loss)
    pcfg = _plain(small_test_config(), ranking_loss)
    fine = kind == "fine"
    jmodel = (JaxFine if fine else JaxCoarse)(jcfg.model)
    jemb = JaxEmbedder.compositional(jcfg.model.text_embed_dim, jcfg.model.max_hint_tokens)
    jopt = jsteps.make_optimizer(jcfg, steps_per_epoch=1, lr=R.LR)
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
    new, metrics = jax.jit(make(jmodel, jemb, jcfg, jopt))(state, b0, jax.random.PRNGKey(1))
    jstats = {k: v for k, v in convert_tree({}, jax.device_get(new.batch_stats)).items()}
    return (pcfg, b0, from_jax_params(params0, stats0, pcfg, kind), float(metrics["loss"]),
            jgrads, jstats)


@pytest.mark.parametrize("kind,ranking_loss,fused_train", [
    ("coarse", "pairwise", "0"), ("coarse", "pairwise", "1"),
    ("coarse", "contrastive", "0"), ("coarse", "contrastive", "1"),
    ("fine", "contrastive", None)])
def test_dp_step_equals_one_device_and_the_jax_step(kind, ranking_loss, fused_train,
                                                   monkeypatch):
    cfg = R.cfg_of(ranking_loss, batch=8)
    data = R.scene(cfg)
    batch = (data.gather_coarse(np.arange(8), cfg.model.object_size) if kind == "coarse"
             else data.gather_fine(np.arange(8), cfg.model.pad_size))
    pcfg, b0, state, jloss, jgrads, jstats = _jax_case(kind, ranking_loss)
    assert JAX_B % WORLD == 0
    cases = [(cfg, kind, batch, fused_train, None), (pcfg, kind, b0, fused_train, state)]
    results = _ranks(R.step_rank, cases)
    _same_ranks(results)
    dp, dp_jax = results[0]

    one = R.train_step(cfg, kind, batch, fused_train)
    assert abs(dp["loss"] - one["loss"]) <= 1e-5 * abs(one["loss"]), (dp["loss"], one["loss"])
    assert dp["grads"].keys() == one["grads"].keys()
    names = sorted(one["grads"])
    err = _rel(_flat(dp["grads"], names), _flat(one["grads"], names))
    assert err <= 1e-5 or (
        err <= F32_GRAD_REL
        and _f32_error(one, cfg, kind, batch, fused_train, monkeypatch) > 1e-5), err
    _check_leaf_scale(dp["grads"], one["grads"])
    for k, v in one["stats"].items():
        assert _rel(dp["stats"][k], v) < 1e-5, k

    np.testing.assert_allclose(dp_jax["loss"], jloss, rtol=1e-4, atol=1e-6)
    _check_grads(dp_jax["grads"], jgrads, 5e-3, cos=0.9999)
    assert jstats
    for k, v in jstats.items():
        assert _rel(dp_jax["stats"][k], v) < 2e-2, k


# ------------------------------------------------------- BN and sa_train


def test_masked_batchnorm_two_ranks_equal_one():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(1.0, 2.0, (12, 5)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(12, 5)).astype(np.float32))
    mask = torch.from_numpy(rng.random(12) < 0.6)
    for m in (mask, None):
        got = _ranks(R.bn_rank, x, m, w)
        want = R.bn_rank(None, x, m, w)
        for key in ("out", "dx"):
            np.testing.assert_allclose(torch.cat([g[key] for g in got]).numpy(),
                                       want[key].numpy(), rtol=1e-5, atol=1e-6)
        for key in ("dweight", "dbias", "running_mean", "running_var"):
            for g in got:
                np.testing.assert_allclose(g[key].numpy(), want[key].numpy(), rtol=1e-5,
                                           atol=1e-6)


def _sa_inputs(seed=5, n=6, p=16, s=4, k=4, h1=8, h2=8):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    maskm = rng.random((n, s, k)) < 0.8
    maskf = maskm & (rng.random((n, 1, 1)) < 0.7)
    return dict(u=t(n, p, h1), sv=t(n, s, h1), w2=t(h1, h2) * 0.5, b2=t(h2) * 0.1,
                g1=1 + 0.1 * t(h1), be1=0.1 * t(h1), g2=1 + 0.1 * t(h2), be2=0.1 * t(h2),
                idx=torch.from_numpy(rng.integers(0, p, (n, s, k))),
                maskm=torch.from_numpy(maskm), maskf=torch.from_numpy(maskf), dout=t(n, s, h2))


def _same_dparams(got: list, want: list):
    """dW2, db2, dgamma1, dbeta1, dgamma2, dbeta2 summed over the ranks
    equal one rank's: the local dgamma / dbeta are counted once."""
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cache_dtype", [None, torch.bfloat16])
def test_sa_train_two_ranks_equal_one(cache_dtype):
    inputs = _sa_inputs()
    got = _ranks(R.sa_train_rank, inputs, cache_dtype)
    want = R.sa_train_rank(None, inputs, cache_dtype)
    for path in ("fused", "plain"):
        w = want[path]
        for key in ("out", "du", "dsv"):
            np.testing.assert_allclose(torch.cat([g[path][key] for g in got]).numpy(),
                                       w[key].numpy(), rtol=1e-5, atol=1e-5)
        for g in got:
            for a, b in zip(g[path]["stats"], w["stats"]):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
            _same_dparams(g[path]["dparams"], w["dparams"])


def test_sa_train_reduced_dgamma_fails_the_comparison():
    """The control: a backward that returns dgamma / dbeta reduced over the
    ranks counts them twice after the gradient all-reduce, and
    _same_dparams rejects it; dW2 and db2 stay equal."""
    inputs = _sa_inputs()
    got = _ranks(R.sa_train_rank, inputs, None, True)
    want = R.sa_train_rank(None, inputs, None)["fused"]["dparams"]
    for g in got:
        dparams = g["fused"]["dparams"]
        _same_dparams(dparams[:2], want[:2])
        for a, b in zip(dparams[2:], want[2:]):
            np.testing.assert_allclose(a.numpy(), 2 * b.numpy(), rtol=1e-5, atol=1e-5)
        with pytest.raises(AssertionError):
            _same_dparams(dparams, want)


# -------------------------------------------------------------- retrieval


def test_sharded_retrieval_and_eval_equal_the_dense_path():
    rng = np.random.default_rng(7)
    gallery = rng.normal(size=(11, 8)).astype(np.float32)
    gallery[7], gallery[10] = gallery[2], gallery[5]          # ties across the shards
    texts = rng.normal(size=(9, 8)).astype(np.float32)
    k = 6
    got = _ranks(R.retrieval_rank, gallery, texts, k)
    want_s, want_i = jax_topk(jnp.asarray(gallery), jnp.asarray(texts), k)
    want_eval = R.eval_model()
    for g in got:
        np.testing.assert_array_equal(g["ids"].numpy(), np.asarray(want_i))
        np.testing.assert_allclose(g["scores"].numpy(), np.asarray(want_s), rtol=1e-5,
                                   atol=1e-6)
        acc, close, idx = g["eval"]
        assert acc == want_eval[0] and close == want_eval[1]
        np.testing.assert_array_equal(idx, want_eval[2])


# ------------------------------------------------------------ the serve


def _same_serve(got, want):
    np.testing.assert_array_equal(got.cell_indices, want.cell_indices)
    assert np.abs(got.candidates_w - want.candidates_w).max() <= 1e-5
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-5, atol=1e-6)


def test_sharded_localizer_equals_the_dense_one(tmp_path):
    got = _ranks(R.localizer_rank, str(tmp_path / "sharded.npz"))
    want = R.localizer_rank(None, str(tmp_path / "dense.npz"))
    for g in got:
        for path in ("cached", "embedded", "stepwise", "from_cache"):
            _same_serve(g[path], want[path])
        assert g["rows"] == (4, 4, 4)                          # 7 cells over 2 ranks
    with np.load(tmp_path / "sharded.npz") as a, np.load(tmp_path / "dense.npz") as b:
        assert set(a.files) == set(b.files) and str(a["digest"]) == str(b["digest"])
        for key in ("gallery", "fine_emb1", "fine_mask"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------- trainers


@pytest.mark.parametrize("kind", ["coarse", "fine"])
def test_one_epoch_trainer_over_a_mesh_equals_one_device(kind, tmp_path):
    got = _ranks(R.trainer_rank, kind, str(tmp_path / "dp"))
    want = R.trainer_rank(None, kind, str(tmp_path / "one"))
    for g in got:
        assert set(g["history"]) == set(want["history"])
        for name, rows in want["history"].items():
            np.testing.assert_allclose(g["history"][name], rows, rtol=1e-5)
        np.testing.assert_allclose(g["steps"], want["steps"], rtol=1e-5)
    from text2loc_tpu_torch.utils.checkpoint import CheckpointManager

    name = f"{kind}_ckpt"
    dp, one = (CheckpointManager(str(tmp_path / d / name)) for d in ("dp", "one"))
    assert dp._metrics().keys() == one._metrics().keys()
    a, b = dp.restore(), one.restore()
    assert a["schedule"] == b["schedule"]
    # Adam turns components whose exact gradient is 0 (BN-shift directions)
    # into steps of either sign: each weight within the 4 x steps x lr
    # envelope of tests/test_torch_port_train.py, the best state likewise.
    envelope = 4 * len(want["steps"]) * R.cfg_of().train.learning_rate
    for k, v in b["model"].items():
        assert float((a["model"][k] - v).abs().max()) <= envelope, k
        assert float((got[0]["best"][k] - want["best"][k]).abs().max()) <= envelope, k


@pytest.mark.parametrize("kind", ["coarse", "fine"])
def test_training_cli_dp_runs_under_torchrun(kind, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={WORLD}", "-m", f"text2loc_tpu_torch.training.{kind}",
         "--dp", str(WORLD), "--synthetic", "--device", "cpu", "--epochs", "1",
         "--workdir", str(tmp_path)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=RANKS_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert os.path.exists(tmp_path / f"{kind}_ckpt" / "metrics.json")
    with open(tmp_path / f"{kind}_metrics.jsonl") as f:
        assert len(f.readlines()) == 1                         # rank 0 alone writes
    assert proc.stdout.count("epoch 000") == 1                 # and prints


def test_dryrun_multichip_runs():
    out = dryrun_multichip(WORLD, timeout=RANKS_TIMEOUT)
    assert all(np.isfinite(out[k]) for k in ("coarse", "fine", "coarse_plain"))
    assert len(out["serve_top1"]) == 4
