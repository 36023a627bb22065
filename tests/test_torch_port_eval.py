"""The port's coarse-to-fine evaluation against the JAX package's.

Same data and the same weights in both packages: JAX towers with BN running
statistics randomized with numpy, carried into the port with
from_jax_params, or one reference-layout .pth per tower
(tests/torch_fixtures.py) loaded by each package's own converter. The JAX
package runs its CPU path (nearest-K SA levels), the port SA mode "off".
Tolerances: recall tables and retrievals equal, pos_in_cells within 1e-4
(f32: the two packages sum in other orders), the host-only copies equal.
"""

import dataclasses
import inspect

import jax
import numpy as np
import pytest
import torch

from text2loc_tpu.data.arrays import MultiSceneArrays as JaxMultiScene
from text2loc_tpu.data.synthetic import make_scene as jax_make_scene
from text2loc_tpu.evaluation import metrics as jmetrics
from text2loc_tpu.evaluation import pipeline as jpipeline
from text2loc_tpu.evaluation.retrieval import eval_retrieval as jax_eval_retrieval
from text2loc_tpu.models.cell_retrieval import CellRetrievalNetwork
from text2loc_tpu.models.cross_matcher import CrossMatch
from text2loc_tpu.training import steps
from text2loc_tpu_torch.convert import build_model, from_jax_params
from text2loc_tpu_torch.data.arrays import MultiSceneArrays
from text2loc_tpu_torch.data.synthetic import make_scene
from text2loc_tpu_torch.evaluation import cli, metrics, pipeline
from text2loc_tpu_torch.evaluation.retrieval import eval_retrieval
from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
from text2loc_tpu_torch.torch_checkpoint import reference_state_dict

POS_ATOL = 1e-4


def _random_stats(stats, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a)
        if str(path[-1].key).endswith("var"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, stats)


def _tables_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k] == want[k], (k, got[k], want[k])


def test_metrics_copy_equals_the_jax_package(capsys):
    rng = np.random.default_rng(0)
    q, k, c = 30, 4, 12
    args = dict(pose_w=rng.random((q, 2)) * 60, pose_scene_idx=rng.integers(0, 2, q),
                top_cell_bbox=rng.random((q, k, 6)) * 40,
                top_cell_size=rng.uniform(20, 40, (q, k)),
                top_cell_scene_idx=rng.integers(0, 2, (q, k)),
                pos_in_cells=rng.random((q, k, 2)), top_k=(1, 2, 4),
                threshs=(5.0, 10.0, 15.0))
    want = jmetrics.localization_accuracies(**args)
    _tables_equal(metrics.localization_accuracies(**args), want)
    rargs = dict(retrieved_cell_idx=rng.integers(0, c, (q, k)),
                 target_cell_idx=rng.integers(0, c, q), pose_w=rng.random((q, 2)) * 60,
                 cell_centers=rng.random((c, 2)) * 60, cell_size=30.0, top_k=(1, 2, 4))
    assert metrics.retrieval_accuracies(**rargs) == jmetrics.retrieval_accuracies(**rargs)
    text = metrics.print_accuracies(want, "Fine")
    assert text == jmetrics.print_accuracies(want, "Fine")
    out = capsys.readouterr().out
    assert out == text + "\n" + text + "\n"


@pytest.mark.parametrize("variant", ["match_first", "hint_obj_idx", "storage_order"])
def test_gather_fine_equals_the_jax_package(variant):
    kw = dict(num_cells=5, num_poses=9, object_slots=8, num_points=16, num_mentioned=3)
    got_data = MultiSceneArrays([make_scene(f"00{i}", seed=i, **kw) for i in range(2)])
    want_data = JaxMultiScene([jax_make_scene(f"00{i}", seed=i, **kw) for i in range(2)])
    pi = np.array([3, 0, 17, 5, 9, 9])
    ci = np.array([1, 4, 0, 8, 2, 3])
    extra = {"match_first": dict(cell_indices=ci),
             "hint_obj_idx": dict(cell_indices=ci, hint_obj_idx=np.tile(
                 np.array([[2, 2, -1]]), (len(pi), 1))),
             "storage_order": dict(cell_indices=ci, match_first=False)}[variant]
    got = got_data.gather_fine(pi, 6, **extra)
    want = want_data.gather_fine(pi, 6, **extra)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(
        got_data.fine_object_order(pi, ci, 6),
        want_data.fine_object_order(pi, ci, 6))


@pytest.fixture(scope="module")
def both_towers(small_cfg, small_embedder, small_data):
    """JAX (state, model) per tower and the port's models on the same
    weights, SA mode "off"."""
    cfg, data, embedder = small_cfg, small_data, small_embedder
    rng = jax.random.PRNGKey(0)
    opt = steps.make_optimizer(cfg, 1)
    cm = CellRetrievalNetwork(cfg.model)
    cobj, ctext = steps.prepare_coarse_batch(
        data.gather_coarse(np.arange(4), cfg.model.object_size), embedder, cfg,
        rng, train=False)
    cs = steps.init_train_state(cm, opt, rng, cobj, ctext)
    cs = cs._replace(batch_stats=_random_stats(cs.batch_stats, 3))
    fm = CrossMatch(cfg.model)
    fb = steps.prepare_fine_batch(data.gather_fine(np.arange(4), cfg.model.pad_size),
                                  embedder, cfg, rng, train=False)
    fs = steps.init_train_state(fm, opt, rng, fb.objects, fb.text)
    fs = fs._replace(batch_stats=_random_stats(fs.batch_stats, 4))
    ports = []
    for kind, st in (("coarse", cs), ("fine", fs)):
        model = build_model(cfg, kind, sa_mode="off")
        model.load_state_dict(from_jax_params(jax.device_get(st.params),
                                              jax.device_get(st.batch_stats), cfg, kind))
        ports.append(model.eval())
    emb = HintTextEmbedder.compositional(cfg.model.text_embed_dim,
                                         cfg.model.max_hint_tokens)
    return dict(jax=((cs, cm), (fs, fm)), port=tuple(ports), emb=emb)


def _with_table(cfg, sentence_table):
    return cfg.replace(eval=dataclasses.replace(cfg.eval, sentence_table=sentence_table))


@pytest.mark.parametrize("sentence_table", [False, True])
def test_eval_retrieval_matches_jax(both_towers, small_cfg, small_embedder, small_data,
                                    sentence_table):
    cfg = _with_table(small_cfg, sentence_table)
    (cs, cm), _ = both_towers["jax"]
    want = jax_eval_retrieval(small_data, cs, cm, small_embedder, cfg)
    got = eval_retrieval(small_data, both_towers["port"][0], both_towers["emb"], cfg,
                         device="cpu")
    assert got[0] == want[0] and got[1] == want[1]
    assert got[2].astype(np.int64).tobytes() == np.asarray(want[2]).astype(
        np.int64).tobytes()


@pytest.mark.parametrize("precompute_cells,sentence_table",
                         [(True, False), (False, False), (True, True)])
def test_run_pipeline_matches_jax(both_towers, small_cfg, small_embedder, small_data,
                                  precompute_cells, sentence_table):
    """run_pipeline on both sides; without precompute_cells, run_coarse and
    run_fine's pair-by-pair branch (run_pipeline always precomputes)."""
    cfg = _with_table(small_cfg, sentence_table)
    (cs, cm), (fs, fm) = both_towers["jax"]
    coarse, fine = both_towers["port"]
    emb = both_towers["emb"]
    if precompute_cells:
        want = jpipeline.run_pipeline(small_data, cs, cm, fs, fm, small_embedder, cfg,
                                      verbose=False)
        got = pipeline.run_pipeline(small_data, coarse, fine, emb, cfg, device="cpu",
                                    verbose=False)
    else:
        want, got = {}, {}
        want["coarse"], want["retrievals"] = jpipeline.run_coarse(
            small_data, cs, cm, small_embedder, cfg)
        want["fine"], want["pos_in_cells"], _ = jpipeline.run_fine(
            small_data, want["retrievals"], fs, fm, small_embedder, cfg,
            precompute_cells=False)
        got["coarse"], got["retrievals"] = pipeline.run_coarse(small_data, coarse, emb, cfg,
                                                               device="cpu")
        got["fine"], got["pos_in_cells"], got["fine_qps"] = pipeline.run_fine(
            small_data, got["retrievals"], fine, emb, cfg, precompute_cells=False,
            device="cpu")
    _tables_equal(got["coarse"], want["coarse"])
    np.testing.assert_array_equal(got["retrievals"], np.asarray(want["retrievals"]))
    np.testing.assert_allclose(got["pos_in_cells"], want["pos_in_cells"], atol=POS_ATOL,
                               rtol=0)
    _tables_equal(got["fine"], want["fine"])
    assert got["fine_qps"] > 0


def _write_checkpoints(tmp_path):
    from torch_fixtures import make_coarse_state_dict, make_fine_state_dict

    from text2loc_tpu.config import small_test_config

    cfg = small_test_config().model
    paths = []
    for kind, make in (("coarse", make_coarse_state_dict), ("fine", make_fine_state_dict)):
        path = str(tmp_path / f"{kind}.pth")
        torch.save(make(cfg), path)
        paths.append(path)
    return paths


def test_reference_checkpoint_loader_matches_the_jax_converter(tmp_path):
    """The port's loader gives the state dict that the JAX converter's
    trees give through from_jax_params."""
    from text2loc_tpu.config import small_test_config
    from text2loc_tpu.models.torch_convert import load_torch_tower

    cfg = small_test_config()
    for path, kind in zip(_write_checkpoints(tmp_path), ("coarse", "fine")):
        want = from_jax_params(*load_torch_tower(path, cfg.model, kind), cfg, kind)
        got = reference_state_dict(torch.load(path, weights_only=False), cfg.model, kind)
        assert set(got) == set(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def test_main_pipeline_matches_the_jax_cli(tmp_path):
    from text2loc_tpu.evaluation.cli import main_pipeline as jax_main_pipeline

    a, b = _write_checkpoints(tmp_path)
    argv = ["--synthetic", "--coarse_torch_ckpt", a, "--fine_torch_ckpt", b]
    want = jax_main_pipeline(argv)
    got = cli.main_pipeline(argv + ["--device", "cpu"])
    _tables_equal(got["coarse"], want["coarse"])
    _tables_equal(got["fine"], want["fine"])
    np.testing.assert_array_equal(got["retrievals"], np.asarray(want["retrievals"]))
    np.testing.assert_allclose(got["pos_in_cells"], want["pos_in_cells"], atol=POS_ATOL,
                               rtol=0)


@pytest.mark.parametrize("mode", ["full,full,all", "gather"])
def test_main_pipeline_runs_fused_modes(mode):
    got = cli.main_pipeline(["--synthetic", "--device", "cpu", "--fused_sa", mode,
                             "--top_k", "1", "3"])
    assert list(got["coarse"]) == [1, 3] and list(got["fine"]) == [1, 3]
    assert got["retrievals"].shape == (24, 3)
    assert np.isfinite(got["pos_in_cells"]).all()
    for row in list(got["coarse"].values()) + list(got["fine"].values()):
        assert all(0.0 <= v <= 1.0 for v in row.values())


@pytest.mark.parametrize("flag", [["--plot_retrievals", "x.png"]])
def test_cli_flags_the_port_lacks_raise(flag):
    with pytest.raises(NotImplementedError, match="item 8"):
        cli.main_pipeline(["--synthetic", "--device", "cpu"] + flag)


@pytest.mark.parametrize("encoder", ["compositional", "t5_snapshot"])
def test_main_pipeline_styled_hints_matches_the_jax_cli(encoder, tmp_path):
    """--styled_hints, with the compositional stand-in or the --t5_snapshot
    encoder: the JAX CLI's "styled" dict (recalls equal, mean errors within
    POS_ATOL)."""
    from test_torch_port_t5 import write_t5_snapshot
    from text2loc_tpu.config import small_test_config
    from text2loc_tpu.evaluation.cli import main_pipeline as jax_main_pipeline

    a, b = _write_checkpoints(tmp_path)
    argv = ["--synthetic", "--coarse_torch_ckpt", a, "--fine_torch_ckpt", b,
            "--styled_hints", "--styled_seed", "5"]
    if encoder == "t5_snapshot":
        argv += ["--t5_snapshot", write_t5_snapshot(
            tmp_path / "t5", d_model=small_test_config().model.text_embed_dim)]
    want = jax_main_pipeline(argv)["styled"]
    got = cli.main_pipeline(argv + ["--device", "cpu"])["styled"]
    assert got["recall_gap"] == want["recall_gap"]
    for name in ("styled", "canonical"):
        assert got[name]["recall"] == want[name]["recall"]
        assert got[name]["recall_close"] == want[name]["recall_close"]
        np.testing.assert_allclose(got[name]["mean_error_m"], want[name]["mean_error_m"],
                                   atol=POS_ATOL, rtol=0)


def test_cli_rejects_a_wrong_mode_list():
    with pytest.raises(ValueError, match="expected 3 modes"):
        cli.main_pipeline(["--synthetic", "--device", "cpu", "--fused_sa", "full,all"])


def test_evaluation_entry_points_default_to_the_card():
    assert cli.build_argparser().parse_args([]).device == "cuda"
    for fn in (pipeline.run_pipeline, pipeline.run_coarse, pipeline.run_fine,
               eval_retrieval):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
