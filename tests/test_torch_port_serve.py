"""The port's cached serve against the JAX package's, end to end.

The JAX Localizer runs its CPU path (XLA FPS, nearest-K SA levels, stock
attention); the port's Localizer runs SA mode "off" (the same semantics)
on the same weights carried over with from_jax_params, with BN running
statistics randomized with numpy. Tolerances: cell indices equal, scores at
atol 1e-5, candidate world positions at atol 1e-3 m (f32).
"""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from text2loc_tpu.models.cell_retrieval import CellRetrievalNetwork
from text2loc_tpu.models.cross_matcher import CrossMatch
from text2loc_tpu.models.text_embedding import HintTextEmbedder as JaxEmbedder
from text2loc_tpu.serving import Localizer as JaxLocalizer
from text2loc_tpu.training import steps
from text2loc_tpu_torch.convert import build_model, from_jax_params, init_weights
from text2loc_tpu_torch.evaluation.retrieval import topk_retrieval
from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
from text2loc_tpu_torch.serving import Localizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_stats(stats, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a)
        if str(path[-1].key).endswith("var"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, stats)


@pytest.fixture(scope="module")
def both_localizers(small_cfg, small_embedder, small_data):
    cfg, data, embedder = small_cfg, small_data, small_embedder
    rng = jax.random.PRNGKey(0)
    opt = steps.make_optimizer(cfg, 1)
    cm = CellRetrievalNetwork(cfg.model)
    cobj, ctext = steps.prepare_coarse_batch(
        data.gather_coarse(np.arange(4), cfg.model.object_size), embedder, cfg,
        rng, train=False)
    cs = steps.init_train_state(cm, opt, rng, cobj, ctext)
    cs = cs._replace(batch_stats=_random_stats(cs.batch_stats, 1))
    fm = CrossMatch(cfg.model)
    fb = steps.prepare_fine_batch(data.gather_fine(np.arange(4), cfg.model.pad_size),
                                  embedder, cfg, rng, train=False)
    fs = steps.init_train_state(fm, opt, rng, fb.objects, fb.text)
    fs = fs._replace(batch_stats=_random_stats(fs.batch_stats, 2))
    jax_loc = JaxLocalizer(data, cs, cm, fs, fm, embedder, cfg, top_k=3)

    models = []
    for kind, st in (("coarse", cs), ("fine", fs)):
        model = build_model(cfg, kind, sa_mode="off")
        model.load_state_dict(from_jax_params(jax.device_get(st.params),
                                              jax.device_get(st.batch_stats), cfg,
                                              kind))
        models.append(model)
    port_emb = HintTextEmbedder.compositional(cfg.model.text_embed_dim,
                                              cfg.model.max_hint_tokens)
    port_loc = Localizer(data, models[0], models[1], port_emb, cfg, top_k=3,
                         device="cpu")
    return jax_loc, port_loc


@pytest.mark.parametrize("n", [5, 8])
def test_port_localizer_matches_jax_localizer(both_localizers, small_data, n):
    jax_loc, port_loc = both_localizers
    data = small_data
    q = np.arange(n)
    mask = data.hint_mask[q]
    want = jax_loc.localize(data.hint_dir[q], data.hint_color[q],
                            data.hint_label[q], sentence_mask=mask)
    got = port_loc.localize(data.hint_dir[q], data.hint_color[q],
                            data.hint_label[q], sentence_mask=mask)
    np.testing.assert_array_equal(got.cell_indices, np.asarray(want.cell_indices))
    np.testing.assert_allclose(got.scores, np.asarray(want.scores), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.candidates_w, np.asarray(want.candidates_w),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(got.position_w, np.asarray(want.position_w),
                               atol=1e-3, rtol=0)


def test_port_gallery_and_tables_match_jax(both_localizers):
    jax_loc, port_loc = both_localizers
    np.testing.assert_allclose(port_loc.gallery.numpy(), np.asarray(jax_loc._gallery),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(port_loc.fine_emb.numpy(), np.asarray(jax_loc._fine_emb),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(port_loc.coarse_sent_table.numpy(),
                               np.asarray(jax_loc._coarse_sent_table),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(port_loc.fine_sent_table.numpy(),
                               np.asarray(jax_loc._fine_sent_table),
                               atol=1e-5, rtol=0)


def test_first_mode_localizer_buckets(small_cfg, small_data):
    """The default ("first") serve: results of a padded odd batch equal the
    prefix of the bucket-sized batch; candidates near their cells."""
    cfg, data = small_cfg, small_data
    gen = torch.Generator().manual_seed(0)
    cm = init_weights(build_model(cfg, "coarse"), gen)
    fm = init_weights(build_model(cfg, "fine"), gen)
    emb = HintTextEmbedder.compositional(cfg.model.text_embed_dim,
                                         cfg.model.max_hint_tokens)
    loc = Localizer(data, cm, fm, emb, cfg, top_k=3, device="cpu")
    full = loc.localize(data.hint_dir[:8], data.hint_color[:8], data.hint_label[:8])
    odd = loc.localize(data.hint_dir[:5], data.hint_color[:5], data.hint_label[:5])
    np.testing.assert_array_equal(odd.cell_indices, full.cell_indices[:5])
    np.testing.assert_allclose(odd.candidates_w, full.candidates_w[:5], atol=1e-5)
    bbox = data.cell_bbox[full.cell_indices]
    assert (full.candidates_w[..., 0] >= bbox[..., 0] - 15.0).all()
    assert (full.candidates_w[..., 0] <= bbox[..., 3] + 15.0).all()
    assert (np.diff(full.scores, axis=1) <= 1e-6).all()


def test_topk_ties_keep_lowest_index_first():
    from text2loc_tpu.evaluation.retrieval import topk_retrieval as jax_topk

    rng = np.random.default_rng(0)
    gallery = rng.normal(size=(6, 8)).astype(np.float32)
    gallery[4] = gallery[1]              # two identical cells
    gallery[5] = gallery[1]
    text = np.stack([gallery[1], gallery[1] + 0.01]).astype(np.float32)
    scores, idx = topk_retrieval(torch.from_numpy(gallery), torch.from_numpy(text), 4)
    want_scores, want_idx = jax_topk(gallery, text, 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(idx.numpy()[:, :3], [[1, 4, 5], [1, 4, 5]])
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), atol=1e-5)


@pytest.mark.parametrize("dims", [(64, 8), (32, 16)])
def test_compositional_table_is_byte_equal(dims):
    e, t = dims
    want = JaxEmbedder.compositional(embed_dim=e, max_tokens=t)
    got = HintTextEmbedder.compositional(embed_dim=e, max_tokens=t)
    assert np.asarray(want.table).tobytes() == got.table.numpy().tobytes()
    assert np.asarray(want.token_mask).tobytes() == got.token_mask.numpy().tobytes()


def test_port_imports_and_serves_without_jax():
    """In a fresh interpreter (this one has jax loaded by conftest): the port
    alone builds a map, serves, takes a CPU train step, one with the bf16
    edge cache at every SA level, runs the evaluation CLI with SA modes
    full,full,all and run_pipeline with the opt-in options (the LN gate at
    every width, stock feed-forward blocks, the VMEM gather in mode off),
    and loads no module of the JAX package and no jax."""
    code = textwrap.dedent("""
        import dataclasses, sys
        import numpy as np, torch
        from text2loc_tpu_torch.config import small_test_config
        from text2loc_tpu_torch.convert import build_model, init_weights
        from text2loc_tpu_torch.data.arrays import MultiSceneArrays
        from text2loc_tpu_torch.data.synthetic import make_scene
        from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
        from text2loc_tpu_torch.serving import Localizer
        from text2loc_tpu_torch.training import steps
        cfg = small_test_config()
        data = MultiSceneArrays([make_scene(
            "0000", num_cells=4, num_poses=4, object_slots=cfg.model.object_size,
            num_points=cfg.model.pointnet.num_points,
            num_mentioned=cfg.model.num_mentioned)])
        gen = torch.Generator().manual_seed(0)
        emb = HintTextEmbedder.compositional(cfg.model.text_embed_dim,
                                             cfg.model.max_hint_tokens)
        coarse = init_weights(build_model(cfg, "coarse"), gen)
        loc = Localizer(data, coarse, init_weights(build_model(cfg, "fine"), gen),
                        emb, cfg, top_k=2, device="cpu")
        res = loc.localize(data.hint_dir, data.hint_color, data.hint_label)
        assert np.isfinite(res.candidates_w).all(), res
        opt = steps.make_optimizer(coarse.parameters(), cfg, steps_per_epoch=1)
        step = steps.make_coarse_train_step(coarse, emb, cfg, opt, gen)
        loss = float(step(data.gather_coarse(np.arange(4), cfg.model.object_size))["loss"])
        assert np.isfinite(loss), loss
        from text2loc_tpu_torch.evaluation.cli import main_pipeline
        out = main_pipeline(["--synthetic", "--device", "cpu", "--fused_sa",
                             "full,full,all"])
        assert np.isfinite(out["pos_in_cells"]).all(), out
        ecoarse = init_weights(build_model(cfg, "coarse", fused_train="e"), gen)
        opt = steps.make_optimizer(ecoarse.parameters(), cfg, steps_per_epoch=1)
        step = steps.make_coarse_train_step(ecoarse, emb, cfg, opt, gen)
        loss = float(step(data.gather_coarse(np.arange(4), cfg.model.object_size))["loss"])
        assert np.isfinite(loss), loss
        from text2loc_tpu_torch.evaluation.pipeline import run_pipeline
        opts = dict(sa_mode="off", fused_ln="all", fused_ffn="0", vmem_gather=True)
        models = [init_weights(build_model(cfg, k, **opts), gen) for k in ("coarse", "fine")]
        out = run_pipeline(data, *models, emb, cfg, device="cpu", verbose=False)
        assert np.isfinite(out["pos_in_cells"]).all(), out
        loaded = sorted(m for m in sys.modules
                        if m in ("jax", "text2loc_tpu")
                        or m.startswith(("jax.", "text2loc_tpu.")))
        assert not loaded, loaded
        print("OK")
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]


def test_localizer_defaults_to_the_card():
    """device=None is not a CPU shortcut: the serve's entry point runs on
    the card unless the caller asks for the CPU."""
    import inspect

    assert inspect.signature(Localizer).parameters["device"].default == "cuda"
