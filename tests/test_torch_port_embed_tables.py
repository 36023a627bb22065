"""The class and colour embedding tables (`class_embed`, `color_embed`) of
the port's ObjectEncoder against the JAX package's, on the CPU.

Weights: the JAX towers' own initialization (their tables' row 0 is not
zero, so the masking by the object mask is exercised), BN running
statistics randomized with numpy, carried to the port by from_jax_params.
The port runs SA mode "off" where a PointNet remains (colour table alone).
Tolerances as in tests/test_torch_port_models.py and
tests/test_torch_port_serve.py / test_torch_port_eval.py: activations at
atol 1e-5 (f32), cell indices and recall tables equal, positions at
atol 1e-3 m. Reference-layout checkpoints (the fixture towers of
tests/test_full_model_convert.py, alphabetical class rows, the
name-keyed colour rows) convert leaf for leaf as the JAX converter does,
and the port's towers give the reference towers' outputs within that
file's atol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_full_model_convert import (DC, DF, RefCellRetrieval, RefCrossMatch, _inputs,
                                     _model_cfg, _randomize_bn)
from text2loc_tpu import constants as JC
from text2loc_tpu.config import small_test_config as jax_small_config
from text2loc_tpu.data.batch import ObjectSet as JaxObjects
from text2loc_tpu.data.batch import TextSet as JaxText
from text2loc_tpu.evaluation import pipeline as jpipeline
from text2loc_tpu.models import torch_convert as jtc
from text2loc_tpu.models.cell_retrieval import CellRetrievalNetwork
from text2loc_tpu.models.cross_matcher import CrossMatch
from text2loc_tpu.models.text_embedding import HintTextEmbedder as JaxEmbedder
from text2loc_tpu.serving import Localizer as JaxLocalizer
from text2loc_tpu.training import steps
from text2loc_tpu_torch import constants as C
from text2loc_tpu_torch.convert import build_model, from_jax_params
from text2loc_tpu_torch.data.batch import ObjectSet, TextSet
from text2loc_tpu_torch.evaluation import pipeline
from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
from text2loc_tpu_torch.serving import Localizer
from text2loc_tpu_torch.torch_checkpoint import load_pretrained_pointnet, reference_state_dict

ATOL = 1e-5
POS_ATOL = 1e-3
TABLES = {"class": ("class",), "color": ("color",), "both": ("class", "color")}


def _random_stats(stats, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a)
        if str(path[-1].key).endswith("var"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, stats)


def _cfg(tables):
    cfg = jax_small_config()
    on = {f"{t}_embed": True for t in TABLES[tables]}
    return cfg.replace(model=dataclasses.replace(cfg.model, **on))


@pytest.fixture(scope="module", params=sorted(TABLES))
def towers(request, small_data, small_embedder):
    """JAX (state, model) per tower and the port's models on the same
    weights, for one choice of tables."""
    cfg, data, embedder = _cfg(request.param), small_data, small_embedder
    rng = jax.random.PRNGKey(0)
    opt = steps.make_optimizer(cfg, 1)
    cm = CellRetrievalNetwork(cfg.model)
    cobj, ctext = steps.prepare_coarse_batch(
        data.gather_coarse(np.arange(4), cfg.model.object_size), embedder, cfg, rng,
        train=False)
    cs = steps.init_train_state(cm, opt, rng, cobj, ctext)
    cs = cs._replace(batch_stats=_random_stats(cs.batch_stats, 5))
    fm = CrossMatch(cfg.model)
    fb = steps.prepare_fine_batch(data.gather_fine(np.arange(4), cfg.model.pad_size),
                                  embedder, cfg, rng, train=False)
    fs = steps.init_train_state(fm, opt, rng, fb.objects, fb.text)
    fs = fs._replace(batch_stats=_random_stats(fs.batch_stats, 6))
    ports = []
    for kind, st in (("coarse", cs), ("fine", fs)):
        model = build_model(cfg, kind, sa_mode="off")
        model.load_state_dict(from_jax_params(jax.device_get(st.params),
                                              jax.device_get(st.batch_stats), cfg, kind))
        ports.append(model.eval())
    emb = HintTextEmbedder.compositional(cfg.model.text_embed_dim,
                                         cfg.model.max_hint_tokens)
    return dict(name=request.param, cfg=cfg, jax=((cs, cm), (fs, fm)),
                port=tuple(ports), emb=emb)


def _batch(cfg, seed, o):
    rng = np.random.default_rng(seed)
    b, p, s = 5, cfg.model.pointnet.num_points, cfg.model.num_mentioned
    mask = rng.random((b, o)) < 0.7
    mask[:, 0] = True
    arrays = dict(
        xyz=rng.random((b, o, p, 3)).astype(np.float32),
        rgb=rng.random((b, o, p, 3)).astype(np.float32),
        center=rng.random((b, o, 3)).astype(np.float32),
        color=rng.random((b, o, 3)).astype(np.float32),
        num_points=rng.integers(10, 5000, (b, o)).astype(np.float32),
        class_idx=rng.integers(0, JC.NUM_CLASSES, (b, o)).astype(np.int32),
        color_idx=rng.integers(0, JC.NUM_COLORS, (b, o)).astype(np.int32),
        mask=mask)
    text = dict(token_embeds=rng.normal(size=(b, s, cfg.model.max_hint_tokens,
                                              cfg.model.text_embed_dim)).astype(np.float32),
                token_mask=np.ones((b, s, cfg.model.max_hint_tokens), bool),
                sentence_mask=np.ones((b, s), bool))
    jobj = JaxObjects(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jtext = JaxText(**{k: jnp.asarray(v) for k, v in text.items()})
    pobj = ObjectSet(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    ptext = TextSet(**{k: torch.from_numpy(v) for k, v in text.items()})
    return jobj, jtext, pobj, ptext


def test_forward_matches_jax(towers):
    (cs, cm), (fs, fm) = towers["jax"]
    coarse, fine = towers["port"]
    cfg = towers["cfg"]
    tables = TABLES[towers["name"]]
    assert hasattr(coarse.object_encoder, "pointnet") == ("class" not in tables)
    for t in tables:
        row0 = getattr(coarse.object_encoder, f"{t}_embedding").weight[0]
        assert row0.abs().max() > 0                     # masked by the mask alone
    jobj, jtext, pobj, ptext = _batch(cfg, 1, cfg.model.object_size)
    want_cell, want_text = cm.apply({"params": cs.params, "batch_stats": cs.batch_stats},
                                    jobj, jtext, train=False)
    with torch.no_grad():
        got_cell, got_text = coarse(pobj, ptext)
    np.testing.assert_allclose(got_cell.numpy(), np.asarray(want_cell), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_text.numpy(), np.asarray(want_text), atol=ATOL, rtol=0)
    jobj, jtext, pobj, ptext = _batch(cfg, 2, cfg.model.pad_size)
    want = fm.apply({"params": fs.params, "batch_stats": fs.batch_stats}, jobj, jtext,
                    train=False)
    with torch.no_grad():
        got = fine(pobj, ptext)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_localizer_matches_jax(towers, small_data):
    (cs, cm), (fs, fm) = towers["jax"]
    cfg, data = towers["cfg"], small_data
    jax_loc = JaxLocalizer(data, cs, cm, fs, fm, JaxEmbedder.compositional(
        cfg.model.text_embed_dim, cfg.model.max_hint_tokens), cfg, top_k=3)
    port_loc = Localizer(data, *towers["port"], towers["emb"], cfg, top_k=3, device="cpu")
    q = np.arange(8)
    want = jax_loc.localize(data.hint_dir[q], data.hint_color[q], data.hint_label[q],
                            sentence_mask=data.hint_mask[q])
    got = port_loc.localize(data.hint_dir[q], data.hint_color[q], data.hint_label[q],
                            sentence_mask=data.hint_mask[q])
    np.testing.assert_array_equal(got.cell_indices, np.asarray(want.cell_indices))
    np.testing.assert_allclose(got.scores, np.asarray(want.scores), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.candidates_w, np.asarray(want.candidates_w),
                               atol=POS_ATOL, rtol=0)
    np.testing.assert_allclose(port_loc.gallery.numpy(), np.asarray(jax_loc._gallery),
                               atol=ATOL, rtol=0)


def test_run_pipeline_matches_jax(towers, small_data, small_embedder):
    (cs, cm), (fs, fm) = towers["jax"]
    cfg = towers["cfg"]
    want = jpipeline.run_pipeline(small_data, cs, cm, fs, fm, small_embedder, cfg,
                                  verbose=False)
    got = pipeline.run_pipeline(small_data, *towers["port"], towers["emb"], cfg,
                                device="cpu", verbose=False)
    for stage in ("coarse", "fine"):
        assert list(got[stage]) == list(want[stage])
        for k in want[stage]:
            assert got[stage][k] == want[stage][k], (stage, k)
    np.testing.assert_array_equal(got["retrievals"], np.asarray(want["retrievals"]))
    np.testing.assert_allclose(got["pos_in_cells"], want["pos_in_cells"], atol=POS_ATOL,
                               rtol=0)


def _reference_sd(kind, seed, color_rows):
    """A reference-shaped tower's state dict (class table in alphabetical
    order), with, where `color_rows`, the name-keyed colour table of 8 rows
    in place of the colour MLP."""
    torch.manual_seed(seed)
    ref = (RefCellRetrieval if kind == "coarse" else RefCrossMatch)().eval()
    _randomize_bn(ref)
    sd = jtc.to_numpy(ref.state_dict())
    if color_rows:
        d = DC if kind == "coarse" else DF
        sd = {k: v for k, v in sd.items() if ".color_encoder." not in k}
        sd["object_encoder.color_embedding.weight"] = np.random.default_rng(seed).normal(
            size=(8, d)).astype(np.float32)
    return ref, sd


@pytest.mark.parametrize("kind,color", [("coarse", False), ("fine", False),
                                        ("coarse", True), ("fine", True)])
def test_reference_checkpoint_equals_the_jax_converter(kind, color):
    """torch_checkpoint on the reference-layout fixture: the port's state
    dict equals the JAX converter's trees through from_jax_params, leaf for
    leaf (the class rows permuted out of alphabetical order, the colour rows
    by name: centroid 1 "gray" takes row 4, "dark-green" row 0); without the
    colour table the port's tower gives the reference tower's outputs."""
    mcfg = dataclasses.replace(_model_cfg(), color_embed=color)
    cfg = jax_small_config().replace(model=mcfg)
    ref, sd = _reference_sd(kind, 3 if kind == "coarse" else 4, color)
    convert = (jtc.convert_cell_retrieval_checkpoint if kind == "coarse"
               else jtc.convert_cross_matcher_checkpoint)
    want = from_jax_params(*convert(sd, mcfg), cfg, kind)
    got = reference_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                               mcfg, kind)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    tbl = got["object_encoder.class_embedding.weight"].numpy()
    w = sd["object_encoder.class_embedding.weight"]
    for name, j in C.CLASS_TO_INDEX.items():
        np.testing.assert_array_equal(tbl[j + 1], w[sorted(C.CLASS_TO_INDEX).index(name) + 1])
    if color:
        ctbl = got["object_encoder.color_embedding.weight"].numpy()
        cw = sd["object_encoder.color_embedding.weight"]
        np.testing.assert_array_equal(ctbl[2], cw[4])
        np.testing.assert_array_equal(ctbl[1], cw[0])
        return
    model = build_model(cfg, kind, sa_mode="off").eval()
    model.load_state_dict(got)
    class_idx, colors, centers, nums, tokens, _, _ = _inputs(seed=0 if kind == "coarse" else 1)
    b, o = class_idx.shape
    objects = ObjectSet(
        xyz=torch.zeros(b, o, 4, 3), rgb=torch.zeros(b, o, 4, 3),
        center=torch.from_numpy(centers), color=torch.from_numpy(colors),
        num_points=torch.from_numpy(nums), class_idx=torch.from_numpy(class_idx).long(),
        color_idx=torch.zeros(b, o, dtype=torch.long), mask=torch.ones(b, o, dtype=torch.bool))
    text = TextSet(token_embeds=torch.from_numpy(tokens),
                   token_mask=torch.ones(tokens.shape[:3], dtype=torch.bool),
                   sentence_mask=torch.ones(tokens.shape[:2], dtype=torch.bool))
    args = (torch.as_tensor(class_idx, dtype=torch.long), torch.as_tensor(colors),
            torch.as_tensor(centers), torch.as_tensor(nums))
    with torch.no_grad():
        if kind == "coarse":
            np.testing.assert_allclose(model.encode_objects(objects).numpy(),
                                       ref.encode_objects(*args).numpy(), atol=1e-4, rtol=1e-3)
            np.testing.assert_allclose(model.encode_text(text).numpy(),
                                       ref.encode_text(torch.as_tensor(tokens)).numpy(),
                                       atol=1e-4, rtol=1e-3)
        else:
            np.testing.assert_allclose(model(objects, text).numpy(),
                                       ref(*args, torch.as_tensor(tokens)).numpy(),
                                       atol=1e-4, rtol=1e-3)


def test_pointnet_graft_refuses_a_tower_without_a_pointnet(tmp_path):
    from test_pointnet_convert import make_pointnet_state_dict

    path = str(tmp_path / "pn.pth")
    torch.save(make_pointnet_state_dict(jax_small_config().model.pointnet), path)
    model = build_model(_cfg("class"), "coarse", sa_mode="off")
    with pytest.raises(ValueError, match="no PointNet"):
        load_pretrained_pointnet(model, path)
    load_pretrained_pointnet(build_model(_cfg("color"), "coarse", sa_mode="off"), path)
