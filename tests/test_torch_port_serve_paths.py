"""The port's serve paths beyond the cached hint-triple serve, against the
JAX package's Localizer on the same weights (carried over with
from_jax_params; BN running statistics randomized with numpy):

* precompute_fine=False (the stepwise path): against the port's cached
  serve, cells equal and positions at atol 1e-4 m (the JAX package's own
  criterion); against the JAX stepwise Localizer, cells equal, scores at
  atol 1e-5, positions at atol 1e-3 m;
* localize_embedded (cached and stepwise) and localize_text (in the
  vocabulary, and out of it through a numpy stub online encoder) against the
  JAX ones: cells equal, scores at atol 1e-5, positions at atol 1e-3 m;
  localize_text in the vocabulary equals the port's localize bit for bit;
* the persisted cache: a second build encodes nothing and serves bit-equal
  results; each outcome of _load_cache; the gallery-only upgrade; the fine
  cache carried through a stepwise re-save; bf16 through the dtype sidecar;
  a cache file written by the JAX package is refused;
* HintTextEmbedder.checksum() equals the JAX embedder's.
"""

import dataclasses
import os
import warnings
import zlib

import jax
import numpy as np
import pytest
import torch

from test_torch_port_serve import _random_stats
from text2loc_tpu.models.cell_retrieval import CellRetrievalNetwork
from text2loc_tpu.models.cross_matcher import CrossMatch
from text2loc_tpu.models.text_embedding import HintTextEmbedder as JaxEmbedder
from text2loc_tpu.serving import Localizer as JaxLocalizer
from text2loc_tpu.text import render_description
from text2loc_tpu.training import steps
from text2loc_tpu_torch import serving
from text2loc_tpu_torch.convert import build_model, from_jax_params
from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
from text2loc_tpu_torch.serving import Localizer
from text2loc_tpu_torch.text import HintParseError

OOV = " Take me to the big glowing obelisk."


class StubEncoder:
    """A deterministic online sentence encoder: each sentence's tokens are
    standard normals seeded by the sentence's CRC32."""

    def __init__(self, embed_dim, max_tokens):
        self.embed_dim, self.max_tokens = embed_dim, max_tokens

    def encode(self, sentences):
        emb = np.zeros((len(sentences), self.max_tokens, self.embed_dim), np.float32)
        mask = np.zeros((len(sentences), self.max_tokens), bool)
        for i, s in enumerate(sentences):
            n = min(len(s.split()), self.max_tokens)
            rng = np.random.default_rng(zlib.crc32(s.encode()))
            emb[i, :n] = rng.standard_normal((n, self.embed_dim))
            mask[i, :n] = True
        return emb, mask


def _jax_states(cfg, embedder, data):
    rng = jax.random.PRNGKey(0)
    opt = steps.make_optimizer(cfg, 1)
    cm = CellRetrievalNetwork(cfg.model)
    cobj, ctext = steps.prepare_coarse_batch(
        data.gather_coarse(np.arange(4), cfg.model.object_size), embedder, cfg, rng,
        train=False)
    cs = steps.init_train_state(cm, opt, rng, cobj, ctext)
    cs = cs._replace(batch_stats=_random_stats(cs.batch_stats, 3))
    fm = CrossMatch(cfg.model)
    fb = steps.prepare_fine_batch(data.gather_fine(np.arange(4), cfg.model.pad_size),
                                  embedder, cfg, rng, train=False)
    fs = steps.init_train_state(fm, opt, rng, fb.objects, fb.text)
    fs = fs._replace(batch_stats=_random_stats(fs.batch_stats, 4))
    return cs, cm, fs, fm


def _port_models(cfg, cs, fs):
    models = []
    for kind, st in (("coarse", cs), ("fine", fs)):
        model = build_model(cfg, kind, sa_mode="off")
        model.load_state_dict(from_jax_params(jax.device_get(st.params),
                                              jax.device_get(st.batch_stats), cfg, kind))
        models.append(model)
    return models


@pytest.fixture(scope="module")
def env(small_cfg, small_embedder, small_data, tmp_path_factory):
    cfg, data = small_cfg, small_data
    tmp = tmp_path_factory.mktemp("serve_paths")
    stub = StubEncoder(cfg.model.text_embed_dim, cfg.model.max_hint_tokens)
    cs, cm, fs, fm = _jax_states(cfg, small_embedder, data)
    jax_cache = str(tmp / "jax_gallery.npz")
    jax_cached = JaxLocalizer(data, cs, cm, fs, fm, small_embedder, cfg, top_k=3,
                              cache_path=jax_cache, online_encoder=stub)
    jax_step = JaxLocalizer(data, cs, cm, fs, fm, small_embedder, cfg, top_k=3,
                            precompute_fine=False)
    coarse, fine = _port_models(cfg, cs, fs)
    emb = HintTextEmbedder.compositional(cfg.model.text_embed_dim,
                                         cfg.model.max_hint_tokens)

    def make(**kw):
        return Localizer(data, coarse, fine, emb, cfg, top_k=3, device="cpu", **kw)

    return dict(cfg=cfg, data=data, stub=stub, jax_cached=jax_cached, jax_step=jax_step,
                jax_cache=jax_cache, make=make, cached=make(online_encoder=stub),
                step=make(precompute_fine=False), emb=emb, tmp=tmp)


def _hints(data, q):
    return data.hint_dir[q], data.hint_color[q], data.hint_label[q], data.hint_mask[q]


def _equal(got, want):
    for name in ("position_w", "candidates_w", "cell_indices", "scores"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)),
                                      err_msg=name)


def _close(got, want, pos_atol=1e-3, score_atol=1e-5):
    np.testing.assert_array_equal(got.cell_indices, np.asarray(want.cell_indices))
    if score_atol is not None:
        np.testing.assert_allclose(got.scores, np.asarray(want.scores), atol=score_atol,
                                   rtol=0)
    np.testing.assert_allclose(got.candidates_w, np.asarray(want.candidates_w),
                               atol=pos_atol, rtol=0)
    np.testing.assert_allclose(got.position_w, np.asarray(want.position_w),
                               atol=pos_atol, rtol=0)


@pytest.mark.parametrize("n", [1, 5, 8])
def test_stepwise_equals_cached_serve_and_jax_stepwise(env, n):
    data, q = env["data"], np.arange(n)
    step = env["step"].localize(*_hints(data, q))
    assert env["step"].fine_emb is None
    _close(step, env["cached"].localize(*_hints(data, q)), pos_atol=1e-4, score_atol=None)
    _close(step, env["jax_step"].localize(*_hints(data, q)))


@pytest.mark.parametrize("path", ["cached", "step"])
def test_localize_embedded_equals_jax(env, path):
    data, q = env["data"], np.arange(6)
    text = env["emb"].embed(*_hints(data, q))
    args = (text.token_embeds.numpy(), text.token_mask.numpy(), text.sentence_mask.numpy())
    got = env[path].localize_embedded(*args)
    _close(got, env["jax_" + path].localize_embedded(*args))
    # The embedder's own embeddings of in-vocabulary hints: the same answer
    # as the sentence-table serve.
    _close(got, env["cached"].localize(*_hints(data, q)), pos_atol=1e-4, score_atol=1e-5)


def _descriptions(data, q, short=()):
    out = []
    for i in q:
        k = 2 if i in short else data.hint_dir.shape[1]
        out.append(render_description(data.hint_dir[i][:k], data.hint_color[i][:k],
                                      data.hint_label[i][:k], data.hint_mask[i][:k]))
    return out


def test_localize_text_in_vocabulary(env):
    data, q = env["data"], np.arange(5)
    descs = _descriptions(data, q, short=(1, 3))
    got = env["cached"].localize_text(descs)
    s = data.hint_dir.shape[1]
    mask = np.asarray(data.hint_mask[q], bool).copy()
    mask[[1, 3], 2:] = False
    zero = np.zeros((len(q), s), np.int64)

    def masked(a):
        return np.where(mask, a[q], zero)

    _equal(got, env["cached"].localize(masked(data.hint_dir), masked(data.hint_color),
                                       masked(data.hint_label), sentence_mask=mask))
    _close(got, env["jax_cached"].localize_text(descs))
    _close(env["step"].localize_text(descs), env["jax_step"].localize_text(descs))


def test_localize_text_oov(env):
    data = env["data"]
    oov = _descriptions(data, [0], short=(0,))[0] + OOV
    full = _descriptions(data, [1])[0]
    with pytest.raises(HintParseError):
        env["step"].localize_text([full, oov])
    with pytest.raises(HintParseError, match="empty description"):
        env["cached"].localize_text([full, " "])
    got = env["cached"].localize_text([oov, full])
    assert np.isfinite(got.candidates_w).all()
    _close(got, env["jax_cached"].localize_text([oov, full]))


def test_online_encoder_dim_and_mesh_raise(env):
    with pytest.raises(ValueError, match="embed_dim"):
        env["make"](online_encoder=StubEncoder(env["cfg"].model.text_embed_dim + 1, 4))
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        env["make"](mesh=object())


@pytest.mark.parametrize("dims", [(64, 8), (32, 16)])
def test_checksum_equals_jax(dims):
    e, t = dims
    assert (HintTextEmbedder.compositional(e, t).checksum()
            == JaxEmbedder.compositional(embed_dim=e, max_tokens=t).checksum())
    rng = np.random.default_rng(e)
    table = rng.standard_normal((JaxEmbedder.compositional(e, t).table.shape)).astype(
        np.float32)
    mask = rng.random(table.shape[:2]) < 0.5
    assert HintTextEmbedder(table, mask).checksum() == JaxEmbedder(table, mask).checksum()


@pytest.fixture
def calls(monkeypatch):
    """Counts the encoder calls of Localizer builds."""
    counts = {}
    for name in ("encode_gallery", "encode_fine_gallery", "build_vocab_sentence_table"):
        real = getattr(serving, name)

        def counted(*a, _real=real, _name=name, **k):
            counts[_name] = counts.get(_name, 0) + 1
            return _real(*a, **k)

        monkeypatch.setattr(serving, name, counted)
    return counts


def test_cache_round_trip_encodes_nothing(env, calls, tmp_path):
    # Not .npz: np.savez on a bare path would append the extension.
    path = str(tmp_path / "gallery.cache")
    first = env["make"](cache_path=path)
    assert calls == {"encode_gallery": 1, "encode_fine_gallery": 1,
                     "build_vocab_sentence_table": 2}
    assert os.path.exists(path) and os.listdir(tmp_path) == ["gallery.cache"]
    calls.clear()
    warm = env["make"](cache_path=path)
    assert calls == {}
    for name in ("gallery", "fine_emb", "fine_mask", "coarse_sent_table",
                 "fine_sent_table"):
        assert torch.equal(getattr(warm, name), getattr(first, name)), name
    q = np.arange(6)
    _equal(warm.localize(*_hints(env["data"], q)), first.localize(*_hints(env["data"], q)))


def _rewrite(path, drop=(), **extra):
    with np.load(path, allow_pickle=False) as f:
        arrays = {k: f[k] for k in f.files if k not in drop}
    arrays.update(extra)
    with open(path, "wb") as fh:
        np.savez(fh, **arrays)


@pytest.mark.parametrize("outcome", ["unreadable", "incomplete", "legacy_fine_emb",
                                     "digest", "num_cells", "pad_size"])
def test_load_cache_outcomes(env, calls, tmp_path, outcome):
    path = str(tmp_path / "gallery.npz")
    env["make"](cache_path=path)
    calls.clear()
    if outcome == "unreadable":
        with open(path, "wb") as fh:
            fh.write(b"not an npz")
    elif outcome == "incomplete":
        _rewrite(path, drop=("digest",))
    elif outcome == "legacy_fine_emb":
        with np.load(path) as f:
            legacy = f["fine_emb1"]
        _rewrite(path, drop=("fine_emb1",), fine_emb=legacy)
    elif outcome == "digest":
        _rewrite(path, digest=np.asarray("0" * 64))
    else:
        with np.load(path) as f:
            _rewrite(path, **{outcome: f[outcome] + 1})
    if outcome in ("digest", "num_cells", "pad_size"):
        with pytest.raises(ValueError, match="does not match"):
            env["make"](cache_path=path)
        return
    with pytest.warns(UserWarning, match="re-encoding|pre-factorization"):
        loc = env["make"](cache_path=path)
    # Legacy: the gallery and tables load, the fine cache is re-encoded.
    want = ({"encode_fine_gallery": 1} if outcome == "legacy_fine_emb" else
            {"encode_gallery": 1, "encode_fine_gallery": 1,
             "build_vocab_sentence_table": 2})
    assert calls == want
    with np.load(path) as f:
        assert "fine_emb1" in f.files and "fine_emb" not in f.files and "digest" in f.files
    calls.clear()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        again = env["make"](cache_path=path)
    assert calls == {}
    q = np.arange(4)
    _equal(again.localize(*_hints(env["data"], q)), loc.localize(*_hints(env["data"], q)))


def test_gallery_only_cache_upgrades_and_stepwise_resave_keeps_fine(env, calls, tmp_path):
    path = str(tmp_path / "gallery.npz")
    env["make"](precompute_fine=False, cache_path=path)
    with np.load(path) as f:
        assert "gallery" in f.files and "fine_emb1" not in f.files
    calls.clear()
    up = env["make"](cache_path=path)
    assert calls == {"encode_fine_gallery": 1}
    with np.load(path) as f:
        assert "fine_emb1" in f.files
    # A stepwise build that re-saves (sentence tables missing) carries the
    # fine encodings through to the new file.
    _rewrite(path, drop=("coarse_sent_table", "fine_sent_table"))
    calls.clear()
    env["make"](precompute_fine=False, cache_path=path)
    assert calls == {"build_vocab_sentence_table": 2}
    calls.clear()
    warm = env["make"](cache_path=path)
    assert calls == {}
    assert torch.equal(warm.fine_emb, up.fine_emb)
    q = np.arange(4)
    _equal(warm.localize(*_hints(env["data"], q)), up.localize(*_hints(env["data"], q)))


def test_bf16_cache_round_trip(env, calls, tmp_path):
    cfg = env["cfg"].replace(model=dataclasses.replace(env["cfg"].model, dtype="bfloat16"))
    coarse, fine = (build_model(cfg, kind, sa_mode="off") for kind in ("coarse", "fine"))
    for model, ref in ((coarse, env["cached"].coarse_model),
                       (fine, env["cached"].fine_model)):
        model.load_state_dict(ref.state_dict())
    path = str(tmp_path / "gallery_bf16.npz")

    def make():
        return Localizer(env["data"], coarse, fine, env["emb"], cfg, top_k=3,
                         device="cpu", cache_path=path)

    first = make()
    assert first.fine_emb.dtype == torch.bfloat16
    with np.load(path, allow_pickle=False) as f:
        assert all(f[k].dtype.kind != "V" for k in f.files)
        assert str(f["fine_emb1__dtype"]) == "bfloat16"
    calls.clear()
    warm = make()
    assert calls == {}
    assert warm.fine_emb.dtype == torch.bfloat16 and torch.equal(warm.fine_emb,
                                                                  first.fine_emb)
    q = np.arange(4)
    _equal(warm.localize(*_hints(env["data"], q)), first.localize(*_hints(env["data"], q)))


def test_a_jax_cache_file_is_refused(env):
    """The same weights, map and embedder: the JAX package's digest hashes
    its own parameter trees, so its file does not pass the port's guard."""
    assert os.path.exists(env["jax_cache"])
    with pytest.raises(ValueError, match="does not match"):
        env["make"](cache_path=env["jax_cache"])
