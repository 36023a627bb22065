"""Styled hints in the port (text2loc_tpu_torch/text_styles.py,
evaluation/styled.py) against the JAX package's.

The banks and the rendering must be equal, string for string, under the
same seeded rng. eval_styled_retrieval and localize_text run the port's
Localizer and the JAX Localizer over the same weights (JAX towers with
randomized BN statistics, carried over with from_jax_params, as in
tests/test_torch_port_serve_paths.py) and the same online encoder: the
compositional stand-in of each package, or a tiny HF T5 converted by each
package with the vendored tokenizer (transformers' for the JAX package, the
port's reader for the port). Tolerances: recall dicts and retrieved cells
equal; positions within 1e-4 m; scores within 1e-5.
"""

import numpy as np
import pytest

from test_torch_port_serve_paths import _jax_states, _port_models
from test_torch_port_t5 import tiny_hf_t5
from text2loc_tpu import text_styles as jstyles
from text2loc_tpu.assets import load_tiny_tokenizer as jax_tiny_tokenizer
from text2loc_tpu.data.synthetic import make_scene as jax_make_scene
from text2loc_tpu.evaluation import styled as jstyled
from text2loc_tpu.models import t5_encoder as J
from text2loc_tpu.serving import Localizer as JaxLocalizer
from text2loc_tpu_torch import text_styles
from text2loc_tpu_torch.assets import load_tiny_tokenizer
from text2loc_tpu_torch.data.synthetic import make_scene
from text2loc_tpu_torch.evaluation import styled
from text2loc_tpu_torch.models import t5_encoder as P
from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
from text2loc_tpu_torch.serving import Localizer
from text2loc_tpu_torch.torch_checkpoint import to_numpy

POS_ATOL = 1e-4
SCORE_ATOL = 1e-5


def test_banks_equal():
    assert text_styles.SENTENCE_STYLES == jstyles.SENTENCE_STYLES
    for direction in ("on-top", "north", "north-east", "west"):
        assert text_styles.num_styles(direction) == jstyles.num_styles(direction)


@pytest.mark.parametrize("seed", [0, 7])
def test_render_styled_description_equal(seed):
    kw = dict(num_cells=6, num_poses=24, num_mentioned=6, seed=seed)
    got, want = make_scene(**kw), jax_make_scene(**kw)
    rng_got, rng_want = np.random.default_rng(seed), np.random.default_rng(seed)
    for p in range(24):
        args = (got.hint_dir[p], got.hint_color[p], got.hint_label[p], got.hint_mask[p])
        jargs = (want.hint_dir[p], want.hint_color[p], want.hint_label[p], want.hint_mask[p])
        assert (text_styles.render_styled_description(*args, rng=rng_got)
                == jstyles.render_styled_description(*jargs, rng=rng_want))
    for d, direction in enumerate(text_styles.C.DIRECTIONS):   # the diagonals: canonical
        for i in range(max(1, text_styles.num_styles(direction))):
            assert (text_styles.render_styled_hint(d, 3, 5, None, style_idx=i)
                    == jstyles.render_styled_hint(d, 3, 5, None, style_idx=i))


def test_rendered_queries_equal(small_data):
    pi = np.array([0, 3, 5, 11, 20])
    assert (styled.render_styled_queries(small_data, np.random.default_rng(4), pi)
            == jstyled.render_styled_queries(small_data, np.random.default_rng(4), pi))
    assert (styled.render_canonical_queries(small_data, pi)
            == jstyled.render_canonical_queries(small_data, pi))


@pytest.fixture(scope="module")
def towers(small_cfg, small_embedder, small_data):
    cs, cm, fs, fm = _jax_states(small_cfg, small_embedder, small_data)
    coarse, fine = _port_models(small_cfg, cs, fs)
    return (cs, cm, fs, fm), (coarse, fine)


def _encoders(kind, cfg):
    m = cfg.model
    if kind == "compositional":
        return (P.CompositionalOnlineEncoder(m.text_embed_dim, m.max_hint_tokens),
                J.CompositionalOnlineEncoder(m.text_embed_dim, m.max_hint_tokens))
    sd = to_numpy(tiny_hf_t5(d_model=m.text_embed_dim).state_dict())
    params, t5cfg = P.convert_t5_encoder(sd)
    jparams, jcfg = J.convert_t5_encoder(sd)
    return (P.T5OnlineEncoder(params, t5cfg, load_tiny_tokenizer(), m.max_hint_tokens,
                              device="cpu"),
            J.T5OnlineEncoder(jparams, jcfg, jax_tiny_tokenizer(), m.max_hint_tokens))


@pytest.fixture(scope="module", params=["compositional", "t5"])
def localizers(request, towers, small_cfg, small_embedder, small_data):
    (cs, cm, fs, fm), (coarse, fine) = towers
    got_enc, want_enc = _encoders(request.param, small_cfg)
    emb = HintTextEmbedder.compositional(small_cfg.model.text_embed_dim,
                                         small_cfg.model.max_hint_tokens)
    got = Localizer(small_data, coarse, fine, emb, small_cfg, top_k=3,
                    online_encoder=got_enc, device="cpu")
    want = JaxLocalizer(small_data, cs, cm, fs, fm, small_embedder, small_cfg, top_k=3,
                        online_encoder=want_enc)
    return got, want


def test_eval_styled_retrieval_equals_jax(localizers, small_data):
    got_loc, want_loc = localizers
    got = styled.eval_styled_retrieval(got_loc, small_data, seed=3)
    want = jstyled.eval_styled_retrieval(want_loc, small_data, seed=3)
    assert set(got) == set(want) == {"styled", "canonical", "recall_gap"}
    assert got["recall_gap"] == want["recall_gap"]
    for name in ("styled", "canonical"):
        assert got[name]["recall"] == want[name]["recall"]
        assert got[name]["recall_close"] == want[name]["recall_close"]
        np.testing.assert_allclose(got[name]["mean_error_m"], want[name]["mean_error_m"],
                                   atol=POS_ATOL, rtol=0)


def test_localize_text_of_styled_queries_equals_jax(localizers, small_data):
    got_loc, want_loc = localizers
    queries = styled.render_styled_queries(small_data, np.random.default_rng(9))
    assert any(q != c for q, c in zip(queries, styled.render_canonical_queries(small_data)))
    got, want = got_loc.localize_text(queries), want_loc.localize_text(queries)
    np.testing.assert_array_equal(got.cell_indices, np.asarray(want.cell_indices))
    np.testing.assert_allclose(got.scores, np.asarray(want.scores), atol=SCORE_ATOL, rtol=0)
    np.testing.assert_allclose(got.candidates_w, np.asarray(want.candidates_w),
                               atol=POS_ATOL, rtol=0)
