"""The port's BatchingFrontend over the port's Localizer: the eight cases of
tests/test_serving_frontend.py (coalescing, batchmate independence,
concurrent threads, text and mixed kinds, ragged hint counts, poisoned-
request isolation, shape validation, close and error paths), and the same
dispatch log and results as the JAX package's frontend over one fake
localizer. Tolerances: a query served in a group against the same query
alone, positions at atol 1e-3 m and scores at atol 1e-4; a backlog against
the direct batched call, bit for bit."""

import threading

import numpy as np
import pytest
import torch

from text2loc_tpu_torch import constants as C
from text2loc_tpu_torch.config import small_test_config
from text2loc_tpu_torch.convert import build_model, init_weights
from text2loc_tpu_torch.data.arrays import MultiSceneArrays
from text2loc_tpu_torch.data.synthetic import make_scene
from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
from text2loc_tpu_torch.serving import LocalizationResult, Localizer
from text2loc_tpu_torch.serving_frontend import BatchingFrontend
from text2loc_tpu_torch.text import HintParseError, parse_descriptions


def port_localizer(num_scenes=2):
    """A port Localizer at the small test config with seeded random weights
    over synthetic scenes, on the CPU."""
    cfg = small_test_config()
    m = cfg.model
    data = MultiSceneArrays([
        make_scene(f"000{i}", num_cells=6, num_poses=12, object_slots=m.object_size,
                   num_points=m.pointnet.num_points, num_mentioned=m.num_mentioned,
                   seed=i)
        for i in range(num_scenes)])
    gen = torch.Generator().manual_seed(0)
    emb = HintTextEmbedder.compositional(m.text_embed_dim, m.max_hint_tokens)
    return Localizer(data, init_weights(build_model(cfg, "coarse"), gen),
                     init_weights(build_model(cfg, "fine"), gen), emb, cfg, top_k=3,
                     device="cpu")


@pytest.fixture(scope="module")
def localizer():
    return port_localizer()


def _query(data, i):
    return data.hint_dir[i], data.hint_color[i], data.hint_label[i]


def _description(data, i):
    return " ".join(C.render_hint(data.hint_dir[i][s], data.hint_color[i][s],
                                  data.hint_label[i][s])
                    for s in range(data.hint_dir.shape[1]))


def test_backlog_coalesces_into_one_dispatch(localizer):
    data = localizer.data
    fe = BatchingFrontend(localizer, max_batch=8, max_wait_s=0.5, start=False)
    q = np.arange(5)
    futures = [fe.submit(*_query(data, i)) for i in q]
    fe.start()
    results = [f.result(timeout=300) for f in futures]
    fe.close()
    assert fe.stats.dispatches == 1 and fe.stats.requests == 5
    assert list(fe.stats.group_sizes) == [5]
    direct = localizer.localize(data.hint_dir[q], data.hint_color[q], data.hint_label[q],
                                sentence_mask=np.ones((5, data.hint_dir.shape[1]), bool))
    for i, r in enumerate(results):
        for name in LocalizationResult._fields:
            np.testing.assert_array_equal(getattr(r, name), getattr(direct, name)[i])


def test_batchmate_independence(localizer):
    data = localizer.data
    fe = BatchingFrontend(localizer, max_batch=8, max_wait_s=0.5, start=False)
    futures = [fe.submit(*_query(data, i)) for i in range(8)]
    fe.start()
    grouped = [f.result(timeout=300) for f in futures]
    fe.close()
    assert list(fe.stats.group_sizes) == [8]
    for i in (0, 3, 7):
        solo = localizer.localize(*(a[i:i + 1] for a in _query(data, slice(None))))
        np.testing.assert_array_equal(grouped[i].cell_indices, solo.cell_indices[0])
        np.testing.assert_allclose(grouped[i].position_w, solo.position_w[0], atol=1e-3)
        np.testing.assert_allclose(grouped[i].scores, solo.scores[0], atol=1e-4)


def test_concurrent_threads_batch_under_load(localizer):
    data = localizer.data
    fe = BatchingFrontend(localizer, max_batch=32, max_wait_s=0.25)
    n = 32
    results, errors = [None] * n, []

    def client(i):
        try:
            results[i] = fe.localize_one(*_query(data, i % 8), timeout=300)
        except Exception as e:  # noqa: BLE001
            errors.append((i, e))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    fe.close()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert fe.stats.requests == n and fe.stats.dispatches < n
    for i in range(n):
        np.testing.assert_array_equal(results[i].cell_indices, results[i % 8].cell_indices)


def test_text_front_door_and_mixed_kinds(localizer):
    data = localizer.data
    d0 = _description(data, 0)
    fe = BatchingFrontend(localizer, max_batch=8, max_wait_s=0.5, start=False)
    f_text = fe.submit_text(d0)
    f_trip = fe.submit(*_query(data, 1))
    fe.start()
    r_text, r_trip = f_text.result(timeout=300), f_trip.result(timeout=300)
    fe.close()
    assert fe.stats.dispatches == 2
    direct = localizer.localize_text([d0])
    np.testing.assert_array_equal(r_text.cell_indices, direct.cell_indices[0])
    np.testing.assert_allclose(r_text.position_w, direct.position_w[0], atol=1e-3)
    assert r_trip.position_w.shape == (2,)


def test_ragged_hint_counts_batch_together(localizer):
    data = localizer.data
    s_full, short = data.hint_dir.shape[1], 2
    fe = BatchingFrontend(localizer, max_batch=8, max_wait_s=0.5, start=False)
    f_long = fe.submit(*_query(data, 0))
    f_short = fe.submit(*(a[:short] for a in _query(data, 1)))
    fe.start()
    r_long, r_short = f_long.result(timeout=300), f_short.result(timeout=300)
    fe.close()
    assert fe.stats.dispatches == 1 and list(fe.stats.group_sizes) == [2]
    mask = np.zeros((1, s_full), bool)
    mask[0, :short] = True
    pad = np.zeros((1, s_full - short), np.int32)
    solo = localizer.localize(
        *(np.concatenate([a[1:2, :short], pad], axis=1)
          for a in (data.hint_dir, data.hint_color, data.hint_label)),
        sentence_mask=mask)
    np.testing.assert_array_equal(r_short.cell_indices, solo.cell_indices[0])
    np.testing.assert_allclose(r_short.position_w, solo.position_w[0], atol=1e-3)
    np.testing.assert_allclose(r_short.scores, solo.scores[0], atol=1e-4)
    solo_long = localizer.localize(*(a[0:1] for a in _query(data, slice(None))))
    np.testing.assert_array_equal(r_long.cell_indices, solo_long.cell_indices[0])
    np.testing.assert_allclose(r_long.position_w, solo_long.position_w[0], atol=1e-3)


def test_bad_request_does_not_poison_batchmates(localizer):
    data = localizer.data
    d_good = _description(data, 0)
    fe = BatchingFrontend(localizer, max_batch=8, max_wait_s=0.5, start=False)
    f_good = fe.submit_text(d_good)
    f_bad = fe.submit_text("utter gibberish that parses to nothing")
    fe.start()
    r_good = f_good.result(timeout=300)
    with pytest.raises(HintParseError):
        f_bad.result(timeout=300)
    fe.close()
    np.testing.assert_array_equal(r_good.cell_indices,
                                  localizer.localize_text([d_good]).cell_indices[0])
    assert fe.stats.dispatches == 3 and fe.stats.requests == 2


def test_submit_validates_triple_shapes(localizer):
    data = localizer.data
    fe = BatchingFrontend(localizer, max_batch=4, start=False)
    with pytest.raises(ValueError, match="hint_color"):
        fe.submit(data.hint_dir[0], data.hint_color[0][:-1], data.hint_label[0])
    with pytest.raises(ValueError, match="sentence_mask"):
        fe.submit(*_query(data, 0), sentence_mask=np.ones(2, bool))
    assert fe.stats.requests == 0
    fe.close()


def test_close_and_error_paths(localizer):
    data = localizer.data
    fe = BatchingFrontend(localizer, max_batch=4, max_wait_s=0.01)
    fe.localize_one(*_query(data, 0), timeout=300)
    fe.close()
    fe.close()
    assert fe._thread is None
    with pytest.raises(RuntimeError):
        fe.submit(*_query(data, 0))
    with BatchingFrontend(localizer, max_batch=4) as fe2:
        with pytest.raises(ValueError):
            fe2.submit(*(a[:2] for a in _query(data, slice(None))))
        with pytest.raises(TypeError):
            fe2.submit_text(["a", "b"])
    with pytest.raises(ValueError, match="max_batch"):
        BatchingFrontend(localizer, max_batch=0)


class _FakeLocalizer:
    """Deterministic stand-in: a row's result is a function of its hints
    alone; a description with "bad" fails its whole call."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.calls = []

    def localize(self, hd, hc, hl, sentence_mask=None):
        self.calls.append(("triple", np.asarray(hd).shape))
        v = (np.asarray(hd) * 7 + np.asarray(hc) * 3 + np.asarray(hl)) * sentence_mask
        s = v.sum(axis=1).astype(np.float32)
        return LocalizationResult(np.stack([s, -s], 1), np.stack([s, s], 1)[:, None],
                                  v[:, :1], s[:, None])

    def localize_text(self, descriptions):
        self.calls.append(("text", len(descriptions)))
        if any("bad" in d for d in descriptions):
            raise HintParseError("bad")
        p = parse_descriptions(descriptions, self.cfg.model.num_mentioned)
        return self.localize(p["hint_dir"], p["hint_color"], p["hint_label"],
                             p["sentence_mask"])


def test_dispatch_log_and_results_equal_jax_frontend(localizer):
    """The same backlog through both packages' frontends: the same calls,
    group sizes, stats and per-request outcomes."""
    from text2loc_tpu.serving_frontend import BatchingFrontend as JaxFrontend

    data = localizer.data
    logs = []
    for frontend in (BatchingFrontend, JaxFrontend):
        fake = _FakeLocalizer(localizer.cfg)
        fe = frontend(fake, max_batch=4, max_wait_s=0.2, start=False)
        futures = [fe.submit(*_query(data, i)) for i in range(3)]
        futures.append(fe.submit(*(a[:1] for a in _query(data, 4))))
        futures += [fe.submit_text(_description(data, 5)), fe.submit_text("bad one"),
                    fe.submit(*_query(data, 6))]
        fe.start()
        outcomes = []
        for f in futures:
            try:
                outcomes.append(tuple(np.asarray(x).tolist() for x in f.result(timeout=60)))
            except HintParseError as e:
                outcomes.append(str(e))
        fe.close()
        logs.append((fake.calls, list(fe.stats.group_sizes), fe.stats.requests,
                     fe.stats.dispatches, fe.stats.mean_group_size, outcomes))
    assert logs[0] == logs[1]
