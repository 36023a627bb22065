"""The port's HTTP endpoint over its micro-batching frontend: the three cases
of tests/test_serving_http.py (request and response formats, concurrent
clients coalescing, error codes) on port 0, and `main(argv)` started on a
thread with --synthetic --device cpu --no_warmup, queried and shut down
(with --t5_snapshot, an out-of-vocabulary description answered).
HTTP answers are held against the direct Localizer call: cells equal,
positions at atol 1e-3 m."""

import contextlib
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from test_torch_port_frontend import port_localizer
from test_torch_port_t5 import write_t5_snapshot
from text2loc_tpu_torch import constants as C
from text2loc_tpu_torch import serving
from text2loc_tpu_torch.config import small_test_config
from text2loc_tpu_torch.models.t5_encoder import T5OnlineEncoder
from text2loc_tpu_torch.serving_frontend import BatchingFrontend
from text2loc_tpu_torch.serving_http import LocalizationServer, main


@pytest.fixture(scope="module")
def server():
    loc = port_localizer()
    fe = BatchingFrontend(loc, max_batch=16, max_wait_s=0.05)
    with LocalizationServer(fe, port=0) as srv:
        yield srv, loc, loc.data


def _post(addr, payload, timeout=300):
    host, port = addr
    req = urllib.request.Request(f"http://{host}:{port}/localize",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(addr, path, timeout=60):
    host, port = addr
    with urllib.request.urlopen(f"http://{host}:{port}{path}", timeout=timeout) as r:
        return r.status, json.loads(r.read())


def test_healthz_and_hints_roundtrip(server):
    srv, loc, data = server
    assert _get(srv.address, "/healthz") == (200, {"ok": True})
    status, out = _post(srv.address, {"hints": {
        "dir": data.hint_dir[0].tolist(), "color": data.hint_color[0].tolist(),
        "label": data.hint_label[0].tolist()}})
    assert status == 200
    direct = loc.localize(data.hint_dir[:1], data.hint_color[:1], data.hint_label[:1])
    np.testing.assert_allclose(out["position"], direct.position_w[0], atol=1e-3)
    assert out["cells"] == direct.cell_indices[0].tolist()
    assert len(out["candidates"]) == 3 and len(out["scores"]) == 3


def test_description_and_concurrent_batching(server):
    srv, loc, data = server
    d0 = " ".join(C.render_hint(data.hint_dir[0][s], data.hint_color[0][s],
                                data.hint_label[0][s]) for s in range(data.hint_dir.shape[1]))
    before = srv.frontend.stats.requests
    results, errs = [None] * 8, []

    def client(i):
        try:
            results[i] = _post(srv.address, {"description": d0})
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not errs, errs
    assert all(s == 200 for s, _ in results)
    direct = loc.localize_text([d0])
    for _, out in results:
        assert out["cells"] == direct.cell_indices[0].tolist()
        np.testing.assert_allclose(out["position"], direct.position_w[0], atol=1e-3)
    st = srv.frontend.stats
    assert st.requests - before >= 8 and st.dispatches < st.requests
    status, stats = _get(srv.address, "/stats")
    assert status == 200 and stats["requests"] == st.requests
    assert stats["mean_group_size"] == pytest.approx(st.mean_group_size)


def test_error_paths(server):
    srv, _, _ = server
    status, out = _post(srv.address, {})
    assert status == 400 and "need" in out["error"]
    status, out = _post(srv.address, {"hints": {"dir": [0]}})
    assert status == 400 and "KeyError" in out["error"]
    status, out = _post(srv.address, {"description": "take me to the glowing obelisk"})
    assert status == 400 and "HintParseError" in out["error"]
    host, port = srv.address
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(urllib.request.Request(f"http://{host}:{port}/nope",
                                                      data=b"{}"), timeout=60)
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://{host}:{port}/nope", timeout=60)
    assert e.value.code == 404


@contextlib.contextmanager
def _serving_main(capsys, argv):
    """main(argv) on a thread; yields the (host, port) it serves on, and
    stops and joins it on exit."""
    stop = threading.Event()
    errors = []

    def run():
        try:
            main(argv, stop=stop)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    thread = threading.Thread(target=run)
    thread.start()
    printed = ""
    try:
        deadline = time.monotonic() + 120
        while "serving on" not in printed and time.monotonic() < deadline and not errors:
            time.sleep(0.05)
            printed += capsys.readouterr().out
        assert not errors, errors
        line = next(x for x in printed.splitlines() if x.startswith("serving on"))
        addr = line.split("http://")[1].split()[0]
        yield tuple(addr.rsplit(":", 1))
    finally:
        stop.set()
        thread.join(60)
    assert not thread.is_alive() and not errors


def test_main_serves_and_shuts_down(capsys, tmp_path):
    cache = str(tmp_path / "gallery.npz")
    with _serving_main(capsys, ["--synthetic", "--device", "cpu", "--no_warmup", "--port",
                                "0", "--max_batch", "4", "--cache_path", cache]) as addr:
        assert _get(addr, "/healthz") == (200, {"ok": True})
        status, out = _post(addr, {"hints": {"dir": [0, 1, 2], "color": [1, 2, 3],
                                             "label": [3, 4, 5]}})
        assert status == 200 and len(out["cells"]) == 3
        assert np.isfinite(out["position"]).all()
    with np.load(cache) as f:
        assert int(f["num_cells"]) == 8


def test_main_t5_snapshot_answers_out_of_vocabulary_posts(capsys, tmp_path, monkeypatch):
    """--t5_snapshot: the Localizer gets the snapshot's T5OnlineEncoder, and
    a description outside the hint vocabulary is answered (without an
    online encoder it is a 400)."""
    built = []

    class Recording(serving.Localizer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    monkeypatch.setattr(serving, "Localizer", Recording)
    snap = write_t5_snapshot(tmp_path / "t5", d_model=small_test_config().model.text_embed_dim)
    with _serving_main(capsys, ["--synthetic", "--device", "cpu", "--no_warmup", "--port",
                                "0", "--max_batch", "4", "--t5_snapshot", snap]) as addr:
        status, out = _post(addr, {"description": "The pose is west of a beige pole. "
                                                  "A zeppelin hovers over the square."})
        assert status == 200, out
        assert len(out["cells"]) == 3 and np.isfinite(out["position"]).all()
    (loc,) = built
    assert isinstance(loc.online_encoder, T5OnlineEncoder)
    assert loc.online_encoder.embed_dim == loc.embedder.embed_dim
