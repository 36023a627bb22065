"""The port's HTTP endpoint over its micro-batching frontend: the three cases
of tests/test_serving_http.py (request and response formats, concurrent
clients coalescing, error codes) on port 0, and `main(argv)` started on a
thread with --synthetic --device cpu --no_warmup, queried and shut down.
HTTP answers are held against the direct Localizer call: cells equal,
positions at atol 1e-3 m."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from test_torch_port_frontend import port_localizer
from text2loc_tpu_torch import constants as C
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


def test_main_serves_and_shuts_down(capsys, tmp_path):
    stop = threading.Event()
    errors = []
    cache = str(tmp_path / "gallery.npz")

    def run():
        try:
            main(["--synthetic", "--device", "cpu", "--no_warmup", "--port", "0",
                  "--max_batch", "4", "--cache_path", cache], stop=stop)
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
        host, port = addr.rsplit(":", 1)
        assert _get((host, port), "/healthz") == (200, {"ok": True})
        status, out = _post((host, port), {"hints": {"dir": [0, 1, 2], "color": [1, 2, 3],
                                                     "label": [3, 4, 5]}})
        assert status == 200 and len(out["cells"]) == 3
        assert np.isfinite(out["position"]).all()
    finally:
        stop.set()
        thread.join(60)
    assert not thread.is_alive() and not errors
    with np.load(cache) as f:
        assert int(f["num_cells"]) == 8


def test_main_flags_of_unported_paths_raise():
    with pytest.raises(NotImplementedError, match="item 6"):
        main(["--synthetic", "--device", "cpu", "--t5_snapshot", "x"])
