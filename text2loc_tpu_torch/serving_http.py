"""Minimal HTTP serving endpoint over `serving_frontend.BatchingFrontend`
(port of text2loc_tpu/serving_http.py: make_handler, LocalizationServer,
main; the same API, JSON and status codes).

Stdlib only (http.server): each HTTP worker thread parks its request on the
micro-batching dispatcher, so concurrent HTTP clients are coalesced into
single device batches exactly like direct `submit()` callers. Put a real
load balancer in front of it.

    python -m text2loc_tpu_torch.serving_http --base_path DATA \
        --array_cache DATA/arrays --cache_path gallery.npz \
        --coarse_ckpt W/coarse_ckpt --fine_ckpt W/fine_ckpt

API
---
POST /localize   {"description": "..."}                       -> one query
                 {"hints": {"dir": [...], "color": [...],
                            "label": [...], "mask": [...]?}}  -> one query
GET  /healthz    liveness
GET  /stats      dispatcher counters (requests, dispatches, mean group size)

Responses: {"position": [x, y], "candidates": [[x, y], ...],
            "cells": [...], "scores": [...]}
"""
from __future__ import annotations

import json
import threading
from concurrent.futures import TimeoutError as FuturesTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from text2loc_tpu_torch.serving_frontend import BatchingFrontend
from text2loc_tpu_torch.text import HintParseError


def _result_json(res) -> dict:
    return {
        "position": np.asarray(res.position_w, np.float64).tolist(),
        "candidates": np.asarray(res.candidates_w, np.float64).tolist(),
        "cells": np.asarray(res.cell_indices).tolist(),
        "scores": np.asarray(res.scores, np.float64).tolist(),
    }


def make_handler(frontend: BatchingFrontend, timeout_s: float):
    class Handler(BaseHTTPRequestHandler):
        # Silence per-request stderr logging (a serving hot path shouldn't
        # pay a write() per query; hook log_message to reinstate).
        def log_message(self, fmt, *args):  # noqa: D102
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 — http.server API
            if self.path == "/healthz":
                self._send(200, {"ok": True})
            elif self.path == "/stats":
                s = frontend.stats
                self._send(200, {
                    "requests": s.requests,
                    "dispatches": s.dispatches,
                    "rows_dispatched": s.rows_dispatched,
                    "mean_group_size": s.mean_group_size,
                })
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802 — http.server API
            if self.path != "/localize":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
                if "description" in req:
                    fut = frontend.submit_text(req["description"])
                elif "hints" in req:
                    h = req["hints"]
                    fut = frontend.submit(
                        np.asarray(h["dir"], np.int32),
                        np.asarray(h["color"], np.int32),
                        np.asarray(h["label"], np.int32),
                        sentence_mask=(np.asarray(h["mask"], bool)
                                       if "mask" in h else None),
                    )
                else:
                    self._send(400, {"error":
                                     "need 'description' or 'hints'"})
                    return
                res = fut.result(timeout=timeout_s)
            except FuturesTimeoutError as e:
                # A backend stall, not a caller fault: 504 so clients and
                # load balancers retry.
                self._send(504, {"error": f"TimeoutError: {e}"})
                return
            except (ValueError, TypeError, KeyError,
                    json.JSONDecodeError, HintParseError) as e:
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
                return
            except Exception as e:  # noqa: BLE001 — report, don't crash
                self._send(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._send(200, _result_json(res))

    return Handler


class LocalizationServer:
    """Own a ThreadingHTTPServer + its serve_forever thread. Context-manager
    friendly; `close()` stops HTTP first, then the dispatcher."""

    def __init__(self, frontend: BatchingFrontend, host: str = "127.0.0.1",
                 port: int = 0, timeout_s: float = 120.0):
        self.frontend = frontend
        self.httpd = ThreadingHTTPServer(
            (host, port), make_handler(frontend, timeout_s)
        )
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self):
        return self.httpd.server_address  # (host, bound_port)

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self.httpd.serve_forever,
                name="text2loc-http", daemon=True,
            )
            self._thread.start()
        return self

    def close(self):
        if self._thread is not None:
            self.httpd.shutdown()
            self._thread.join(30)
            self._thread = None
        self.httpd.server_close()
        self.frontend.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()


def build_argparser():
    """The evaluation CLI's flags (data, checkpoints, text table, model
    options, --device) and the server's."""
    from text2loc_tpu_torch.evaluation.cli import build_argparser as eval_argparser

    ap = eval_argparser()
    ap.description = __doc__
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8460)
    ap.add_argument("--max_batch", type=int, default=1024,
                    help="largest coalesced device batch (a power of two)")
    ap.add_argument("--max_wait_ms", type=float, default=2.0,
                    help="longest a lone request waits for batchmates")
    ap.add_argument("--cache_path", default=None,
                    help="npz path persisting the gallery, fine cache and sentence "
                         "tables across restarts")
    ap.add_argument("--serve_top_k", type=int, default=None,
                    help="candidates refined per query (default: max(eval top_k))")
    ap.add_argument("--no_warmup", action="store_true",
                    help="skip localizing the 1- and max_batch-buckets before "
                         "accepting traffic")
    return ap


def main(argv=None, stop: Optional[threading.Event] = None):
    """`python -m text2loc_tpu_torch.serving_http`: load the map and the
    models through the evaluation CLI's stack (--synthetic or --base_path
    with --array_cache; --coarse_ckpt / --fine_ckpt for the port's trainer
    checkpoints, --*_torch_ckpt for reference .pth files; --text_table;
    --t5_snapshot for the online encoder of out-of-vocabulary descriptions),
    build a cached Localizer (persisted by --cache_path), warm it, and serve
    it through the micro-batching dispatcher until `stop` is set (or an
    interrupt, with stop=None)."""
    from text2loc_tpu_torch.evaluation.cli import (_apply_model_flags, _load, _model,
                                                   online_encoder)
    from text2loc_tpu_torch.models.text_embedding import make_embedder
    from text2loc_tpu_torch.serving import Localizer

    args = build_argparser().parse_args(argv)
    cfg, data = _load(args)
    cfg = _apply_model_flags(cfg, args)
    cfg, embedder = make_embedder(cfg, args.text_table)
    gen = torch.Generator().manual_seed(0)
    coarse = _model(cfg, "coarse", args, args.coarse_torch_ckpt, gen)
    fine = _model(cfg, "fine", args, args.fine_torch_ckpt, gen)
    loc = Localizer(data, coarse, fine, embedder, cfg,
                    top_k=args.serve_top_k or max(cfg.eval.top_k),
                    cache_path=args.cache_path, online_encoder=online_encoder(args, cfg),
                    device=args.device)
    # Warm the two bucket extremes (a lone request and a full drain) before
    # accepting traffic: on the card the first calls build the kernels and
    # fill their plan caches.
    if not args.no_warmup:
        mask = np.asarray(data.hint_mask[:1], bool)
        for b in sorted({1, args.max_batch}):
            reps = np.zeros(b, np.int64)
            print(f"warmup: bucket {b}", flush=True)
            loc.localize(data.hint_dir[reps], data.hint_color[reps],
                         data.hint_label[reps], sentence_mask=mask[reps])

    frontend = BatchingFrontend(loc, max_batch=args.max_batch,
                                max_wait_s=args.max_wait_ms / 1000.0)
    with LocalizationServer(frontend, host=args.host, port=args.port) as srv:
        host, port = srv.address
        print(f"serving on http://{host}:{port}  "
              f"(POST /localize, GET /healthz, GET /stats)", flush=True)
        try:
            (stop or threading.Event()).wait()
        except KeyboardInterrupt:
            print("shutting down", flush=True)


if __name__ == "__main__":
    main()
