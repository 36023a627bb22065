"""Online micro-batching front end for `serving.Localizer` (port of
text2loc_tpu/serving_frontend.py: BatchingFrontend, FrontendStats; the same
threading, over the port's Localizer).

Independent clients each hold one query, yet the device sees large batches:

- Clients call `submit()` / `localize_one()` / `submit_text()` /
  `localize_text_one()` from any thread with a single query; each call
  returns or awaits a `concurrent.futures.Future`.
- One dispatcher thread drains the queue and coalesces up to `max_batch`
  waiting requests into a group; a lone request waits at most `max_wait_s`
  for company before it is dispatched alone.
- A group becomes ONE `Localizer.localize` / `localize_text` call. The
  Localizer pads to power-of-two buckets (`Localizer._bucket`), so the
  device sees a handful of batch shapes whatever request sizes arrive.
- Hint triples and description strings are grouped per kind within a drain
  (two dispatches at worst), which keeps `localize_text`'s online-encoder
  fallback for out-of-vocabulary sentences.

Batching is transparent because rows are independent: at eval the towers use
running BatchNorm statistics and per-sample attention, so a query's result
does not depend on its batchmates (tests/test_torch_port_frontend.py checks
it against single-query calls).
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Deque, List, Optional

import numpy as np

from text2loc_tpu_torch.serving import LocalizationResult, Localizer

_TRIPLE = "triple"
_TEXT = "text"


def _complete(future: Future, result) -> None:
    """set_result tolerant of client-side cancellation / shutdown races."""
    try:
        future.set_result(result)
    except InvalidStateError:
        pass


def _fail(future: Future, exc: BaseException) -> None:
    """set_exception tolerant of already-completed/cancelled futures."""
    try:
        future.set_exception(exc)
    except InvalidStateError:
        pass


@dataclass
class FrontendStats:
    """Observability counters (read under the dispatcher's own updates —
    plain ints, monotone, safe to read without a lock for monitoring).
    `group_sizes` keeps only the most recent dispatches (bounded deque) so a
    long-running server doesn't leak; the lifetime mean comes from the
    monotone counters instead."""

    requests: int = 0
    dispatches: int = 0
    rows_dispatched: int = 0
    group_sizes: Deque[int] = field(
        default_factory=lambda: deque(maxlen=4096)
    )

    @property
    def mean_group_size(self) -> float:
        return (self.rows_dispatched / self.dispatches
                if self.dispatches else 0.0)


class _Request:
    __slots__ = ("kind", "payload", "future")

    def __init__(self, kind: str, payload):
        self.kind = kind
        self.payload = payload
        self.future: Future = Future()


class BatchingFrontend:
    """Micro-batching dispatcher over a `Localizer`.

    Parameters
    ----------
    localizer: the (already warmed/cached) Localizer to serve through.
    max_batch: largest group coalesced into one dispatch. Keep it at a
        power of two so groups land exactly on one batch bucket.
    max_wait_s: the longest a request waits for batchmates. 0 disables
        coalescing delay (each drain takes only what is already queued —
        still batches under concurrent load, adds no idle latency).
    start: spawn the dispatcher thread immediately. Tests pass False to
        enqueue a deterministic backlog first.
    """

    def __init__(self, localizer: Localizer, *, max_batch: int = 1024,
                 max_wait_s: float = 0.002, start: bool = True):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.localizer = localizer
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self.stats = FrontendStats()
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        if start:
            self.start()

    # ------------------------------------------------------------- client
    def submit(self, hint_dir, hint_color, hint_label,
               sentence_mask=None) -> Future:
        """One query ([S] int triples + optional [S] bool mask) -> Future of
        a single-row `LocalizationResult` slice (position_w [2],
        candidates_w [K, 2], cell_indices [K], scores [K])."""
        hint_dir = np.asarray(hint_dir)
        if hint_dir.ndim != 1:
            raise ValueError(
                f"submit() takes ONE query ([S] hint arrays); got shape "
                f"{hint_dir.shape}. Batch clients should call "
                f"Localizer.localize directly."
            )
        if sentence_mask is None:
            sentence_mask = np.ones(hint_dir.shape, bool)
        payload = (
            hint_dir,
            np.asarray(hint_color),
            np.asarray(hint_label),
            np.asarray(sentence_mask, bool),
        )
        # Malformed triples must fail THIS caller at submit time, not the
        # whole micro-batch at dispatch time.
        for name, a in zip(("hint_color", "hint_label", "sentence_mask"),
                           payload[1:]):
            if a.shape != hint_dir.shape:
                raise ValueError(
                    f"{name} shape {a.shape} != hint_dir shape "
                    f"{hint_dir.shape}"
                )
        return self._enqueue(_Request(_TRIPLE, payload))

    def submit_text(self, description: str) -> Future:
        """One natural-language description string -> Future (same row
        semantics as `submit`; OOV sentences use the Localizer's online
        encoder, matching `localize_text`)."""
        if not isinstance(description, str):
            raise TypeError(
                f"submit_text() takes ONE description string, got "
                f"{type(description).__name__}"
            )
        return self._enqueue(_Request(_TEXT, description))

    def localize_one(self, hint_dir, hint_color, hint_label,
                     sentence_mask=None, timeout: Optional[float] = None):
        """Blocking convenience wrapper around `submit`."""
        return self.submit(hint_dir, hint_color, hint_label,
                           sentence_mask).result(timeout)

    def localize_text_one(self, description: str,
                          timeout: Optional[float] = None):
        """Blocking convenience wrapper around `submit_text`."""
        return self.submit_text(description).result(timeout)

    # ---------------------------------------------------------- lifecycle
    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="text2loc-frontend", daemon=True
            )
            self._thread.start()
        return self

    def close(self, timeout: Optional[float] = 30.0):
        """Drain the queue, stop the dispatcher. Idempotent. Requests
        submitted after close() fail fast. If the dispatcher is still inside
        a device call when `timeout` expires (e.g. the first call's kernel
        builds), the thread is left to finish its group and exit on the
        shutdown sentinel — pass timeout=None to block until then."""
        if self._closed:
            return
        self._closed = True
        thread = self._thread
        if thread is not None:
            self._queue.put(None)
            thread.join(timeout)
            if not thread.is_alive():
                self._thread = None
        # Fail any stragglers enqueued concurrently with shutdown. If the
        # dispatcher outlived the join timeout, its shutdown sentinel may
        # still be queued — put it back so the thread terminates instead of
        # blocking in _queue.get() forever, and let IT fail the stragglers.
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is None:
                if thread is not None and thread.is_alive():
                    self._queue.put(None)
                    break
                continue
            _fail(req.future, RuntimeError("frontend closed"))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    # --------------------------------------------------------- dispatcher
    def _enqueue(self, req: _Request) -> Future:
        if self._closed:
            raise RuntimeError("frontend closed")
        self.stats.requests += 1
        self._queue.put(req)
        # close() may have set _closed and finished its straggler drain
        # between the check above and the put; don't leave such a future
        # pending forever (if the dispatcher races us and serves it anyway,
        # _fail is a no-op on the completed future).
        if self._closed:
            _fail(req.future, RuntimeError("frontend closed"))
        return req.future

    def _drain_group(self) -> Optional[List[_Request]]:
        """Block for the first request, then take what arrives within
        `max_wait_s` (up to `max_batch`). Returns None on shutdown."""
        first = self._queue.get()
        if first is None:
            return None
        group = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(group) < self.max_batch:
            remaining = deadline - time.monotonic()
            try:
                nxt = (self._queue.get_nowait() if remaining <= 0
                       else self._queue.get(timeout=remaining))
            except queue.Empty:
                break
            if nxt is None:
                # Keep the shutdown sentinel ordered AFTER this group.
                self._queue.put(None)
                break
            group.append(nxt)
        return group

    def _run(self):
        while True:
            group = self._drain_group()
            if group is None:
                break
            for kind in (_TRIPLE, _TEXT):
                part = [r for r in group if r.kind == kind]
                if part:
                    self._dispatch(kind, part)
        # Shutdown: requests that were queued behind the sentinel (racing
        # close()) must not hang forever.
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            if req is not None:
                _fail(req.future, RuntimeError("frontend closed"))

    def _dispatch(self, kind: str, part: List[_Request],
                  *, isolate_on_error: bool = True):
        self.stats.dispatches += 1
        self.stats.rows_dispatched += len(part)
        self.stats.group_sizes.append(len(part))
        try:
            if kind == _TRIPLE:
                hd, hc, hl, sm = self._padded_triples(part)
                res = self.localizer.localize(hd, hc, hl, sentence_mask=sm)
            else:
                res = self.localizer.localize_text(
                    [r.payload for r in part]
                )
        except Exception as e:  # noqa: BLE001 — every waiter must learn
            if isolate_on_error and len(part) > 1:
                # One bad request must not poison its batchmates (e.g. an
                # unparseable description fails the whole
                # localize_text([...]) call): retry each request alone so
                # every client gets ITS OWN outcome.
                for r in part:
                    self._dispatch(kind, [r], isolate_on_error=False)
            else:
                for r in part:
                    _fail(r.future, e)
            return
        for i, r in enumerate(part):
            _complete(r.future, LocalizationResult(
                position_w=res.position_w[i],
                candidates_w=res.candidates_w[i],
                cell_indices=res.cell_indices[i],
                scores=res.scores[i],
            ))

    def _padded_triples(self, part: List[_Request]):
        """Stack per-request [s] triples into fixed-shape [G, S] arrays.

        Requests may carry different hint counts; every dispatch pads to the
        MODEL's native hint slot count (cfg.model.num_mentioned) — not the
        group max — so the sentence axis is one constant shape. Pad slots
        hold triple (0, 0, 0) with mask False, the text.parse_descriptions
        convention that keeps them out of attention/pooling. A query LONGER
        than the native count is served at the group max instead.
        """
        s_fixed = int(self.localizer.cfg.model.num_mentioned)
        s_max = max(s_fixed, max(len(r.payload[0]) for r in part))

        def _col(col, fill):
            rows = []
            for r in part:
                a = r.payload[col]
                if len(a) < s_max:
                    a = np.concatenate(
                        [a, np.full(s_max - len(a), fill, a.dtype)]
                    )
                rows.append(a)
            return np.stack(rows)

        return _col(0, 0), _col(1, 0), _col(2, 0), _col(3, False)
