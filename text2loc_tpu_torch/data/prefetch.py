"""Background input pipeline: the host batch gather runs ahead of the train
step on a worker thread (the port's own copy of text2loc_tpu/data/prefetch.py:
prefetch, maybe_prefetch; the environment switch is an argument here).

One worker thread runs the host-side gathers (numpy gathers, PMC /
close-cell / negative draws) while the main thread runs the step, so:

* the host RNG streams (np.random.Generator state threaded through the
  gathers) advance in exactly the serial loop's order: a prefetched run is
  bitwise identical to the serial loop;
* the queue is bounded: at most _DEPTH batches wait for the step;
* generator exceptions re-raise in the consumer at the point of
  consumption; an early consumer exit (an exception mid-epoch, or close())
  stops and joins the worker.

The trainers stage host batches only: the step copies its batch to the
card on the step's own stream, so no copy races the step.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()
_DEPTH = 2


def prefetch(batches: Iterable[T]) -> Iterator[T]:
    """Yield each batch of `batches`, gathered ahead by a worker thread.

    `batches`: the host-side batch generator (gathers + RNG draws). It runs
    entirely on one worker thread, in order.
    """
    q: queue.Queue = queue.Queue(maxsize=_DEPTH)
    stop = threading.Event()
    failure: list[BaseException] = []

    def worker():
        try:
            for item in batches:
                # Bounded put that notices consumer abandonment: poll the
                # stop flag so an abandoned epoch does not leak a blocked
                # thread.
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # re-raised at the consumer
            failure.append(e)
        finally:
            while not stop.is_set():
                try:
                    q.put(_SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=worker, name="text2loc-prefetch", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if failure:
                    raise failure[0]
                return
            yield item
    finally:
        stop.set()
        t.join(timeout=10.0)


def maybe_prefetch(batches: Iterable[T], enabled: bool = True) -> Iterator[T]:
    """`prefetch` when `enabled`, else the serial equivalent (the same
    semantics, no worker thread)."""
    if enabled:
        return prefetch(batches)
    return (b for b in batches)
