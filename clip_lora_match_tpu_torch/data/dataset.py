"""Host data pipeline helpers (port of ``clip_lora_match_tpu/data/dataset.py``:
``prefetch`` only; the training datasets come with the trainer)."""

from __future__ import annotations

import queue
import threading
from typing import Iterator, TypeVar

T = TypeVar("T")


def prefetch(it: Iterator[T], depth: int = 2) -> Iterator[T]:
    """Run ``it`` in a background thread with a bounded queue of ``depth``
    items, so host work on item i+1 overlaps the consumer's work on item i.
    Items keep their order; an exception in ``it`` is raised in the consumer
    after the items before it.

    A consumer that stops early (``break``, an exception) closes the
    generator, whose ``finally`` sets the stop event: a worker blocked on a
    full queue sees it within 0.1 s and returns instead of holding ``depth``
    items for the life of the process."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()
    err: list[BaseException] = []
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not put(item):
                    return
        except BaseException as e:  # raised on the consumer's side
            err.append(e)
        finally:
            put(sentinel)  # unless the consumer has gone

    t = threading.Thread(target=worker, daemon=True, name="prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
