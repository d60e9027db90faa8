"""Micro-batching queue in front of the encoder (port of
``services/batch_queue.py``).

Concurrent single-item encode requests are coalesced into one padded batch
per tower pass: callers block on a per-request future while one worker
thread drains the queue within a ``linger_ms`` window and makes one bucketed
encoder call on the encoder's device. A lone request waits at most
``linger_ms`` longer.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Optional

import numpy as np

from clip_lora_match_tpu_torch.core.logging import get_logger
from clip_lora_match_tpu_torch.models.encoder import ClipEncoder

log = get_logger("batch_queue")


@dataclass
class _Request:
    kind: str  # "text" | "image"
    payload: object  # str | PIL image | path
    future: Future


class EncoderBatchQueue:
    def __init__(self, encoder: ClipEncoder, max_batch: int = 64, linger_ms: float = 2.0):
        self.encoder = encoder
        self.max_batch = max_batch
        self.linger = linger_ms / 1e3
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._closed = False
        # the closed flag and the shutdown sentinel change together under
        # this lock, so no request can slip in behind the sentinel
        self._close_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- public API -----------------------------------------------------------

    def encode_text(self, text: str) -> np.ndarray:
        return self._submit("text", text).result()

    def encode_image(self, image) -> np.ndarray:
        return self._submit("image", image).result()

    def close(self) -> None:
        with self._close_lock:
            self._closed = True
            self._q.put(None)
        self._worker.join(timeout=5)
        # fail any request that raced past the worker's shutdown
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item.future.set_exception(RuntimeError("queue closed"))

    # -- internals ------------------------------------------------------------

    def _submit(self, kind: str, payload) -> Future:
        with self._close_lock:
            if self._closed:
                raise RuntimeError("queue closed")
            req = _Request(kind, payload, Future())
            self._q.put(req)
        return req.future

    def _drain(self, first: _Request) -> list[_Request]:
        batch = [first]
        deadline = time.perf_counter() + self.linger
        while len(batch) < self.max_batch:
            timeout = deadline - time.perf_counter()
            if timeout <= 0:
                break
            try:
                item = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if item is None:
                self._q.put(None)  # re-signal shutdown
                break
            batch.append(item)
        return batch

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            by_kind: dict[str, list[_Request]] = {}
            for r in self._drain(item):
                by_kind.setdefault(r.kind, []).append(r)
            for kind, reqs in by_kind.items():
                payloads = [r.payload for r in reqs]
                try:
                    if kind == "text":
                        out = self.encoder.encode_text(payloads)
                    else:
                        out = self.encoder.encode_image(payloads)
                except Exception as e:  # the worker keeps serving; callers get the error
                    log.exception("batched %s encode failed", kind)
                    for r in reqs:
                        r.future.set_exception(e)
                    continue
                for r, vec in zip(reqs, out):
                    r.future.set_result(np.asarray(vec))


class QueuedEncoder:
    """Encoder facade: single-item normalized text/image encodes go through an
    ``EncoderBatchQueue`` (concurrent service calls coalesce into one padded
    batch); everything else goes to the wrapped encoder."""

    def __init__(self, encoder: ClipEncoder, **queue_kwargs):
        self._encoder = encoder
        self.queue = EncoderBatchQueue(encoder, **queue_kwargs)

    def encode_text(self, text, normalize: bool = True):
        if isinstance(text, str) and normalize:
            return self.queue.encode_text(text)
        return self._encoder.encode_text(text, normalize=normalize)

    def encode_image(self, image, normalize: bool = True):
        if not isinstance(image, (list, tuple)) and normalize:
            return self.queue.encode_image(image)
        return self._encoder.encode_image(image, normalize=normalize)

    def close(self) -> None:
        self.queue.close()

    def __getattr__(self, name):
        return getattr(self._encoder, name)
