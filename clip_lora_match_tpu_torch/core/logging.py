"""Logging with the JAX package's ``[component]`` style and the JSONL
metrics sink (port of ``core/logging.py``: ``get_logger``, ``MetricsWriter``)."""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any, Optional

_FORMAT = "%(asctime)s [%(name)s] %(levelname)s %(message)s"
_configured = False


def get_logger(component: str) -> logging.Logger:
    global _configured
    if not _configured:
        logging.basicConfig(level=logging.INFO, format=_FORMAT, stream=sys.stderr)
        _configured = True
    return logging.getLogger(component)


class MetricsWriter:
    """Append-only JSONL metrics sink, one event per line:
    ``{"event": ..., "time": <unix s>, **fields}``. No path: writes nothing."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a")

    def write(self, event: str, **fields: Any) -> None:
        rec = {"event": event, "time": time.time(), **fields}
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
