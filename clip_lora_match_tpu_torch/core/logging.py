"""Logging with the JAX package's ``[component]`` style (port of
``core/logging.py``'s ``get_logger``)."""

from __future__ import annotations

import logging
import sys

_FORMAT = "%(asctime)s [%(name)s] %(levelname)s %(message)s"
_configured = False


def get_logger(component: str) -> logging.Logger:
    global _configured
    if not _configured:
        logging.basicConfig(level=logging.INFO, format=_FORMAT, stream=sys.stderr)
        _configured = True
    return logging.getLogger(component)
