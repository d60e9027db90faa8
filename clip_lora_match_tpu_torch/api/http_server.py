"""Stdlib HTTP binding of the REST API (port of ``api/http_server.py``).

The endpoint cores of ``api/handlers.py`` bound to ``http.server``, so the
live HTTP path (sockets, multipart parsing, the JSON wire format) needs no
dependency:

- GET /health, POST /api/report (multipart), POST /api/search (multipart or
  urlencoded), GET /api/items: the reference's routes, validation and
  response JSON (``api/schemas.py``);
- /static/* serves files under ``data_dir``, with a path-traversal guard;
- ``Access-Control-Allow-Origin: *`` and the OPTIONS preflight, as the
  reference's CORS middleware;
- errors are ``{"detail": ...}`` JSON as FastAPI's; a missing required form
  field is 422, as FastAPI's form validation gives.

``ThreadingHTTPServer`` runs each request on its own thread, as FastAPI's
threadpool runs plain ``def`` endpoints, so concurrent requests reach the
``QueuedEncoder`` and coalesce into one tower pass. Multipart bodies are
parsed by the stdlib ``email`` package.
"""

from __future__ import annotations

import io
import json
import mimetypes
import os
import threading
from email import policy
from email.parser import BytesParser
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlsplit

from clip_lora_match_tpu_torch.api.handlers import (
    ApiError,
    Upload,
    handle_items,
    handle_report,
    handle_search,
)
from clip_lora_match_tpu_torch.api.wiring import ServiceGraph, build_services
from clip_lora_match_tpu_torch.core.logging import get_logger

log = get_logger("api.http")

# uploads larger than this are rejected outright (the reference has no limit;
# an unbounded read into memory is a trivial DoS on a shared host)
MAX_BODY_BYTES = 64 * 1024 * 1024


def parse_form_body(content_type: str, body: bytes):
    """Parse a request body into (fields: dict[str, str], files: dict[str,
    Upload]). Supports multipart/form-data and x-www-form-urlencoded."""
    fields: dict[str, str] = {}
    files: dict[str, Upload] = {}
    ctype = (content_type or "").split(";", 1)[0].strip().lower()
    if ctype == "application/x-www-form-urlencoded":
        for k, vs in parse_qs(body.decode("utf-8", "replace"),
                              keep_blank_values=True).items():
            fields[k] = vs[0]
        return fields, files
    if ctype != "multipart/form-data":
        raise ApiError(415, f"Unsupported content type: {content_type!r}")
    # multipart/form-data IS a MIME entity: hand the header line + body to
    # the stdlib parser instead of splitting boundaries by hand
    msg = BytesParser(policy=policy.HTTP).parsebytes(
        b"Content-Type: " + content_type.encode("latin-1") + b"\r\n"
        b"MIME-Version: 1.0\r\n\r\n" + body
    )
    if not msg.is_multipart():
        raise ApiError(400, "Malformed multipart body")
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if name is None:
            continue
        filename = part.get_filename()
        payload = part.get_payload(decode=True)
        if payload is None:
            payload = b""
        if filename is not None:
            files[name] = Upload(
                file=io.BytesIO(payload),
                filename=filename,
                content_type=part.get_content_type(),
            )
        else:
            charset = part.get_content_charset() or "utf-8"
            fields[name] = payload.decode(charset, "replace")
    return fields, files


def _require_field(fields: dict, name: str) -> str:
    # FastAPI returns 422 for a missing required Form(...) field
    if name not in fields:
        raise ApiError(422, f"Field required: {name}")
    return fields[name]


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # set by create_server on the handler class
    graph: ServiceGraph

    # ---- plumbing -----------------------------------------------------------

    def log_message(self, fmt, *args):  # route to the package logger
        log.debug("%s %s", self.address_string(), fmt % args)

    def _send(self, status: int, payload: bytes,
              content_type: str = "application/json"):
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        # CORS *, as the reference's middleware
        self.send_header("Access-Control-Allow-Origin", "*")
        self.end_headers()
        self.wfile.write(payload)

    def _send_json(self, status: int, obj) -> None:
        self._send(status, json.dumps(obj).encode("utf-8"))

    def _send_model(self, model) -> None:
        if isinstance(model, list):
            obj = [m.model_dump(mode="json") for m in model]
        else:
            obj = model.model_dump(mode="json")
        self._send_json(200, obj)

    def _read_body(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        if n > MAX_BODY_BYTES:
            raise ApiError(413, "Request body too large")
        return self.rfile.read(n) if n else b""

    def _dispatch(self, fn) -> None:
        try:
            fn()
        except ApiError as e:
            self._send_json(e.status_code, {"detail": e.detail})
        except BrokenPipeError:  # client went away mid-response
            pass
        except Exception:
            log.exception("unhandled error in %s %s", self.command, self.path)
            self._send_json(500, {"detail": "Internal server error"})

    # ---- routes -------------------------------------------------------------

    def do_OPTIONS(self):  # CORS preflight
        self.send_response(204)
        self.send_header("Access-Control-Allow-Origin", "*")
        self.send_header("Access-Control-Allow-Methods", "GET, POST, OPTIONS")
        self.send_header("Access-Control-Allow-Headers", "*")
        self.send_header("Content-Length", "0")
        self.end_headers()

    def do_GET(self):
        self._dispatch(self._get)

    def do_POST(self):
        self._dispatch(self._post)

    def _get(self):
        path = urlsplit(self.path).path
        if path == "/health":
            self._send_json(200, {"status": "ok"})
        elif path == "/api/items":
            self._send_model(handle_items(self.graph.store))
        elif path.startswith("/static/"):
            self._static(path[len("/static/"):])
        else:
            self._send_json(404, {"detail": "Not Found"})

    def _post(self):
        path = urlsplit(self.path).path
        if path not in ("/api/report", "/api/search"):
            self._send_json(404, {"detail": "Not Found"})
            return
        fields, files = parse_form_body(
            self.headers.get("Content-Type", ""), self._read_body()
        )
        if path == "/api/report":
            image = files.get("image")
            if image is None:
                raise ApiError(422, "Field required: image")
            body = handle_report(
                self.graph.finder,
                description=_require_field(fields, "description"),
                image=image,
                location=fields.get("location"),
                reporter=fields.get("reporter"),
                found_at=fields.get("found_at"),
            )
        else:
            try:
                top_k = int(fields.get("top_k", 5))
            except ValueError:
                raise ApiError(422, "top_k must be an integer")
            body = handle_search(
                self.graph.seeker,
                description=fields.get("description"),
                image=files.get("image"),
                top_k=top_k,
                data_dir=self.graph.data_dir,
            )
        self._send_model(body)

    def _static(self, rel: str):
        """Serve ``data_dir`` under /static, as the reference's mount does,
        refusing path escapes."""
        root = os.path.realpath(self.graph.data_dir)
        target = os.path.realpath(os.path.join(root, rel))
        if not (target == root or target.startswith(root + os.sep)):
            self._send_json(404, {"detail": "Not Found"})
            return
        if not os.path.isfile(target):
            self._send_json(404, {"detail": "Not Found"})
            return
        ctype = mimetypes.guess_type(target)[0] or "application/octet-stream"
        with open(target, "rb") as f:
            self._send(200, f.read(), content_type=ctype)


def create_server(
    host: str = "0.0.0.0",
    port: int = 8000,
    *,
    encoder=None,
    finder=None,
    seeker=None,
    store=None,
    data_dir: str = "data",
    index_path: Optional[str] = None,
    use_batch_queue: bool = True,
    index_quantize: str = "none",
) -> ThreadingHTTPServer:
    """Build the service graph and return a ready (unstarted) HTTP server.

    Call ``.serve_forever()`` (blocking) or use :func:`serve_background` for
    tests. ``server.server_address`` carries the bound (host, port) — pass
    port 0 to bind an ephemeral port.
    """
    graph = build_services(
        encoder=encoder,
        finder=finder,
        seeker=seeker,
        store=store,
        data_dir=data_dir,
        index_path=index_path,
        use_batch_queue=use_batch_queue,
        index_quantize=index_quantize,
    )
    handler = type("BoundHandler", (_Handler,), {"graph": graph})
    server = ThreadingHTTPServer((host, port), handler)
    server.daemon_threads = True
    return server


def serve_background(server: ThreadingHTTPServer) -> threading.Thread:
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return t
