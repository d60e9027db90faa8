"""The port's HTTP API against the JAX package's on the CPU: the wire
schemas' JSON byte for byte, the endpoint cores (report, search, items and
every error) against the JAX handlers, a live port server over real sockets
mirroring tests/test_http_server.py, the same requests to a JAX server and a
port server giving equal JSON (scores within 1e-4, the tiny encoders'
agreement), and the serve entry point. Every live server binds
127.0.0.1:0, every request has a timeout, and each server is shut down in its
fixture's finalizer."""

import datetime as dt
import io
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from clip_lora_match_tpu.api import handlers as jh
from clip_lora_match_tpu.api import schemas as js
from clip_lora_match_tpu.api.http_server import create_server as j_create_server
from clip_lora_match_tpu.api.http_server import parse_form_body as j_parse
from clip_lora_match_tpu.core.config import ClipConfig as JConfig
from clip_lora_match_tpu.db.store import SqliteStore as JStore
from clip_lora_match_tpu.models import clip as jclip
from clip_lora_match_tpu.models.encoder import ClipEncoder as JEncoder
from clip_lora_match_tpu.models.io import flatten_params as j_flatten
from clip_lora_match_tpu.nn import layers as jlayers
from clip_lora_match_tpu_torch.api import handlers as th
from clip_lora_match_tpu_torch.api import schemas as ts
from clip_lora_match_tpu_torch.api import serve as tserve
from clip_lora_match_tpu_torch.api.http_server import create_server, parse_form_body, serve_background
from clip_lora_match_tpu_torch.core.config import ClipConfig as TConfig
from clip_lora_match_tpu_torch.db.store import SqliteStore
from clip_lora_match_tpu_torch.models.encoder import ClipEncoder as TEncoder
from clip_lora_match_tpu_torch.models.io import params_from_numpy
from tests._torch_helpers import J_SMALL, T_SMALL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 60


def _multipart(fields=None, files=None, boundary="clmtorchboundary4201"):
    out = bytearray()
    for k, v in (fields or {}).items():
        out += f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode()
    for k, (filename, ctype, data) in (files or {}).items():
        out += (f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"; filename="{filename}"\r\n'
                f"Content-Type: {ctype}\r\n\r\n").encode()
        out += data + b"\r\n"
    out += f"--{boundary}--\r\n".encode()
    return bytes(out), f"multipart/form-data; boundary={boundary}"


def _request(url, method="GET", body=None, content_type=None):
    """(status, headers, parsed JSON or bytes); 4xx/5xx do not raise."""
    req = urllib.request.Request(url, data=body, method=method)
    if content_type:
        req.add_header("Content-Type", content_type)
    try:
        resp = urllib.request.urlopen(req, timeout=TIMEOUT)
    except urllib.error.HTTPError as e:
        resp = e
    with resp:
        raw = resp.read()
        headers = dict(resp.headers)
        status = resp.status
    if headers.get("Content-Type", "").startswith("application/json"):
        return status, headers, json.loads(raw)
    return status, headers, raw


def _wire(model) -> bytes:
    obj = [m.model_dump(mode="json") for m in model] if isinstance(model, list) else model.model_dump(mode="json")
    return json.dumps(obj).encode()


def test_schemas_json_byte_equal_to_jax():
    when = dt.datetime(2026, 8, 1, 10, 0, 5, 123456)
    cases = [
        ("ReportItemResponse", dict(id=3, image_path="a/b.jpg", description="tas pink, ditemukan di gk 1",
                                    location="gk 1", found_at=when, reporter="ani")),
        ("ReportItemResponse", dict(id=1, image_path="x.jpg", description="dompet")),
        ("FoundItemModel", dict(id=2, image_path="y.jpg", description="kunci", found_at=dt.datetime(2026, 1, 2))),
        ("SearchResultModel", dict(score=0.123456789, image_path="", text="topi")),
    ]
    for name, kw in cases:
        assert _wire(getattr(ts, name)(**kw)) == _wire(getattr(js, name)(**kw))
    results = [dict(score=0.5, image_path="a.jpg", text="tas"), dict(score=-0.25, image_path="", text="")]
    t = ts.SearchResponse(query_text="tas", query_image_path="data/tmp/q.jpg",
                          results=[ts.SearchResultModel(**r) for r in results])
    j = js.SearchResponse(query_text="tas", query_image_path="data/tmp/q.jpg",
                          results=[js.SearchResultModel(**r) for r in results])
    assert _wire(t) == _wire(j)
    assert _wire(ts.SearchResponse(results=[])) == _wire(js.SearchResponse(results=[]))


def test_parse_form_body_matches_jax():
    body, ctype = _multipart(fields={"description": "tas pink", "top_k": "3", "kosong": ""},
                             files={"image": ("q.jpg", "image/jpeg", b"\xff\xd8abc")})
    tf, tfiles = parse_form_body(ctype, body)
    jf, jfiles = j_parse(ctype, body)
    assert tf == jf == {"description": "tas pink", "top_k": "3", "kosong": ""}
    assert list(tfiles) == list(jfiles) == ["image"]
    t, j = tfiles["image"], jfiles["image"]
    assert (t.filename, t.content_type, t.file.read()) == (j.filename, j.content_type, j.file.read())
    assert parse_form_body("application/x-www-form-urlencoded", b"a=1&b=&a=2") == (
        {"a": "1", "b": ""}, {}) == j_parse("application/x-www-form-urlencoded", b"a=1&b=&a=2")
    with pytest.raises(th.ApiError) as e:
        parse_form_body("application/json", b"{}")
    assert e.value.status_code == 415


class _Raising:
    def __init__(self, exc):
        self.exc = exc

    def report_item(self, *a, **k):
        raise self.exc

    def search_items(self, *a, **k):
        raise self.exc

    def all_items(self, *a, **k):
        raise self.exc


def _png() -> bytes:
    buf = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(buf, "PNG")
    return buf.getvalue()


_ERRORS = {
    "report_non_image": ("report", dict(description="x", image=("a.txt", "text/plain"))),
    "report_bad_found_at": ("report", dict(description="x", image=("a.png", "image/png"), found_at="kemarin")),
    "report_internal": ("report", dict(description="x", image=("a.png", "image/png")), RuntimeError("db down")),
    "search_neither": ("search", dict(description="   ")),
    "search_empty_filename": ("search", dict(description=None, image=("", "image/png"))),
    "search_non_image": ("search", dict(description=None, image=("q.txt", "text/plain"))),
    "search_value_error": ("search", dict(description="tas"), ValueError("top_k must be >= 0, got -1")),
    "search_internal": ("search", dict(description="tas"), RuntimeError("boom")),
    "items_store_error": ("items", {}, RuntimeError("db down")),
}


@pytest.mark.parametrize("case", sorted(_ERRORS))
def test_handler_errors_match_jax(tmp_path, case):
    kind, kw, *exc = _ERRORS[case]
    out = []
    for mod in (jh, th):
        args = dict(kw)
        if "image" in args:
            name, ctype = args["image"]
            args["image"] = mod.Upload(io.BytesIO(_png()), name, ctype)
        target = _Raising(exc[0] if exc else AssertionError("not reached"))
        with pytest.raises(mod.ApiError) as e:
            if kind == "report":
                mod.handle_report(target, **args)
            elif kind == "search":
                mod.handle_search(target, data_dir=str(tmp_path / mod.__name__), **args)
            else:
                mod.handle_items(target)
        out.append((e.value.status_code, e.value.detail))
    assert out[1] == out[0]
    assert out[1][0] in (400, 500)


@pytest.fixture(scope="module")
def encoders():
    params = jclip.init_params(jax.random.PRNGKey(0), J_SMALL)
    jflags = dict(jlayers._KERNEL_FLAGS)  # the JAX encoder sets them process-wide
    jenc = JEncoder(params, arch=J_SMALL, config=JConfig(arch=J_SMALL))
    jlayers._KERNEL_FLAGS.update(jflags)
    tenc = TEncoder(params_from_numpy(j_flatten(params), device="cpu"), arch=T_SMALL,
                    config=TConfig(arch=T_SMALL), device="cpu")
    return jenc, tenc


@pytest.fixture(scope="module")
def image_bytes():
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(0).integers(0, 255, (40, 40, 3), dtype=np.uint8), "RGB").save(buf, "JPEG")
    return buf.getvalue()


def _serve(create, encoder, tmp):
    srv = create("127.0.0.1", 0, encoder=encoder, store=(SqliteStore if create is create_server else JStore)(
        str(tmp / "db.sqlite")), data_dir=str(tmp), index_path=str(tmp / "index.npz"))
    serve_background(srv)
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _shutdown(srv):
    srv.shutdown()
    srv.server_close()
    srv.RequestHandlerClass.graph.seeker.encoder.close()  # the batch queue's worker


@pytest.fixture(scope="module")
def servers(tmp_path_factory, encoders):
    """A JAX server and a port server over the same weights, each with its
    own store, data directory and index."""
    jenc, tenc = encoders
    jtmp, ttmp = tmp_path_factory.mktemp("jax_api"), tmp_path_factory.mktemp("port_api")
    jsrv, jbase = _serve(j_create_server, jenc, jtmp)
    try:
        tsrv, tbase = _serve(create_server, tenc, ttmp)
    except BaseException:
        _shutdown(jsrv)
        raise
    yield {"jax": (jbase, jtmp), "port": (tbase, ttmp), "port_server": tsrv}
    _shutdown(tsrv)
    _shutdown(jsrv)


def _same_results(t, j):
    assert [r["text"] for r in t] == [r["text"] for r in j]
    assert [os.path.basename(r["image_path"]) for r in t] == [os.path.basename(r["image_path"]) for r in j]
    np.testing.assert_allclose([r["score"] for r in t], [r["score"] for r in j], atol=1e-4)


def test_same_requests_to_both_servers_give_equal_json(servers, image_bytes):
    got = {}
    for name in ("jax", "port"):
        base, tmp = servers[name]
        out = got[name] = []
        for desc, loc in (("tas pink kanken", "lab iot"), ("dompet coklat", None)):
            fields = {"description": desc, "found_at": "2026-08-01T10:00:00", "reporter": "ani"}
            if loc:
                fields["location"] = loc
            out.append(_request(f"{base}/api/report", "POST",
                                *_multipart(fields, {"image": ("barang.jpg", "image/jpeg", image_bytes)})))
        for fields, files in (({"description": "tas pink", "top_k": "2"}, None),
                              ({}, {"image": ("q.jpg", "image/jpeg", image_bytes)}),
                              ({"description": "dompet"}, {"image": ("q.jpg", "image/jpeg", image_bytes)})):
            out.append(_request(f"{base}/api/search", "POST", *_multipart(fields, files)))
        out.append(_request(f"{base}/api/items"))
    for (tstat, _, tbody), (jstat, _, jbody) in zip(got["port"], got["jax"]):
        assert tstat == jstat == 200
        if isinstance(tbody, list):  # items
            for t, j in zip(tbody, jbody):
                assert os.path.basename(t.pop("image_path")) == os.path.basename(j.pop("image_path"))
            assert tbody == jbody and len(tbody) == 2
        elif "results" in tbody:
            _same_results(tbody.pop("results"), jbody.pop("results"))
            tq, jq = tbody.pop("query_image_path"), jbody.pop("query_image_path")
            assert (tq is None) == (jq is None) and (tq is None or not os.path.exists(tq))
            assert tbody == jbody
        else:
            assert os.path.basename(tbody.pop("image_path")) == os.path.basename(jbody.pop("image_path"))
            assert tbody == jbody
    assert got["port"][0][2]["description"] == "tas pink kanken, ditemukan di lab iot"


def test_health_and_cors(servers):
    base, _ = servers["port"]
    status, headers, body = _request(f"{base}/health")
    assert status == 200 and body == {"status": "ok"} and headers["Access-Control-Allow-Origin"] == "*"
    with urllib.request.urlopen(urllib.request.Request(f"{base}/api/search", method="OPTIONS"),
                                timeout=TIMEOUT) as resp:
        assert resp.status == 204 and resp.headers["Access-Control-Allow-Origin"] == "*"


def test_search_urlencoded_body_and_image_upload(servers, image_bytes):
    base, _ = servers["port"]
    status, _, res = _request(f"{base}/api/search", "POST", b"description=tas+pink+kanken&top_k=2",
                              "application/x-www-form-urlencoded")
    assert status == 200 and res["query_text"] == "tas pink kanken" and len(res["results"]) <= 2
    status, _, res = _request(f"{base}/api/search", "POST",
                              *_multipart(files={"image": ("query.jpg", "image/jpeg", image_bytes)}))
    assert status == 200 and res["query_image_path"] and not os.path.exists(res["query_image_path"])


@pytest.mark.parametrize("case", ["neither", "no_description", "no_image", "non_image", "bad_found_at",
                                  "content_type", "bad_top_k", "unknown_get", "unknown_post"])
def test_validation_errors_over_the_wire_match_jax(servers, image_bytes, case):
    requests = {
        "neither": ("/api/search", _multipart({"description": "   "})),
        "no_description": ("/api/report", _multipart(files={"image": ("a.jpg", "image/jpeg", b"x")})),
        "no_image": ("/api/report", _multipart({"description": "x"})),
        "non_image": ("/api/report", _multipart({"description": "x"}, {"image": ("a.txt", "text/plain", b"hi")})),
        "bad_found_at": ("/api/report", _multipart({"description": "x", "found_at": "not-a-date"},
                                                   {"image": ("up.jpg", "image/jpeg", image_bytes)})),
        "content_type": ("/api/search", (b"{}", "application/json")),
        "bad_top_k": ("/api/search", _multipart({"description": "x", "top_k": "lima"})),
        "unknown_get": ("/nope", None),
        "unknown_post": ("/api/nope", _multipart({"description": "x"})),
    }
    path, body = requests[case]
    out = []
    for name in ("jax", "port"):
        base, _ = servers[name]
        out.append(_request(f"{base}{path}") if body is None else _request(f"{base}{path}", "POST", *body))
    (tstat, _, tbody), (jstat, _, jbody) = out[1], out[0]
    assert (tstat, tbody) == (jstat, jbody)
    assert tstat in (400, 404, 415, 422)


def test_static_mount_and_traversal_guard(servers, image_bytes):
    base, tmp = servers["port"]
    (tmp / "static_probe.jpg").write_bytes(image_bytes)
    status, headers, raw = _request(f"{base}/static/static_probe.jpg")
    assert status == 200 and headers["Content-Type"] == "image/jpeg" and raw == image_bytes
    assert _request(f"{base}/static/../../../../etc/hostname")[0] == 404
    assert _request(f"{base}/static/missing.jpg")[0] == 404


def test_concurrent_searches_coalesce(servers, monkeypatch):
    """8 searches at once over ThreadingHTTPServer: all succeed with the
    sequential results, in fewer text tower passes than requests."""
    base, _ = servers["port"]
    graph = servers["port_server"].RequestHandlerClass.graph
    queue = graph.seeker.encoder.queue
    inner = queue.encoder
    calls = []
    real = inner.encode_text

    def counting(text, *a, **k):
        calls.append(1 if isinstance(text, str) else len(text))
        return real(text, *a, **k)

    texts = [f"barang nomor {i}" for i in range(8)]
    want = [_request(f"{base}/api/search", "POST", *_multipart({"description": t}))[2] for t in texts]
    monkeypatch.setattr(inner, "encode_text", counting)
    monkeypatch.setattr(queue, "linger", 0.5)
    got = [None] * 8
    barrier = threading.Barrier(8)

    def hit(i):
        barrier.wait(timeout=TIMEOUT)
        got[i] = _request(f"{base}/api/search", "POST", *_multipart({"description": texts[i]}))

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    assert [g[0] for g in got] == [200] * 8
    for g, w in zip(got, want):
        _same_results(g[2]["results"], w["results"])
    assert sum(calls) == 8 and len(calls) < 8


def test_serve_help_and_device():
    out = subprocess.run([sys.executable, "-m", "clip_lora_match_tpu_torch.api.serve", "--help"],
                         cwd=REPO, capture_output=True, text=True, timeout=120, check=True).stdout
    for flag in ("--host", "--port", "--data-dir", "--db", "--index-quantize", "--binding",
                 "--clip-config", "--weights", "--lora", "--seed", "--device"):
        assert flag in out
    assert "--lora-epoch" not in out  # the JAX script's flags the port cannot honour stay out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tserve.main(["--port", "0", "--binding", "stdlib"])


def _tiny_clip_yaml(path) -> str:
    arch = "".join(f"    {k}: {v}\n" for k, v in dict(
        image_size=64, patch_size=32, vision_width=128, vision_layers=1, vision_heads=2, vision_mlp_dim=256,
        text_width=128, text_layers=1, text_heads=2, text_mlp_dim=256, vocab_size=514, projection_dim=64,
    ).items())
    path.write_text(f"model:\n  name: openai/clip-vit-base-patch32\n  arch:\n{arch}")
    return str(path)


def test_serve_entry_point_on_the_cpu(tmp_path):
    """``python -m clip_lora_match_tpu_torch.api.serve --device cpu`` prints
    its flushed port line and answers over a real socket."""
    stderr = (tmp_path / "serve.stderr").open("w")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONUNBUFFERED"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "clip_lora_match_tpu_torch.api.serve", "--device", "cpu", "--binding", "stdlib",
         "--host", "127.0.0.1", "--port", "0", "--clip-config", _tiny_clip_yaml(tmp_path / "clip.yaml"),
         "--data-dir", str(tmp_path / "data"), "--db", str(tmp_path / "db.sqlite")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=stderr, text=True,
    )
    try:
        port, deadline = None, time.time() + 120
        while port is None and time.time() < deadline:
            line = proc.stdout.readline()
            if not line and proc.poll() is not None:
                break
            m = re.search(r"listening on http://[^:]+:(\d+)", line)
            port = int(m.group(1)) if m else None
        assert port, f"no port line; rc={proc.poll()} stderr={(tmp_path / 'serve.stderr').read_text()[-800:]}"
        status, _, body = _request(f"http://127.0.0.1:{port}/health")
        assert status == 200 and body == {"status": "ok"}
        status, _, res = _request(f"http://127.0.0.1:{port}/api/search", "POST",
                                  *_multipart({"description": "tas"}))
        assert status == 200 and res["results"] == []  # a fresh, empty index
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
        stderr.close()


def test_fastapi_binding_is_import_gated():
    from clip_lora_match_tpu_torch.api import main

    try:
        import fastapi  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="fastapi"):
            main.create_app()
    else:
        pytest.skip("fastapi is installed here: the gate is not reached")
