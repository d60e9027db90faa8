"""seek_closed_loop: independent seekers in a closed loop.

A fixed number of seekers (the cell's ``seekers``), each a thread that calls
``SeekerService.search_items(description=...)`` again as soon as its last
call returned, with no think time. The service is wired as
``api/wiring.py::build_services`` wires it for the HTTP bindings: one
``QueuedEncoder`` (the batch queue at ``max_batch`` and ``linger_ms``) in
front of the ``ClipEncoder``, and the device-resident ``EmbeddingIndex``
passed in as ``index=``. The index holds seeded unit rows, made on the
device and handed over through the host with ``normalize=False``.

Request ``i`` searches text ``i`` of a pool drawn from the seed (cycled if a
window outruns it); the pool's token lengths are one fixed multiset,
permuted by the seed. Enough seekers keep the service saturated, so
``queries_per_s``, the requests that returned inside the window per second
of it, is what the service can serve: no offered rate caps it. When the
window closes no seeker starts another request; those in flight are waited
for (a minute at most) and checked, and one that raises or never returns
counts as failed. The benchmark's own wrappers record the spans: an encoder
proxy behind the ``QueuedEncoder`` (each batched text-tower pass: its size
and host time) and a wrapper around ``SearchIndex.search_with_embedding``
(its host time, and the query embedding the search was given).

The check, once the window has closed and the program is freed, takes a
seeded sample of the window's requests with the longest texts in it:
``tower_err``, the largest cosine distance (1 - cos) between a served query
embedding and the reference's fp32 LoRA text tower over the reference
tokenizer's ids;
``search_err``, over each served result, the largest of its score's
distance from the exact fp32 cosine of its row, the gap by which that
cosine lies below the exact top-k's score at its rank, and its score's
distance from that exact score; a result that names a row twice reads
infinite. The queries are the served embeddings (the search is judged on
what it was given).
Controls: ``int8_tower`` serves the towers W8A8 (the port's
``quantize="int8"``), ``bf16_index`` holds the index in bf16 (the port's
``storage_dtype="bfloat16"``).
"""

from __future__ import annotations

import itertools
import math
import threading
import time

import numpy as np

from gpu_bench.harness import program, seeds, traffic
from gpu_bench.reference import clip as ref_clip
from gpu_bench.reference.tokenizer import ByteTokenizer
from gpu_bench.reference.topk import exact_topk

WAIT_AFTER_CLOSE_S = 60.0


class TimedEncoder:
    """The encoder behind the batch queue: counts and times the worker's
    batched text-tower passes; everything else goes to the encoder."""

    def __init__(self, encoder):
        self._encoder = encoder
        self.calls: list[tuple[float, float, int]] = []
        self.recording = False

    def encode_text(self, text, normalize: bool = True):
        t0 = time.perf_counter()
        out = self._encoder.encode_text(text, normalize=normalize)
        if self.recording and not isinstance(text, str):
            self.calls.append((t0, time.perf_counter(), len(text)))
        return out

    def __getattr__(self, name):
        return getattr(self._encoder, name)


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.tr = {**ctx.traffic, **ctx.cell.get("load", {})}
        self.attempted = 0
        self.failed = 0
        self.errors: list[str] = []

    # -- set-up ----------------------------------------------------------------

    def setup(self) -> None:
        from clip_lora_match_tpu_torch.index.store import EmbeddingIndex
        from clip_lora_match_tpu_torch.services import QueuedEncoder, SeekerConfig, SeekerService

        ctx, tr = self.ctx, self.tr
        program.build_kernels(ctx.device)
        self.N, self.D = tr["index_rows"], ctx.config["widths"]["projection_dim"]
        self.k = tr["top_k"]
        enc = program.encoder(ctx, quantize="int8" if ctx.control == "int8_tower" else None)
        self.proxy = TimedEncoder(enc)
        self.queued = QueuedEncoder(self.proxy, max_batch=tr["max_batch"], linger_ms=tr["linger_ms"])
        # the rows cross the host once: EmbeddingIndex takes host arrays
        host = np.empty((self.N, self.D), np.float32)
        for start, rows in traffic.unit_rows(self.N, self.D, ctx.seed, ctx.device):
            host[start:start + rows.shape[0]] = rows.cpu().numpy()
            del rows
        storage = "bfloat16" if ctx.control == "bf16_index" else "float32"
        index = EmbeddingIndex(host, normalize=False, storage_dtype=storage, device=ctx.device)
        del host
        self.seeker = SeekerService(self.queued, SeekerConfig(top_k=self.k), index=index)
        self._wrap_search()

        words = ctx.bench.data_file(tr["words"])
        lo, hi = tr["token_lengths"]
        self.lengths = traffic.token_lengths(tr["text_pool"], lo, hi, ctx.seed)
        self.texts = traffic.texts(words, self.lengths, ctx.seed, "queries")
        self._warm(words)

    def length(self, i: int) -> int:
        """Token length of request ``i``'s text."""
        return int(self.lengths[i % len(self.lengths)])

    def _wrap_search(self) -> None:
        search = self.seeker._search
        orig = search.search_with_embedding
        self.local = threading.local()
        self.search_spans: list[tuple[float, float]] = []
        self.queries: dict[int, np.ndarray] = {}
        self.recording = False

        def timed(query, k=5):
            t0 = time.perf_counter()
            out = orig(query, k)
            rid = getattr(self.local, "rid", None)
            if self.recording and rid is not None:
                self.search_spans.append((t0, time.perf_counter()))
                self.queries[rid] = np.array(query, np.float32)
            return out

        search.search_with_embedding = timed

    def _warm(self, words) -> None:
        """Every bucket of the batch queue (1-64 texts at the cell's token
        widths), the tokenizer's native build, and the seekers."""
        r = seeds.rng(self.ctx.seed, "warm")
        self.warm_texts = [traffic.text_of_length(words, int(n), r) for n in (8, 24, 40)] * 22
        b = 1
        while b <= self.tr["max_batch"]:
            self.proxy.encode_text(self.warm_texts[:b])
            b *= 2
        self.start_seekers(self.tr["seekers"])

    def start_seekers(self, n: int) -> None:
        """``n`` seeker threads, each of which makes one search and then
        waits for the window: the window's threads have made their library
        handles before it opens."""
        self.go, self.stop = threading.Event(), threading.Event()
        warmed = threading.Barrier(n + 1)
        self.ids = itertools.count()
        self.start: dict[int, float] = {}
        self.done: dict[int, float] = {}
        self.results: dict[int, list[tuple[int, float]]] = {}

        def seeker(j: int):
            self.seeker.search_items(description=self.warm_texts[j % len(self.warm_texts)])
            warmed.wait()
            self.go.wait()
            while not self.stop.is_set():
                i = next(self.ids)
                self.start[i] = time.perf_counter()
                self.local.rid = i
                try:
                    res = self.seeker.search_items(description=self.texts[i % len(self.texts)])
                    self.done[i] = time.perf_counter()
                    self.results[i] = [(int(x.index), float(x.score)) for x in res]
                except Exception as e:  # a failed request counts as failed
                    self.errors.append(repr(e))
                finally:
                    self.local.rid = None

        self.pool = [threading.Thread(target=seeker, args=(j,), daemon=True) for j in range(n)]
        for t in self.pool:
            t.start()
        warmed.wait()

    # -- the window --------------------------------------------------------------

    def window(self, seconds: float, sub) -> float:
        self.recording = self.proxy.recording = True
        t0 = time.perf_counter()
        if sub is not None:
            sub.begin(t0)
        self.go.set()
        while True:
            now = time.perf_counter()
            if now >= t0 + seconds:
                break
            if sub is not None:
                sub.tick()
            time.sleep(min(0.02, t0 + seconds - now))
        self.stop.set()
        deadline = time.perf_counter() + WAIT_AFTER_CLOSE_S
        for t in self.pool:
            t.join(timeout=max(0.0, deadline - time.perf_counter()))
        self.recording = self.proxy.recording = False
        self.proxy_calls = list(self.proxy.calls)
        self.t0 = t0
        self.attempted = len(self.start)
        self.failed = sum(1 for i in self.start if i not in self.results)
        return seconds

    def latencies_ms(self) -> np.ndarray:
        return np.array([(self.done.get(i, math.inf) - s) * 1e3 for i, s in sorted(self.start.items())])

    def end_to_end(self) -> dict:
        """Queries returned inside the window per second of it: the seekers
        keep the service saturated all through the window, and this is what
        it serves."""
        close = self.t0 + self.ctx.seconds
        return {"queries_per_s": sum(1 for t in self.done.values() if t <= close) / self.ctx.seconds}

    # -- the check ---------------------------------------------------------------

    def free(self) -> None:
        self.queued.close()
        del self.seeker, self.queued, self.proxy
        program.free_device(self.ctx.device)

    def _sample(self) -> list[int]:
        served = sorted(i for i in self.results if i in self.queries)
        m = min(self.tr["check_requests"], len(served))
        picked = set(seeds.rng(self.ctx.seed, "check").choice(served, size=m, replace=False).tolist())
        longest = sorted(served, key=lambda i: (-self.length(i), i))[: self.tr["check_longest"]]
        return sorted(picked | set(longest))

    def check(self) -> dict:
        import torch

        ctx = self.ctx
        sample = self._sample()
        if not sample:
            return {"tower_err": math.inf, "search_err": math.inf}
        params, lora, scaling = program.seeded_weights(ctx)
        tok = ByteTokenizer(length=ctx.config["widths"]["max_text_length"])
        ids = torch.as_tensor(tok([self.texts[i % len(self.texts)] for i in sample]), device=ctx.device)
        with torch.no_grad(), ref_clip.precision(False):
            ref = ref_clip.unit(ref_clip.text_features(params, lora, ids, ctx.config["widths"], tok.eot, scaling))
        del params, lora
        served = torch.as_tensor(np.stack([self.queries[i] for i in sample]), device=ctx.device)
        # 1 - cos: the served embedding against the reference's
        self.tower_errs = (1.0 - torch.nn.functional.cosine_similarity(served.double(), ref.double())).tolist()
        tower_err = max(self.tower_errs)

        q = served.double()
        q = (q / q.norm(dim=1, keepdim=True)).float()
        results = [self.results[i] for i in sample]
        if any(len(r) != self.k or len({x[0] for x in r}) != self.k for r in results):
            return {"tower_err": tower_err, "search_err": math.inf}  # short, or a row named twice
        got_ids = torch.tensor([[x[0] for x in r] for r in results], device=ctx.device)
        got_s = torch.tensor([[x[1] for x in r] for r in results], device=ctx.device)
        blocks = traffic.unit_rows(self.N, self.D, ctx.seed, ctx.device)
        with torch.no_grad():
            best, _, own = exact_topk(q, blocks, self.k, ids=got_ids.long())
        err = torch.maximum(torch.maximum((got_s - own).abs(), best - own), (got_s - best).abs())
        search_err = float(err.max())
        if math.isnan(search_err):  # an id outside the index
            search_err = math.inf
        return {"tower_err": tower_err, "search_err": search_err}
