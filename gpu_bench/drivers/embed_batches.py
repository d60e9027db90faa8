"""embed_batches: one caller in a closed loop submitting image batches.

The caller hands ``ClipEncoder.encode_image_batch`` one batch of decoded,
CLIP-normalized fp32 pixels at a time (the index build's unit; JPEG decode
is left out) and submits the next when it returns. A pool of distinct
seeded batches is made in set-up and cycled. ``images_per_s`` is every
image embedded over all the window's time, the last batch's overrun
included.

The check, once the window has closed and the program is freed: over a
seeded sample of the images the window embedded, ``embed_err``, the largest
cosine distance (1 - cos) between a served embedding and the reference's
fp32 LoRA image tower over the same pixels. Control: ``int8_tower`` serves the towers W8A8
(the port's ``quantize="int8"``).
"""

from __future__ import annotations

import math
import time

import numpy as np

from gpu_bench.harness import program, seeds, traffic
from gpu_bench.reference import clip as ref_clip


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.tr = {**ctx.traffic, **ctx.cell.get("load", {})}
        self.attempted = 0
        self.failed = 0
        self.errors: list[str] = []

    def _pixels(self, j: int):
        w = self.ctx.config["widths"]
        u8 = traffic.pixels_u8(self.tr["batch"], w["image_size"], self.ctx.seed, self.ctx.device, f"pixels{j}")
        return traffic.clip_normalize(u8)

    def setup(self) -> None:
        program.build_kernels(self.ctx.device)
        self.enc = program.encoder(self.ctx, quantize="int8" if self.ctx.control == "int8_tower" else None)
        self.pool = [self._pixels(j).cpu().numpy() for j in range(self.tr["pool_batches"])]
        for _ in range(2):
            self.enc.encode_image_batch(self.pool[0])

    def window(self, seconds: float, sub) -> float:
        self.spans: list[tuple[float, float, bool]] = []
        self.outs: list[tuple[int, np.ndarray]] = []
        t0 = time.perf_counter()
        if sub is not None:
            sub.begin(t0)
        i = 0
        while time.perf_counter() - t0 < seconds:
            if sub is not None:
                sub.tick()
            j = i % len(self.pool)
            s, ok = time.perf_counter(), True
            try:
                out = self.enc.encode_image_batch(self.pool[j])
                self.outs.append((j, out))
            except Exception as e:  # a failed batch embeds nothing
                self.failed += 1
                self.errors.append(repr(e))
                ok = False
            self.spans.append((s, time.perf_counter(), ok))
            i += 1
        self.t0, self.t_end = t0, time.perf_counter()
        self.attempted = i
        self.window_s = self.t_end - t0
        return self.window_s

    def images(self) -> int:
        return len(self.outs) * self.tr["batch"]

    def end_to_end(self) -> dict:
        return {"images_per_s": self.images() / self.window_s}

    def free(self) -> None:
        del self.enc
        program.free_device(self.ctx.device)

    def check(self) -> dict:
        import torch

        if not self.outs:
            return {"embed_err": math.inf}
        B = self.tr["batch"]
        r = seeds.rng(self.ctx.seed, "check")
        picks = sorted(set(r.choice(len(self.outs) * B, size=min(self.tr["check_images"], len(self.outs) * B),
                                    replace=False).tolist()))
        params, lora, scaling = program.seeded_weights(self.ctx)
        self.embed_errs: list[float] = []
        by_batch: dict[int, list[int]] = {}
        for p in picks:
            by_batch.setdefault(self.outs[p // B][0], []).append(p)
        w = self.ctx.config["widths"]
        with torch.no_grad(), ref_clip.precision(False):
            for j, ps in sorted(by_batch.items()):
                pix = self._pixels(j)
                rows = torch.tensor([p % B for p in ps], device=self.ctx.device)
                ref = torch.cat([ref_clip.unit(ref_clip.image_features(params, lora, pix[rows[a:a + 8]], w, scaling))
                                 for a in range(0, len(ps), 8)])
                got = torch.as_tensor(np.stack([self.outs[p // B][1][p % B] for p in ps]), device=self.ctx.device)
                self.embed_errs += (1.0 - torch.nn.functional.cosine_similarity(got.double(), ref.double())).tolist()
        return {"embed_err": max(self.embed_errs)}
