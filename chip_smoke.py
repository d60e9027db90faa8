#!/usr/bin/env python3
"""Drive the PyTorch port's seeker read path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
1. environment: the card's name and power limit, torch/CUDA versions, and the
   build of every kernel in clip_lora_match_tpu_torch/ops/csrc/ (one nvcc per
   source, all at once) into build/torch_kernels/;
2. each kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it, with kernel / plain / library times and the bound;
3. the main path at full ViT-B/32 width with a seeded r=8, alpha=16 LoRA:
   text, image and fused SeekerService.search_items requests over a
   44,446-row fp32 index, self-retrieval checks, launch-count checks, a
   96-image / 256-text batch held against the plain fp32 path, request
   latency, host preprocessing time, batch throughput, and device time by
   kernel (torch.profiler) for one fused request and one 96-image batch.
The last line is {"ok": true, "device": {...}}; the line before it is the
kernel table as JSON. Exits non-zero without a CUDA device or without the
port's package beside it.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
SEED = 0
INDEX_ROWS = 44_436  # random unit rows; +5 texts +5 images = 44,446
# a CPU encoder built beside the card's (head_dim 64, two layers a tower)
TINY_ARCH = dict(
    image_size=64, patch_size=32, vision_width=128, vision_layers=2, vision_heads=2,
    vision_mlp_dim=256, text_width=128, text_layers=2, text_heads=2, text_mlp_dim=256,
    projection_dim=64,
)
REPO = os.path.dirname(os.path.abspath(__file__))
# wrapper name -> (CUDA source stem, the TPU kernel's pallas_call site)
KERNELS = {
    "attention_small": ("attention_small", "clip_lora_match_tpu/ops/attention_small.py:302"),
    "lora_matmul": ("lora_matmul", "clip_lora_match_tpu/ops/lora_matmul.py:84"),
    "topk_retrieve": ("retrieval_topk", "clip_lora_match_tpu/ops/retrieval_topk.py:150"),
}


def log(*parts) -> None:
    print(*parts, flush=True)


def bound_ms(nbytes: float, flops: float, kind: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_attention(torch, ops_attn, gen):
    rows = []
    worst = 0.0
    f32, bf16 = torch.float32, torch.bfloat16
    # (B, S, H, causal, dtype). The image tower's residual stream is fp32
    # (float pixels in), so its attention runs fp32 and maskless; the text
    # tower runs bf16 and causal at S=64 (sliced) or 77.
    shapes = [
        (1, 50, 12, False, f32), (96, 50, 12, False, f32),
        (1, 50, 12, False, bf16), (96, 50, 12, False, bf16),
        (1, 64, 8, True, bf16), (256, 64, 8, True, bf16),
        (1, 77, 8, True, bf16), (256, 77, 8, True, bf16),
    ]
    for B, S, H, causal, dtype in shapes:
        kind = "fp32" if dtype == f32 else "bf16"
        q, k, v = (
            torch.randn(B, S, H, 64, device="cuda", generator=gen).to(dtype) for _ in range(3)
        )
        got = ops_attn.attention_small(q, k, v, causal=causal)
        ref = ops_attn.attention_small_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        # bf16: P is rounded to bf16 before P.V; fp32: summation order only
        tol = 2e-2 if dtype == bf16 else 1e-5
        if not err <= tol:
            raise AssertionError(f"attention_small B={B} S={S} causal={causal} {kind}: max err {err}")
        worst = max(worst, err)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        pairs = S * (S + 1) // 2 if causal else S * S
        b_ms, b_by = bound_ms(
            4 * B * S * H * 64 * q.element_size(), 4 * B * H * pairs * 64, kind
        )
        rows.append(dict(
            shape=f"B={B} S={S} H={H} hd=64 {'causal' if causal else 'maskless'} {kind}",
            ms=cuda_ms(torch, lambda: ops_attn.attention_small(q, k, v, causal=causal)),
            plain_ms=cuda_ms(torch, lambda: ops_attn.attention_small_plain(q, k, v, causal=causal)),
            library_ms=cuda_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=causal)),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
        ))
    return rows, worst


def check_lora(torch, ops_lora, gen):
    rows = []
    worst = 0.0
    r, s = 8, 2.0
    for M, D in ((50, 768), (96 * 50, 768), (64, 512), (256 * 64, 512)):
        bf = torch.bfloat16
        x = torch.randn(M, D, device="cuda", generator=gen).to(bf)
        w = (torch.randn(D, D, device="cuda", generator=gen) * D ** -0.5).to(bf)
        a = (torch.randn(D, r, device="cuda", generator=gen) * D ** -0.5).to(bf)
        b = (torch.randn(r, D, device="cuda", generator=gen) * 0.05).to(bf)
        got = ops_lora.lora_matmul(x, w, a, b, s)
        ref = ops_lora.lora_matmul_plain(x, w, a, b, s)
        torch.cuda.synchronize()
        scale = ref.float().abs().max().item()
        err = (got.float() - ref.float()).abs().max().item()
        if not err <= 1e-2 * scale:
            raise AssertionError(f"lora_matmul M={M} D={D}: max err {err} vs scale {scale}")
        worst = max(worst, err)
        nbytes = (M * D + D * D + D * r + r * D + M * D) * 2
        flops = 2 * M * D * D + 2 * M * r * (D + D)
        b_ms, b_by = bound_ms(nbytes, flops, "bf16")
        rows.append(dict(
            shape=f"M={M} K=N={D} r={r} bf16",
            ms=cuda_ms(torch, lambda: ops_lora.lora_matmul(x, w, a, b, s)),
            plain_ms=cuda_ms(torch, lambda: ops_lora.lora_matmul_plain(x, w, a, b, s)),
            library_ms=cuda_ms(
                torch, lambda: torch.addmm(torch.mm(torch.mm(x, a), b), x, w, beta=s)
            ),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
        ))
    return rows, worst


def check_topk(torch, ops_topk, gen):
    rows = []
    worst = 0.0
    N, D = 44_441, 512
    base = torch.nn.functional.normalize(
        torch.randn(N, D, device="cuda", generator=gen), dim=1
    )
    for dtype, kind in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        index = base.to(dtype)
        for Q in (1, 64):
            queries = torch.randn(Q, D, device="cuda", generator=gen)
            for k in (5, 64):
                s, i = ops_topk.topk_retrieve(queries, index, k)
                rs, ri = ops_topk.topk_retrieve_plain(queries, index, k)
                torch.cuda.synchronize()
                err = (s - rs).abs().max().item()
                if not err <= 1e-5:
                    raise AssertionError(f"topk_retrieve Q={Q} k={k} {kind}: score err {err}")
                # ids must agree wherever the plain scores are distinct: a
                # swap is allowed only between positions within 1e-5 of a tie
                diff = (i != ri)
                if diff.any():
                    gap = torch.minimum(
                        torch.nn.functional.pad((rs[:, :-1] - rs[:, 1:]), (0, 1), value=1.0),
                        torch.nn.functional.pad((rs[:, :-1] - rs[:, 1:]), (1, 0), value=1.0),
                    )
                    if (gap[diff] > 1e-5).any():
                        raise AssertionError(f"topk_retrieve Q={Q} k={k} {kind}: ids differ")
                worst = max(worst, err)
                qn = torch.nn.functional.normalize(queries, dim=1).to(dtype)
                nbytes = N * D * index.element_size() + Q * D * 4 + Q * k * 8
                b_ms, b_by = bound_ms(nbytes, 2 * Q * N * D, kind)
                rows.append(dict(
                    shape=f"Q={Q} N={N} D={D} k={k} {kind} index",
                    ms=cuda_ms(torch, lambda: ops_topk.topk_retrieve(queries, index, k)),
                    plain_ms=cuda_ms(torch, lambda: ops_topk.topk_retrieve_plain(queries, index, k)),
                    library_ms=cuda_ms(torch, lambda: torch.topk(qn @ index.T, k)),
                    bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                ))
    return rows, worst


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


def _host_ms(fn, reps: int = 10) -> float:
    samples = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        samples.append((time.perf_counter() - t) * 1e3)
    return statistics.median(samples)


def profile_device_time(torch, name: str, fn, wall_ms: float, card: str) -> None:
    """Device time of one call by kernel (torch.profiler), beside the call's
    unprofiled wall time: the idle share is 1 - device / wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per: dict[str, list] = {}
    for e in prof.events():  # device-side activities only: kernels and copies
        if e.device_type == DeviceType.CUDA:
            row = per.setdefault(e.name, [0.0, 0])
            row[0] += e.time_range.elapsed_us() / 1e3
            row[1] += 1
    rows = [(ms, count, key) for key, (ms, count) in per.items()]
    if not rows:
        log(f"{name}: device time not measured (the profiler saw no device activity)")
        return
    rows.sort(reverse=True)
    dev_ms = sum(r[0] for r in rows)
    log(f"{name}: device busy {dev_ms:.4f} ms of {wall_ms:.4f} ms wall "
        f"(idle share {1 - dev_ms / wall_ms:.3f}) [{card}]")
    for ms, count, key in rows[:8]:
        log(f"  {ms:9.4f} ms  x{count:<4d} {key[:90]}")


def main_path(torch, card: str):
    from PIL import Image

    from clip_lora_match_tpu_torch import ops
    from clip_lora_match_tpu_torch.core.config import ClipArchConfig, ClipConfig, LoraConfig
    from clip_lora_match_tpu_torch.index.build import read_custom_items_csv
    from clip_lora_match_tpu_torch.index.store import EmbeddingIndex
    from clip_lora_match_tpu_torch.lora.adapter import init_lora
    from clip_lora_match_tpu_torch.models.clip import init_params
    from clip_lora_match_tpu_torch.models.encoder import ClipEncoder
    from clip_lora_match_tpu_torch.services.seeker import SeekerConfig, SeekerService

    arch = ClipArchConfig()  # ViT-B/32 at full width and depth
    lcfg = LoraConfig()  # r=8, alpha=16 on q/k/v/out_proj
    t0 = time.perf_counter()
    params = init_params(SEED, arch, device="cuda")
    lora = init_lora(SEED + 1, arch, lcfg, device="cuda")
    rng = np.random.default_rng(SEED + 2)
    for tower in lora.values():
        for proj in tower["blocks"]["attn"].values():
            proj["b"] = torch.from_numpy(
                rng.normal(0.0, 0.02, tuple(proj["b"].shape)).astype(np.float32)
            ).cuda()
    enc = ClipEncoder(params, arch=arch, config=ClipConfig(arch=arch), device="cuda")
    enc.attach_lora(lora, lcfg.scaling)
    if enc.compute_dtype != torch.bfloat16:
        raise AssertionError(f"expected bf16 compute on CUDA, got {enc.compute_dtype}")
    # a CPU encoder beside the card's one: kernel dispatch is decided per
    # tensor, so it must not turn the card's kernels off (the launch counts
    # below would show it)
    tiny = ClipArchConfig(**TINY_ARCH)
    cpu_enc = ClipEncoder(
        init_params(SEED, tiny, device="cpu"), arch=tiny, config=ClipConfig(arch=tiny), device="cpu"
    )
    cpu_enc.attach_lora(init_lora(SEED + 1, tiny, lcfg, device="cpu"), lcfg.scaling)
    if not np.isfinite(cpu_enc.encode_text("tas pink")).all():
        raise AssertionError("CPU encoder: non-finite embedding")

    paths, texts = read_custom_items_csv(os.path.join(REPO, "data/custom/my_items.csv"))
    paths = [os.path.join(REPO, p) for p in paths]
    images = [Image.open(p).convert("RGB") for p in paths]
    noise = rng.standard_normal((INDEX_ROWS, arch.projection_dim), dtype=np.float32)
    index = EmbeddingIndex(noise, device="cuda", capacity=INDEX_ROWS + 16)
    text_rows = [index.append(enc.encode_text(t), paths[i], texts[i]) for i, t in enumerate(texts)]
    image_rows = [index.append(enc.encode_image(im), paths[i], texts[i]) for i, im in enumerate(images)]
    if len(index) != INDEX_ROWS + 10:
        raise AssertionError(f"index has {len(index)} rows")
    svc = SeekerService(enc, SeekerConfig(), index=index)
    torch.cuda.synchronize()
    log(f"main path set-up: {time.perf_counter() - t0:.3f} s; index rows {len(index)} "
        f"({index.embeddings.numel() * 4 / 1e6:.1f} MB fp32 on the device)")

    # -- the run whose launches are counted ---------------------------------
    ops.reset_launch_counts()
    text_res = [svc.search_items(description=t) for t in texts]
    image_res = [svc.search_items(image_path=im) for im in images]
    both_res = [svc.search_items(description=t, image_path=im) for t, im in zip(texts, images)]
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    log("main path launches:", json.dumps(counts))

    n = len(texts)
    layers = arch.vision_layers  # == text_layers for B/32
    want = {
        "attention_small": 4 * n * layers,      # 12 per single-tower request
        "lora_matmul": 4 * 4 * n * layers,      # q/k/v/out per layer per tower
        "topk_retrieve": 3 * n,                 # one search per request
    }
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    # the text, image and fused rounds together make two text+image requests
    # per item, and three searches per item
    log(f"per text+image request: attention_small {counts['attention_small'] // (2 * n)}, "
        f"lora_matmul {counts['lora_matmul'] // (2 * n)}, "
        f"topk_retrieve {counts['topk_retrieve'] // (3 * n)} per search")

    for i in range(n):
        t0r, i0r = text_res[i][0], image_res[i][0]
        if t0r.index != text_rows[i] or t0r.score < 0.99:
            raise AssertionError(f"text query {i}: top {t0r.index} {t0r.score}")
        if i0r.index != image_rows[i] or i0r.score < 0.99:
            raise AssertionError(f"image query {i}: top {i0r.index} {i0r.score}")
        top5 = {r.index for r in both_res[i]}
        if not {text_rows[i], image_rows[i]} <= top5 or len(both_res[i]) != 5:
            raise AssertionError(f"fused query {i}: top-5 {sorted(top5)}")
    log("self-retrieval: text and image queries return their own rows first "
        f"(min score {min(min(r[0].score for r in text_res), min(r[0].score for r in image_res)):.6f}); "
        "fused queries hold both rows in their top 5")

    # -- request latency -----------------------------------------------------
    lat = {}
    for name, call in (
        ("text", lambda: svc.search_items(description=texts[0])),
        ("image", lambda: svc.search_items(image_path=images[0])),
        ("both", lambda: svc.search_items(description=texts[0], image_path=images[0])),
    ):
        call()
        samples = []
        for _ in range(10):
            torch.cuda.synchronize()
            t = time.perf_counter()
            call()
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t) * 1e3)
        lat[name] = statistics.median(samples)
    log(f"seeker request latency, median of 10 (ms): {json.dumps(lat)} [{card}]")
    host = {
        "tokenize_ms": _host_ms(lambda: enc.preprocessor.preprocess_text(texts[0])),
        "image_preprocess_ms": _host_ms(lambda: enc.preprocessor.preprocess_images(images[:1])),
    }
    log(f"host preprocessing per request, median of 10: {json.dumps(host)}")
    profile_device_time(
        torch, "fused request",
        lambda: svc.search_items(description=texts[0], image_path=images[0]), lat["both"], card,
    )

    # -- batch: kernel path (bf16) against the plain path (fp32) ---------------
    pix = np.clip(rng.normal(0.0, 1.0, (96, arch.image_size, arch.image_size, 3)), -2, 2)
    pix = pix.astype(np.float32)
    pix[: n] = enc.preprocessor.preprocess_images(images)
    batch_texts = [f"{texts[i % n]} nomor {i}" for i in range(256)]
    tok = enc.preprocessor.preprocess_text(batch_texts)
    img_k = enc.encode_image_batch(pix)
    txt_k = enc.encode_text_batch(tok["input_ids"], tok["attention_mask"])
    thr = {}
    for name, call, count in (
        ("images_per_s", lambda: enc.encode_image_batch(pix), 96),
        ("texts_per_s", lambda: enc.encode_text_batch(tok["input_ids"], tok["attention_mask"]), 256),
    ):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(5):
            call()
        torch.cuda.synchronize()
        thr[name] = 5 * count / (time.perf_counter() - t)
    log(f"batch throughput (96 images, 256 texts, host preprocessing excluded): "
        f"{json.dumps(thr)} [{card}]")
    profile_device_time(
        torch, "96-image batch", lambda: enc.encode_image_batch(pix), 96e3 / thr["images_per_s"], card
    )

    # the plain path on the card: fp32 compute, kernels off for this encoder
    plain = ClipEncoder(
        params, arch=arch, config=ClipConfig(arch=arch, use_pallas_kernels=False),
        compute_dtype="float32", device="cuda",
    )
    plain.attach_lora(lora, lcfg.scaling)
    ops.reset_launch_counts()
    img_p = plain.encode_image_batch(pix)
    txt_p = plain.encode_text_batch(tok["input_ids"], tok["attention_mask"])
    if any(ops.launch_counts().values()):
        raise AssertionError(f"plain encoder launched kernels: {ops.launch_counts()}")
    for name, got, ref in (("image", img_k, img_p), ("text", txt_k, txt_p)):
        if got.shape != ref.shape or not np.isfinite(got).all():
            raise AssertionError(f"{name} batch: shape {got.shape} or non-finite values")
        cos = (got * ref).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(ref, axis=1))
        if not cos.min() >= 0.99:
            raise AssertionError(f"{name} batch: min cosine {cos.min()} < 0.99")
        log(f"{name} batch kernel path (bf16) vs plain path (fp32): min cosine {cos.min():.6f}")
    return counts, lat, thr


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from clip_lora_match_tpu_torch.ops import _build
    except ImportError:
        print("chip_smoke: the clip_lora_match_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    from clip_lora_match_tpu_torch.ops import attention_small as ops_attn
    from clip_lora_match_tpu_torch.ops import lora_matmul as ops_lora
    from clip_lora_match_tpu_torch.ops import retrieval_topk as ops_topk

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t = time.perf_counter()
    logs = _build.build_all()
    log(f"kernel build: {time.perf_counter() - t:.2f} s ({len(logs)} sources in parallel)")
    for name, text in logs.items():
        for line in text.splitlines():
            if "Used" in line:
                log(f"  {name}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = {}
    for name, fn, mod in (
        ("attention_small", check_attention, ops_attn),
        ("lora_matmul", check_lora, ops_lora),
        ("topk_retrieve", check_topk, ops_topk),
    ):
        rows, worst = fn(torch, mod, gen)
        results[name] = (rows, worst)
        for row in rows:
            log(f"{name} {row['shape']}: kernel_ms {row['ms']:.5f} plain_ms {row['plain_ms']:.5f} "
                f"library_ms {row['library_ms']:.5f} bound_ms {row['bound_ms']:.5f} "
                f"({row['bound_by']}) max_abs_err {row['max_abs_err']:.3e} [{card}]")

    counts, _, _ = main_path(torch, card)

    table = []
    for name, (rows, worst) in results.items():
        stem, site = KERNELS[name]
        row = rows[0]  # the seeker's per-request shape
        table.append({
            "name": name, "route": "cuda",
            "source": f"clip_lora_match_tpu_torch/ops/csrc/{stem}.cu",
            "replaces": site, "launches": counts[name], "max_abs_err": worst,
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"], "shape": row["shape"],
        })
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": table}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
