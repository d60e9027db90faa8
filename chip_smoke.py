#!/usr/bin/env python3
"""Drive the PyTorch port's paths (seeker, finder, training, evaluation) on
one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only topk_retrieve   # build and check one kernel (phase 2 only)
    python3 chip_smoke.py --only tilemax         # the three pass-1 kernels and the bodies' crossover
    python3 chip_smoke.py --stop-after 3         # phases 1-3 (an A/B of the main path's latency)
    python3 chip_smoke.py --stop-after 6         # phases 1-6 (an A/B without the image-file phase)
    python3 chip_smoke.py --stop-after 7         # phases 1-7 (an A/B without the W8A8 phase)
    python3 chip_smoke.py --stop-after 8         # phases 1-8 (an A/B without the training phase)
    python3 chip_smoke.py --stop-after 9         # phases 1-9 (an A/B without the evaluation phase)
    python3 chip_smoke.py --stop-after 10        # phases 1-10 (an A/B without the data axis)
    python3 chip_smoke.py --stop-after 11        # phases 1-11 (an A/B without the model axes)
    python3 chip_smoke.py --stop-after 12        # phases 1-12 (an A/B without approximate top-k and
                                                 # the last entry points)
    python3 chip_smoke.py --only approx_topk     # the bin-max kernel and the fused selection: phase 2's
                                                 # rows and phase 13 (a)'s over a seeded index

Phases (any failure raises and exits non-zero):
1. environment: the card's name and power limit, torch/CUDA versions, and the
   build of every kernel in clip_lora_match_tpu_torch/ops/csrc/ (one nvcc per
   source, all at once) into build/torch_kernels/;
2. each kernel against its plain PyTorch version on the card, at the shapes
   the main paths give it (lora_matmul per projection and as the grouped
   q/k/v launch, with the body and tiles its plan picks; topk_retrieve at
   Q = 1 and 64, k = 5 and 64, with the body that ran), with kernel / plain
   / library times (wall per call between CUDA events, and the kernel's and
   the library's device time from torch.profiler) and the bound (fp32 flash
   and fp32 pass 1 on its mma body at the 3xTF32 rate they compute at)
   (the bin-max kernel of approximate top-k, csrc/retrieval_binmax.cu, at
   Q = 1 and 64 over a seeded 44,446-row index in fp32 and bf16, k = 10, r =
   0.95, each row naming the body it took and the fused selection's launches
   a search, the selection bit-equal to the sort of the kernel's bins, with
   its recall and the exact route's time beside it; with --only approx_topk
   also phase 13 (a)'s rows over a seeded index of phase 3's size)
   (the pass-1 tile-max kernels over 524,298- and 1,048,586-row indexes at
   Q = 1, 16 (tilemax) and 64, each row naming the body its plan took, both
   bodies of tilemax (bf16, fp32) and of tilemax_sup_q8 (int8) at Q = 8, 16
   and 32, and the two-pass routes through them against the plain route);
3. the main path at full ViT-B/32 width with a seeded r=8, alpha=16 LoRA:
   text, image and fused SeekerService.search_items requests over a
   44,446-row fp32 index, self-retrieval checks, a k=300 search through
   SearchIndex (past the kernel's k <= 256: the exact mid-band route) held
   against the plain route, launch-count checks (two
   lora_matmul launches per adapted attention layer: q/k/v grouped, out), a
   96-image / 256-text batch held against the plain fp32 path, request
   latency, host preprocessing time, batch throughput, and device time by
   kernel (torch.profiler) for one fused request and one 96-image batch;
4. the same requests at HBM scale, each configuration with its own counted
   run: (a) a 1,048,586-row fp32 index (two-pass, tilemax_sup), (b) its first
   524,288 seeded rows and the 10 custom rows in a bf16 arena (tilemax),
   (c) (a) served from the int8 index (tilemax_sup_q8, hierarchical), (d) a
   44,446-row index served int8 (tilemax_sup_q8, flat route), each run's
   15 Q=1 searches on the CUDA-core body and its batch on the mma body; a
   64-query search_batch against the plain route, and its search's device and
   wall ms by the kernel route and the plain route on (a)-(d); request
   latency; then a
   FinderService.report_item into (c)'s index with a SqliteStore, found by
   the next search, the int8 copy extended by one row;
5. ViT-L/14-336 (ClipConfig(model_name="openai/clip-vit-large-patch14-336"),
   seeded full-width weights, r=8 alpha=16 LoRA) under flash_attention=True
   and fused_mlp=True, served through build_services (QueuedEncoder,
   SqliteStore, a 44,446-row D=768 index saved to a temp .npz): a counted
   run of text, image and fused requests with exact launch counts,
   self-retrieval, 8 concurrent searches coalesced by the queue, request
   latency, a 32-image batch against the plain fp32 path, device time by
   kernel, the image tower with flash and the fused MLP each on and off, and
   a report_item through the graph's finder found by the next search;
6. the YOLO crop stage and the HTTP API over phase 3's encoder and index:
   (a) both committed detectors (yolov8n_synth, yolov8n_real, 320²) on the
   card in bf16 and fp32 over the 5 custom photos and 6 held-out renders
   (the synth detector's IoU@0.5 recall >= 0.75, the bf16 top box within
   IoU 0.9 of the fp32 one with the same class), nms_fixed against its CPU
   run, n@320 detect latency at B=1 and a seeded YOLOv8-s at 640², B=16;
   (b) the device crop against its CPU run, SeekerService with
   use_yolo_crop on disk and on the device (the device crop serving every
   image query, launch counts), the fused search against the staged one
   (box, top-5 ids, scores), its latency and host syncs, and
   FinderService(use_yolo_crop=True); (c) the stdlib HTTP server
   (serve_background over build_services, a SqliteStore, the 44,446-row
   index saved to a temp .npz) over real sockets: health, report then
   search, image and text+image searches, items, 400s, launch counts per
   text search, 8 concurrent searches in fewer tower passes, and wire
   against in-process latency;
7. the image-file encode path (ClipEncoder.encode_image_files: the native
   JPEG loader, the uint8 feed normalized on the card, decode overlapped
   through prefetch, readback through pinned buffers) over 480 fashion
   renders written as JPEG and 192 photo-size (1200x1600) copies, after a
   check of which loader runs (native where g++ finds jpeglib.h, and then
   its build must succeed; PIL rows otherwise): (b), inside phase 5, one
   32-image batch at L/14-336 with flash and the fused MLP forced; (a), after
   phase 6, phase 3's B/32 encoder. Each part holds encode_image_files
   against encode_image over the same files (cosine > 0.999 in bf16, >
   0.9999 with fp32 compute), the DCT-scaled decode against the full one on
   the photos (>= 0.999), and one batch's launch counts, and prints the host
   decode ms of one batch and one batch's device busy, Memcpy HtoD and idle
   share beside the float feed's (torch.profiler); (a) adds images/s over
   the renders and the photos with the DCT-scaled decode on and off, and
   over the renders by host staging (pinned, pageable), and one batch's
   upload alone between CUDA events;
8. adapter and weight persistence and W8A8 int8 serving: (a) phase 3's
   adapter written by save_peft_adapter and save_lora, each read back by
   load_lora on the card bit for bit, ClipEncoder.save read back by
   load_params, and a from_config encoder over those weights and the PEFT
   directory giving phase 3's embeddings bit for bit; (b) ViT-B/32 built by
   from_config from a YAML with quantize: int8 and the PEFT adapter: the
   int8 product on the card against its CPU run (codes and int32 products
   bit-equal), text, image and fused requests over phase 3's index with
   exact launch counts (no lora_matmul, no mlp_fused, four int8 products a
   layer a tower pass), self-retrieval, cosine >= 0.995 against phase 3's
   float encoder, latency, one fused request's busy and idle share and a
   96-image batch's device ms beside the float encoder's, and the int8
   product's device ms at the B/32 and L/14-336 shapes beside bf16
   torch.matmul; (c), inside phase 5, one 32-image batch through the
   L/14-336 encoder rebuilt with quantize="int8" (flash forced): launches,
   cosine against the float batch, device ms by feed beside the float
   encoder's and device time by kind of kernel;
9. contrastive LoRA training over phase 3's encoder (ViT-B/32, fp32, the
   training precision): (a) the three differentiable kernels' gradients
   through their autograd Functions (lora_matmul, its grouped q/k/v launch
   adapter by adapter, attention_small maskless and causal+lengths,
   mlp_fused) against autograd through their plain versions at the B=128
   training shapes in fp32 and bf16, each backward's time beside its bound
   and the plain autograd backward's, flash_attention refusing a
   differentiable call, and one B/32 pass through both towers whose LoRA
   gradients under the default "auto" flags equal those with the kernels
   off; (b) train() through train/cli.py at full width on the in-repo CSVs
   (batch 6, r=8, alpha=16, dropout 0.1, a YAML from config/lora_config.yaml,
   phase 3's base weights): a run stopped after epoch 2 and resumed for the
   third against an uninterrupted 3-epoch run, bit for bit (losses and the
   adapter), the epoch_2 adapter (native and PEFT) through
   ClipEncoder.from_config giving TrainResult.final_lora's text embeddings
   bit for bit, and text searches over phase 3's index with it; (c) the
   train step at B=128 (seeded uint8 224² pixels, 64-wide token ids) in four
   configurations: (i) the trainer's flags at dropout 0.1, (ii) at dropout 0,
   (iii) fused_lora and small_attention on at dropout 0 (its loss and
   gradients held against (ii)), (iv) (i) with remat=True: step ms (median
   of 10), device busy and idle share, device time by kind, peak memory,
   launches; (d) make_chained_train_step K=4 against 4 single steps, bit for
   bit;
10. the evaluation job and the detector's training (the corpora made by
   scripts/generate_fashion_corpus.py in subprocesses under a temporary
   directory): (a) eval.cli run-all at ViT-B/32 over the in-repo 60 rows
   and phase 9 (b)'s epoch_1..3 adapters over phase 3's base weights, the
   launches of each encode, the written evaluation_results.json,
   model_comparison.json and evaluation_report.md against the metric keys
   of the committed results/model_comparison.json, and the base and epoch-3 metrics against those of the
   same encoder with the kernels off in fp32 (a rank may differ only at a
   near-tie); (b) eval.cli evaluate-model for the base encoder over 4,441
   generated rows: images/s, texts/s, the host's share, and a 512-row
   encode's device busy and idle share; (c) eval.cli similarity over phase
   3's index (Q=256, k=10) through topk_retrieve, its ids tie-aware against
   the plain top-k; (d) models.yolo.cli train: YOLOv8-n at 320² for one
   epoch of 75 steps at batch 32 on the committed recipe's corpus (seed 42,
   2,400 / 600), a falling loss, the step's median ms, busy and idle share
   and peak memory, one loss and its gradients from the committed
   detector's weights on the card against the CPU (normwise 1e-4), the
   saved weights through load_detector, and --init-weights grafting every
   leaf; (e) models.yolo.cli eval of the committed detector over the
   regenerated val split's first 150 images in fp32 and bf16 beside its
   eval_val.json;
11. the data axis over torch.distributed ranks (the kernels built once above;
   spawned ranks of this script, --phase11-rank, only load them; a file store
   in a temporary directory; a join timeout): (a) one NCCL rank (this
   process) on cuda:0: all_gather and all_reduce of CUDA tensors, and
   sharded_topk_retrieve over phase 4 (a)'s 1,048,586 fp32 rows and (b)'s
   524,298 bf16 rows and sharded_topk_retrieve_q8 over (a) quantized, Q = 1
   and 64 at k = 5 and Q = 1 at k = 300, bit-equal to the unsharded
   two-pass searches; (b) gloo worlds of 2 and 4 ranks sharing cuda:0, each
   rank holding its shard of the same rows padded by pad_to_multiple: the
   same searches tie-aware equal (scores within 1e-6, int8 exact), one
   pass-1 launch a search on the body its Q picks (logged by rank), a seeded
   all-negative index padded with its best rows in the last shard (no pad
   id), each search's wall ms and its gather-and-merge ms by world size;
   (c) index.cli build-text at 2 ranks over 4,441 generated rows
   (attention_small and lora_matmul on each rank) against the 1-process
   build (cosine >= 0.99999, self-retrieval); (d) the B=128 fp32 step at 2
   ranks (64 rows a rank, phase 9's weights and adapter, dropout 0) against
   one process over 3 steps (losses, grad norms, LoRA leaves within rel
   1e-5) and its ms beside one process's, and torchrun --nproc-per-node 2
   of train.cli over the in-repo rows (batch 6, 2 epochs): only rank 0
   writes, and its epoch_2 adapter is within rel 1e-5 of a 1-process run's;
12. the model axes (tensor, sequence and pipeline parallelism) over gloo
   worlds of 2 and 4 spawned ranks sharing cuda:0 (--phase12-rank), at full
   ViT-B/32 width over phase 3's weights and adapter: (a) the serving encode
   (image and text, B=8, bf16, kernels under "auto") through the TP, SP and
   PP (M=4) executors in the world of 2 and a pp4 one (M=4) in the world of
   4, every rank against the unsharded encode (cosine >= 0.999),
   lora_matmul launched on every rank and attention_small on every TP and
   PP rank; (b) the B=128 fp32 step of phase 9 (c) (ii) (dropout 0, 77-wide
   text: SP's pad path) as tp2, sp2 and pp2 (M=4) in the world of 2 and
   dp2×tp2, dp1×tp2×sp2 and pp2×sp2 (M=4) in the world of 4: each rank's
   losses over 2 steps and LoRA tree after them within rel 1e-5 of one
   process's, the step ms beside one process's, the collectives' count and
   ms by axis, peak memory and launches by rank;
13. approximate top-k and the last entry points: (a) the bin-max kernel
   (XLA's ApproxTopK partial reduce, ops/approx_topk.py) against its plain
   version over phase 3's 44,446 rows at Q = 1 and 64, k = 5, 10, 100, r =
   0.9, 0.95, 0.99, and over a 524,298-row bf16 arena at Q = 64, k = 10,
   r = 0.95 and k = 256, r = 0.99 (the two-launch selection): L and lg, the
   body, the bins' maxima and ids, the fused selection bit-equal to the sort
   of the kernel's bins and its launches a search, the top-k tie-aware, the
   recall against the exact route (>= r - 0.05 over each (k, r)'s 65
   queries), and the wrapper's, the
   kernel's, the plain version's, the exact route's and one library call's
   times beside the bound (device time twice: torch.profiler's, refused
   where its record is incomplete, and the span of CUDA events around calls
   queued behind a spin kernel; the profiler's window check); then 15 text
   requests through
   SearchIndex(approximate=True) over phase 3's index, counted (approx_topk
   15, topk_retrieve 0, 15 fused selection launches, no sort), each finding
   its own row; (b) at full ViT-B/32
   width over phase 3's weights and adapter saved to a temporary .npz and
   adapter directory, from a temporary working directory: index.cli
   build-custom and build-text, every services.cli demo once in one-shot
   mode (finder-report into a copy of the index with a SqliteStore, found
   first by the next search-text-custom; seeker; search-text and
   search-image over the text index; search-text-custom,
   search-image-custom; search-image-yolo staged and --fused with the
   committed synth detector), lora.cli merge, peft and native (the adapter
   back bit for bit; the merged weights within cosine 0.9999 of the
   unmerged encoder in fp32, the bf16 cosine printed), tokenizer.cli,
   models.cli load and lora-inference, and models.yolo.cli heldout over
   five rendered photos (2 folds, 1 epoch) with its pooled JSON.
The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit, and the one before that the kernel table as
JSON. Exits non-zero without a CUDA device or without the port's package
beside it.
"""

from __future__ import annotations

import collections
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12
# "3xtf32": fp32 products as three TF32 tensor-core products (hi.hi + hi.lo + lo.hi)
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12, "3xtf32": 495e12 / 3}
SEED = 0
INDEX_ROWS = 44_436  # random unit rows; +5 texts +5 images = 44,446
HBM_ROWS = 1_048_576  # phase 4 (a), (c): seeded unit rows; +10 custom rows
BF16_ROWS = 524_288  # phase 4 (b)
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
    "tilemax": ("retrieval_tilemax", "clip_lora_match_tpu/ops/retrieval_topk.py:526"),
    "tilemax_sup": ("retrieval_tilemax", "clip_lora_match_tpu/ops/retrieval_topk.py:442"),
    "tilemax_sup_q8": ("retrieval_tilemax", "clip_lora_match_tpu/ops/retrieval_topk.py:830"),
    "mlp_fused": ("mlp_fused", "clip_lora_match_tpu/ops/mlp_fused.py:96"),
    "flash_attention": ("flash_attention", "clip_lora_match_tpu/ops/flash_attention.py:110"),
    # no pallas_call: XLA's ApproxTopK (lax.approx_max_k) in the JAX package's approximate search
    "approx_topk": ("retrieval_binmax", "clip_lora_match_tpu/retrieval/similarity.py:40 (XLA ApproxTopK)"),
}
# off by default, or reached only through approximate=True: phases 3-4 never launch them
OFF_BY_DEFAULT = {"mlp_fused": 0, "flash_attention": 0, "approx_topk": 0}
L14_INDEX_ROWS = 44_436  # phase 5: seeded unit rows at D=768; +5 texts +5 images
# SMOKE_UNGROUPED_LORA=1 runs this script in a checkout from before the
# grouped q/k/v launch (an A/B against it): 4 lora_matmul launches per
# adapted attention layer, and the grouped phase-2 rows as one (M, 3N)
# product with A contiguous. Otherwise q/k/v are one launch, out_proj another.
UNGROUPED = os.environ.get("SMOKE_UNGROUPED_LORA") == "1"
LORA_PER_LAYER = 4 if UNGROUPED else 2
# SMOKE_SKIP_K300=1 runs this script in a checkout from before k > 256 took
# the mid-band route on the card (an A/B against it): phase 3 leaves out its
# k=300 search, which such a checkout refuses.
SKIP_K300 = os.environ.get("SMOKE_SKIP_K300") == "1"


def log(*parts) -> None:
    print(*parts, flush=True)


def fmt(v) -> str:
    return "null" if v is None else f"{v:.5f}"


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


def device_ms(torch, fn, reps: int = 10, expect: str | None = None, floor_ms: float = 0.0):
    """Device time of one call of ``fn`` (every kernel and copy it starts on
    the card), the mean over ``reps`` calls profiled after a warm-up call.
    None, with the reason and the profiler's rows logged, when the record is
    incomplete: no device activity, a kernel whose count is not a multiple of
    ``reps`` (the calls are alike, so some of its records were lost), no
    kernel whose name holds ``expect`` (the hand-written kernel the call
    launches), or a time below ``floor_ms``, the least the card could take."""
    rows = device_rows(torch, fn, reps)
    ms = sum(r[0] for r in rows) / reps if rows else None
    if ms is None:
        kind, why = "empty", "no device activity"
    elif any(count % reps for _, count, _ in rows):
        kind, why = "counts", f"kernel counts not multiples of the {reps} calls"
    elif expect is not None and not any(expect in name for _, _, name in rows):
        kind, why = "kernel missing", f"no kernel named *{expect}*"
    elif ms < floor_ms:
        kind, why = "below bound", f"{ms:.5f} ms per call, below the bound {floor_ms:.5f} ms"
    else:
        return ms
    seen = ", ".join(f"{name[:60]} x{count} {t:.4f} ms" for t, count, name in sorted(rows, reverse=True)[:6])
    log(f"  device time not measured: {why}; the profiler recorded [{seen}]")
    DEVICE_GAPS.append(kind)
    return None


# the readings device_ms refused in this run, by reason (summed in the log's last lines)
DEVICE_GAPS: list[str] = []


def span_ms(torch, fn, reps: int = 10):
    """Device time of one call of ``fn`` without torch.profiler: the span of
    CUDA events around ``reps`` calls queued behind a spin kernel, so that
    the card starts them only once the host has issued them all and the span
    holds no host time (the card's gaps between launches stay in it). None
    when the spin was over before the host was done (``fn`` waits on the
    card, or the spin was too short)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    # twice the calls' wall at 2 GHz (the H100's SM clock is at most 1.98 GHz)
    cycles = int(max(2 * (time.perf_counter() - t), 1e-3) * 2e9)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cycles)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    queued = not start.query()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps if queued else None


def timings(torch, kern, plain, library, expect: str, floor_ms: float) -> dict:
    """A phase-2 row's times: wall per call (CUDA events over back-to-back
    calls, so host work in a wrapper shows) of the kernel's wrapper, its
    plain version and the library call, and the device time (torch.profiler)
    of the wrapper's and the library call's kernels, each held to the row's
    bound and the wrapper's to its kernel ``expect``."""
    return dict(
        ms=cuda_ms(torch, kern), plain_ms=cuda_ms(torch, plain),
        library_ms=None if library is None else cuda_ms(torch, library),
        device_ms=device_ms(torch, kern, expect=expect, floor_ms=floor_ms),
        library_device_ms=None if library is None else device_ms(torch, library, floor_ms=floor_ms),
    )


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
            **timings(torch, lambda: ops_attn.attention_small(q, k, v, causal=causal),
                      lambda: ops_attn.attention_small_plain(q, k, v, causal=causal),
                      lambda: sdpa(qt, kt, vt, is_causal=causal), "attention_small_", b_ms),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
        ))
    return rows, worst


def check_lora(torch, ops_lora, gen):
    """lora_matmul against its plain version, A in the serving copy's layout
    (the transposed view of a contiguous (r, K) tensor). Per projection: B/32
    image (one, 96), text (one, 256), one L/14-336 image; then the grouped
    q/k/v launch (groups=3 on [Wq|Wk|Wv], [Aq|Ak|Av], blockdiag(Bq, Bk, Bv),
    as nn.layers.group_qkv builds them) of every tower at a request and at a
    batch (``UNGROUPED``: the same products with A contiguous and an (M, 3N)
    output). The bound counts the work the three projections need: B as
    3 x r x D, not blockdiag's zero blocks."""
    rows = []
    worst = 0.0
    r, s, bf = 8, 2.0, torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def call(fn, x, w, a, b, G):
        return fn(x, w, a, b, s) if UNGROUPED else fn(x, w, a, b, s, groups=G)

    shapes = [  # (M, K = N per projection, groups)
        (50, 768, 1), (96 * 50, 768, 1), (64, 512, 1), (256 * 64, 512, 1), (577, 1024, 1),
        (50, 768, 3), (64, 512, 3), (577, 1024, 3), (64, 768, 3),
        (96 * 50, 768, 3), (256 * 64, 512, 3), (32 * 577, 1024, 3),
    ]
    for M, D, G in shapes:
        x = torch.randn(M, D, device="cuda", generator=gen).to(bf)

        def proj():
            return ((torch.randn(D, D, device="cuda", generator=gen) * D ** -0.5).to(bf),
                    (torch.randn(r, D, device="cuda", generator=gen) * D ** -0.5).to(bf).t(),
                    (torch.randn(r, D, device="cuda", generator=gen) * 0.05).to(bf))
        if G == 1:
            w, a, b = proj()
        else:
            qkv = [proj() for _ in range(3)]
            w = torch.cat([t[0] for t in qkv], 1)
            a = torch.cat([t[1] for t in qkv], 1).t().contiguous().t()
            b = torch.block_diag(*[t[2] for t in qkv])
        if UNGROUPED:
            a = a.contiguous()
        N, rr = w.shape[1], a.shape[1]
        got = call(ops_lora.lora_matmul, x, w, a, b, G)
        ref = call(ops_lora.lora_matmul_plain, x, w, a, b, G)
        torch.cuda.synchronize()
        scale = ref.float().abs().max().item()
        err = (got.float() - ref.float()).abs().max().item()
        what = f"M={M} K={D} N={N} r={rr}{' groups=3' if G > 1 else ''} bf16"
        if not UNGROUPED:  # the body and tiles this shape runs
            what += f" [{ops_lora.plan(M, N, D, rr, bf, True, sms, G)}]"
        if not err <= 1e-2 * scale:
            raise AssertionError(f"lora_matmul {what}: max err {err} vs scale {scale}")
        worst = max(worst, err)
        rp = rr // G  # each projection's rank
        nbytes = (M * D + D * N + D * rr + rp * N + M * N) * 2
        flops = 2 * M * N * D + 2 * M * rp * (G * D + N)
        b_ms, b_by = bound_ms(nbytes, flops, "bf16")
        rows.append(dict(
            shape=what,
            **timings(torch, lambda: call(ops_lora.lora_matmul, x, w, a, b, G),
                      lambda: call(ops_lora.lora_matmul_plain, x, w, a, b, G),
                      lambda: torch.addmm(torch.mm(torch.mm(x, a), b), x, w, beta=s), "lora_matmul_", b_ms),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
        ))
    return rows, worst


def check_topk(torch, ops_topk, gen):
    """topk_retrieve against its plain version at the main path's N and D, at
    the seeker's Q=1 and search_batch's Q=64, k=5 and 64, both index types.
    Each row names the pass-1 body that ran (the wrapper's ``bodies`` count)
    and the plan's query tile and grid."""
    rows = []
    worst = 0.0
    N, D = 44_441, 512
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    base = torch.nn.functional.normalize(
        torch.randn(N, D, device="cuda", generator=gen), dim=1
    )
    for dtype, kind in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        index = base.to(dtype)
        for Q in (1, 64):
            queries = torch.randn(Q, D, device="cuda", generator=gen)
            for k in (5, 64):
                before = dict(getattr(ops_topk.topk_retrieve, "bodies", {}))
                s, i = ops_topk.topk_retrieve(queries, index, k)
                rs, ri = ops_topk.topk_retrieve_plain(queries, index, k)
                torch.cuda.synchronize()
                err = (s - rs).abs().max().item()
                if not err <= 1e-5:
                    raise AssertionError(f"topk_retrieve Q={Q} k={k} {kind}: score err {err}")
                # ids must agree wherever the plain scores are distinct: a
                # swap is allowed only between positions within 1e-5 of a tie
                assert_ids_tie_aware(torch, f"topk_retrieve Q={Q} k={k} {kind}", i, rs, ri, 1e-5)
                worst = max(worst, err)
                ran = [b for b, n in getattr(ops_topk.topk_retrieve, "bodies", {}).items()
                       if n != before.get(b, 0)]
                what = f"Q={Q} N={N} D={D} k={k} {kind} index"
                if hasattr(ops_topk, "plan"):  # the body and tiles this shape runs
                    p = ops_topk.plan(Q, N, D, k, dtype, index.data_ptr() % 16 == 0, sms)
                    if ran != [p.body]:
                        raise AssertionError(f"topk_retrieve {what}: bodies {ran}, plan {p.body}")
                    what += f" [{p.body} qt={p.qt} grid={p.grid[0]}x{p.grid[1]}]"
                qn = torch.nn.functional.normalize(queries, dim=1).to(dtype)
                nbytes = N * D * index.element_size() + Q * D * 4 + Q * k * 8
                b_ms, b_by = bound_ms(nbytes, 2 * Q * N * D, "fp32")
                rows.append(dict(
                    shape=what,
                    **timings(torch, lambda: ops_topk.topk_retrieve(queries, index, k),
                              lambda: ops_topk.topk_retrieve_plain(queries, index, k),
                              lambda: torch.topk(qn @ index.T, k), "topk_", b_ms),
                    bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                ))
    return rows, worst


def check_flash(torch, ops_flash, gen):
    """flash_attention against its plain version; the first row is the
    L/14-336 image tower's shape (fp32 residual, maskless)."""
    rows = []
    worst = 0.0
    f32, bf16 = torch.float32, torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    shapes = [  # (B, S, H, causal mask, dtype)
        (1, 577, 16, False, f32), (1, 577, 16, False, bf16), (32, 577, 16, False, f32),
        (1, 197, 12, False, f32), (1, 257, 16, False, f32), (1, 77, 12, True, bf16),
    ]
    for B, S, H, causal, dtype in shapes:
        kind = "fp32" if dtype == f32 else "bf16"
        q, k, v = (torch.randn(B, S, H, 64, device="cuda", generator=gen).to(dtype) for _ in range(3))
        mask = torch.triu(torch.full((S, S), torch.finfo(torch.float32).min, device="cuda"), 1)[None, None] if causal else None
        got = ops_flash.flash_attention(q, k, v, mask=mask)
        ref = ops_flash.flash_attention_plain(q, k, v, mask=mask)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        # fp32: summation order only; bf16: one bf16 step of the output
        tol = 2e-2 if dtype == bf16 else 5e-5
        if not err <= tol:
            raise AssertionError(f"flash_attention B={B} S={S} H={H} causal={causal} {kind}: max err {err}")
        worst = max(worst, err)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib_mask = None if mask is None else mask.to(dtype)
        # the additive mask is applied to every (query, key) pair: count them all
        nbytes = 4 * B * S * H * 64 * q.element_size() + (S * S * 4 if causal else 0)
        # fp32 products run as 3xTF32 on the tensor cores: the bound of that
        # arithmetic (3 TF32 products per product at 495 TFLOP/s), not of fp32 FMA
        arith = "3xtf32" if dtype == f32 else kind
        b_ms, b_by = bound_ms(nbytes, 4 * B * H * S * S * 64, arith)
        rows.append(dict(
            shape=f"B={B} S={S} H={H} hd=64 {'causal mask' if causal else 'maskless'} {kind}"
                  f"{' (bound: 3xTF32)' if arith == '3xtf32' else ''}",
            **timings(torch, lambda: ops_flash.flash_attention(q, k, v, mask=mask),
                      lambda: ops_flash.flash_attention_plain(q, k, v, mask=mask),
                      lambda: sdpa(qt, kt, vt, attn_mask=lib_mask), "flash_attention_", b_ms),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
        ))
    return rows, worst


def check_mlp_fused(torch, ops_mlp, gen):
    """mlp_fused against its plain version; the first row is one L/14-336
    image's vision MLP, then the L/14 text tower's and a 32-image batch's."""
    rows = []
    worst = 0.0
    bf = torch.bfloat16
    for M, K, H in ((577, 1024, 4096), (64, 768, 3072), (32 * 577, 1024, 4096)):
        N = K
        x = torch.randn(M, K, device="cuda", generator=gen).to(bf)
        w1 = (torch.randn(K, H, device="cuda", generator=gen) * K ** -0.5).to(bf)
        b1 = torch.randn(H, device="cuda", generator=gen) * 0.1
        w2 = (torch.randn(H, N, device="cuda", generator=gen) * H ** -0.5).to(bf)
        b2 = torch.randn(N, device="cuda", generator=gen) * 0.1
        got = ops_mlp.mlp_fused(x, w1, b1, w2, b2)
        ref = ops_mlp.mlp_fused_plain(x, w1, b1, w2, b2)
        torch.cuda.synchronize()
        scale = ref.float().abs().max().item()
        err = (got.float() - ref.float()).abs().max().item()
        if not err <= 1e-2 * scale:
            raise AssertionError(f"mlp_fused M={M} K={K} H={H}: max err {err} vs scale {scale}")
        worst = max(worst, err)
        b1b, b2b = b1.to(bf), b2.to(bf)

        def library():
            h = torch.addmm(b1b, x, w1)
            return torch.addmm(b2b, h * torch.sigmoid(1.702 * h), w2)
        nbytes = (M * K + K * H + H * N + M * N) * 2 + (H + N) * 4
        b_ms, b_by = bound_ms(nbytes, 2 * M * H * (K + N), "bf16")
        rows.append(dict(
            shape=f"M={M} K=N={K} H={H} bf16",
            **timings(torch, lambda: ops_mlp.mlp_fused(x, w1, b1, w2, b2),
                      lambda: ops_mlp.mlp_fused_plain(x, w1, b1, w2, b2), library, "mlp_fused_", b_ms),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
        ))
    return rows, worst


def assert_ids_tie_aware(torch, what, i, rs, ri, tol):
    """Ids equal wherever the plain scores are more than ``tol`` from a
    neighbour: a swap is allowed only inside a tie."""
    diff = i != ri
    if diff.any():
        pad, step = torch.nn.functional.pad, rs[:, :-1] - rs[:, 1:]
        gap = torch.minimum(pad(step, (0, 1), value=1.0), pad(step, (1, 0), value=1.0))
        if (gap[diff] > tol).any():
            raise AssertionError(f"{what}: ids differ outside ties")


def assert_ids_score_ties(torch, what, i, ri, rs, qc, index, rv, tol):
    """Ids of a binned selection (row j in bin j mod L, ``rv`` the plain
    (Q, L) bin maxima) equal to the plain selection's wherever the row
    returned does not tie it: where they differ, the returned row's own
    score (fp32, from the index) is within ``tol`` of its bin's plain
    maximum and of the plain score at that rank. That admits another row of
    a bin whose two best rows tie, and a bin whose maximum ties the plain
    one at that rank (neighbours swapped, or the k-th bin), and nothing
    else."""
    diff = i != ri
    if diff.any():
        own = (qc.float()[:, None, :] * index[i.long()].float()).sum(-1)
        best = rv.gather(1, i.long() % rv.shape[1])
        bad = diff & (((own - rs).abs() > tol) | ((own - best).abs() > tol))
        if bad.any():
            at = bad.nonzero()[:4].tolist()
            raise AssertionError(f"{what}: ids differ outside ties at (query, rank) {at}: ids "
                                 f"{[i[q, r].item() for q, r in at]} against {[ri[q, r].item() for q, r in at]}, own "
                                 f"scores {[own[q, r].item() for q, r in at]} against {[rs[q, r].item() for q, r in at]}")


def check_pass1(torch, R, gen):
    """The three tile-max kernels against their plain versions, and the
    two-pass routes through them against the plain route. Each kernel's
    first row is the shape its main path (phase 4) gives it."""
    D, tile, group = 512, 16, R.HIER_GROUP
    n_small, n_big = BF16_ROWS + 10, HBM_ROWS + 10
    base = torch.nn.functional.normalize(torch.randn(n_big, D, device="cuda", generator=gen), dim=1)
    out = {"tilemax": ([], 0.0), "tilemax_sup": ([], 0.0), "tilemax_sup_q8": ([], 0.0)}

    def record(name, shape, err, kern, plain, library, nbytes, ops_, kind):
        rows, worst = out[name]
        b_ms, b_by = bound_ms(nbytes, ops_, kind)
        rows.append(dict(shape=shape, **timings(torch, kern, plain, library, "tilemax", b_ms),
                         bound_ms=b_ms, bound_by=b_by, max_abs_err=err))
        out[name] = (rows, max(worst, err))

    def routes(what, queries, run, tol):
        for k in (5, 64):
            s, i = run(queries, k, None)
            rs, ri = run(queries, k, False)
            torch.cuda.synchronize()
            err = (s - rs).abs().max().item()
            if not err <= tol:
                raise AssertionError(f"{what} k={k}: kernel route vs plain route score err {err}")
            assert_ids_tie_aware(torch, f"{what} k={k}", i, rs, ri, tol)

    planned = hasattr(R, "tilemax_plan")  # False in a checkout from before the mma body
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, N, dtypes, qs in (("tilemax", n_small, ("bf16", "fp32"), (1, 16, 64)),
                                ("tilemax_sup", n_big, ("fp32", "bf16"), (1, 64))):
        n_al = N // tile * tile
        wrapper = getattr(R, name)
        for kind in dtypes:
            index = base[:N].to(torch.bfloat16 if kind == "bf16" else torch.float32)
            for Q in qs:
                queries = torch.randn(Q, D, device="cuda", generator=gen)
                qc = R._normalize(queries).to(index.dtype)
                before = dict(getattr(wrapper, "bodies", {}))
                if name == "tilemax":
                    got, ref = R.tilemax(qc, index, tile), R.tilemax_plain(qc, index, tile)
                    kern = lambda: R.tilemax(qc, index, tile)  # noqa: E731
                    plain = lambda: R.tilemax_plain(qc, index, tile)  # noqa: E731
                    n_out = Q * (-(-N // tile))
                else:
                    got = torch.cat(R.tilemax_sup(qc, index, tile, group), 1)
                    ref = torch.cat(R.tilemax_sup_plain(qc, index, tile, group), 1)
                    kern = lambda: R.tilemax_sup(qc, index, tile, group)  # noqa: E731
                    plain = lambda: R.tilemax_sup_plain(qc, index, tile, group)  # noqa: E731
                    n_out = got.numel()
                torch.cuda.synchronize()
                err = (got - ref).abs().max().item()
                if not err <= 1e-5:
                    raise AssertionError(f"{name} Q={Q} N={N} {kind}: max err {err}")
                what = f"Q={Q} N={N} D={D} tile={tile}{f' group={group}' if name != 'tilemax' else ''} {kind} index"
                arith = kind
                if planned:  # the body this shape ran, which must be the plan's
                    p = R.tilemax_plan(Q, N, D, index.dtype, tile, None if name == "tilemax" else group, sms)
                    ran = [b for b, n in wrapper.bodies.items() if n != before.get(b, 0)]
                    if ran != [p.body]:
                        raise AssertionError(f"{name} {what}: bodies {ran}, plan {p.body}")
                    what += f" [{p.body} qb={p.qb} grid={p.grid[0]}x{p.grid[1]}]"
                    # the mma body's fp32 products are 3xTF32: the bound of that arithmetic
                    if p.body == "mma" and kind == "fp32":
                        arith = "3xtf32"
                        what += " (bound: 3xTF32)"
                record(
                    name, what, err, kern, plain,
                    lambda: torch.matmul(qc, index[:n_al].T).view(Q, -1, tile).amax(2),
                    N * D * index.element_size() + Q * D * index.element_size() + 4 * n_out,
                    2 * Q * N * D, arith,
                )
                routes(f"two-pass {name} Q={Q} {kind}", queries,
                       lambda q, k, p: R.topk_retrieve_twopass(q, index, k, pallas_pass1=p), 1e-5)
            del index

    values, scales = R.quantize_index_int8(base)
    del base
    # False in a checkout from before the int8 index took the mma body
    q8_planned = hasattr(R.tilemax_sup_q8, "bodies")
    for Q in (1, 64):
        queries = torch.randn(Q, D, device="cuda", generator=gen)
        qq, _ = R._quantize_queries(queries)
        what = f"Q={Q} N={n_big} D={D} tile={tile} group={group} int8 index"
        for mxu in ("int8", "bf16") if Q == 64 else ("int8",):
            before = dict(getattr(R.tilemax_sup_q8, "bodies", {}))
            got = torch.cat(R.tilemax_sup_q8(qq, values, scales, tile, group, mxu), 1)
            ref = torch.cat(R.tilemax_sup_q8_plain(qq, values, scales, tile, group), 1)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"tilemax_sup_q8 Q={Q} mxu={mxu}: maxima not bit-equal "
                                     f"(max err {(got - ref).abs().max().item()})")
            if q8_planned:  # the body this shape ran, which must be the plan's
                p = R.tilemax_plan(Q, n_big, D, torch.int8, tile, group, sms)
                ran = [b for b, n in R.tilemax_sup_q8.bodies.items() if n != before.get(b, 0)]
                if ran != [p.body]:
                    raise AssertionError(f"tilemax_sup_q8 {what} mxu={mxu}: bodies {ran}, plan {p.body}")
        if q8_planned:
            what += f" [{p.body} qb={p.qb} grid={p.grid[0]}x{p.grid[1]}]"
        n_al = n_big // tile * tile
        # torch._int_mm takes more than 16 rows: a smaller query block is
        # padded with zero rows to 17, and only its own rows are scaled
        qp = torch.nn.functional.pad(qq, (0, 0, 0, max(0, 17 - Q)))

        def library_call():
            dots = torch._int_mm(qp, values[:n_al].T)[:Q]
            return (dots.float() * scales[:n_al, 0]).view(Q, -1, tile).amax(2)
        try:
            library_call()
        except RuntimeError as e:  # a yardstick only: the port never calls it
            log(f"library int8 matmul not timed: {str(e).splitlines()[0]}")
            library_call = None
        pad_note = f" (library: query padded to {qp.shape[0]} rows)" if qp.shape[0] != Q else ""
        record(
            "tilemax_sup_q8", f"{what}{pad_note}", 0.0,
            lambda: R.tilemax_sup_q8(qq, values, scales, tile, group),
            lambda: R.tilemax_sup_q8_plain(qq, values, scales, tile, group),
            library_call, n_big * D + n_big * 4 + Q * D + 4 * got.numel(), 2 * Q * n_big * D, "int8",
        )
        routes(f"q8 two-pass Q={Q}", queries,
               lambda q, k, p: R.topk_retrieve_q8(q, values, scales, k, pallas_pass1=p), 0.0)
    return out


def approx_row(torch, AT, R, index, queries, k: int, r: float, where: str) -> dict:
    """The bin-max kernel (``ops/approx_topk.py``) against its plain version
    on one shape, and the whole approximate selection against the plain
    selection: every bin's id is a row of its bin scoring the plain maximum
    and the values agree within 2e-6 (sum order; 3xTF32 on the fp32 wgmma
    body); the fused selection over the kernel's bins (``select_bins``) and
    the whole search bit-equal to ``_select_bins`` over the kernel's bins;
    the top-k scores within 2e-6 of the plain selection, and each id either
    the plain selection's or a row whose own score ties, within 2e-6, both
    its bin's plain maximum and the plain score at that rank (a bin's two
    best rows, or two bins' maxima, can tie: sum order picks one).
    Returns the row: L, lg, the body, the selection's launches per search,
    the recall against the exact route, the kernel's (``binmax``), its plain
    version's and the library's times and its bound, then the whole
    selection's (``approx_topk``, ``approx_topk_plain``, the library's with a
    top-k) beside the exact route's, device times as spans of CUDA events.
    """
    Q, D = queries.shape
    N = index.shape[0]
    L, lg = AT.reduction_bins(N, k, r)
    qc = R._normalize_div(queries).to(index.dtype)
    p = AT.binmax_plan(Q, N, D, index.dtype, L, torch.cuda.get_device_properties(0).multi_processor_count)
    what = f"Q={Q} N={N} D={D} k={k} r={r} {str(index.dtype)[6:]} index ({where}) L={L} lg={lg}"
    before = dict(AT.approx_topk.bodies)
    vals, ids = AT.binmax(qc, index, L)
    rv, _ = AT.binmax_plain(qc, index, L)
    torch.cuda.synchronize()
    ran = [b for b, n in AT.approx_topk.bodies.items() if n != before[b]]
    if ran != [p.body]:
        raise AssertionError(f"binmax {what}: bodies {ran}, plan {p.body}")
    sims = qc.float() @ index.float().T
    bin_err = max((vals - rv).abs().max().item(), (sims.gather(1, ids.long()) - rv).abs().max().item())
    if not bin_err <= 2e-6 or not ((ids.long() % L) == torch.arange(L, device="cuda")).all():
        raise AssertionError(f"binmax {what}: bin maxima err {bin_err} or ids outside their bins")
    del sims
    ws, wi = AT._select_bins(vals, ids, k)
    s0, n0 = AT.approx_topk.select_launches, AT.approx_topk.sorts
    s, i = AT.approx_topk(queries, index, k, r)
    torch.cuda.synchronize()
    launches, sorts = AT.approx_topk.select_launches - s0, AT.approx_topk.sorts - n0
    if not (torch.equal(s, ws) and torch.equal(i, wi)):
        raise AssertionError(f"approx_topk {what}: the fused search differs from _select_bins over the bins")
    if AT.select_plan(L, k) is not None:
        fs, fi = AT.select_bins(vals, ids, k)
        torch.cuda.synchronize()
        if not (torch.equal(fs, ws) and torch.equal(fi, wi)):
            raise AssertionError(f"select_bins {what}: not bit-equal to _select_bins over the kernel's bins")
        if sorts != 0:
            raise AssertionError(f"approx_topk {what}: {sorts} sorts at k <= {AT.K_MAX}")
    rs, ri = AT.approx_topk_plain(queries, index, k, r)
    torch.cuda.synchronize()
    err = (s - rs).abs().max().item()
    if not err <= 2e-6:
        raise AssertionError(f"approx_topk {what}: score err {err}")
    assert_ids_score_ties(torch, f"approx_topk {what}", i, ri, rs, qc, index, rv, 2e-6)
    _, ei = R.topk_retrieve_auto(queries, index, k)
    recall = sum(len(set(a) & set(b)) for a, b in zip(i.tolist(), ei.tolist())) / (Q * k)
    qn = qc.float()
    W = -(-N // L)

    def library():  # one product, then the strided max with its argmax
        sims = torch.nn.functional.pad(qn @ index.float().T, (0, W * L - N), value=-float("inf"))
        return torch.max(sims.view(Q, W, L), dim=1)

    def library_select():  # the same, then a top-k over the bins
        v, w = library()
        return torch.topk(v, k, dim=1), w

    elem = index.element_size()
    kind = {"mma": "3xtf32" if elem == 4 else "bf16", "cuda_core": "fp32"}[p.body]
    b_ms, b_by = bound_ms(N * D * elem + Q * D * elem + Q * L * 8, 2 * Q * N * D, kind)
    select = lambda: AT.approx_topk(queries, index, k, r)  # noqa: E731
    exact = lambda: R.topk_retrieve_auto(queries, index, k)  # noqa: E731
    sel = {}
    if AT.select_plan(L, k) is not None:
        # the fused selection alone over the kernel's (Q, L) bins (one split),
        # beside the sort it replaces and torch.topk; bound: the bins read once
        # and the (Q, k) answer written once
        sel = dict(fused_select_span_ms=span_ms(torch, lambda: AT.select_bins(vals, ids, k)),
                   fused_select_plain_span_ms=span_ms(torch, lambda: AT._select_bins(vals, ids, k)),
                   fused_select_library_span_ms=span_ms(torch, lambda: torch.topk(vals, k, dim=1)),
                   fused_select_bound_ms=(Q * L * 8 + Q * k * 8) / HBM_BYTES_PER_S * 1e3)
    plan = (f"{p.body} qb={p.qb} bins={p.bins} splits={p.splits} grid={'x'.join(map(str, p.grid))} "
            f"rows={p.rows} stages={p.stages}")
    return dict(shape=f"{what} [{plan}] selection launches a search {launches}",
                **timings(torch, lambda: AT.binmax(qc, index, L), lambda: AT.binmax_plain(qc, index, L), library,
                          "binmax_", b_ms),
                span_ms=span_ms(torch, lambda: AT.binmax(qc, index, L)), library_span_ms=span_ms(torch, library),
                select_ms=cuda_ms(torch, select),
                select_device_ms=device_ms(torch, select, expect="binmax_", floor_ms=b_ms),
                select_span_ms=span_ms(torch, select),
                select_plain_ms=cuda_ms(torch, lambda: AT.approx_topk_plain(queries, index, k, r)),
                select_library_ms=cuda_ms(torch, library_select),
                exact_ms=cuda_ms(torch, exact), exact_span_ms=span_ms(torch, exact),
                bound_ms=b_ms, bound_by=b_by, max_abs_err=max(err, bin_err), recall=recall, L=L, lg=lg,
                body=p.body, select_launches=launches, sorts=sorts, **sel)


def approx_line(row: dict) -> str:
    """One phase-13 (a) row's log line: the kernel, the whole search, the exact route."""
    return (f"{row['shape']}: binmax wall ms {row['ms']:.5f} (device {fmt(row['device_ms'])}, span "
            f"{fmt(row['span_ms'])}), plain {row['plain_ms']:.5f}, library {fmt(row['library_ms'])} (device "
            f"{fmt(row['library_device_ms'])}, span {fmt(row['library_span_ms'])}), bound {row['bound_ms']:.5f} "
            f"({row['bound_by']}); approx_topk wall ms {row['select_ms']:.5f} (device {fmt(row['select_device_ms'])}, "
            f"span {fmt(row['select_span_ms'])}), plain {row['select_plain_ms']:.5f}, library "
            f"{row['select_library_ms']:.5f}, exact route {row['exact_ms']:.5f} (span {fmt(row['exact_span_ms'])}); "
            f"recall {row['recall']:.4f}; max err {row['max_abs_err']:.3e}"
            + (f"; fused selection over the bins span {fmt(row['fused_select_span_ms'])} (sort "
               f"{fmt(row['fused_select_plain_span_ms'])}, torch.topk {fmt(row['fused_select_library_span_ms'])}, "
               f"bound {row['fused_select_bound_ms']:.5f})" if "fused_select_span_ms" in row else ""))


def check_approx(torch, AT, R, gen):
    """Phase 2's rows of the bin-max kernel: a 44,446-row seeded index (fp32
    and bf16) at the seeker's Q = 1 (the first row: phase 13's counted
    searches) and search_batch's Q = 64, k = 10, r = 0.95."""
    N, D = INDEX_ROWS + 10, 512
    base = torch.nn.functional.normalize(torch.randn(N, D, device="cuda", generator=gen), dim=1)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        index = base.to(dtype)
        for Q in (1, 64):
            rows.append(approx_row(torch, AT, R, index, torch.randn(Q, D, device="cuda", generator=gen),
                                   10, 0.95, "seeded"))
    return rows, max(r["max_abs_err"] for r in rows)


def pass1_crossover(torch, R, gen, card):
    """Both bodies of ``tilemax`` (bf16, fp32) and of ``tilemax_sup_q8``
    (int8, group 16) at Q = 8, 16 and 32 over the 524,298-row index, each
    forced through the private launcher with its own plan and held against the
    plain version (int8: bit-equal): the crossover ``TILEMAX_MMA_MIN_Q`` rests
    on. Device ms by torch.profiler."""
    D, tile, N, group = 512, 16, BF16_ROWS + 10, R.HIER_GROUP
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    index32 = torch.nn.functional.normalize(torch.randn(N, D, device="cuda", generator=gen), dim=1)
    kinds = [("bf16", torch.bfloat16), ("fp32", torch.float32)]
    if hasattr(R.tilemax_sup_q8, "bodies"):  # the int8 index takes both bodies
        kinds.append(("int8", torch.int8))
    for kind, dtype in kinds:
        if dtype == torch.int8:
            index, scales = R.quantize_index_int8(index32)
            grp = group
        else:
            index, scales, grp = index32.to(dtype), None, None
        for Q in (8, 16, 32):
            queries = torch.randn(Q, D, device="cuda", generator=gen)
            if scales is None:
                qc = R._normalize(queries).to(dtype)
                ref = R.tilemax_plain(qc, index, tile)
            else:
                qc, _ = R._quantize_queries(queries)
                ref = torch.cat(R.tilemax_sup_q8_plain(qc, index, scales, tile, grp), 1)
            times = {}
            for body in ("cuda_core", "mma"):
                p = R.tilemax_plan(Q if body == "cuda_core" else max(Q, R.TILEMAX_MMA_MIN_Q),
                                   N, D, dtype, tile, grp, sms)
                if body == "cuda_core" and p.body != body:
                    p = p._replace(body="cuda_core", qb=8)
                if p.body != body:
                    raise AssertionError(f"crossover Q={Q} {kind}: no {body} plan")

                def run():
                    if scales is None:
                        return R._pass1_launch(qc, index, tile, None, p)[0]
                    return torch.cat(R._pass1_launch(qc, index, tile, grp, p, scales), 1)
                got = run()
                torch.cuda.synchronize()
                err = (got - ref).abs().max().item()
                if not (torch.equal(got, ref) if scales is not None else err <= 1e-5):
                    raise AssertionError(f"pass 1 {body} Q={Q} {kind}: max err {err}")
                times[body] = device_ms(torch, run, expect="tilemax")
            name = "tilemax" if scales is None else "tilemax_sup_q8"
            log(f"{name} crossover Q={Q} N={N} D={D} {kind}: cuda_core device_ms {fmt(times['cuda_core'])} "
                f"mma device_ms {fmt(times['mma'])}; the plan takes "
                f"{R.tilemax_plan(Q, N, D, dtype, tile, grp, sms).body} [{card}]")
        del index


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


# torch.profiler keeps only the device records that fall inside its capture
# window, timed on its host clock, and late in a long run it loses records,
# more the older the process. Holding the window open this long on either
# side of the calls saves some (profiler_window_check in phase 13 (a)), not
# all: device_ms refuses a reading whose record is still incomplete.
PROFILE_PAD_S = 0.02


def device_rows(torch, fn, reps: int = 1, pad_s: float = PROFILE_PAD_S) -> list:
    """(device ms, count, name) of every device activity (kernels and copies)
    in ``reps`` calls of ``fn`` after a warm-up call, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    per: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            row = per.setdefault(e.name, [0.0, 0])
            row[0] += e.time_range.elapsed_us() / 1e3
            row[1] += 1
    return [(ms, count, key) for key, (ms, count) in per.items()]


def profiler_window_check(torch, fn, name: str, reps: int = 10) -> None:
    """The records torch.profiler keeps of the kernel named ``name`` over
    ``reps`` calls of ``fn`` (one launch a call), without and with the
    window's margins: late in the run, the evidence for PROFILE_PAD_S."""
    got = [sum(c for _, c, n in device_rows(torch, fn, reps, pad) if name in n) for pad in (0.0, PROFILE_PAD_S)]
    log(f"profiler window check, {reps} calls launching *{name}*: {got[0]} records without margins, "
        f"{got[1]} with {PROFILE_PAD_S * 1e3:.0f} ms margins")


def profile_device_time(torch, name: str, fn, wall_ms: float, card: str) -> None:
    """Device time of one call by kernel (torch.profiler), beside the call's
    unprofiled wall time: the idle share is 1 - device / wall."""
    rows = device_rows(torch, fn)
    if not rows:
        log(f"{name}: device time not measured (the profiler saw no device activity)")
        return None
    rows.sort(reverse=True)
    dev_ms = sum(r[0] for r in rows)
    log(f"{name}: device busy {dev_ms:.4f} ms of {wall_ms:.4f} ms wall "
        f"(idle share {1 - dev_ms / wall_ms:.3f}) [{card}]")
    for ms, count, key in rows[:8]:
        log(f"  {ms:9.4f} ms  x{count:<4d} {key[:90]}")
    return dev_ms


def check_k300(torch, index, enc, text):
    """k past the streaming kernel's K_MAX through SearchIndex (the exact
    mid-band route on the card), held against the plain route."""
    from clip_lora_match_tpu_torch.ops import retrieval_topk as R
    from clip_lora_match_tpu_torch.retrieval.search import SearchIndex

    q = enc.encode_text(text)
    res = SearchIndex(index, enc).search_with_embedding(q, 300)
    if len(res) != 300:
        raise AssertionError(f"k=300 search: {len(res)} results")
    rs, ri = R.topk_retrieve_plain(torch.from_numpy(q)[None].cuda(), index.embeddings, 300)
    got_s = torch.tensor([[r.score for r in res]], device="cuda")
    got_i = torch.tensor([[r.index for r in res]], device="cuda", dtype=torch.int32)
    err = (got_s - rs).abs().max().item()
    if not err <= 1e-5:
        raise AssertionError(f"k=300 search: score err {err}")
    assert_ids_tie_aware(torch, "k=300 search", got_i, rs, ri, 1e-5)
    log(f"k=300 search through SearchIndex over {len(index)} rows: 300 results, "
        f"max score err {err:.3e} against the plain route")


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
        "lora_matmul": LORA_PER_LAYER * 4 * n * layers,  # per layer per tower
        "topk_retrieve": 3 * n,                 # one search per request
        "tilemax": 0, "tilemax_sup": 0, "tilemax_sup_q8": 0,  # N < TWOPASS_MIN_N
        **OFF_BY_DEFAULT,
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

    if SKIP_K300:
        log("k=300 search left out (SMOKE_SKIP_K300=1)")
    else:
        check_k300(torch, index, enc, texts[0])

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
    return counts, (enc, texts, images, paths), (index, lat)


# ---------------------------------------------------------------------------
# phase 4: the seeker and finder at HBM scale
# ---------------------------------------------------------------------------


def _latency(torch, calls) -> dict:
    lat = {}
    for name, call in calls:
        call()
        samples = []
        for _ in range(10):
            torch.cuda.synchronize()
            t = time.perf_counter()
            call()
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t) * 1e3)
        lat[name] = statistics.median(samples)
    return lat


def hbm_path(torch, card, enc, texts, images, paths):
    """Phase 4: four index configurations, each with its own counted run,
    then the finder's append into (c). Returns the launches of each
    configuration's run."""
    from clip_lora_match_tpu_torch import ops
    from clip_lora_match_tpu_torch.db.store import SqliteStore
    from clip_lora_match_tpu_torch.index.store import EmbeddingIndex
    from clip_lora_match_tpu_torch.ops import retrieval_topk as R
    from clip_lora_match_tpu_torch.retrieval import search as search_mod
    from clip_lora_match_tpu_torch.services.finder import FinderConfig, FinderService
    from clip_lora_match_tpu_torch.services.seeker import SeekerConfig, SeekerService

    n = len(texts)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    noise = torch.randn(HBM_ROWS, enc.arch.projection_dim, device="cuda", generator=gen).cpu().numpy()
    custom = np.concatenate([enc.encode_text(texts), enc.encode_image(images)])
    meta_paths, meta_texts = list(paths) * 2, list(texts) * 2
    index_a = EmbeddingIndex(
        np.concatenate([noise, custom]), [""] * HBM_ROWS + meta_paths, [""] * HBM_ROWS + meta_texts,
        capacity=HBM_ROWS + 64, device="cuda",
    )
    index_b = EmbeddingIndex(
        np.concatenate([noise[:BF16_ROWS], custom]), [""] * BF16_ROWS + meta_paths,
        [""] * BF16_ROWS + meta_texts, storage_dtype="bfloat16", device="cuda",
    )
    index_d = EmbeddingIndex(
        np.concatenate([noise[:INDEX_ROWS], custom]), [""] * INDEX_ROWS + meta_paths,
        [""] * INDEX_ROWS + meta_texts, device="cuda",
    )
    del noise
    torch.cuda.synchronize()
    log(f"phase 4 set-up: {time.perf_counter() - t0:.3f} s; (a) {len(index_a)} fp32 rows "
        f"({index_a.embeddings.numel() * 4 / 1e9:.2f} GB), (b) {len(index_b)} bf16 rows")

    rng = np.random.default_rng(SEED + 4)
    batch = np.concatenate([custom, rng.standard_normal((64 - 2 * n, custom.shape[1]))]).astype(np.float32)
    configs = (
        ("a", "fp32 1,048,586 rows", index_a, SeekerConfig(), "tilemax_sup"),
        ("b", "bf16 524,298 rows", index_b, SeekerConfig(), "tilemax"),
        ("c", "int8 1,048,586 rows", index_a, SeekerConfig(index_quantize="int8"), "tilemax_sup_q8"),
        # below Q8_HIER_MIN_TILES: the flat route, still through the int8 kernel
        ("d", "int8 44,446 rows", index_d, SeekerConfig(index_quantize="int8"), "tilemax_sup_q8"),
    )
    launches, services = {}, {}
    for tag, what, index, cfg, kernel in configs:
        svc = SeekerService(enc, cfg, index=index)
        services[tag] = svc
        base = len(index) - 2 * n
        svc.search_items(description=texts[0])  # set-up: the int8 copy of (c) is built here
        torch.cuda.synchronize()
        wrapper = ops.KERNEL_WRAPPERS[kernel]
        # -- the run whose launches are counted ----------------------------
        bodies_before = dict(getattr(wrapper, "bodies", {}))
        ops.reset_launch_counts()
        text_res = [svc.search_items(description=t) for t in texts]
        image_res = [svc.search_items(image_path=im) for im in images]
        both_res = [svc.search_items(description=t, image_path=im) for t, im in zip(texts, images)]
        batch_res = svc._search.search_batch(batch, k=10)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        launches[tag] = counts
        log(f"phase 4 ({tag}) {what}: launches {json.dumps(counts)}")
        layers = enc.arch.vision_layers
        want = {"attention_small": 4 * n * layers, "lora_matmul": LORA_PER_LAYER * 4 * n * layers,
                "topk_retrieve": 0,
                "tilemax": 0, "tilemax_sup": 0, "tilemax_sup_q8": 0, **OFF_BY_DEFAULT}
        want[kernel] = 3 * n + 1  # one per search, the 64-query batch included
        if counts != want:
            raise AssertionError(f"({tag}) launch counts {counts} != expected {want}")
        if bodies_before:  # the Q=1 searches on the CUDA-core body, the batch on the mma body
            ran = {b: wrapper.bodies[b] - bodies_before[b] for b in bodies_before}
            if ran != {"cuda_core": 3 * n, "mma": 1}:
                raise AssertionError(f"({tag}) {kernel} bodies {ran} != {3 * n} cuda_core + 1 mma")
            log(f"phase 4 ({tag}) {kernel} bodies: {json.dumps(ran)}")

        for i in range(n):
            t_top, i_top, b_top = text_res[i][0], image_res[i][0], both_res[i][0]
            if t_top.index != base + i or t_top.score < 0.98:
                raise AssertionError(f"({tag}) text query {i}: top {t_top.index} {t_top.score}")
            if i_top.index != base + n + i or i_top.score < 0.98:
                raise AssertionError(f"({tag}) image query {i}: top {i_top.index} {i_top.score}")
            if b_top.index not in (base + i, base + n + i):
                raise AssertionError(f"({tag}) fused query {i}: top {b_top.index}")
        scores = np.array([[r.score for r in row] for row in batch_res], np.float32)
        ids = np.array([[r.index for r in row] for row in batch_res], np.int64)
        q = torch.from_numpy(batch).cuda()
        if cfg.index_quantize == "int8":
            vq, sc = svc._search._q8[1], svc._search._q8[2]
            rs, ri = R.topk_retrieve_q8(q, vq, sc, 10, pallas_pass1=False)
            tol = 0.0
        else:
            rs, ri = R.topk_retrieve_twopass(q, index.embeddings, 10, pallas_pass1=False)
            tol = 1e-5
        err = np.abs(scores - rs.cpu().numpy()).max()
        if not err <= tol:
            raise AssertionError(f"({tag}) search_batch: kernel vs plain route score err {err}")
        assert_ids_tie_aware(torch, f"({tag}) search_batch", torch.from_numpy(ids).cuda(), rs, ri.long(), tol)
        if list(ids[: 2 * n, 0]) != list(range(base, base + 2 * n)):
            raise AssertionError(f"({tag}) search_batch: custom rows not first {ids[: 2 * n, 0]}")
        log(f"({tag}) self-retrieval: every text and image query finds its own row first, fused "
            f"queries one of their two; 64-query search_batch equals the plain route "
            f"(max score err {err:.3e})")
        # one Q=1 search (passes 1-3) by the kernel route and by the plain route
        q1 = q[:1]
        if cfg.index_quantize == "int8":
            route = lambda p: R.topk_retrieve_q8(q1, vq, sc, 5, pallas_pass1=p)  # noqa: E731
        else:
            route = lambda p: R.topk_retrieve_twopass(q1, index.embeddings, 5, pallas_pass1=p)  # noqa: E731
        log(f"({tag}) one Q=1 k=5 search: kernel route {cuda_ms(torch, lambda: route(None)):.5f} ms, "
            f"plain route {cuda_ms(torch, lambda: route(False)):.5f} ms [{card}]")
        # the 64-query search_batch's search (passes 1-3), both routes
        if cfg.index_quantize == "int8":
            route64 = lambda p: R.topk_retrieve_q8(q, vq, sc, 10, pallas_pass1=p)  # noqa: E731
        else:
            route64 = lambda p: R.topk_retrieve_twopass(q, index.embeddings, 10, pallas_pass1=p)  # noqa: E731
        dev = {p: device_ms(torch, lambda: route64(p), reps=5) for p in (None, False)}
        wall = {p: cuda_ms(torch, lambda: route64(p), reps=10) for p in (None, False)}
        log(f"({tag}) 64-query k=10 search (search_batch's): kernel route device {fmt(dev[None])} ms "
            f"wall {wall[None]:.5f} ms, plain route device {fmt(dev[False])} ms wall "
            f"{wall[False]:.5f} ms; search_batch wall {cuda_ms(torch, lambda: svc._search.search_batch(batch, k=10), reps=5):.5f} ms [{card}]")
        lat = _latency(torch, (
            ("text", lambda: svc.search_items(description=texts[0])),
            ("image", lambda: svc.search_items(image_path=images[0])),
            ("both", lambda: svc.search_items(description=texts[0], image_path=images[0])),
        ))
        log(f"({tag}) seeker request latency over {what}, median of 10 (ms): {json.dumps(lat)} [{card}]")
        if tag in ("a", "c", "d"):
            profile_device_time(
                torch, f"({tag}) fused request",
                lambda: svc.search_items(description=texts[0], image_path=images[0]), lat["both"], card,
            )

    # -- the finder appends to (c)'s index; the int8 copy follows ---------------
    svc = services["c"]
    rows_before = len(index_a)
    if svc._search._q8[0] != rows_before:
        raise AssertionError("the int8 copy does not cover the index")
    quantized = []
    real_quantize = search_mod.quantize_index_int8
    search_mod.quantize_index_int8 = lambda x: quantized.append(x.shape[0]) or real_quantize(x)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        store = SqliteStore(os.path.join(tmp, "found_items.sqlite"))
        # the 2 GB index is not written to disk here (persist_every_insert
        # off); the CPU tests hold the persisted file to the JAX package's
        finder = FinderService(enc, FinderConfig(
            index_path=os.path.join(tmp, "index.npz"),
            reported_images_dir=os.path.join(tmp, "reported"), persist_every_insert=False,
        ), store=store, index=index_a)
        t = time.perf_counter()
        rep = finder.report_item(paths[0], f"{texts[0]} (lapor ulang)", location="lobi gedung a",
                                 reporter="smoke")
        torch.cuda.synchronize()
        report_ms = (time.perf_counter() - t) * 1e3
        ops.reset_launch_counts()
        res = svc.search_items(description=rep.indexed_text)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        items = store.all_items()
    finally:
        search_mod.quantize_index_int8 = real_quantize
        shutil.rmtree(tmp, ignore_errors=True)
    if rep.index_row != rows_before or res[0].index != rep.index_row or res[0].score < 0.98:
        raise AssertionError(f"finder: row {rep.index_row}, next search top {res[0].index} {res[0].score}")
    if svc._search._q8[0] != rows_before + 1 or quantized != [1]:
        raise AssertionError(f"int8 copy: {svc._search._q8[0]} rows, quantized {quantized}")
    if counts["tilemax_sup_q8"] != 1 or len(items) != 1 or items[0].description != rep.indexed_text:
        raise AssertionError(f"finder: launches {counts}, DB rows {items}")
    log(f"finder: report_item {report_ms:.3f} ms; row {rep.index_row} is the next int8 search's "
        f"top 1 (score {res[0].score:.6f}); the int8 copy grew to {svc._search._q8[0]} rows by "
        f"quantizing {quantized[0]} row; DB row {items[0].id}: {items[0].description!r} [{card}]")
    return launches


# ---------------------------------------------------------------------------
# phase 5: ViT-L/14-336 through the config entry point and the service graph
# ---------------------------------------------------------------------------


def _cosines(got, ref):
    return (got * ref).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(ref, axis=1))


def l14_path(torch, card, texts, images, paths, files=None, w8a8=False):
    """Phase 5, phase 7 (b) over ``files`` (loader, renders, photos) when
    given, and phase 8 (c) when ``w8a8``. Returns the launches of phase 5's
    counted run."""
    from concurrent.futures import ThreadPoolExecutor

    from clip_lora_match_tpu_torch import ops
    from clip_lora_match_tpu_torch.api import build_services
    from clip_lora_match_tpu_torch.core.config import ClipConfig, LoraConfig
    from clip_lora_match_tpu_torch.db.store import SqliteStore
    from clip_lora_match_tpu_torch.index.store import EmbeddingIndex
    from clip_lora_match_tpu_torch.lora.adapter import init_lora
    from clip_lora_match_tpu_torch.models.clip import init_params
    from clip_lora_match_tpu_torch.models.encoder import ClipEncoder
    from clip_lora_match_tpu_torch.nn.layers import kernel_flags

    cfg = ClipConfig(model_name="openai/clip-vit-large-patch14-336")
    arch = cfg.arch
    if (arch.image_size, arch.vision_seq_len, arch.vision_width, arch.projection_dim) != (336, 577, 1024, 768):
        raise AssertionError(f"L/14-336 preset: {arch}")
    lcfg = LoraConfig()
    t0 = time.perf_counter()
    params = init_params(SEED, arch, device="cuda")
    lora = init_lora(SEED + 1, arch, lcfg, device="cuda")
    rng = np.random.default_rng(SEED + 5)
    for tower in lora.values():
        for proj in tower["blocks"]["attn"].values():
            proj["b"] = torch.from_numpy(
                rng.normal(0.0, 0.02, tuple(proj["b"].shape)).astype(np.float32)
            ).cuda()
    enc = ClipEncoder(params, arch=arch, config=cfg, device="cuda")
    enc.attach_lora(lora, lcfg.scaling)
    n = len(texts)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_l14_")
    graph = None
    try:
        with kernel_flags(flash_attention=True, fused_mlp=True):
            noise = rng.standard_normal((L14_INDEX_ROWS, arch.projection_dim), dtype=np.float32)
            index = EmbeddingIndex(noise, [""] * L14_INDEX_ROWS, [""] * L14_INDEX_ROWS,
                                   device="cuda", capacity=L14_INDEX_ROWS + 16)
            text_rows = [index.append(enc.encode_text(t), paths[i], texts[i]) for i, t in enumerate(texts)]
            image_rows = [index.append(enc.encode_image(im), paths[i], texts[i]) for i, im in enumerate(images)]
            index_path = os.path.join(tmp, "index", "items_index.npz")
            os.makedirs(os.path.dirname(index_path))
            index.save(index_path)
            del index
            store = SqliteStore(os.path.join(tmp, "found_items.sqlite"))
            graph = build_services(enc, store=store, data_dir=tmp, index_path=index_path)
            seeker = graph.seeker
            if type(seeker.encoder).__name__ != "QueuedEncoder" or seeker.index is not graph.finder.index:
                raise AssertionError("the service graph does not share one queued encoder and one index")
            if len(seeker.index) != L14_INDEX_ROWS + 2 * n:
                raise AssertionError(f"index has {len(seeker.index)} rows")
            torch.cuda.synchronize()
            log(f"phase 5 set-up (L/14-336 weights, LoRA, index, service graph): "
                f"{time.perf_counter() - t0:.3f} s; index rows {len(seeker.index)} at D={arch.projection_dim}")

            # -- the run whose launches are counted -----------------------------
            ops.reset_launch_counts()
            text_res = [seeker.search_items(description=t) for t in texts]
            image_res = [seeker.search_items(image_path=im) for im in images]
            both_res = [seeker.search_items(description=t, image_path=im) for t, im in zip(texts, images)]
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            log("phase 5 launches:", json.dumps(counts))
            vl, tl = arch.vision_layers, arch.text_layers
            want = {
                "attention_small": 2 * n * tl,              # text tower: text + fused requests
                "lora_matmul": LORA_PER_LAYER * 2 * n * (vl + tl),  # per layer per tower pass
                "topk_retrieve": 3 * n,
                "tilemax": 0, "tilemax_sup": 0, "tilemax_sup_q8": 0,
                "mlp_fused": 2 * n * (vl + tl),              # every MLP of both towers
                "flash_attention": 2 * n * vl,               # image tower: image + fused requests
                "approx_topk": 0,
            }
            if counts != want:
                raise AssertionError(f"phase 5 launch counts {counts} != expected {want}")
            for i in range(n):
                t0r, i0r = text_res[i][0], image_res[i][0]
                if t0r.index != text_rows[i] or t0r.score < 0.99:
                    raise AssertionError(f"L/14 text query {i}: top {t0r.index} {t0r.score}")
                if i0r.index != image_rows[i] or i0r.score < 0.99:
                    raise AssertionError(f"L/14 image query {i}: top {i0r.index} {i0r.score}")
                top5 = {r.index for r in both_res[i]}
                if not {text_rows[i], image_rows[i]} <= top5 or len(both_res[i]) != 5:
                    raise AssertionError(f"L/14 fused query {i}: top-5 {sorted(top5)}")
            log("phase 5 self-retrieval: text and image queries return their own rows first "
                f"(min score {min(min(r[0].score for r in text_res), min(r[0].score for r in image_res)):.6f}); "
                "fused queries hold both rows in their top 5")

            # -- concurrent searches coalesce in the queue ----------------------
            many = list(texts) + [f"{texts[i]} warna lain" for i in range(8 - n)]
            sequential = [seeker.search_items(description=t) for t in many]
            queue = seeker.encoder.queue
            linger, queue.linger = queue.linger, 0.5
            try:
                ops.reset_launch_counts()
                with ThreadPoolExecutor(len(many)) as pool:
                    futures = [pool.submit(seeker.search_items, description=t) for t in many]
                    concurrent = [f.result(timeout=300) for f in futures]
                torch.cuda.synchronize()
            finally:
                queue.linger = linger
            passes = ops.launch_counts()["attention_small"] // tl
            worst = 0.0
            for t, a, b in zip(many, sequential, concurrent):
                if [r.index for r in a] != [r.index for r in b]:
                    raise AssertionError(f"concurrent search {t!r}: ids {[r.index for r in b]} "
                                         f"!= sequential {[r.index for r in a]}")
                worst = max(worst, max(abs(x.score - y.score) for x, y in zip(a, b)))
            # a batch of 8 rounds the final projection in another cuBLAS kernel
            # than a batch of 1: scores agree to a bf16 step
            if not (passes < len(many) and worst <= 5e-3):
                raise AssertionError(f"concurrent searches: {passes} text tower passes, score diff {worst}")
            log(f"phase 5 batch queue: {len(many)} concurrent text searches in {passes} text tower "
                f"pass(es), the sequential ids, max score diff {worst:.3e}")

            # -- request latency --------------------------------------------------
            lat = _latency(torch, (
                ("text", lambda: seeker.search_items(description=texts[0])),
                ("image", lambda: seeker.search_items(image_path=images[0])),
                ("both", lambda: seeker.search_items(description=texts[0], image_path=images[0])),
            ))
            log(f"phase 5 L/14-336 seeker request latency, median of 10 (ms): {json.dumps(lat)} [{card}]")
            profile_device_time(
                torch, "phase 5 fused request",
                lambda: seeker.search_items(description=texts[0], image_path=images[0]), lat["both"], card,
            )

            # -- 32-image batch: kernel path (bf16) against the plain path (fp32) --
            pix = np.clip(rng.normal(0.0, 1.0, (32, arch.image_size, arch.image_size, 3)), -2, 2)
            pix = pix.astype(np.float32)
            pix[:n] = enc.preprocessor.preprocess_images(images)
            img_k = enc.encode_image_batch(pix)
            batch_ms = _host_ms(lambda: enc.encode_image_batch(pix), reps=5)
            log(f"phase 5 32-image batch: {batch_ms:.3f} ms, {32e3 / batch_ms:.1f} images/s "
                f"(host preprocessing excluded) [{card}]")
            profile_device_time(torch, "phase 5 32-image batch", lambda: enc.encode_image_batch(pix),
                                batch_ms, card)
            plain = ClipEncoder(
                params, arch=arch, config=ClipConfig(arch=arch, use_pallas_kernels=False),
                compute_dtype="float32", device="cuda",
            )
            plain.attach_lora(lora, lcfg.scaling)
            ops.reset_launch_counts()
            img_p = plain.encode_image_batch(pix)
            if any(ops.launch_counts().values()):
                raise AssertionError(f"plain encoder launched kernels: {ops.launch_counts()}")
            del plain
            if img_k.shape != img_p.shape or not np.isfinite(img_k).all():
                raise AssertionError(f"32-image batch: shape {img_k.shape} or non-finite values")
            cos = _cosines(img_k, img_p)
            if not cos.min() >= 0.99:
                raise AssertionError(f"32-image batch: min cosine {cos.min()} < 0.99")
            log(f"phase 5 32-image batch kernel path (bf16, flash + fused MLP) vs plain path (fp32): "
                f"min cosine {cos.min():.6f}")
            if files is not None:
                l14_files(torch, card, enc, params, lora, lcfg, cfg, files)
            if w8a8:
                l14_w8a8(torch, card, enc, pix, img_k)

            # -- the image tower with flash and the fused MLP on and off ----------
            table = []
            for B in (1, 32):
                for flash in (True, False):
                    for fused in (True, False):
                        with kernel_flags(flash_attention=flash, fused_mlp=fused):
                            rows = device_rows(torch, lambda: enc.encode_image_batch(pix[:B]))
                            wall = _host_ms(lambda: enc.encode_image_batch(pix[:B]), reps=5)
                        table.append(dict(B=B, flash=flash, fused_mlp=fused,
                                          device_ms=sum(r[0] for r in rows), wall_ms=wall))
            for row in table:
                log(f"phase 5 image tower B={row['B']} flash={row['flash']} fused_mlp={row['fused_mlp']}: "
                    f"device {row['device_ms']:.4f} ms, wall {row['wall_ms']:.4f} ms [{card}]")

            # -- the finder through the graph --------------------------------------
            rows_before = len(graph.finder.index)
            rep = graph.finder.report_item(paths[0], f"{texts[0]} (lapor ulang)", location="kantin",
                                           reporter="smoke")
            res = seeker.search_items(description=rep.indexed_text)
            items = store.all_items()
            if rep.index_row != rows_before or res[0].index != rep.index_row or res[0].score < 0.99:
                raise AssertionError(f"L/14 finder: row {rep.index_row}, next search top {res[0].index}")
            if len(items) != 1 or items[0].description != rep.indexed_text or not os.path.exists(index_path):
                raise AssertionError(f"L/14 finder: DB rows {items}")
            log(f"phase 5 finder: row {rep.index_row} is the next search's top 1 (score {res[0].score:.6f}); "
                f"DB row {items[0].id}: {items[0].description!r}")
    finally:
        if graph is not None:
            graph.seeker.encoder.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return counts


def l14_files(torch, card, enc, params, lora, lcfg, cfg, files):
    """Phase 7 (b): one 32-image batch of files through phase 5's L/14-336
    encoder (flash and the fused MLP forced), beside its float feed."""
    from clip_lora_match_tpu_torch.models.encoder import ClipEncoder

    t0 = time.perf_counter()
    loader, renders, photos = files
    vl = enc.arch.vision_layers
    enc32 = ClipEncoder(params, arch=enc.arch, config=cfg, compute_dtype="float32", device=enc.device)
    enc32.attach_lora(lora, lcfg.scaling)
    check_file_encodes(torch, "phase 7 (b) L/14-336", loader, enc, enc32, renders, photos, 32,
                       {"flash_attention": vl, "mlp_fused": vl, "lora_matmul": LORA_PER_LAYER * vl}, card)
    del enc32
    torch.cuda.empty_cache()
    _feeds(torch, "phase 7 (b)", enc, renders[:32], 32, card)
    log(f"phase 7 (b): {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 6: the YOLO crop stage and the HTTP API
# ---------------------------------------------------------------------------

YOLO_WEIGHTS = ("models/yolo_synth/yolov8n_synth.npz", "models/yolo_real/yolov8n_real.npz")
N_RENDERS = 6  # held-out detection renders, random.Random(999), as tests/test_yolo_trained.py


def _iou(a, b) -> float:
    ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
    ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, ix2 - ix1) * max(0.0, iy2 - iy1)
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / max(union, 1e-9)


def _renders(tmp: str) -> list:
    """(path, ground-truth boxes) of the held-out renders, written as PNG."""
    import random

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import generate_fashion_corpus as gen

    rng = random.Random(999)
    out = []
    for i in range(N_RENDERS):
        img, boxes = gen.render_detect_image(rng, 320, max_objects=1)
        path = os.path.join(tmp, f"render_{i}.png")
        img.save(path)
        out.append((path, boxes))
    return out


def detector_phase(torch, card, paths, renders):
    """Phase 6 (a): both committed checkpoints on the card in bf16 and fp32,
    nms_fixed against its CPU run, latency at n@320 B=1 and throughput of a
    seeded YOLOv8-s at 640² B=16. Returns the synth detector (bf16)."""
    from PIL import Image

    from clip_lora_match_tpu_torch.models.yolo import yolov8 as Y
    from clip_lora_match_tpu_torch.models.yolo.postprocess import nms_fixed

    images = [Image.open(p).convert("RGB") for p in list(paths) + [r[0] for r in renders]]
    dets = {}
    for weights in YOLO_WEIGHTS:
        name = os.path.basename(weights)
        bf16 = Y.load_detector(os.path.join(REPO, weights), device="cuda")
        fp32 = Y.load_detector(os.path.join(REPO, weights), device="cuda", compute_dtype=torch.float32)
        on_card = {t.device.type for t in (bf16._params_c["backbone"]["0"]["kernel"],
                                           fp32._params_c["head"]["levels"][2]["cv3"][2]["bias"])}
        if on_card != {"cuda"} or bf16.compute_dtype != torch.bfloat16 or bf16.cfg.imgsz != 320:
            raise AssertionError(f"{name}: parameters on {on_card}, {bf16.compute_dtype}, imgsz {bf16.cfg.imgsz}")
        found = both = 0
        worst = 1.0
        for img in images:
            d16, d32 = bf16.detect(img, 0.25, 0.45, 5), fp32.detect(img, 0.25, 0.45, 5)
            found += bool(d16)
            if d16 and d32:
                both += 1
                iou = _iou(d16[0].box, d32[0].box)
                worst = min(worst, iou)
                if iou < 0.9 or d16[0].class_id != d32[0].class_id:
                    raise AssertionError(f"{name}: bf16 top box {d16[0]} vs fp32 {d32[0]} (IoU {iou:.4f})")
        log(f"phase 6 (a) {name} on the card: detections on {found} of {len(images)} images (5 custom "
            f"photos, {N_RENDERS} renders); bf16 vs fp32 top box: same class, min IoU {worst:.4f} over "
            f"{both} images where both detect")
        dets[name] = (bf16, fp32)
    bf16, fp32 = dets["yolov8n_synth.npz"]

    hits = total = 0
    for path, boxes in renders:
        got = bf16.detect(Image.open(path).convert("RGB"), 0.25, 0.45, 5)
        for gt in boxes:
            total += 1
            hits += any(_iou(gt[:4], d.box) >= 0.5 for d in got)
    if total < 4 or hits / total < 0.75:
        raise AssertionError(f"synth detector IoU@0.5 recall {hits}/{total} < 0.75")
    log(f"phase 6 (a) synth detector (bf16) IoU@0.5 recall on the held-out renders: {hits}/{total}")

    # nms_fixed on the card against its CPU run on the same decoded boxes
    arr, _, _ = Y.letterbox(Image.open(renders[0][0]).convert("RGB"), 320)
    with torch.inference_mode():
        x = torch.from_numpy(arr).permute(2, 0, 1)[None].cuda()
        boxes, probs = Y.decode_predictions(Y.forward(fp32._params_c, x.contiguous(memory_format=torch.channels_last)))
        scores, classes = probs.amax(-1), probs.argmax(-1)
        for agnostic in (False, True):
            got = nms_fixed(boxes, scores, classes, 0.05, 0.45, max_det=16, agnostic=agnostic)
            want = nms_fixed(boxes.cpu(), scores.cpu(), classes.cpu(), 0.05, 0.45, max_det=16, agnostic=agnostic)
            if not all(g.device.type == "cuda" and torch.equal(g.cpu(), w) for g, w in zip(got, want)):
                raise AssertionError(f"nms_fixed (agnostic={agnostic}): the card's run differs from the CPU's")
    log(f"phase 6 (a) nms_fixed on the card equals its CPU run over {boxes.shape[1]} decoded boxes "
        f"(class-aware and agnostic, conf 0.05, {int(got[3].sum())} kept of 16 slots)")

    img = images[0]
    wall = _host_ms(lambda: bf16.detect(img, 0.25, 0.45, 5))
    dev = device_ms(torch, lambda: bf16.detect(img, 0.25, 0.45, 5))
    log(f"phase 6 (a) n@320 detect, B=1 (host letterbox, bf16 forward, decode, NMS, one readback): "
        f"wall median of 10 {wall:.4f} ms, device {fmt(dev)} ms [{card}]")
    profile_device_time(torch, "phase 6 (a) n@320 detect", lambda: bf16.detect(img, 0.25, 0.45, 5), wall, card)

    s_det = Y.YoloV8Detector(Y.init_params(SEED, device="cuda"), device="cuda")  # -s, 80 classes, 640²
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    batch = torch.rand(16, 3, 640, 640, device="cuda", generator=gen)
    call = lambda: s_det.infer(batch, 0.25, 0.45, 5)  # noqa: E731
    ms = cuda_ms(torch, call, reps=10)
    dev = device_ms(torch, call, reps=5)
    log(f"phase 6 (a) seeded YOLOv8-s (80 classes) at 640², B=16, bf16: {ms:.4f} ms per batch "
        f"({16e3 / ms:.1f} images/s), device {fmt(dev)} ms per batch [{card}]")
    del s_det, batch
    return bf16


def crop_phase(torch, card, enc, index, paths, renders, det, tmp):
    """Phase 6 (b): the device crop against its CPU run, the seeker's disk and
    device crop paths over phase 3's encoder and index, the fused search
    against the staged one, and the finder's crop. Returns the device
    seeker run's launches."""
    import traceback
    import warnings

    from PIL import Image

    from clip_lora_match_tpu_torch import ops
    from clip_lora_match_tpu_torch.core.config import YoloConfig
    from clip_lora_match_tpu_torch.index.store import EmbeddingIndex
    from clip_lora_match_tpu_torch.models.yolo.cropper import YoloCropper
    from clip_lora_match_tpu_torch.models.yolo.device_crop import (
        crop_embed_pipeline,
        crop_resize_normalize,
        make_fused_search,
    )
    from clip_lora_match_tpu_torch.ops import retrieval_topk as R
    from clip_lora_match_tpu_torch.services.finder import FinderConfig, FinderService
    from clip_lora_match_tpu_torch.services.seeker import SeekerConfig, SeekerService

    photo = np.asarray(Image.open(paths[0]).convert("RGB"), np.float32) / 255.0
    H, W = photo.shape[:2]
    boxes = torch.tensor([[0.0, 0.0, W, H], [10.3, 5.7, W - 20.9, H - 30.2], [200.5, 100.25, 215.75, 111.5]])
    imgs = torch.from_numpy(photo)[None].expand(3, -1, -1, -1)
    got = crop_resize_normalize(imgs.cuda(), boxes.cuda(), enc.arch.image_size)
    want = crop_resize_normalize(imgs, boxes, enc.arch.image_size)
    err = (got.cpu() - want).abs().max().item()
    if not err <= 1e-4:
        raise AssertionError(f"crop_resize_normalize: card vs CPU max abs err {err}")
    log(f"phase 6 (b) crop_resize_normalize on the card vs the CPU ({W}x{H} photo, 3 boxes, out "
        f"{enc.arch.image_size}): max abs err {err:.3e}")

    queries = list(paths) + [r[0] for r in renders]
    cropper = YoloCropper(det, YoloConfig(crop_save_dir=os.path.join(tmp, "crops")))
    emb = {}
    counts = None
    for mode in ("disk", "device"):
        svc = SeekerService(enc, SeekerConfig(use_yolo_crop=True, use_device_crop=mode == "device"),
                            cropper=cropper, index=index)
        svc.search_items(image_path=queries[0])  # warm-up
        svc.device_crops = 0
        ops.reset_launch_counts()
        emb[mode] = np.stack([svc._build_query_embedding(None, q) for q in queries])
        res = [svc.search_items(image_path=q) for q in queries]
        torch.cuda.synchronize()
        if mode == "device":
            counts = ops.launch_counts()
            if svc.device_crops != 2 * len(queries):
                raise AssertionError(f"device crop served {svc.device_crops} of {2 * len(queries)} image queries")
            layers = enc.arch.vision_layers
            want = {"attention_small": 2 * len(queries) * layers,
                    "lora_matmul": LORA_PER_LAYER * 2 * len(queries) * layers, "topk_retrieve": len(queries)}
            if {k: counts[k] for k in want} != want:
                raise AssertionError(f"device crop seeker launches {counts} != {want}")
            log(f"phase 6 (b) seeker, use_device_crop: the device crop served all {svc.device_crops} image "
                f"queries; launches {json.dumps(counts)}")
        if any(len(r) != 5 for r in res):
            raise AssertionError(f"seeker ({mode} crop): a query without 5 results")
        lat = _latency(torch, (("image", lambda: svc.search_items(image_path=queries[-1])),))
        log(f"phase 6 (b) seeker image request with the {mode} crop, median of 10: {lat['image']:.4f} ms [{card}]")
    cos = (emb["disk"] * emb["device"]).sum(1)
    log(f"phase 6 (b) disk vs device crop query embeddings: cosine min {cos.min():.4f} median "
        f"{np.median(cos):.4f} (the disk path center-crops the saved crop, the device path stretches "
        f"the box)")

    search = make_fused_search(det, enc, index.embeddings, k=5)
    strict, photos = 0, []
    for path in queries:
        img = Image.open(path).convert("RGB")
        s, i, box, detected = search(np.asarray(img, np.uint8))
        q, dets = crop_embed_pipeline(det, enc, img)
        rs, ri = R.topk_retrieve_auto(torch.from_numpy(q).cuda(), index.embeddings, 5)
        rs, ri = rs[0].cpu().numpy(), ri[0].cpu().numpy()
        if path in paths:  # 480x360: the device letterbox resamples otherwise than PIL's
            photos.append(f"{detected}/{bool(dets)}" + (f" IoU {_iou(box, dets[0].box):.3f}"
                                                        if detected and dets else ""))
            continue
        # a 320² render: both letterboxes are the identity, so both paths see one canvas
        if detected != bool(dets):
            raise AssertionError(f"fused search {path}: detected {detected}, staged {len(dets)} boxes")
        if not detected:  # the full image: resampled on the device here, by PIL in the staged path
            continue
        strict += 1
        if np.abs(box - np.asarray(dets[0].box)).max() > 1e-3 or list(i) != list(ri) or np.abs(s - rs).max() > 1e-3:
            raise AssertionError(f"fused search {path}: box {box} ids {i} scores {s}; staged "
                                 f"{dets[0].box} {ri} {rs}")
    if strict < 3:
        raise AssertionError(f"fused search: only {strict} renders detected")
    log(f"phase 6 (b) fused search: the staged path's box, top-5 ids and scores (within 1e-3) on "
        f"{strict} detected renders; on the photos fused/staged detected and box IoU: {photos}")
    arr = np.asarray(Image.open(queries[-1]).convert("RGB"), np.uint8)
    ops.reset_launch_counts()
    search(arr)
    fused_counts = ops.launch_counts()
    if fused_counts["topk_retrieve"] != 1 or fused_counts["attention_small"] != enc.arch.vision_layers:
        raise AssertionError(f"fused search launches {fused_counts}")
    lat = _latency(torch, (("fused", lambda: search(arr)),
                           ("staged", lambda: crop_embed_pipeline(det, enc, Image.open(queries[-1]).convert("RGB"))),))
    torch.cuda.synchronize()
    syncs = []
    inside = [False]  # setting the debug mode synchronizes itself: count the call's only

    def record(message, category, filename, lineno, file=None, line=None):
        if inside[0] and "synchroniz" in str(message):
            # the Python frames that led to the synchronizing call, innermost
            # last, without this hook's and the warnings module's
            frames = [f for f in traceback.extract_stack()[:-1] if not f.filename.endswith("warnings.py")]
            syncs.append(" <- ".join(f"{os.path.basename(f.filename)}:{f.lineno} {f.name}"
                                     for f in reversed(frames[-3:])))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            inside[0] = True
            search(arr)
            inside[0] = False
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = {w: syncs.count(w) for w in sorted(set(syncs))}
    log(f"phase 6 (b) fused search (detect, crop, B/32 tower, top-k over {len(index)} rows): median of "
        f"10 {lat['fused']:.4f} ms, staged crop_embed_pipeline alone {lat['staged']:.4f} ms; "
        f"host syncs in one call: {len(syncs)}: {json.dumps(where)} [{card}]")
    profile_device_time(torch, "phase 6 (b) fused search", lambda: search(arr), lat["fused"], card)

    finder = FinderService(enc, FinderConfig(
        index_path=os.path.join(tmp, "finder", "index.npz"), reported_images_dir=os.path.join(tmp, "reported"),
        use_yolo_crop=True), cropper=cropper, index=EmbeddingIndex(dim=enc.arch.projection_dim, device="cuda"))
    rep = finder.report_item(paths[1], "dompet coklat", location="kantin teknik")
    if rep.index_row != 0 or not rep.crop_used or not os.path.exists(rep.stored_image_path):
        raise AssertionError(f"finder with the crop stage: {rep}")
    log(f"phase 6 (b) FinderService(use_yolo_crop=True): row {rep.index_row}, crop_used {rep.crop_used}, "
        f"crops {sorted(os.listdir(cropper.cfg.crop_save_dir))[-1:]}")
    return counts


def _multipart(fields=None, files=None, boundary="chipsmokeboundary"):
    out = bytearray()
    for k, v in (fields or {}).items():
        out += f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode()
    for k, (filename, ctype, data) in (files or {}).items():
        out += (f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"; filename="{filename}"\r\n'
                f"Content-Type: {ctype}\r\n\r\n").encode() + data + b"\r\n"
    out += f"--{boundary}--\r\n".encode()
    return bytes(out), f"multipart/form-data; boundary={boundary}"


def _http(url, body=None, ctype=None):
    """(status, parsed JSON) over a real socket; 4xx/5xx do not raise."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST" if body is not None else "GET")
    if ctype:
        req.add_header("Content-Type", ctype)
    try:
        resp = urllib.request.urlopen(req, timeout=120)
    except urllib.error.HTTPError as e:
        resp = e
    with resp:
        return resp.status, json.loads(resp.read())


def http_phase(torch, card, enc, index, texts, paths, lat3, tmp):
    """Phase 6 (c): the port's stdlib server over build_services on the card.
    Returns the launches of its counted text searches."""
    from concurrent.futures import ThreadPoolExecutor

    from clip_lora_match_tpu_torch import ops
    from clip_lora_match_tpu_torch.api.http_server import create_server, serve_background
    from clip_lora_match_tpu_torch.db.store import SqliteStore

    from clip_lora_match_tpu_torch.index.store import EmbeddingIndex

    # phase 3's rows with their metadata: the seeded rows, then the custom
    # items' 5 text rows and 5 image rows
    seeded = len(index) - 2 * len(texts)
    index_path = os.path.join(tmp, "index", "items_index.npz")
    os.makedirs(os.path.dirname(index_path))
    EmbeddingIndex(index.embeddings_np(), [""] * seeded + list(paths) * 2, [""] * seeded + list(texts) * 2,
                   device="cpu").save(index_path)
    server = create_server("127.0.0.1", 0, encoder=enc, store=SqliteStore(os.path.join(tmp, "found.sqlite")),
                           data_dir=tmp, index_path=index_path)
    graph = server.RequestHandlerClass.graph
    thread = serve_background(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        if len(graph.seeker.index) != len(index) or graph.seeker.index.embeddings.device.type != "cuda":
            raise AssertionError(f"server index: {len(graph.seeker.index)} rows")
        if _http(f"{base}/health") != (200, {"status": "ok"}):
            raise AssertionError("health")
        photo = open(paths[2], "rb").read()
        desc = "jam tangan silver tertinggal di lab kimia lantai dua"
        status, rep = _http(f"{base}/api/report", *_multipart(
            {"description": desc, "reporter": "smoke"}, {"image": (os.path.basename(paths[2]), "image/jpeg", photo)}))
        if status != 200 or rep["description"] != desc:
            raise AssertionError(f"report: {status} {rep}")
        status, res = _http(f"{base}/api/search", *_multipart({"description": desc}))
        top = res["results"][0] if status == 200 and res["results"] else {}
        if top.get("image_path") != rep["image_path"] or top.get("text") != desc or top.get("score", 0) < 0.99:
            raise AssertionError(f"search after report: {status} {res}")
        upload = {"image": ("query.jpg", "image/jpeg", photo)}
        for fields in ({}, {"description": texts[2]}):
            status, res = _http(f"{base}/api/search", *_multipart(fields, upload))
            if status != 200 or len(res["results"]) != 5 or os.path.exists(res["query_image_path"]):
                raise AssertionError(f"image search {fields}: {status} {res}")
        status, items = _http(f"{base}/api/items")
        if status != 200 or not items or items[0]["id"] != rep["id"] or items[0]["description"] != desc:
            raise AssertionError(f"items: {status} {items}")
        bad = (_http(f"{base}/api/search", *_multipart({"description": " "}))[0],
               _http(f"{base}/api/report", *_multipart({"description": "x"},
                                                        {"image": ("a.txt", "text/plain", b"bukan gambar")}))[0])
        if bad != (400, 400):
            raise AssertionError(f"validation: {bad}")
        log(f"phase 6 (c) HTTP over {base}: health; report row {rep['id']} is the next search's top 1 "
            f"(score {top['score']:.6f}); image and text+image searches; items lists the report first; "
            f"missing fields and a non-image upload give {bad}")

        # -- the counted run: text searches over the wire -----------------------
        n = 5
        ops.reset_launch_counts()
        for t in texts[:n]:
            if _http(f"{base}/api/search", *_multipart({"description": t}))[0] != 200:
                raise AssertionError("text search")
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        layers = enc.arch.text_layers
        want = {"attention_small": n * layers, "lora_matmul": LORA_PER_LAYER * n * layers, "topk_retrieve": n,
                "tilemax": 0, "tilemax_sup": 0, "tilemax_sup_q8": 0, **OFF_BY_DEFAULT}
        if counts != want:
            raise AssertionError(f"HTTP text search launches {counts} != {want}")
        log(f"phase 6 (c) launches over {n} HTTP text searches: {json.dumps(counts)} (per search "
            f"attention_small {layers}, lora_matmul {LORA_PER_LAYER * layers}, topk_retrieve 1, as phase 3's "
            f"in-process text request)")

        many = [f"{texts[i % len(texts)]} nomor {i}" for i in range(8)]
        sequential = [_http(f"{base}/api/search", *_multipart({"description": t}))[1] for t in many]
        queue = graph.seeker.encoder.queue
        linger, queue.linger = queue.linger, 0.5
        try:
            ops.reset_launch_counts()
            with ThreadPoolExecutor(8) as pool:
                futures = [pool.submit(_http, f"{base}/api/search", *_multipart({"description": t})) for t in many]
                concurrent = [f.result(timeout=300) for f in futures]
            torch.cuda.synchronize()
        finally:
            queue.linger = linger
        passes = ops.launch_counts()["attention_small"] // layers
        worst = 0.0
        for a, (status, b) in zip(sequential, concurrent):
            ids_a = [r["image_path"] + r["text"] for r in a["results"]]
            ids_b = [r["image_path"] + r["text"] for r in b["results"]]
            if status != 200 or ids_a != ids_b:
                raise AssertionError(f"concurrent search: {status} {ids_b} != {ids_a}")
            worst = max(worst, max(abs(x["score"] - y["score"]) for x, y in zip(a["results"], b["results"])))
        if not (passes < 8 and worst <= 5e-3):
            raise AssertionError(f"8 concurrent HTTP searches: {passes} text tower passes, score diff {worst}")
        log(f"phase 6 (c) 8 concurrent HTTP searches: {passes} text tower pass(es), the sequential "
            f"results, max score diff {worst:.3e}")

        text_body = _multipart({"description": texts[0]})
        image_body = _multipart(files=upload)
        both_body = _multipart({"description": texts[0]}, upload)
        wire = _latency(torch, (
            ("text", lambda: _http(f"{base}/api/search", *text_body)),
            ("image", lambda: _http(f"{base}/api/search", *image_body)),
            ("both", lambda: _http(f"{base}/api/search", *both_body)),
        ))
        seeker = graph.seeker
        local = _latency(torch, (
            ("text", lambda: seeker.search_items(description=texts[0])),
            ("image", lambda: seeker.search_items(image_path=paths[2])),
            ("both", lambda: seeker.search_items(description=texts[0], image_path=paths[2])),
        ))
        log(f"phase 6 (c) request latency, median of 10 (ms): over the wire {json.dumps(wire)}; the "
            f"server's seeker in-process {json.dumps(local)}; phase 3's in-process {json.dumps(lat3)} [{card}]")
    finally:
        server.shutdown()
        server.server_close()
        graph.seeker.encoder.close()
        thread.join(timeout=30)
    return counts


def crop_http_path(torch, card, enc, index, texts, paths, lat3):
    """Phase 6: (a) the detector, (b) the crop stage, (c) the HTTP API.
    Returns the launches of (b)'s device-crop seeker run and (c)'s HTTP text
    searches."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p6_")
    try:
        renders = _renders(tmp)
        det = detector_phase(torch, card, paths, renders)
        crop = crop_phase(torch, card, enc, index, paths, renders, det, tmp)
        http = http_phase(torch, card, enc, index, texts, paths, lat3, os.path.join(tmp, "http"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 6: {time.perf_counter() - t0:.1f} s")
    return crop, http


# ---------------------------------------------------------------------------
# phase 7: the image-file encode path (native JPEG loader, uint8 feed)
# ---------------------------------------------------------------------------

N_RENDERS_FILES = 480  # five batches of 96
N_PHOTOS = 192  # 1200x1600 photo-size files made from the first renders


def file_corpus(tmp: str) -> tuple[list, list]:
    """(render paths, photo paths): the fashion renders as JPEG (quality 92)
    and photo-size copies of the first ones (1200x1600, bilinear, quality
    90), as bench.py's image-file benchmark makes them."""
    from PIL import Image

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import generate_fashion_corpus as gen

    combos = [(c, a, g, p) for c in list(gen.COLOURS)[:8] for a in list(gen.ARTICLES)[:8]
              for g in gen.GENDERS for p in gen.PATTERNS[:3]][:N_RENDERS_FILES]
    renders, photos = [], []
    for i, (c, a, g, p) in enumerate(combos):
        path = os.path.join(tmp, f"render_{i:04d}.jpg")
        gen.render(c, a, g, p, "grey" if c != "grey" else "red").save(path, quality=92)
        renders.append(path)
    for i, src in enumerate(renders[:N_PHOTOS]):
        path = os.path.join(tmp, f"photo_{i:04d}.jpg")
        Image.open(src).resize((1200, 1600), Image.BILINEAR).save(path, quality=90)
        photos.append(path)
    return renders, photos


def native_loader_check() -> str:
    """Which loader the image-file path runs. Where g++ finds jpeglib.h the
    native library must build (a failure raises); elsewhere the PIL rows
    serve, as the JAX package would."""
    from clip_lora_match_tpu_torch.core import native
    from clip_lora_match_tpu_torch.data.native_loader import native_available

    probe = subprocess.run(["g++", "-fsyntax-only", "-x", "c++", "-"],
                           input="#include <cstdio>\n#include <jpeglib.h>\n",
                           capture_output=True, text=True, timeout=60)
    if probe.returncode != 0:
        log("phase 7 loader: PIL (g++ finds no jpeglib.h: every row through PIL, as the JAX package)")
        return "PIL"
    t = time.perf_counter()
    lib = native.build("clm_native")
    if not native_available():
        raise AssertionError("phase 7: the native loader built but does not load")
    log(f"phase 7 loader: native ({lib.name}, libjpeg; build or cache {time.perf_counter() - t:.2f} s)")
    return "native"


def _feed_profile(torch, name: str, fn, upload, card: str) -> dict:
    """Device busy, Memcpy HtoD and idle share of one call (torch.profiler,
    beside the median unprofiled wall of 3 calls), and the call's upload
    alone timed between CUDA events (the profiler does not always list the
    copy)."""
    rows = device_rows(torch, fn)
    wall = _host_ms(fn, reps=3)
    busy = sum(r[0] for r in rows)
    htod = sum(r[0] for r in rows if "HtoD" in r[2])
    up = cuda_ms(torch, upload, reps=10, warmup=2)
    log(f"{name}: device busy {busy:.4f} ms, Memcpy HtoD {htod:.4f} ms (profiler), upload "
        f"{up:.4f} ms (CUDA events), wall {wall:.4f} ms, idle share {1 - busy / wall:.3f} [{card}]")
    for ms, count, key in sorted(rows, reverse=True)[:6]:
        log(f"  {ms:9.4f} ms  x{count:<4d} {key[:90]}")
    return dict(busy_ms=busy, htod_ms=htod, upload_ms=up, wall_ms=wall)


def _feeds(torch, tag: str, enc, files, batch: int, card: str) -> None:
    """One batch of ``files`` through the u8 feed (encode_image_files, its
    decode inside) and through the float feed (encode_image_batch of the
    same pixels), each with its upload as the path makes it: uint8 from
    pinned memory, fp32 from pageable memory."""
    from clip_lora_match_tpu_torch.data.native_loader import preprocess_image_batch_native_u8

    pix = enc.preprocessor.preprocess_images(files)
    u8 = torch.from_numpy(preprocess_image_batch_native_u8(files, enc.cfg.preprocess)).pin_memory()
    _feed_profile(torch, f"{tag} one {batch}-image batch, encode_image_files (u8 feed, {u8.nbytes / 1e6:.1f} MB, "
                  "decode inside)", lambda: enc.encode_image_files(files, batch_size=batch, dct_scale=False),
                  lambda: u8.to("cuda", non_blocking=True), card)
    _feed_profile(torch, f"{tag} one {batch}-image batch, encode_image_batch (float feed, {pix.nbytes / 1e6:.1f} MB)",
                  lambda: enc.encode_image_batch(pix), lambda: torch.from_numpy(pix).to("cuda"), card)


def _files_rate(torch, enc, paths, reps: int = 2, **kw) -> list:
    """images/s of encode_image_files over ``paths`` (decode included), per rep."""
    rates = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        enc.encode_image_files(paths, **kw)
        torch.cuda.synchronize()
        rates.append(len(paths) / (time.perf_counter() - t))
    return rates


def check_file_encodes(torch, tag: str, loader: str, enc, enc32, renders, photos, batch: int,
                       want: dict, card: str):
    """The asserts of one part of phase 7: the u8 path against the float
    feed (bf16 and fp32 compute), DCT-scaled against full decode, the launch
    counts of one batch, and the host decode ms of one batch."""
    from clip_lora_match_tpu_torch import ops
    from clip_lora_match_tpu_torch.data.native_loader import preprocess_image_batch_native_u8

    log(f"{tag}: loader {loader}")
    files = renders[:batch]
    for name, e, floor in (("bf16", enc, 0.999), ("fp32", enc32, 0.9999)):
        got = e.encode_image_files(files, batch_size=batch, dct_scale=False)
        ref = e.encode_image(files)
        if got.shape != ref.shape or not np.isfinite(got).all():
            raise AssertionError(f"{tag}: encode_image_files shape {got.shape} or non-finite values")
        cos = _cosines(got, ref).min()
        if not cos > floor:
            raise AssertionError(f"{tag} {name}: encode_image_files vs encode_image min cosine {cos} <= {floor}")
        log(f"{tag} {name} compute: encode_image_files (u8 feed) vs encode_image (float feed) over "
            f"{batch} files: min cosine {cos:.6f} (> {floor}) [{card}]")
    full = enc.encode_image_files(photos[:batch], batch_size=batch, dct_scale=False)
    fast = enc.encode_image_files(photos[:batch], batch_size=batch, dct_scale=True)
    cos = _cosines(fast, full).min()
    if not cos >= 0.999:
        raise AssertionError(f"{tag}: dct_scale on vs off min cosine {cos} < 0.999")
    log(f"{tag}: dct_scale=True vs False over {batch} 1200x1600 photos: min cosine {cos:.6f} [{card}]")
    enc.encode_image_files(files, batch_size=batch)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    enc.encode_image_files(files, batch_size=batch)
    torch.cuda.synchronize()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    if counts != want:
        raise AssertionError(f"{tag}: launches of one {batch}-image batch {counts} != {want}")
    log(f"{tag}: launches of one {batch}-image batch: {json.dumps(counts)} [{card}]")
    size = enc.cfg.preprocess.image_size
    decode = {
        "renders": _host_ms(lambda: preprocess_image_batch_native_u8(files, enc.cfg.preprocess, dct_scale=False), 3),
        "photos_dct_off": _host_ms(lambda: preprocess_image_batch_native_u8(
            photos[:batch], enc.cfg.preprocess, dct_scale=False), 3),
        "photos_dct_on": _host_ms(lambda: preprocess_image_batch_native_u8(
            photos[:batch], enc.cfg.preprocess, dct_scale=True), 3),
    }
    log(f"{tag}: host decode ms of one {batch}-image batch at {size}^2 (median of 3, "
        f"{os.cpu_count()} threads): {json.dumps(decode)} [{card}]")


def image_files_path(torch, card, enc, files):
    """Phase 7 (a): ViT-B/32 (phase 3's encoder) over the renders and photos."""
    from clip_lora_match_tpu_torch.models.encoder import HOST_STAGING, ClipEncoder

    t0 = time.perf_counter()
    loader, renders, photos = files
    layers = enc.arch.vision_layers
    enc32 = ClipEncoder(enc.params, arch=enc.arch, config=enc.cfg, compute_dtype="float32", device=enc.device)
    enc32.attach_lora(enc.lora, enc.lora_scaling)
    check_file_encodes(torch, "phase 7 (a) B/32", loader, enc, enc32, renders, photos, 96,
                       {"attention_small": layers, "lora_matmul": LORA_PER_LAYER * layers}, card)
    del enc32

    enc.encode_image_files(renders[:96])  # warm
    rates = {
        "renders": _files_rate(torch, enc, renders, dct_scale=False),
        "renders_1_thread": _files_rate(torch, enc, renders, dct_scale=False, num_threads=1),
        "photos_dct_on": _files_rate(torch, enc, photos, dct_scale=True),
        "photos_dct_off": _files_rate(torch, enc, photos, dct_scale=False),
        "photos_dct_off_1_thread": _files_rate(torch, enc, photos, reps=1, dct_scale=False, num_threads=1),
    }
    log(f"phase 7 (a) encode_image_files images/s (decode included; {os.cpu_count()} decode threads "
        f"unless 1): {json.dumps(rates)} [{card}]")
    # host staging: each way in turns (a, b, c, c, b, a), twice
    staging = {name: [] for name in HOST_STAGING}
    for name in 2 * (HOST_STAGING + HOST_STAGING[::-1]):
        enc.host_staging = name
        staging[name] += _files_rate(torch, enc, renders, reps=1, dct_scale=False)
    enc.host_staging = "pinned"
    log(f"phase 7 (a) images/s over the {len(renders)} renders by host staging: {json.dumps(staging)} [{card}]")
    _feeds(torch, "phase 7 (a)", enc, renders[:96], 96, card)
    log(f"phase 7 (a): {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 8: adapter and weight persistence, W8A8 int8 serving
# ---------------------------------------------------------------------------


def same_tree(torch, what: str, got, ref) -> None:
    """Two nested dicts of tensors: the same keys, and every leaf of the same
    type, shape and device and bit-equal."""
    def walk(g, r, path):
        if isinstance(r, dict):
            if not isinstance(g, dict) or set(g) != set(r):
                raise AssertionError(f"{what}: keys at {path or '/'} differ")
            for k in r:
                walk(g[k], r[k], f"{path}/{k}")
        elif not (g.dtype == r.dtype and g.shape == r.shape and g.device == r.device and torch.equal(g, r)):
            raise AssertionError(f"{what}: leaf {path} differs ({g.dtype} {tuple(g.shape)} {g.device} "
                                 f"vs {r.dtype} {tuple(r.shape)} {r.device})")
    walk(got, ref, "")


def _by_kind(rows) -> dict:
    """torch.profiler rows (ms, count, name) summed by kind of kernel."""
    kinds: dict[str, list] = {}
    for ms, count, name in rows:
        low = name.lower()
        gemm = any(t in low for t in ("gemm", "xmma", "cutlass", "nvjet", "sm90_", "sm80_"))
        if "memcpy" in low:
            kind = "copies"
        elif any(t in low for t in ("fprop", "dgrad", "wgrad", "conv")):
            kind = "convolutions (cuDNN)"
        elif "flash" in low:
            kind = "flash_attention"
        elif any(t in low for t in ("attention_small", "lora_matmul", "mlp_fused")):
            kind = next(t for t in ("attention_small", "lora_matmul", "mlp_fused") if t in low)
        elif gemm and any(t in low for t in ("s8", "i8", "imma", "int8")):
            kind = "int8 GEMM"
        elif gemm:
            kind = "float GEMM"
        elif "reduce" in low:
            kind = "reductions (LayerNorm mean/var, the per-token abs-max)"
        elif "elementwise" in low or "vectorized" in low:
            kind = "elementwise (LayerNorm, residual, quantize/dequantize, casts)"
        else:
            kind = "other"
        row = kinds.setdefault(kind, [0.0, 0])
        row[0] += ms
        row[1] += count
    return {k: (round(v[0], 4), v[1]) for k, v in sorted(kinds.items(), key=lambda kv: -kv[1][0])}


def check_int8_on_card(torch, qenc) -> None:
    """The int8 weights and product on the card against the same calls on
    CPU tensors: the serving copy's weight codes and scales (quantized on the
    card) bit-equal to a CPU quantization of the fp32 master, and on its
    layer-0 operands the activation codes, scales and int32 products
    bit-equal, outputs to fp32 rounding. M = 1 and 16 take the padded
    product (torch._int_mm needs more than 16 rows)."""
    from clip_lora_match_tpu_torch.quant.int8 import int8_matmul, int8_mm, quantize_linear_params, quantize_rows

    params, _ = qenc._serving_state()
    for tower in ("visual", "text"):
        for grp, name in (("attn", "q_proj"), ("attn", "v_proj"), ("attn", "out_proj"), ("mlp", "fc1"),
                          ("mlp", "fc2")):
            master = qenc.params[tower]["blocks"][grp][name]["kernel"]
            want = quantize_linear_params({"kernel": master.cpu()})
            for i, layer in enumerate(params[tower]["blocks"]):
                got = layer[grp][name]
                if not (torch.equal(got["kernel_q"].cpu(), want["kernel_q"][i])
                        and torch.equal(got["w_scale"].cpu(), want["w_scale"][i])):
                    raise AssertionError(f"int8 weights of {tower} layer {i} {name}: the card's "
                                         "quantization differs from the CPU's")
    layer = params["visual"]["blocks"][0]
    rng = np.random.default_rng(SEED + 8)
    worst, equal = 0.0, 0
    cases = 0
    for M in (1, 16, 17, 50, 577, 4800):
        for name, p in (("q/k/v", layer["attn"]["qkv"]), ("out_proj", layer["attn"]["out_proj"]),
                        ("fc1", layer["mlp"]["fc1"]), ("fc2", layer["mlp"]["fc2"])):
            K = p["kernel_q"].shape[0]
            x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).cuda().to(torch.bfloat16)
            xc, wc, sc = x.cpu(), p["kernel_q"].cpu(), p["w_scale"].cpu()
            q, s_x = quantize_rows(x)
            q_c, s_c = quantize_rows(xc)
            if not (torch.equal(q.cpu(), q_c) and torch.equal(s_x.cpu(), s_c)):
                raise AssertionError(f"int8 codes on the card differ from the CPU's: M={M} {name}")
            if not torch.equal(int8_mm(q, p["kernel_q"]).cpu(), int8_mm(q_c, wc)):
                raise AssertionError(f"int8 product on the card differs from the CPU's: M={M} {name}")
            y, y_c = int8_matmul(x, p["kernel_q"], p["w_scale"]).cpu(), int8_matmul(xc, wc, sc)
            rel = ((y - y_c).abs() / y_c.abs().clamp_min(1e-30)).max().item()
            if not rel <= 2.0 ** -23:
                raise AssertionError(f"int8_matmul on the card: relative error {rel} at M={M} {name}")
            worst = max(worst, rel)
            equal += int(torch.equal(y, y_c))
            cases += 1
    log(f"phase 8 (b) int8 on the card against the CPU: every block linear's weight codes and scales "
        f"bit-equal; M = 1-4800 x q/k/v, out_proj, fc1, fc2 (layer 0): activation codes, scales and int32 "
        f"products bit-equal in {cases} of {cases}; outputs bit-equal in {equal}, max relative error {worst:.3e}")


def int8_gemm_rows(torch, card) -> None:
    """The int8 product (torch._int_mm, a library call: the JAX package's
    lax.dot_general outside any kernel) at the B/32 request shapes (M=50)
    and the L/14-336 32-image batch (M=18,464), beside bf16 torch.matmul:
    device ms per call (torch.profiler), the GEMM alone with the weight
    column-major (the serving copy's layout) and row-major, and the whole
    int8_matmul (quantize, GEMM, dequantize)."""
    from clip_lora_match_tpu_torch.quant.int8 import int8_matmul, int8_mm, quantize_linear_params, quantize_rows

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    for tag, M, K, N in (
        ("B/32 q/k/v", 50, 768, 2304), ("B/32 out_proj", 50, 768, 768),
        ("B/32 fc1", 50, 768, 3072), ("B/32 fc2", 50, 3072, 768),
        ("L/14-336 q/k/v", 18464, 1024, 3072), ("L/14-336 out_proj", 18464, 1024, 1024),
        ("L/14-336 fc1", 18464, 1024, 4096), ("L/14-336 fc2", 18464, 4096, 1024),
    ):
        x = torch.randn(M, K, device="cuda", generator=gen).to(torch.bfloat16)
        w = torch.randn(K, N, device="cuda", generator=gen) * K ** -0.5
        qp = quantize_linear_params({"kernel": w})
        w_col = qp["kernel_q"].t().contiguous().t()
        xq, _ = quantize_rows(x)
        wb = w.to(torch.bfloat16)
        t = {
            "int8 GEMM (W col-major)": device_ms(torch, lambda: int8_mm(xq, w_col)),
            "int8 GEMM (W row-major)": device_ms(torch, lambda: int8_mm(xq, qp["kernel_q"])),
            "int8_matmul": device_ms(torch, lambda: int8_matmul(x, w_col, qp["w_scale"])),
            "bf16 matmul": device_ms(torch, lambda: torch.matmul(x, wb)),
        }
        b8, by8 = bound_ms(M * K + K * N + 4 * M * N, 2 * M * K * N, "int8")
        b16, by16 = bound_ms(2 * (M * K + K * N + M * N), 2 * M * K * N, "bf16")
        log(f"phase 8 int8 product {tag} M={M} K={K} N={N}, device ms per call: "
            f"{json.dumps({k: None if v is None else round(v, 5) for k, v in t.items()})}; "
            f"bound int8 GEMM {b8:.5f} ({by8}), bf16 {b16:.5f} ({by16}) [{card}]")


def w8a8_path(torch, card, enc, texts, images, index, lat3) -> None:
    """Phase 8 (a) and (b) over phase 3's encoder and index."""
    from clip_lora_match_tpu_torch import ops
    from clip_lora_match_tpu_torch.core.config import LoraConfig
    from clip_lora_match_tpu_torch.lora import load_lora, save_lora, save_peft_adapter
    from clip_lora_match_tpu_torch.models.encoder import ClipEncoder
    from clip_lora_match_tpu_torch.models.io import load_params
    from clip_lora_match_tpu_torch.quant import int8 as Q
    from clip_lora_match_tpu_torch.services.seeker import SeekerConfig, SeekerService

    t0 = time.perf_counter()
    n, arch = len(texts), enc.arch
    layers = arch.vision_layers  # == text_layers for B/32
    lcfg = LoraConfig()
    if len(index) != INDEX_ROWS + 2 * n or enc.lora_scaling != lcfg.scaling:
        raise AssertionError(f"phase 8: phase 3's index has {len(index)} rows, scaling {enc.lora_scaling}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p8_")
    try:
        # -- (a) persistence ------------------------------------------------
        peft_dir, native_dir = os.path.join(tmp, "peft"), os.path.join(tmp, "native")
        save_peft_adapter(peft_dir, enc.lora, lcfg)
        save_lora(native_dir, enc.lora, lcfg)
        for name, d in (("PEFT", peft_dir), ("native", native_dir)):
            tree, scale = load_lora(d, device="cuda", arch=arch)
            if scale != lcfg.scaling:
                raise AssertionError(f"phase 8 (a) {name} adapter: scaling {scale}")
            same_tree(torch, f"phase 8 (a) {name} adapter", tree, enc.lora)
        weights = os.path.join(tmp, "clip_b32.npz")
        t = time.perf_counter()
        enc.save(weights)
        save_s = time.perf_counter() - t
        same_tree(torch, "phase 8 (a) ClipEncoder.save -> load_params", load_params(weights, device="cuda"),
                  enc.params)
        ref_t, ref_i = enc.encode_text(texts), enc.encode_image(images)
        peft_enc = ClipEncoder.from_config(None, weights_path=weights, lora_path=peft_dir, device="cuda")
        got_t, got_i = peft_enc.encode_text(texts), peft_enc.encode_image(images)
        del peft_enc
        if not (np.array_equal(got_t, ref_t) and np.array_equal(got_i, ref_i)):
            raise AssertionError(
                f"phase 8 (a) from_config(PEFT dir): embeddings differ from phase 3's (max "
                f"{max(np.abs(got_t - ref_t).max(), np.abs(got_i - ref_i).max()):.3e})")
        log(f"phase 8 (a) persistence: PEFT ({os.path.getsize(os.path.join(peft_dir, 'adapter_model.safetensors'))} "
            f"B) and native adapters read back bit for bit on the card; ClipEncoder.save "
            f"({os.path.getsize(weights) / 1e6:.1f} MB, {save_s:.2f} s) -> load_params bit for bit; "
            f"from_config(weights, PEFT dir) gives phase 3's {n} text and {n} image embeddings bit for bit")

        # -- (b) W8A8 at B/32 -------------------------------------------------
        cfg_path = os.path.join(tmp, "clip_int8.yaml")
        with open(cfg_path, "w") as f:
            f.write("model:\n  name: openai/clip-vit-base-patch32\n  quantize: int8\n")
        qenc = ClipEncoder.from_config(cfg_path, weights_path=weights, lora_path=peft_dir, device="cuda")
        if qenc.quantize != "int8" or qenc.compute_dtype != torch.bfloat16:
            raise AssertionError(f"phase 8 (b): quantize {qenc.quantize}, compute {qenc.compute_dtype}")
        check_int8_on_card(torch, qenc)
        svc = SeekerService(qenc, SeekerConfig(), index=index)
        fsvc = SeekerService(enc, SeekerConfig(), index=index)

        ops.reset_launch_counts()
        Q.int8_mm.calls = 0
        text_res = [svc.search_items(description=t) for t in texts]
        image_res = [svc.search_items(image_path=im) for im in images]
        both_res = [svc.search_items(description=t, image_path=im) for t, im in zip(texts, images)]
        torch.cuda.synchronize()
        counts, gemms = ops.launch_counts(), Q.int8_mm.calls
        log(f"phase 8 (b) launches: {json.dumps(counts)}, int8 products {gemms}")
        want = {
            "attention_small": 4 * n * layers, "lora_matmul": 0, "topk_retrieve": 3 * n,
            "tilemax": 0, "tilemax_sup": 0, "tilemax_sup_q8": 0, "mlp_fused": 0, "flash_attention": 0,
            "approx_topk": 0,
        }
        if counts != want or gemms != 4 * layers * 4 * n:  # 4 a layer, 4n tower passes
            raise AssertionError(f"phase 8 (b) launches {counts}, int8 products {gemms}: expected {want}, "
                                 f"{4 * layers * 4 * n}")
        for i in range(n):
            t0r, i0r = text_res[i][0], image_res[i][0]
            if t0r.index != INDEX_ROWS + i or t0r.score < 0.99:
                raise AssertionError(f"phase 8 (b) text query {i}: top {t0r.index} {t0r.score}")
            if i0r.index != INDEX_ROWS + n + i or i0r.score < 0.99:
                raise AssertionError(f"phase 8 (b) image query {i}: top {i0r.index} {i0r.score}")
            top5 = {r.index for r in both_res[i]}
            if not {INDEX_ROWS + i, INDEX_ROWS + n + i} <= top5:
                raise AssertionError(f"phase 8 (b) fused query {i}: top-5 {sorted(top5)}")
        log("phase 8 (b) self-retrieval over phase 3's float rows: int8 text and image queries return "
            f"their own rows first (min score {min(min(r[0].score for r in text_res), min(r[0].score for r in image_res)):.6f})")

        rng = np.random.default_rng(SEED + 10)
        pix = np.clip(rng.normal(0.0, 1.0, (96, arch.image_size, arch.image_size, 3)), -2, 2).astype(np.float32)
        pix[:n] = enc.preprocessor.preprocess_images(images)
        batch_texts = [f"{texts[i % n]} nomor {i}" for i in range(256)]
        cos = {
            "texts": _cosines(qenc.encode_text(texts), ref_t),
            "images": _cosines(qenc.encode_image(images), ref_i),
            "96-image batch": _cosines(qenc.encode_image_batch(pix), enc.encode_image_batch(pix)),
            "256-text batch": _cosines(qenc.encode_text(batch_texts), enc.encode_text(batch_texts)),
        }
        lows = {k: float(v.min()) for k, v in cos.items()}
        if not min(lows.values()) >= 0.995:
            raise AssertionError(f"phase 8 (b) int8 vs float (bf16) cosines {lows}")
        log(f"phase 8 (b) int8 vs phase 3's float encoder (both bf16 compute), min cosine per row: "
            f"{json.dumps({k: round(v, 6) for k, v in lows.items()})}")

        # -- latency and device time, float and int8 in turns -----------------
        def calls(s):
            return (
                ("text", lambda: s.search_items(description=texts[0])),
                ("image", lambda: s.search_items(image_path=images[0])),
                ("both", lambda: s.search_items(description=texts[0], image_path=images[0])),
            )

        lat = {"float": [], "int8": []}
        for name in ("float", "int8", "int8", "float"):
            lat[name].append(_latency(torch, calls(fsvc if name == "float" else svc)))
        log(f"phase 8 (b) B/32 seeker request latency, median of 10 (ms), two rounds in turns: "
            f"{json.dumps(lat)}; phase 3's float run {json.dumps(lat3)} [{card}]")
        busy = {}
        for name, s in (("float", fsvc), ("int8", svc)):
            busy[name] = profile_device_time(
                torch, f"phase 8 (b) {name} fused request",
                lambda: s.search_items(description=texts[0], image_path=images[0]),
                statistics.median(r["both"] for r in lat[name]), card)
        batch = {}
        for name, e in (("float", enc), ("int8", qenc), ("int8", qenc), ("float", enc)):
            batch.setdefault(name, []).append(device_ms(torch, lambda: e.encode_image_batch(pix), reps=3))
        log(f"phase 8 (b) 96-image batch device ms (upload included), in turns: {json.dumps(batch)}; "
            f"fused request busy ms {json.dumps(busy)} [{card}]")
        rows = device_rows(torch, lambda: qenc.encode_image_batch(pix))
        frows = device_rows(torch, lambda: enc.encode_image_batch(pix))
        log(f"phase 8 (b) 96-image batch by kind (ms, count): int8 {json.dumps(_by_kind(rows))}; "
            f"float {json.dumps(_by_kind(frows))} [{card}]")
        del qenc, svc
        torch.cuda.empty_cache()
        int8_gemm_rows(torch, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 8 (a), (b): {time.perf_counter() - t0:.1f} s")


def l14_w8a8(torch, card, enc, pix, img_k) -> None:
    """Phase 8 (c): one 32-image batch through phase 5's L/14-336 encoder
    rebuilt with quantize="int8" (inside phase 5's flash + fused-MLP flags)."""
    from clip_lora_match_tpu_torch import ops
    from clip_lora_match_tpu_torch.models.encoder import ClipEncoder
    from clip_lora_match_tpu_torch.quant import int8 as Q

    t0 = time.perf_counter()
    vl = enc.arch.vision_layers
    qenc = ClipEncoder(enc.params, arch=enc.arch, config=enc.cfg, quantize="int8", device="cuda")
    qenc.attach_lora(enc.lora, enc.lora_scaling)
    ops.reset_launch_counts()
    Q.int8_mm.calls = 0
    got = qenc.encode_image_batch(pix)
    torch.cuda.synchronize()
    counts, gemms = ops.launch_counts(), Q.int8_mm.calls
    want = {"attention_small": 0, "lora_matmul": 0, "topk_retrieve": 0, "tilemax": 0, "tilemax_sup": 0,
            "tilemax_sup_q8": 0, "mlp_fused": 0, "flash_attention": vl, "approx_topk": 0}
    if counts != want or gemms != 4 * vl:
        raise AssertionError(f"phase 8 (c) launches {counts}, int8 products {gemms}")
    if got.shape != img_k.shape or not np.isfinite(got).all():
        raise AssertionError(f"phase 8 (c): shape {got.shape} or non-finite values")
    cos = _cosines(got, img_k)
    if not cos.min() >= 0.995:
        raise AssertionError(f"phase 8 (c) int8 vs float batch: min cosine {cos.min()}")
    u8 = torch.from_numpy(np.random.default_rng(SEED + 11).integers(
        0, 256, pix.shape, dtype=np.uint8)).cuda()
    u8_cos = _cosines(qenc._encode_u8(u8, True)[:len(pix)].cpu().numpy(),
                      enc._encode_u8(u8, True)[:len(pix)].cpu().numpy())
    if not u8_cos.min() >= 0.995:
        raise AssertionError(f"phase 8 (c) int8 vs float, u8 feed: min cosine {u8_cos.min()}")
    log(f"phase 8 (c) L/14-336 32-image batch, int8: launches {json.dumps(counts)}, int8 products {gemms}; "
        f"min cosine against the float batch {cos.min():.6f} (float feed), {u8_cos.min():.6f} (u8 feed)")
    feeds = {}
    for name, e in (("float", enc), ("int8", qenc), ("int8", qenc), ("float", enc)):
        feeds.setdefault(f"{name} float feed", []).append(
            device_ms(torch, lambda: e.encode_image_batch(pix), reps=2))
        feeds.setdefault(f"{name} u8 feed", []).append(device_ms(torch, lambda: e._encode_u8(u8, True), reps=2))
    log(f"phase 8 (c) L/14-336 32-image batch device ms (float feed: upload included), in turns: "
        f"{json.dumps(feeds)} [{card}]")
    for name, e in (("int8", qenc), ("float", enc)):
        rows = device_rows(torch, lambda: e._encode_u8(u8, True))
        log(f"phase 8 (c) u8-feed batch by kind, {name} (ms, count): {json.dumps(_by_kind(rows))}")
        for ms, count, key in sorted(rows, reverse=True)[:10]:
            log(f"  {ms:9.4f} ms  x{count:<4d} {key[:100]}")
    del qenc
    torch.cuda.empty_cache()
    log(f"phase 8 (c): {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 9: contrastive LoRA training
# ---------------------------------------------------------------------------

# gradient checks against autograd through the plain versions: fp32, the same
# products in another order (attention: max-free against exact softmax);
# bf16, the rank-r partials, the hidden or P rounded at other places
GRAD_TOL = {"fp32": 1e-5, "bf16": 2e-2}
ATTN_GRAD_TOL = {"fp32": 1e-4, "bf16": 3e-2}
TRAIN_B = 128  # phase 9 (a), (c): the training batch at B/32 width (image M = 6,400, text 8,192)


def _normrel(torch, got, ref) -> float:
    return ((got.double() - ref.double()).norm() / ref.double().norm().clamp_min(1e-30)).item()


def _autograd(torch, fn, inputs, cot, need):
    """fn(inputs) and the gradients of <fn(inputs), cot> for the inputs
    ``need`` names."""
    ts = [t.detach().clone().requires_grad_(n) for t, n in zip(inputs, need)]
    out = fn(*ts)
    return out.detach(), list(torch.autograd.grad(out, [t for t, n in zip(ts, need) if n], cot))


def _bwd_row(torch, shape, kind, bwd, plain_fn, inputs, cot, need, nbytes, flops, err):
    """A backward row: the backward function's wall and device ms per call,
    the plain version's autograd backward (its graph kept), the bound (the
    backward computes in fp32)."""
    ts = [t.detach().clone().requires_grad_(n) for t, n in zip(inputs, need)]
    out = plain_fn(*ts)
    leaves = [t for t, n in zip(ts, need) if n]
    plain = lambda: torch.autograd.grad(out, leaves, cot, retain_graph=True)  # noqa: E731
    b_ms, b_by = bound_ms(nbytes, flops, "fp32")
    return dict(shape=f"{shape} {kind}", ms=cuda_ms(torch, bwd, reps=10), device_ms=device_ms(torch, bwd, reps=3),
                plain_ms=cuda_ms(torch, plain, reps=10), bound_ms=b_ms, bound_by=b_by, max_rel_err=err)


def grad_checks(torch, card, gen) -> dict:
    """Phase 9 (a): each differentiable kernel's forward and gradients
    through its wrapper (the autograd Function around the kernel) against
    autograd through its plain version, at the B/32 training shapes (B=128) in fp32
    and bf16, and its backward's time beside its bound. Returns
    {kernel: [rows]}, the first row the fp32 image-tower shape."""
    from clip_lora_match_tpu_torch.nn.layers import QKV, group_qkv
    from clip_lora_match_tpu_torch.ops import attention_small as A
    from clip_lora_match_tpu_torch.ops import flash_attention as F
    from clip_lora_match_tpu_torch.ops import lora_matmul as L
    from clip_lora_match_tpu_torch.ops import mlp_fused as MF

    rows = {"lora_matmul": [], "attention_small": [], "mlp_fused": []}
    rnd = lambda *s, dtype=torch.float32, scale=1.0: (  # noqa: E731
        torch.randn(*s, device="cuda", generator=gen) * scale).to(dtype)

    def check(name, what, got, ref, tol):
        """The wrapper's forward and gradients, ``got`` = (out, grads),
        against the plain version's ``ref``."""
        errs = [_normrel(torch, g, r) for g, r in zip([got[0], *got[1]], [ref[0], *ref[1]])]
        if not max(errs) <= tol:
            raise AssertionError(f"phase 9 (a) {name} {what}: forward, gradient errors {errs} > {tol}")
        return max(errs)

    for dtype in (torch.float32, torch.bfloat16):
        kind = "fp32" if dtype == torch.float32 else "bf16"
        es = 4 if kind == "fp32" else 2
        # -- lora_matmul: image and text projections; the frozen base takes no dW
        for M, K, r in ((TRAIN_B * 50, 768, 8), (TRAIN_B * 64, 512, 8)):
            N = K
            ins = (rnd(M, K, dtype=dtype), rnd(K, N, dtype=dtype, scale=K ** -0.5),
                   rnd(K, r, dtype=dtype, scale=0.05), rnd(r, N, dtype=dtype, scale=0.05))
            cot, need = rnd(M, N, dtype=dtype), (True, False, True, True)
            before = L.lora_matmul.launches
            got = _autograd(torch, lambda *t: L.lora_matmul(*t, scaling=2.0), ins, cot, need)
            if L.lora_matmul.launches != before + 1:
                raise AssertionError("phase 9 (a) lora_matmul: the kernel did not launch")
            ref = _autograd(torch, lambda *t: L.lora_matmul_plain(*t, scaling=2.0), ins, cot, need)
            err = check("lora_matmul", f"M={M} K=N={K} r={r} {kind}", got, ref, GRAD_TOL[kind])
            flops = 2 * M * N * K + 4 * M * N * r + 6 * M * K * r
            nbytes = es * (2 * M * K + K * N + 2 * K * r + 2 * r * N + M * N)
            rows["lora_matmul"].append(_bwd_row(
                torch, f"backward (dx, dA, dB) M={M} K=N={K} r={r}", kind,
                lambda: L.lora_matmul_backward(*ins, cot, 2.0, 1, need),
                lambda *t: L.lora_matmul_plain(*t, scaling=2.0), ins, cot, need, nbytes, flops, err))
        # -- the grouped q/k/v launch: each adapter its ungrouped gradient
        D, r, M = 768, 8, TRAIN_B * 50
        p = {n: {"kernel": rnd(D, D, dtype=dtype, scale=D ** -0.5), "bias": None} for n in QKV}
        leaves = {n: {"a": rnd(D, r, dtype=dtype, scale=0.05).requires_grad_(True),
                      "b": rnd(r, D, dtype=dtype, scale=0.05).requires_grad_(True)} for n in QKV}
        x, cot3 = rnd(M, D, dtype=dtype), rnd(3, M, D, dtype=dtype)
        g = group_qkv(p, leaves)
        y = L.lora_matmul(x, g["kernel"], g["a"], g["b"], scaling=2.0, groups=3)
        grouped = torch.autograd.grad(y, [leaves[n][ab] for n in QKV for ab in "ab"], cot3)
        outs, ungrouped = [], []
        for i, n in enumerate(QKV):
            out, gs = _autograd(torch, lambda *t: L.lora_matmul(*t, scaling=2.0),
                                (x, p[n]["kernel"], leaves[n]["a"], leaves[n]["b"]), cot3[i],
                                (False, False, True, True))
            outs.append(out)
            ungrouped += gs
        err = check("lora_matmul", f"grouped q/k/v M={M} {kind}", (y.detach(), grouped),
                    (torch.stack(outs), ungrouped), GRAD_TOL[kind])
        log(f"phase 9 (a) grouped q/k/v launch M={M} D={D} r={r} (grouped rank {3 * r}) {kind}: each of "
            f"a_q/k/v, b_q/k/v gets its ungrouped launch's gradient (max normwise rel err {err:.3e})")
        # -- attention_small: the image tower (maskless), the text tower (causal + lengths)
        for B, S, H, causal in ((TRAIN_B, 50, 12, False), (TRAIN_B, 64, 8, True), (TRAIN_B, 77, 8, True)):
            ins = [rnd(B, S, H, 64, dtype=dtype, scale=0.5) for _ in range(3)]
            cot = rnd(B, S, H, 64, dtype=dtype)
            kw = {}
            if causal:
                kw = dict(causal=True, lengths=torch.randint(
                    1, S + 1, (B,), device="cuda", generator=gen, dtype=torch.int32))
            before = A.attention_small.launches
            got = _autograd(torch, lambda *t: A.attention_small(*t, **kw), ins, cot, (True,) * 3)
            if A.attention_small.launches != before + 1:
                raise AssertionError("phase 9 (a) attention_small: the kernel did not launch")
            ref = _autograd(torch, lambda *t: A.attention_small_plain(*t, **kw), ins, cot, (True,) * 3)
            mode = "causal+lengths" if causal else "maskless"
            err = check("attention_small", f"B={B} S={S} H={H} {mode} {kind}", got, ref, ATTN_GRAD_TOL[kind])
            scale = 64 ** -0.5
            rows["attention_small"].append(_bwd_row(
                torch, f"backward (dq, dk, dv) B={B} S={S} H={H} hd=64 {mode}", kind,
                lambda: A.attention_small_backward(*ins, cot, None, scale, causal, kw.get("lengths")),
                lambda *t: A.attention_small_plain(*t, **kw), ins, cot, (True,) * 3,
                7 * B * S * H * 64 * es, 12 * B * H * S * S * 64, err))
        # -- mlp_fused: the image and text MLPs; every gradient checked, dx timed
        for M, K, Hd in ((TRAIN_B * 50, 768, 3072), (TRAIN_B * 64, 512, 2048)):
            ins = (rnd(M, K, dtype=dtype), rnd(K, Hd, dtype=dtype, scale=K ** -0.5), rnd(Hd, scale=0.1),
                   rnd(Hd, K, dtype=dtype, scale=Hd ** -0.5), rnd(K, scale=0.1))
            cot = rnd(M, K, dtype=dtype)
            before = MF.mlp_fused.launches
            got = _autograd(torch, MF.mlp_fused, ins, cot, (True,) * 5)
            if MF.mlp_fused.launches != before + 1:
                raise AssertionError("phase 9 (a) mlp_fused: the kernel did not launch")
            ref = _autograd(torch, MF.mlp_fused_plain, ins, cot, (True,) * 5)
            err = check("mlp_fused", f"M={M} K={K} H={Hd} {kind}", got, ref, GRAD_TOL[kind])
            need = (True, False, False, False, False)
            rows["mlp_fused"].append(_bwd_row(
                torch, f"backward (dx) M={M} K=N={K} H={Hd}", kind,
                lambda: MF.mlp_fused_backward(*ins, cot, need), MF.mlp_fused_plain, ins, cot, need,
                es * (2 * M * K + 2 * K * Hd) + 4 * (Hd + K) + es * M * K, 6 * M * K * Hd, err))
        torch.cuda.empty_cache()
    # -- flash_attention: no backward, so a differentiable call raises
    q = rnd(2, 200, 2, 64).requires_grad_(True)
    before = F.flash_attention.launches
    try:
        F.flash_attention(q, q.detach(), q.detach())
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
    else:
        raise AssertionError("phase 9 (a) flash_attention under grad returned a result")
    if F.flash_attention.launches != before:
        raise AssertionError("phase 9 (a) flash_attention under grad launched its kernel")
    for name, rs in rows.items():
        for row in rs:
            log(f"phase 9 (a) {name} {row['shape']}: forward and gradients within tolerance (max normwise rel err "
                f"{row['max_rel_err']:.3e}); backward ms {row['ms']:.4f} device_ms {fmt(row['device_ms'])} "
                f"plain autograd backward ms {row['plain_ms']:.4f} bound_ms {row['bound_ms']:.4f} "
                f"({row['bound_by']}, fp32 products) [{card}]")
    log("phase 9 (a) flash_attention with an input that requires grad raises, and launches nothing")
    return rows


def tower_grads(torch, params, lora, arch, batch, eot, **flags):
    """Loss and LoRA gradients of one pass through both towers at fp32 (the
    training precision) under ``flags``."""
    from clip_lora_match_tpu_torch.core.config import LoraConfig
    from clip_lora_match_tpu_torch.nn.layers import kernel_flags
    from clip_lora_match_tpu_torch.models.io import tree_leaves, unflatten
    from clip_lora_match_tpu_torch.train.loss import clip_contrastive_loss
    from clip_lora_match_tpu_torch.train.step import batch_to_device, tower_features

    pairs = tree_leaves(lora)
    live = [t.detach().clone().requires_grad_(True) for _, t in pairs]
    tree = unflatten({path: t for (path, _), t in zip(pairs, live)})
    with kernel_flags(**flags):
        img, txt = tower_features(params, tree, batch_to_device(batch, torch.device("cuda")), arch,
                                  LoraConfig(dropout=0.0), eot, None, False)
        loss = clip_contrastive_loss(img, txt)
        grads = torch.autograd.grad(loss, live)
    return loss.detach(), [(path, g) for (path, _), g in zip(pairs, grads)]


def _hold_grads(torch, what, got, ref, tol) -> float:
    (lk, gk), (lp, gp) = got, ref
    worst = abs(lk.item() - lp.item()) / abs(lp.item())
    for (path, a), (_, b) in zip(gk, gp):
        if not (b.norm() > 0 and a.norm() > 0):
            raise AssertionError(f"{what}: adapter {path} has no gradient")
        worst = max(worst, _normrel(torch, a, b))
    if not worst <= tol:
        raise AssertionError(f"{what}: loss or gradients differ by {worst} > {tol}")
    return worst


def train_batch(enc, n: int, S: int, seed: int) -> dict:
    """A seeded training batch: uint8 224² pixels and ``S``-wide token ids
    (EOT-padded, prefix masks, every row's EOT inside the S columns)."""
    rng = np.random.default_rng(seed)
    eot = enc.preprocessor.tokenizer.eot_id
    S = min(S, enc.arch.max_text_length)
    lens = rng.integers(5, S, n)
    ids = np.full((n, S), eot, np.int32)
    mask = np.zeros((n, S), np.int32)
    for i, k in enumerate(lens):
        ids[i, :k - 1] = rng.integers(1, eot - 1, k - 1)
        mask[i, :k] = 1
    return {"pixel_values": rng.integers(0, 256, (n, enc.arch.image_size, enc.arch.image_size, 3), dtype=np.uint8),
            "input_ids": ids, "attention_mask": mask}


def repaired_fault(torch, enc) -> None:
    """Phase 9 (a): one B/32 pass through both towers (8 pairs) whose LoRA
    gradients under the default "auto" flags, through the kernels, equal
    those with the kernels off."""
    from clip_lora_match_tpu_torch import ops

    batch = train_batch(enc, 8, 77, SEED + 20)
    eot = enc.preprocessor.tokenizer.eot_id
    ops.reset_launch_counts()
    auto = tower_grads(torch, enc.params, enc.lora, enc.arch, batch, eot)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    layers = enc.arch.vision_layers + enc.arch.text_layers
    if counts["lora_matmul"] != 4 * layers or counts["attention_small"] != layers:
        raise AssertionError(f"phase 9 (a) tower pass under auto: launches {counts}")
    ops.reset_launch_counts()
    off = tower_grads(torch, enc.params, enc.lora, enc.arch, batch, eot, fused_lora=False, small_attention=False)
    if any(ops.launch_counts().values()):
        raise AssertionError(f"phase 9 (a) kernels off launched {ops.launch_counts()}")
    err = _hold_grads(torch, "phase 9 (a) B/32 tower pass, auto vs off", auto, off, 1e-4)
    log(f"phase 9 (a) B/32 towers (8 pairs, fp32): the LoRA gradients of all {len(auto[1])} adapter leaves "
        f"under the default flags (lora_matmul {counts['lora_matmul']}, attention_small "
        f"{counts['attention_small']} launches) equal those with the kernels off (max normwise rel err {err:.3e}, "
        f"loss {auto[0].item():.6f} vs {off[0].item():.6f})")


def _train_yaml(path: str, out: str, epochs: int, dropout: float = 0.1) -> None:
    """config/lora_config.yaml with phase 9 (b)'s run: batch 6, r=8,
    alpha=16, ``dropout`` (0.1), ``epochs`` epochs, logging every 5 steps,
    the in-repo CSVs."""
    import yaml

    with open(os.path.join(REPO, "config/lora_config.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["lora"].update(r=8, alpha=16, dropout=dropout)
    cfg["data"] = {"train_csv": os.path.join(REPO, "data/text/train_fashion.csv"),
                   "val_csv": os.path.join(REPO, "data/text/val_fashion.csv"), "image_root_dir": REPO}
    cfg["training"].update(batch_size=6, num_epochs=epochs, logging_steps=5, output_dir=out)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)


def train_end_to_end(torch, card, enc, texts, index, tmp: str) -> None:
    """Phase 9 (b): train() at full ViT-B/32 width through cli.py: a
    2-epoch run whose epoch-2 adapter is served; a 3-epoch run, and a copy
    of its output without the epoch-3 checkpoint and adapters (an
    interruption after epoch 2) resumed for the third epoch. Everything goes
    under ``tmp``: phase 10 evaluates ``tmp/full``'s adapters over
    ``tmp/base.npz``."""
    from clip_lora_match_tpu_torch import ops
    from clip_lora_match_tpu_torch.core.config import LoraConfig
    from clip_lora_match_tpu_torch.models.encoder import ClipEncoder
    from clip_lora_match_tpu_torch.models.io import load_params
    from clip_lora_match_tpu_torch.services.seeker import SeekerConfig, SeekerService
    from clip_lora_match_tpu_torch.train import cli

    weights = os.path.join(tmp, "base.npz")
    enc.save(weights)
    runs = {}
    for name, epochs in (("two", 2), ("full", 3), ("resumed", 3)):
        _train_yaml(os.path.join(tmp, f"{name}.yaml"), os.path.join(tmp, name), epochs)

    def run(name):
        t = time.perf_counter()
        runs[name] = cli.run(["--config", os.path.join(tmp, f"{name}.yaml"), "--weights", weights])
        torch.cuda.synchronize()
        runs[name + "_s"] = time.perf_counter() - t

    ops.reset_launch_counts()
    run("two")
    run("full")
    shutil.copytree(os.path.join(tmp, "full"), os.path.join(tmp, "resumed"))
    os.remove(os.path.join(tmp, "resumed", "checkpoints", "27.pt"))
    shutil.rmtree(os.path.join(tmp, "resumed", "epoch_3"))
    run("resumed")
    counts = ops.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"phase 9 (b) train() launched kernels with the training flags: {counts}")
    two, full, resumed = runs["two"], runs["full"], runs["resumed"]
    if (two.epochs, full.epochs, resumed.epochs) != (2, 3, 3) or (full.steps, resumed.steps) != (27, 9):
        raise AssertionError(f"phase 9 (b) epochs {two.epochs}, {full.epochs}, {resumed.epochs}, "
                             f"steps {full.steps}, {resumed.steps}")
    if resumed.train_losses != full.train_losses[-9:] or resumed.val_losses != full.val_losses[-1:]:
        raise AssertionError(f"phase 9 (b) resumed run's losses {resumed.train_losses} differ from the "
                             f"uninterrupted run's {full.train_losses[-9:]}")
    same_tree(torch, "phase 9 (b) resumed vs uninterrupted final adapter", resumed.final_lora, full.final_lora)
    if not all(np.isfinite(two.train_losses + two.val_losses + full.train_losses + full.val_losses)):
        raise AssertionError("phase 9 (b): non-finite losses")
    log(f"phase 9 (b) train() through cli.py at ViT-B/32 (batch 6, r=8, alpha=16, dropout 0.1, 9 steps an "
        f"epoch, the in-repo CSVs): launches {json.dumps(counts)} (the trainer's flags: plain products); "
        f"epoch 3 resumed from epoch 2's checkpoint: its losses and the final adapter bit-equal to the "
        f"uninterrupted 3-epoch run's; train losses {[round(v, 4) for v in full.train_losses]}, val losses "
        f"{[round(v, 4) for v in full.val_losses]}; wall {runs['two_s']:.1f} s (2 epochs), "
        f"{runs['resumed_s']:.1f} s (1 epoch resumed), {runs['full_s']:.1f} s (3 epochs, "
        f"{27 / runs['full_s']:.2f} steps/s with data, validation and saves) [{card}]")

    # -- the epoch-2 adapter, served ------------------------------------------------
    lcfg = LoraConfig()
    native = os.path.join(tmp, "two", "epoch_2")
    peft = os.path.join(tmp, "peft_epoch_2")
    os.makedirs(peft)
    for f in ("adapter_model.safetensors", "adapter_config.json"):
        shutil.copy(os.path.join(native, f), peft)
    ref_enc = ClipEncoder(load_params(weights, device="cuda"), arch=enc.arch, config=enc.cfg, device="cuda")
    ref_enc.attach_lora(two.final_lora, lcfg.scaling)
    ref = ref_enc.encode_text(texts)
    for name, d in (("native", native), ("PEFT", peft)):
        e = ClipEncoder.from_config(None, weights_path=weights, lora_path=d, device="cuda")
        got = e.encode_text(texts)
        if not np.array_equal(got, ref):
            raise AssertionError(f"phase 9 (b) epoch_2 {name} adapter: text embeddings differ from "
                                 f"TrainResult.final_lora's (max {np.abs(got - ref).max():.3e})")
        del e
    rows = [index.append(ref[i], f"trained/{i}", t) for i, t in enumerate(texts)]
    svc = SeekerService(ref_enc, SeekerConfig(), index=index)
    for i, t in enumerate(texts):
        res = svc.search_items(description=t)
        if len(res) != 5 or res[0].index != rows[i] or not res[0].score >= 0.99:
            raise AssertionError(f"phase 9 (b) search with the trained adapter, query {i}: "
                                 f"top {res[0].index} {res[0].score}")
    log(f"phase 9 (b) the epoch_2 adapter, native and PEFT, loaded by ClipEncoder.from_config: text "
        f"embeddings bit-equal to TrainResult.final_lora's at epoch 2; {len(texts)} text searches over "
        f"phase 3's index ({len(index)} rows with the trained encoder's rows) return their own rows first")
    del ref_enc, svc


def step_configs(torch, card, enc) -> dict:
    """Phase 9 (c): the train step at B=128 (uint8 224² pixels, 64-wide
    token ids, fp32) in four configurations; (d): the chained step. Returns
    the launches of one (iii) step."""
    from clip_lora_match_tpu_torch import ops
    from clip_lora_match_tpu_torch.core.config import LoraConfig, TrainingConfig
    from clip_lora_match_tpu_torch.nn.layers import kernel_flags
    from clip_lora_match_tpu_torch.models.io import tree_leaves
    from clip_lora_match_tpu_torch.train.step import (
        init_train_state, make_chained_train_step, make_optimizer, make_train_step)

    arch, eot = enc.arch, enc.preprocessor.tokenizer.eot_id
    batch = train_batch(enc, TRAIN_B, 64, SEED + 21)
    tcfg = TrainingConfig()
    tx, _ = make_optimizer(tcfg, 1000)
    off = dict(fused_lora=False, small_attention=False, flash_attention=False)
    on = dict(fused_lora=True, small_attention=True, flash_attention=False)
    configs = (
        ("(i) training flags, dropout 0.1", off, 0.1, False),
        ("(ii) training flags, dropout 0", off, 0.0, False),
        ("(iii) fused_lora + small_attention, dropout 0", on, 0.0, False),
        ("(iv) training flags, dropout 0.1, remat=True", off, 0.1, True),
    )
    out = {}
    for name, flags, rate, remat in configs:
        lcfg = LoraConfig(dropout=rate)
        with kernel_flags(**flags):
            step = make_train_step(enc.params, arch, lcfg, tcfg, tx, eot_id=eot, remat=remat)
            state = init_train_state(enc.lora, tx, seed=42)
            for _ in range(2):
                state, m = step(state, batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            samples, losses = [], []
            for _ in range(10):
                t = time.perf_counter()
                state, m = step(state, batch)
                torch.cuda.synchronize()
                samples.append((time.perf_counter() - t) * 1e3)
                losses.append(m["loss"].item())
            peak = torch.cuda.max_memory_allocated()
            ops.reset_launch_counts()
            step(state, batch)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            rows = device_rows(torch, lambda: step(state, batch))
        if not np.isfinite(losses).all():
            raise AssertionError(f"phase 9 (c) {name}: non-finite loss {losses}")
        ms = statistics.median(samples)
        busy = sum(r[0] for r in rows)
        out[name] = dict(ms=ms, busy=busy, peak=peak, counts=counts)
        log(f"phase 9 (c) B={TRAIN_B} step {name}: median of 10 {ms:.2f} ms (min {min(samples):.2f}); device "
            f"busy {busy:.2f} ms, idle share {1 - busy / ms:.3f}; peak memory "
            f"{peak / 2 ** 30:.2f} GiB; launches {json.dumps({k: v for k, v in counts.items() if v})}; "
            f"losses {losses[0]:.5f}..{losses[-1]:.5f} [{card}]")
        log(f"  by kind (ms, count): {json.dumps(_by_kind(rows))}")
        for ms_, count, key in sorted(rows, reverse=True)[:6]:
            log(f"  {ms_:9.3f} ms  x{count:<5d} {key[:100]}")
        del state, step
        torch.cuda.empty_cache()
    layers = arch.vision_layers + arch.text_layers
    c3 = out[configs[2][0]]["counts"]
    if c3["lora_matmul"] != 4 * layers or c3["attention_small"] != layers:
        raise AssertionError(f"phase 9 (c) (iii) launches {c3}")
    if any(out[configs[i][0]]["counts"][k] for i in (0, 1, 3) for k in ("lora_matmul", "attention_small")):
        raise AssertionError("phase 9 (c): a step with the training flags launched a kernel")
    # (iii) against (ii): the loss and every LoRA gradient at B=128
    kern = tower_grads(torch, enc.params, enc.lora, arch, batch, eot, **on)
    plain = tower_grads(torch, enc.params, enc.lora, arch, batch, eot, **off)
    err = _hold_grads(torch, "phase 9 (c) (iii) vs (ii)", kern, plain, 1e-4)
    log(f"phase 9 (c) (iii) against (ii) at B={TRAIN_B}: loss and all {len(kern[1])} LoRA gradients within "
        f"max normwise rel err {err:.3e}")
    del kern, plain
    torch.cuda.empty_cache()

    # -- (d) the chained step: K=4 against 4 single steps, bit for bit, dropout 0.1
    K = 4
    B = TRAIN_B // K
    lcfg = LoraConfig(dropout=0.1)
    sub = [{k: v[i * B:(i + 1) * B] for k, v in batch.items()} for i in range(K)]
    single = make_train_step(enc.params, arch, lcfg, tcfg, tx, eot_id=eot)
    chained = make_chained_train_step(enc.params, arch, lcfg, tcfg, tx, K, eot_id=eot)
    s1 = init_train_state(enc.lora, tx, seed=42)
    singles = []
    for b in sub:
        s1, m = single(s1, b)
        singles.append(m["loss"])
    s2, m = chained(init_train_state(enc.lora, tx, seed=42), {k: np.stack([b[k] for b in sub]) for k in sub[0]})
    if not torch.equal(torch.stack(singles), m["losses"]):
        raise AssertionError(f"phase 9 (d) chained losses {m['losses'].tolist()} != singles "
                             f"{[v.item() for v in singles]}")
    for (path, a), (_, b) in zip(tree_leaves(s1.lora), tree_leaves(s2.lora)):
        if not torch.equal(a, b):
            raise AssertionError(f"phase 9 (d) chained adapter differs at {path}")
    log(f"phase 9 (d) make_chained_train_step K={K} at B={B}, dropout 0.1: losses "
        f"{[round(v, 6) for v in m['losses'].tolist()]} and the adapter bit-equal to {K} single steps")
    return c3


def training_path(torch, card, enc, texts, index, gen, tmp: str) -> tuple[dict, dict]:
    """Phase 9 over phase 3's encoder and index, its training runs under
    ``tmp``. Returns the backward rows and the launches of one (iii) step."""
    t0 = time.perf_counter()
    rows = grad_checks(torch, card, gen)
    repaired_fault(torch, enc)
    log(f"phase 9 (a): {time.perf_counter() - t0:.1f} s")
    t = time.perf_counter()
    train_end_to_end(torch, card, enc, texts, index, tmp)
    log(f"phase 9 (b): {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    counts = step_configs(torch, card, enc)
    log(f"phase 9 (c), (d): {time.perf_counter() - t:.1f} s")
    return rows, counts


# ---------------------------------------------------------------------------
# phase 10: the evaluation job and the detector's training
# ---------------------------------------------------------------------------

EVAL_ROWS = 4441  # phase 10 (b): the reference's validation size (ref:data/text/val_fashion.csv)
# phase 10 (a): a diagonal rank may differ between the bf16 kernel path and
# the fp32 plain path only where the two scores it orders lie this close
NEAR_TIE = 0.01
YOLO_B = 32  # phase 10 (d): the batch of the timed detector run
SYNTH_DETECTOR = "models/yolo_synth/yolov8n_synth.npz"


def _corpora(tmp: str) -> dict:
    """Start scripts/generate_fashion_corpus.py (PIL and the stdlib) for
    both corpora, as subprocesses writing under ``tmp``: (b)'s 4,441
    captioned renders and (d)'s detection corpus with the committed
    detector's recipe (seed 42, 320², 2,400 train / 600 val)."""
    gen = os.path.join(REPO, "scripts", "generate_fashion_corpus.py")
    cmds = {
        "fashion": ["--out", os.path.join(tmp, "fashion"), "--n-train", "0", "--n-val", str(EVAL_ROWS)],
        "detect": ["--detect", "--out", os.path.join(tmp, "detect"), "--seed", "42", "--imgsz", "320",
                   "--n-train", "2400", "--n-val", "600"],
    }
    return {name: (time.perf_counter(), subprocess.Popen([sys.executable, gen, *args], stdout=subprocess.PIPE,
                                                        stderr=subprocess.STDOUT, text=True))
            for name, args in cmds.items()}


def _corpus_ready(procs: dict, name: str) -> str:
    t0, proc = procs[name]
    out, _ = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"phase 10: generate_fashion_corpus.py ({name}) exited {proc.returncode}: {out}")
    log(f"phase 10 corpus {name}: {out.strip().splitlines()[-1]} (ready {time.perf_counter() - t0:.1f} s "
        f"after its start)")


class _EncodeRecorder:
    """Wraps ``CLIPEvaluator.encode_dataset`` while installed: each call's
    kernel launches (the counters' difference across the call) and its
    embeddings, in call order."""

    def __init__(self, ops):
        from clip_lora_match_tpu_torch.eval.evaluator import CLIPEvaluator

        self.cls, self.ops, self.calls = CLIPEvaluator, ops, []
        self.orig = CLIPEvaluator.encode_dataset

    def __enter__(self):
        rec = self

        def encode_dataset(ev, data):
            before = rec.ops.launch_counts()
            out = rec.orig(ev, data)
            after = rec.ops.launch_counts()
            rec.calls.append(({k: after[k] - before[k] for k in after if after[k] != before[k]}, out))
            return out

        self.cls.encode_dataset = encode_dataset
        return self

    def __exit__(self, *exc):
        self.cls.encode_dataset = self.orig


def _rank_flips(sim_ref: np.ndarray, sim: np.ndarray) -> list:
    """(direction, row, rank in ref, rank in sim, largest score gap in ref
    among the pairs whose order against the diagonal flipped)."""
    out = []
    for direction, a, b in (("i2t", sim_ref, sim), ("t2i", sim_ref.T, sim.T)):
        da, db = np.diagonal(a)[:, None], np.diagonal(b)[:, None]
        ra, rb = 1 + (a > da).sum(1), 1 + (b > db).sum(1)
        for i in np.nonzero(ra != rb)[0]:
            flipped = (a[i] > da[i]) != (b[i] > db[i])
            out.append((direction, int(i), int(ra[i]), int(rb[i]), float(np.abs(a[i] - da[i])[flipped].max())))
    return out


def eval_run_all(torch, card, tmp, tmp9) -> dict:
    """Phase 10 (a): ``eval.cli run-all`` at full ViT-B/32 width over the
    in-repo 60 rows and phase 9 (b)'s 3-epoch adapters (over phase 3's
    base weights). Returns the run's launches."""
    import yaml

    from clip_lora_match_tpu_torch import ops
    from clip_lora_match_tpu_torch.core.config import load_clip_config
    from clip_lora_match_tpu_torch.eval import BASE_NAME, CLIPEvaluator, epoch_name, load_eval_csv
    from clip_lora_match_tpu_torch.eval import cli as ecli
    from clip_lora_match_tpu_torch.eval.protocols import diagonal_metrics, similarity_matrix
    from clip_lora_match_tpu_torch.lora.adapter import load_lora
    from clip_lora_match_tpu_torch.models.encoder import ClipEncoder
    from clip_lora_match_tpu_torch.models.io import load_params
    from clip_lora_match_tpu_torch.nn.layers import kernel_flags

    images = os.path.join(REPO, "data", "text", "images")
    rows = []
    for name in ("val_fashion.csv", "train_fashion.csv"):
        with open(os.path.join(REPO, "data", "text", name)) as f:
            rows += f.read().splitlines()[1:]
    csv60 = os.path.join(tmp, "val_train_60.csv")
    with open(csv60, "w") as f:
        f.write("\n".join(["image_path,text", *rows]) + "\n")
    out = os.path.join(tmp, "results")
    with open(os.path.join(REPO, "config", "evaluation_config.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["paths"].update(val_csv=csv60, image_root=images, lora_dir=os.path.join(tmp9, "full"), results_dir=out,
                        plots_dir=os.path.join(out, "plots"), qualitative_dir=os.path.join(out, "qualitative"))
    cfg["models"]["lora_epochs"] = [1, 2, 3]
    eval_yaml = os.path.join(tmp, "eval_a.yaml")
    with open(eval_yaml, "w") as f:
        yaml.safe_dump(cfg, f)
    clip_yaml, weights = os.path.join(REPO, "config", "clip_config.yaml"), os.path.join(tmp9, "base.npz")

    ops.reset_launch_counts()
    t = time.perf_counter()
    with _EncodeRecorder(ops) as rec:
        res = ecli.run(["run-all", "--eval-config", eval_yaml, "--clip-config", clip_yaml, "--weights", weights])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = ops.launch_counts()
    names = ["the artifact (base)", BASE_NAME, epoch_name(1), epoch_name(2), epoch_name(3), "qualitative (base)"]
    if len(rec.calls) != len(names):
        raise AssertionError(f"phase 10 (a): {len(rec.calls)} encodes, expected {len(names)}")
    arch = load_clip_config(clip_yaml).arch
    layers = arch.vision_layers + arch.text_layers
    for name, (c, _) in zip(names, rec.calls):
        lora = name.startswith("CLIP+LoRA")
        if c.get("attention_small", 0) != layers or (c.get("lora_matmul", 0) == 2 * layers) != lora or (
                set(c) - {"attention_small", "lora_matmul"}):
            raise AssertionError(f"phase 10 (a) {name}: launches {c}")
    log(f"phase 10 (a) eval.cli run-all at ViT-B/32 over the in-repo 60 rows, base + phase 9 (b)'s epoch_1..3 "
        f"adapters: {wall:.2f} s; launches per encode (60 images + 60 texts, bf16 compute): "
        + "; ".join(f"{n}: {json.dumps(c)}" for n, (c, _) in zip(names, rec.calls)))

    # the written artifacts against the committed model_comparison.json's
    # metric keys (evaluation_results.json: the JAX package's diagonal
    # artifact, {"retrieval": those keys but matching accuracy, "matching_accuracy"})
    with open(os.path.join(REPO, "results", "model_comparison.json")) as f:
        ref_cmp = json.load(f)
    with open(os.path.join(out, "evaluation_results.json")) as f:
        art = json.load(f)
    with open(os.path.join(out, "model_comparison.json")) as f:
        cmp_ = json.load(f)
    with open(os.path.join(out, "evaluation_report.md")) as f:
        report = f.read()
    metric_keys = {k for m in ref_cmp.values() for k in m}
    if set(art) != {"retrieval", "matching_accuracy"} or set(art["retrieval"]) != metric_keys - {"matching_accuracy"}:
        raise AssertionError(f"phase 10 (a) evaluation_results.json keys {sorted(art)} / {sorted(art['retrieval'])}")
    if list(cmp_) != names[1:5] or any(set(m) != metric_keys for m in cmp_.values()):
        raise AssertionError(f"phase 10 (a) model_comparison.json: {list(cmp_)}, keys {[sorted(m) for m in cmp_.values()]}")
    sections = ("## 1. Model Comparison", "## 2. Best Models", "## 3. Improvement (epoch over epoch)",
                "## 4. Recommendations")
    if not all(s in report for s in sections) or not all(f"| {n} |" in report for n in cmp_):
        raise AssertionError("phase 10 (a) evaluation_report.md lacks a section or a model row")
    log(f"phase 10 (a) evaluation_results.json, model_comparison.json (4 models x {len(metric_keys)} metrics) "
        f"and evaluation_report.md have the JAX package's keys and sections; plots written: "
        f"{len(res['plots'])} comparison, {len(res['grids'])} failure grids, embedding space "
        f"{'yes' if res['embedding_plot'] else 'no'} (none without matplotlib, as in the JAX package)")
    for n in names[1:5]:
        log(f"  {n}: " + ", ".join(f"{k} {v:.4f}" for k, v in cmp_[n].items()))

    # base and epoch 3 against the same encoder with the kernels off, fp32
    cfg_clip = load_clip_config(clip_yaml)
    ref = ClipEncoder(load_params(weights, device="cuda"), arch=arch, config=cfg_clip, compute_dtype="float32",
                      device="cuda")
    data = load_eval_csv(csv60, images)
    off = dict(fused_lora=False, small_attention=False, flash_attention=False, fused_mlp=False)
    ops.reset_launch_counts()
    with kernel_flags(**off):
        plain = {BASE_NAME: CLIPEvaluator(ref).encode_dataset(data)}
        ref.attach_lora(*load_lora(os.path.join(tmp9, "full", "epoch_3"), device="cuda", arch=arch))
        plain[epoch_name(3)] = CLIPEvaluator(ref).encode_dataset(data)
    if any(ops.launch_counts().values()):
        raise AssertionError(f"phase 10 (a) the kernels-off encoder launched {ops.launch_counts()}")
    for name, (_, kern) in ((BASE_NAME, rec.calls[1]), (epoch_name(3), rec.calls[4])):
        want = diagonal_metrics(*plain[name], device="cuda")
        cos = min(float(((a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))).min())
                  for a, b in zip(kern, plain[name]))
        flips = _rank_flips(similarity_matrix(*plain[name], device="cuda"), similarity_matrix(*kern, device="cuda"))
        if cmp_[name] == want:
            log(f"phase 10 (a) {name}: run-all's metrics equal those of the kernels-off fp32 encoder's embeddings "
                f"(min cosine bf16 kernels vs fp32 plain {cos:.5f}; diagonal ranks differ on {len(flips)} rows)")
            continue
        bad = [f for f in flips if f[4] > NEAR_TIE]
        widest = sorted(flips, key=lambda f: -f[4])[:3]
        log(f"phase 10 (a) {name}: metrics differ from the kernels-off fp32 encoder's: "
            + ", ".join(f"{k} {cmp_[name][k]:.4f} vs {want[k]:.4f}" for k in want if cmp_[name][k] != want[k])
            + f"; min cosine {cos:.5f}; the diagonal's rank moves on {sum(f[0] == 'i2t' for f in flips)} of 60 "
            f"image rows and {sum(f[0] == 't2i' for f in flips)} of 60 text rows, every move across fp32 score gaps "
            f"of at most {widest[0][4] if flips else 0:.2e} (near-ties: all 3,600 scores of a random-weight model "
            f"lie close together); widest (direction, row, fp32 rank, kernel rank, gap): {widest}")
        if bad or not flips:
            raise AssertionError(f"phase 10 (a) {name}: differences not explained by near-ties (> {NEAR_TIE}): {bad}")
    del ref
    return counts


def eval_throughput(torch, card, tmp, tmp9, procs) -> dict:
    """Phase 10 (b): ``eval.cli evaluate-model`` for the base encoder over
    4,441 generated rows: images/s, texts/s, the host's share (PIL
    preprocessing and tokenization), and a 512-row encode's device busy and
    idle share. Returns the run's launches."""
    from clip_lora_match_tpu_torch import ops
    from clip_lora_match_tpu_torch.eval import CLIPEvaluator, load_eval_csv
    from clip_lora_match_tpu_torch.eval import cli as ecli
    from clip_lora_match_tpu_torch.models.encoder import ClipEncoder
    from clip_lora_match_tpu_torch.preprocess.pipeline import ClipPreprocessor

    root = os.path.join(tmp, "fashion")
    _corpus_ready(procs, "fashion")
    csv_b = os.path.join(root, "val_fashion_synth.csv")
    clip_yaml, weights = os.path.join(REPO, "config", "clip_config.yaml"), os.path.join(tmp9, "base.npz")
    spent = {"preprocess_images": 0.0, "preprocess_text": 0.0, "encode_image": 0.0, "encode_text": 0.0}
    saved = []

    def timed(owner, name):
        fn = getattr(owner, name)

        def wrapper(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[name] += time.perf_counter() - t

        saved.append((owner, name, fn))
        setattr(owner, name, wrapper)

    for owner, name in ((ClipPreprocessor, "preprocess_images"), (ClipPreprocessor, "preprocess_text"),
                        (ClipEncoder, "encode_image"), (ClipEncoder, "encode_text")):
        timed(owner, name)
    ops.reset_launch_counts()
    t = time.perf_counter()
    try:
        art = ecli.run(["evaluate-model", "--csv", csv_b, "--image-root", root, "--clip-config", clip_yaml,
                        "--weights", weights, "--out", os.path.join(tmp, "evaluation_results_4441.json")])
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = ops.launch_counts()
    enc_s = spent["encode_image"] + spent["encode_text"]
    host_s = spent["preprocess_images"] + spent["preprocess_text"]
    log(f"phase 10 (b) eval.cli evaluate-model, base ViT-B/32 over {EVAL_ROWS} generated rows "
        f"(generate_fashion_corpus.py --n-train 0 --n-val {EVAL_ROWS}), batches of 256: {wall:.2f} s in all "
        f"(encoder build and the weights' load included); encode_image {spent['encode_image']:.2f} s = "
        f"{EVAL_ROWS / spent['encode_image']:.1f} images/s, encode_text {spent['encode_text']:.2f} s = "
        f"{EVAL_ROWS / spent['encode_text']:.1f} texts/s; host preprocessing {host_s:.2f} s "
        f"(PIL images {spent['preprocess_images']:.2f}, tokenizer {spent['preprocess_text']:.2f}) = "
        f"{host_s / enc_s:.3f} of the encode time; recall@1 {art['retrieval']['recall@1']:.5f} "
        f"(random weights: chance 1/{EVAL_ROWS}); launches {json.dumps({k: v for k, v in counts.items() if v})} "
        f"[{card}]")
    if art["retrieval"].keys() != {"recall@1", "recall@5", "recall@10", "mrr", "map", "t2i_recall@1",
                                   "t2i_recall@5", "t2i_recall@10"} or not counts["attention_small"]:
        raise AssertionError(f"phase 10 (b): artifact {art}, launches {counts}")
    enc = ClipEncoder.from_config(clip_yaml, weights_path=weights, device="cuda")
    data = load_eval_csv(csv_b, root, max_rows=512)
    ev = CLIPEvaluator(enc)
    rows = device_rows(torch, lambda: ev.encode_dataset(data))
    wall512 = _host_ms(lambda: ev.encode_dataset(data), reps=2)
    busy = sum(r[0] for r in rows)
    log(f"phase 10 (b) one 512-row encode_dataset (2 batches of 256 images and texts): device busy {busy:.2f} ms "
        f"of {wall512:.2f} ms wall, idle share {1 - busy / wall512:.3f}; by kind {json.dumps(_by_kind(rows))} "
        f"[{card}]")
    del enc, ev
    return counts


def eval_similarity(torch, card, tmp, index) -> dict:
    """Phase 10 (c): ``eval.cli similarity`` over phase 3's index (Q=256,
    k=10), its ids held tie-aware against the plain top-k. Returns its
    launches."""
    from clip_lora_match_tpu_torch import ops
    from clip_lora_match_tpu_torch.eval import cli as ecli
    from clip_lora_match_tpu_torch.index.store import EmbeddingIndex
    from clip_lora_match_tpu_torch.retrieval.similarity import l2_normalize

    path = os.path.join(tmp, "index.npz")
    index.save(path)
    ops.reset_launch_counts()
    res = ecli.run(["similarity", "--index", path, "--queries", "256", "--k", "10", "--iters", "20"])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if counts["topk_retrieve"] != 21 or sum(counts.values()) != 21:
        raise AssertionError(f"phase 10 (c): launches {counts} (expected topk_retrieve 21: a warm-up and 20)")
    emb = EmbeddingIndex.load(path, device="cuda").embeddings
    sims = l2_normalize(torch.from_numpy(res["queries"]).cuda()) @ emb.T
    rs, ri = torch.topk(sims, 10, dim=1)
    ids = torch.from_numpy(res["ids"]).cuda().long()
    assert_ids_tie_aware(torch, "phase 10 (c) similarity", ids, rs, ri, 1e-5)
    err = float((torch.from_numpy(res["scores"]).cuda() - rs).abs().max())
    log(f"phase 10 (c) eval.cli similarity over phase 3's index ({res['rows']} rows, D=512 fp32), Q=256 k=10: "
        f"{res['ms_per_batch']:.4f} ms/batch, {res['queries_per_s']:.0f} queries/s (20 iterations, readback "
        f"included); route topk_retrieve_auto -> topk_retrieve (streaming band), launches "
        f"{json.dumps({k: v for k, v in counts.items() if v})}; ids tie-aware equal to the plain top-k "
        f"(fp32 product, torch.topk), scores within {err:.2e} [{card}]")
    return counts


def _yolo_loss_grads(torch, tree, batch, dev, dtype=None):
    """The detection loss and its gradients from a numpy tree (file layout)
    over a ``DetectDataset`` batch on ``dev``, in fp32 (or ``dtype``)."""
    from clip_lora_match_tpu_torch.models.io import tree_leaves
    from clip_lora_match_tpu_torch.models.yolo import train as YT
    from clip_lora_match_tpu_torch.models.yolo import yolov8 as Y

    dtype = dtype or torch.float32
    params = Y.params_from_jax(tree, dev)
    live = [t.detach().to(dtype).requires_grad_(True) for _, t in tree_leaves(params)]
    p = YT._rebuild(params, iter(live))
    S = batch["images"].shape[1]
    anchors, spa = (t.to(dtype) for t in YT.make_anchors(S, device=dev))
    x = torch.from_numpy(batch["images"]).to(dev).to(dtype) / torch.tensor(255.0, device=dev, dtype=dtype)
    loss, aux = YT.detection_loss(p, x.permute(0, 3, 1, 2).contiguous(),
                                  torch.from_numpy(batch["boxes"]).to(dev, dtype),
                                  *(torch.from_numpy(batch[k]).to(dev) for k in ("classes", "valid")),
                                  anchors, spa)
    return loss.item(), aux["num_fg"].item(), [g.cpu().double() for g in torch.autograd.grad(loss, live)]


def detector_training(torch, card, tmp, procs) -> None:
    """Phase 10 (d): YOLOv8-n trained through ``models.yolo.cli train`` for
    one epoch on the committed recipe's corpus, its step on the card against
    the CPU, the saved weights detecting, the warm start's graft; (e): the
    committed detector evaluated beside ``eval_val.json``."""
    from clip_lora_match_tpu_torch import ops
    from clip_lora_match_tpu_torch.core.config import YoloConfig
    from clip_lora_match_tpu_torch.models.yolo import cli as ycli
    from clip_lora_match_tpu_torch.models.yolo import train as YT
    from clip_lora_match_tpu_torch.models.yolo import yolov8 as Y
    from clip_lora_match_tpu_torch.train.step import AdamW, Chain, ClipByGlobalNorm

    data = os.path.join(tmp, "detect")
    _corpus_ready(procs, "detect")
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    res = ycli.run(["train", "--data", data, "--out", os.path.join(tmp, "yolo_out"), "--imgsz", "320",
                    "--epochs", "1", "--batch-size", str(YOLO_B), "--log-every", "5"])
    peak = torch.cuda.max_memory_allocated()
    counts = ops.launch_counts()
    losses = [a["loss"] for a in res["logged"]]
    if any(counts.values()):
        raise AssertionError(f"phase 10 (d) the detector's training launched {counts}")
    if res["steps"] != 2400 // YOLO_B or not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"phase 10 (d) {res['steps']} steps, logged losses {losses}")
    log(f"phase 10 (d) models.yolo.cli train, YOLOv8-n 320^2 from the port's seeded init, 1 epoch of "
        f"{res['steps']} steps at batch {YOLO_B} (2,400 images, fp32, TF32 matmul {tf32[0]} cuDNN {tf32[1]}): "
        f"{res['seconds']:.2f} s = {res['steps'] * YOLO_B / res['seconds']:.1f} img/s end to end (first step "
        f"included); peak memory {peak / 2 ** 30:.2f} GiB; logged losses (every 5 steps) "
        f"{[round(v, 3) for v in losses]}: first {losses[0]:.4f}, last {losses[-1]:.4f}; launches of the eight "
        f"kernels 0 (cuDNN convolutions, plain TAL and losses) [{card}]")

    # the step alone, from the trained weights, over 10 batches of the first 320 images
    sub = os.path.join(tmp, "detect_sub")
    os.makedirs(sub)
    shutil.copy(os.path.join(data, "classes.txt"), sub)
    with open(os.path.join(data, "boxes_train.csv")) as f:
        head = f.read().splitlines()[: 1 + 10 * YOLO_B]
    with open(os.path.join(sub, "boxes_train.csv"), "w") as f:
        f.write("\n".join(head) + "\n")
    ds = YT.DetectDataset(os.path.join(sub, "boxes_train.csv"), 320)
    batches = list(ds.batches(YOLO_B, np.random.default_rng(1)))
    tx = Chain(ClipByGlobalNorm(10.0), AdamW(1e-4, weight_decay=5e-4))
    params = Y.params_from_jax(Y.read_detector(res["weights"])[0], "cuda")
    step = YT.make_yolo_train_step(320, tx, device="cuda")
    state = YT.YoloTrainState(params, tx.init(params), 0)
    for b in batches[:2]:
        state, _ = step(state, b)
    torch.cuda.synchronize()
    samples = []
    for b in batches:
        t = time.perf_counter()
        state, aux = step(state, b)
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t) * 1e3)
    ms = statistics.median(samples)
    rows = device_rows(torch, lambda: step(state, batches[0]))
    busy = sum(r[0] for r in rows)
    log(f"phase 10 (d) the B={YOLO_B} 320^2 train step: median of 10 {ms:.2f} ms (min {min(samples):.2f}) = "
        f"{YOLO_B * 1e3 / ms:.1f} img/s; device busy {busy:.2f} ms, idle share {1 - busy / ms:.3f}; by kind "
        f"{json.dumps(_by_kind(rows))} [{card}]")
    for ms_, count, key in sorted(rows, reverse=True)[:6]:
        log(f"  {ms_:9.3f} ms  x{count:<5d} {key[:100]}")
    del state, step

    # one step's loss and gradients on the card against the CPU (fp32, TF32
    # off), and both against the CPU in fp64: a leaf whose gradient is a sum
    # that cancels shows the summation order of fp32 in either
    committed = Y.read_detector(os.path.join(REPO, SYNTH_DETECTOR))[0]
    small = {k: v[:8] for k, v in batches[0].items()}
    cpu = _yolo_loss_grads(torch, committed, small, "cpu")
    card_ = _yolo_loss_grads(torch, committed, small, "cuda")
    exact = _yolo_loss_grads(torch, committed, small, "cpu", torch.float64)

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-300))

    def flat(gs):
        return torch.cat([g.flatten() for g in gs])

    whole, whole64 = rel(flat(card_[2]), flat(cpu[2])), rel(flat(card_[2]), flat(exact[2]))
    leaf = [(rel(a, b), rel(a, c), rel(b, c)) for a, b, c in zip(card_[2], cpu[2], exact[2])]
    worst = max(range(len(leaf)), key=lambda i: leaf[i][0])
    loss_rel = abs(card_[0] - cpu[0]) / abs(cpu[0])
    if card_[1] != cpu[1] or loss_rel > 1e-5 or whole > 1e-4 or whole64 > 1e-4:
        raise AssertionError(f"phase 10 (d) card vs CPU: loss {card_[0]} vs {cpu[0]}, fg {card_[1]} vs {cpu[1]}, "
                             f"gradients {whole:.3e} normwise ({whole64:.3e} from fp64)")
    log(f"phase 10 (d) one detection loss and its gradients from the committed detector's weights over 8 images "
        f"of the first batch, card against CPU (fp32, TF32 off): loss {card_[0]:.6f} vs {cpu[0]:.6f} (rel "
        f"{loss_rel:.2e}), positives {card_[1]}; the {len(leaf)} gradient leaves together within {whole:.2e} "
        f"normwise of the CPU's and {whole64:.2e} of the CPU's fp64 gradient; leaf by leaf median "
        f"{statistics.median(v[0] for v in leaf):.2e}, worst {leaf[worst][0]:.2e} (leaf {worst}: the card's fp32 "
        f"{leaf[worst][1]:.2e} and the CPU's fp32 {leaf[worst][2]:.2e} from fp64); the card's leaves from fp64 "
        f"at most {max(v[1] for v in leaf):.2e}, the CPU's {max(v[2] for v in leaf):.2e} [{card}]")

    # the trained weights, saved as the JAX trainer saves them, served through load_detector
    det = Y.load_detector(res["weights"], device="cuda")
    m1 = ycli.evaluate(det, os.path.join(data, "boxes_val.csv"), det.cfg, limit=100)
    log(f"phase 10 (d) {os.path.basename(res['weights'])} (fp16, the JAX file layout) through load_detector "
        f"(imgsz {det.cfg.imgsz} from its meta.json), bf16: after 1 epoch over 100 val images {json.dumps(m1)}")
    del det

    # the warm start from the committed detector: every leaf grafted
    g = ycli.run(["train", "--data", sub, "--out", os.path.join(tmp, "graft_out"), "--imgsz", "320",
                  "--epochs", "1", "--batch-size", str(YOLO_B), "--init-weights",
                  os.path.join(REPO, SYNTH_DETECTOR), "--log-every", "5"])
    if g["grafted"] != g["leaves"]:
        raise AssertionError(f"phase 10 (d) --init-weights grafted {g['grafted']} of {g['leaves']} leaves")
    log(f"phase 10 (d) --init-weights {SYNTH_DETECTOR}: {g['grafted']}/{g['leaves']} leaves grafted "
        f"(the same 10 classes)")

    # (e) the committed detector on the regenerated val split
    ops.reset_launch_counts()
    m16 = ycli.run(["eval", "--data", data, "--weights", os.path.join(REPO, SYNTH_DETECTOR), "--limit", "150"])
    det32 = Y.load_detector(os.path.join(REPO, SYNTH_DETECTOR), YoloConfig(), device="cuda",
                            compute_dtype=torch.float32)
    m32 = ycli.evaluate(det32, os.path.join(data, "boxes_val.csv"), det32.cfg, limit=150)
    if any(ops.launch_counts().values()):
        raise AssertionError(f"phase 10 (e) the detector launched {ops.launch_counts()}")
    with open(os.path.join(REPO, "models", "yolo_synth", "eval_val.json")) as f:
        ref = json.load(f)
    log(f"phase 10 (e) models.yolo.cli eval of {SYNTH_DETECTOR} on the regenerated val split, first 150 images "
        f"[{card}]:")
    for name, m in (("eval_val.json (committed)", ref), ("port fp32", m32), ("port bf16 (the card's default)", m16)):
        log(f"  {name}: " + ", ".join(f"{k} {m[k]:.4f}" if isinstance(m[k], float) else f"{k} {m[k]}" for k in ref))
    diff = {k: (m32[k] - ref[k], m16[k] - ref[k]) for k in ref if m32[k] != ref[k] or m16[k] != ref[k]}
    log(f"  differences from the committed (fp32, bf16): {json.dumps(diff) if diff else 'none'}")
    if m32["recall@0.5"] < 0.9 or m16["recall@0.5"] < 0.9:
        raise AssertionError(f"phase 10 (e): fp32 {m32}, bf16 {m16} against {ref}")


def evaluation_path(torch, card, index, tmp9) -> dict:
    """Phase 10 over phase 3's index and phase 9 (b)'s weights and adapters,
    its corpora generated under a temporary directory. Returns the launches
    of its counted runs ((a)-(c))."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p10_")
    procs = _corpora(tmp)
    try:
        counts = eval_run_all(torch, card, tmp, tmp9)
        log(f"phase 10 (a): {time.perf_counter() - t0:.1f} s")
        t = time.perf_counter()
        for part in (eval_throughput(torch, card, tmp, tmp9, procs), eval_similarity(torch, card, tmp, index)):
            counts = {k: counts[k] + part[k] for k in counts}
        log(f"phase 10 (b), (c): {time.perf_counter() - t:.1f} s")
        torch.cuda.empty_cache()
        t = time.perf_counter()
        detector_training(torch, card, tmp, procs)
        log(f"phase 10 (d), (e): {time.perf_counter() - t:.1f} s")
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 10: {time.perf_counter() - t0:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# phase 11: the data axis across ranks
# ---------------------------------------------------------------------------

P11_JOIN_S = 300  # a world of spawned ranks, or torchrun, must end within this
P11_COLLECTIVE_S = 180  # seconds a collective may wait
P11_K = 5
P11_NEG_ROWS = 100_003  # (b): the all-negative index, padded over the ranks
P11_DTYPES = ("fp32", "bf16", "int8")


def _p11_searches(torch, mesh, rows: dict, q, n_valid: dict, timed: bool) -> dict:
    """The sharded searches of one rank over its shards (``rows``: dtype ->
    shard, "int8" a (values, scales) pair): for each dtype Q=1 and Q=64 at
    k=5, then fp32 Q=1 at k=300. Each search is one counted run (its pass-1
    launches and bodies); with ``timed``, then its wall ms (median of 5, the
    ranks in lockstep) and the gather-and-merge's alone."""
    from clip_lora_match_tpu_torch import ops
    from clip_lora_match_tpu_torch.retrieval import sharded as S

    out = {}
    runs = [(d, Q, P11_K) for d in P11_DTYPES for Q in (1, 64)] + [("fp32", 1, 300)]
    for dtype, Q, k in runs:
        def search(dtype=dtype, Q=Q, k=k):
            if dtype == "int8":
                return S.sharded_topk_retrieve_q8(q[:Q], *rows["int8"], k, mesh, n_valid=n_valid[dtype])
            return S.sharded_topk_retrieve(q[:Q], rows[dtype], k, mesh, n_valid=n_valid[dtype])

        bodies = {n: dict(ops.KERNEL_WRAPPERS[n].bodies) for n in ("tilemax", "tilemax_sup", "tilemax_sup_q8")}
        ops.reset_launch_counts()
        s, i = search()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        ran = {n: {b: ops.KERNEL_WRAPPERS[n].bodies[b] - v for b, v in bodies[n].items()
                   if ops.KERNEL_WRAPPERS[n].bodies[b] != v} for n in bodies}
        ran = {n: b for n, b in ran.items() if b}
        body = "cuda_core" if Q == 1 else "mma"
        if sum(counts[n] for n in ran) != 1 or len(ran) != 1 or list(ran.values())[0] != {body: 1}:
            raise AssertionError(f"phase 11 {dtype} Q={Q} k={k}: pass 1 {counts}, bodies {ran}: one launch "
                                 f"on the {body} body expected")
        row = dict(scores=s.cpu(), ids=i.cpu(), counts=counts, bodies=ran)
        if timed:
            walls = []
            for _ in range(5):
                torch.cuda.synchronize()
                t = time.perf_counter()
                search()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t) * 1e3)
            sl, il = s.clone(), i.long().clone()  # the merge alone, over this rank's own candidates
            merges = []
            for _ in range(5):
                torch.cuda.synchronize()
                t = time.perf_counter()
                S.merge_candidates(mesh, sl, il, k)
                torch.cuda.synchronize()
                merges.append((time.perf_counter() - t) * 1e3)
            row.update(ms=statistics.median(walls), merge_ms=statistics.median(merges))
        out[f"{dtype} Q={Q} k={k}"] = row
    return out


def _p11_rows(torch, mesh, d: str, R) -> tuple[dict, dict]:
    """This rank's shards of phase 4's rows, read from ``d``: (a)'s fp32, (b)'s
    bf16, and (a) quantized on the card (pad rows: zero values and scales)."""
    from clip_lora_match_tpu_torch.parallel import pad_to_multiple

    rows, n_valid = {}, {}
    for dtype, name in (("fp32", "rows_a.npy"), ("bf16", "rows_b.npy")):
        # this rank's rows of the whole index padded by pad_to_multiple,
        # read from the file alone (the padded copy of the whole would cost
        # every rank its size in host memory): the last shard's slice is
        # padded to the shard's length, which puts the pad rows where
        # shard_index(pad_to_multiple(whole)) puts them
        whole = np.load(os.path.join(d, name), mmap_mode="r")
        n_valid[dtype] = len(whole)
        n = -(-len(whole) // mesh.n_data)
        mine, _ = pad_to_multiple(np.ascontiguousarray(whole[mesh.rank * n:(mesh.rank + 1) * n]), n)
        rows[dtype] = torch.from_numpy(mine).to(mesh.device)
        del whole, mine
    rows["bf16"] = rows["bf16"].view(torch.bfloat16)
    n = rows["fp32"].shape[0]
    local = min(max(n_valid["fp32"] - mesh.rank * n, 0), n)
    vq, sc = R.quantize_index_int8(rows["fp32"])
    sc[local:] = 0
    rows["int8"], n_valid["int8"] = (vq, sc), n_valid["fp32"]
    return rows, n_valid


def _p11_negative(torch, mesh) -> dict:
    """(b): 100,003 seeded rows that the query scores below 0, its 10 best
    moved to the end (the last shard, beside the zero pad rows), padded over
    the ranks: the sharded search a counted run; then rank 0 searches the
    whole index (uncounted: the reference)."""
    from clip_lora_match_tpu_torch import ops
    from clip_lora_match_tpu_torch.ops import retrieval_topk as R
    from clip_lora_match_tpu_torch.parallel import pad_to_multiple
    from clip_lora_match_tpu_torch.retrieval import sharded as S

    rng = np.random.default_rng(SEED + 40)
    q0 = rng.normal(size=512).astype(np.float32)
    q0 /= np.linalg.norm(q0)
    rows = (-q0 + rng.normal(0, 0.02, (P11_NEG_ROWS, 512))).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    order = np.argsort(-(rows @ q0), kind="stable")
    rows = np.concatenate([rows[order[10:]], rows[order[:10]]])
    q = torch.from_numpy(q0[None]).to(mesh.device)
    padded, n_valid = pad_to_multiple(rows, mesh.n_data)
    shard = S.shard_index(mesh, padded)
    out = {"max_score": float((rows @ q0).max()), "n_valid": n_valid, "padded": padded.shape[0]}
    ops.reset_launch_counts()
    out["got"] = tuple(t.cpu() for t in S.sharded_topk_retrieve(q, shard, 10, mesh, n_valid=n_valid))
    out["counts"] = ops.launch_counts()
    # 41 such rows, the 10 best last: a shard has fewer tiles than the
    # two-pass selection needs, so its search takes the oracle route, which
    # must keep the zero pad rows out too
    small = np.concatenate([rows[:31], rows[-10:]])
    padded, nv = pad_to_multiple(small, mesh.n_data)
    got = S.sharded_topk_retrieve(q, S.shard_index(mesh, padded), 10, mesh, n_valid=nv)
    out["small"] = (got[1][0].tolist(), np.argsort(-(small @ q0), kind="stable")[:10].tolist())
    if mesh.rank == 0:
        out["whole"] = tuple(t.cpu() for t in R.topk_retrieve_twopass(q, torch.from_numpy(rows).cuda(), 10))
    return out


def _p11_dp_steps(torch, params, lora, arch, eot, batch, mesh) -> dict:
    """(d): three B=128 steps (phase 9 (c) (ii): the trainer's flags, fp32,
    dropout 0) from phase 3's adapter, data-parallel under ``mesh`` (this
    rank's 64 rows) or in one process; then three more, timed."""
    from clip_lora_match_tpu_torch.core.config import LoraConfig, TrainingConfig
    from clip_lora_match_tpu_torch.models.io import tree_map
    from clip_lora_match_tpu_torch.nn.layers import kernel_flags
    from clip_lora_match_tpu_torch.parallel import shard_batch
    from clip_lora_match_tpu_torch.train.step import init_train_state, make_optimizer, make_train_step

    tcfg = TrainingConfig()
    tx, _ = make_optimizer(tcfg, 1000)
    placed = batch if mesh is None else shard_batch(mesh, batch)
    with kernel_flags(fused_lora=False, small_attention=False, flash_attention=False):
        step = make_train_step(params, arch, LoraConfig(dropout=0.0), tcfg, tx, eot_id=eot, mesh=mesh)
        state = init_train_state(lora, tx, seed=42)
        losses, norms = [], []
        for _ in range(3):
            state, m = step(state, placed)
            losses.append(m["loss"].item())
            norms.append(m["grad_norm"].item())
        final = tree_map(lambda t: t.detach().cpu(), state.lora)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = step(state, placed)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
    return dict(losses=losses, norms=norms, lora=final, ms=statistics.median(walls))


def p11_rank_main(d: str, rank: int, world: int) -> int:
    """One spawned rank of phase 11 (``chip_smoke.py --phase11-rank DIR RANK
    WORLD``): join the world's gloo group through a file store in ``DIR``,
    run the parts ``DIR/job.json`` names, save what they give to
    ``DIR/rank{RANK}.pt``. The kernels were built by the parent: the rank
    only loads them."""
    import torch

    from clip_lora_match_tpu_torch import ops
    from clip_lora_match_tpu_torch.ops import retrieval_topk as R
    from clip_lora_match_tpu_torch.parallel import initialize_distributed, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(d, "job.json")) as f:
        job = json.load(f)
    initialize_distributed(f"file://{os.path.join(d, 'store')}", world, rank, backend=job["backend"],
                           timeout=P11_COLLECTIVE_S)
    import torch.distributed as dist

    out = {}
    try:
        mesh = make_mesh()
        out["device"] = str(mesh.device)
        top = os.path.dirname(d)
        t = time.perf_counter()
        rows, n_valid = _p11_rows(torch, mesh, top, R)
        q = torch.from_numpy(np.load(os.path.join(top, "queries.npy"))).to(mesh.device)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t
        out["searches"] = _p11_searches(torch, mesh, rows, q, n_valid, timed=True)
        del rows
        torch.cuda.empty_cache()
        out["negative"] = _p11_negative(torch, mesh)
        if "build" in job["parts"]:
            from clip_lora_match_tpu_torch.index import cli as index_cli

            ops.reset_launch_counts()
            t = time.perf_counter()
            index_cli.run(["build-text", "--dist-backend", job["backend"], "--csv", job["csv"],
                           "--weights", os.path.join(top, "base.npz"), "--lora", os.path.join(top, "lora"),
                           "--out", os.path.join(top, "built2.npz")])
            torch.cuda.synchronize()
            out["build"] = dict(counts=ops.launch_counts(), s=time.perf_counter() - t)
            torch.cuda.empty_cache()
        if "train" in job["parts"]:
            from clip_lora_match_tpu_torch.core.config import ClipArchConfig
            from clip_lora_match_tpu_torch.lora.adapter import load_lora
            from clip_lora_match_tpu_torch.models.io import load_params

            params = load_params(os.path.join(top, "base.npz"), device=mesh.device)
            lora, _ = load_lora(os.path.join(top, "lora"), device=mesh.device)
            batch = dict(np.load(os.path.join(top, "train_batch.npz")))
            ops.reset_launch_counts()
            out["train"] = _p11_dp_steps(torch, params, lora, ClipArchConfig(), int(job["eot"]), batch, mesh)
            out["train_counts"] = ops.launch_counts()
        out["memory"] = f"{_host_memory()}, card peak {torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB"
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))
    return 0


def _p11_spawn(torch, tmp: str, name: str, world: int, job: dict, flag: str = "--phase11-rank",
               phase: str = "phase 11") -> list:
    """Start ``world`` ranks of this script (``flag``: ``--phase11-rank`` or
    ``--phase12-rank``), wait for every one within P11_JOIN_S, and return
    their results; a rank that fails or hangs fails the phase (its log's end
    in the error), and no rank is left running."""
    d = os.path.join(tmp, name)
    os.makedirs(d)
    with open(os.path.join(d, "job.json"), "w") as f:
        json.dump(job, f)
    procs = []
    try:
        for r in range(world):
            log_f = open(os.path.join(d, f"rank{r}.log"), "w")
            procs.append((log_f, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), flag, d, str(r), str(world)],
                cwd=REPO, stdout=log_f, stderr=subprocess.STDOUT)))
        deadline = time.monotonic() + P11_JOIN_S
        for r, (_, p) in enumerate(procs):
            try:
                rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = "timed out"
            if rc != 0:
                with open(os.path.join(d, f"rank{r}.log")) as f:
                    tail = f.read()[-4000:]
                raise AssertionError(f"{phase} {name}: rank {r} {rc}:\n{tail}")
    finally:
        for log_f, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
            log_f.close()
    return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False) for r in range(world)]


def _host_memory() -> str:
    """This process's peak resident memory (VmHWM: its own, not a forking
    parent's as getrusage's would be) and the host's available memory, each
    "?" where the kernel does not report it."""
    def field(path, key):
        with open(path) as f:
            kb = next((int(line.split()[1]) for line in f if line.startswith(key)), None)
        return "?" if kb is None else f"{kb / 2 ** 20:.1f}"

    return (f"peak RSS {field('/proc/self/status', 'VmHWM:')} GiB, host available "
            f"{field('/proc/meminfo', 'MemAvailable:')} GiB")


def _p11_same(torch, what, got, ref, tol) -> None:
    """Scores within ``tol``; ids equal but inside a run of reference scores
    tied within ``tol``, where the id must be one of the run's."""
    (gs, gi), (rs, ri) = (t.cpu() for t in got), (t.cpu() for t in ref)
    if gs.shape != rs.shape or not bool(((gs - rs).abs() <= tol).all()):
        raise AssertionError(f"{what}: scores differ (max {float((gs - rs).abs().max()):.3e}, tol {tol})")
    assert_ids_tie_aware(torch, what, gi.long(), rs, ri.long(), tol)


def data_axis_path(torch, card, enc, texts, images) -> dict:
    """Phase 11: (a) one NCCL rank (this process) over phase 4's rows; (b)
    gloo worlds of 2 and 4 spawned ranks sharing the card; (c) the sharded
    build at 2 ranks; (d) the data-parallel step at 2 ranks and train.cli
    under torchrun. Returns the launches of the counted runs of every rank."""
    import torch.distributed as dist

    from clip_lora_match_tpu_torch import ops
    from clip_lora_match_tpu_torch.core.config import LoraConfig
    from clip_lora_match_tpu_torch.index import cli as index_cli
    from clip_lora_match_tpu_torch.index.store import EmbeddingIndex
    from clip_lora_match_tpu_torch.lora.adapter import load_lora, save_lora
    from clip_lora_match_tpu_torch.ops import retrieval_topk as R
    from clip_lora_match_tpu_torch.parallel import all_gather, all_reduce_sum, initialize_distributed, make_mesh
    from clip_lora_match_tpu_torch.retrieval import sharded as S
    from clip_lora_match_tpu_torch.train import cli as train_cli

    t_phase = time.perf_counter()
    launches = {name: 0 for name in KERNELS}

    def add(counts):
        for name, v in counts.items():
            launches[name] += v

    tmp = tempfile.mkdtemp(prefix="chip_smoke_p11_")
    corpus = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "scripts", "generate_fashion_corpus.py"), "--out",
         os.path.join(tmp, "fashion"), "--n-train", "0", "--n-val", str(EVAL_ROWS)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    torchrun = None
    try:
        # -- phase 4's rows and queries, the unsharded searches ------------------
        t = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
        noise = torch.randn(HBM_ROWS, enc.arch.projection_dim, device="cuda", generator=gen).cpu().numpy()
        custom = np.concatenate([enc.encode_text(texts), enc.encode_image(images)])
        emb_a = EmbeddingIndex(np.concatenate([noise, custom]), device="cuda").embeddings
        np.save(os.path.join(tmp, "rows_a.npy"), emb_a.cpu().numpy())
        emb_b = EmbeddingIndex(np.concatenate([noise[:BF16_ROWS], custom]), storage_dtype="bfloat16",
                               device="cuda").embeddings
        del noise
        np.save(os.path.join(tmp, "rows_b.npy"), emb_b.view(torch.int16).cpu().numpy())
        rng = np.random.default_rng(SEED + 4)
        queries = np.concatenate([custom, rng.standard_normal((64 - len(custom), custom.shape[1]))]).astype(
            np.float32)
        np.save(os.path.join(tmp, "queries.npy"), queries)
        q = torch.from_numpy(queries).cuda()
        vq, sc = R.quantize_index_int8(emb_a)
        whole = {"fp32": emb_a, "bf16": emb_b}
        refs = {}
        for dtype in P11_DTYPES:
            for Q, k in ((1, P11_K), (64, P11_K)) + (((1, 300),) if dtype == "fp32" else ()):
                key = f"{dtype} Q={Q} k={k}"
                refs[key] = (R.topk_retrieve_q8(q[:Q], vq, sc, k) if dtype == "int8"
                             else R.topk_retrieve_twopass(q[:Q], whole[dtype], k))
        enc.save(os.path.join(tmp, "base.npz"))
        save_lora(os.path.join(tmp, "lora"), enc.lora, LoraConfig())
        eot = enc.preprocessor.tokenizer.eot_id
        batch = train_batch(enc, TRAIN_B, 64, SEED + 21)
        np.savez(os.path.join(tmp, "train_batch.npz"), **batch)
        torch.cuda.synchronize()
        log(f"phase 11 set-up: {time.perf_counter() - t:.1f} s (phase 4's rows written for the ranks: "
            f"{len(emb_a)} fp32, {len(emb_b)} bf16; the unsharded searches); {_host_memory()}; card "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB allocated, "
            f"{torch.cuda.memory_reserved() / 2 ** 30:.1f} GiB reserved")

        # -- (a) one NCCL rank on cuda:0 -----------------------------------------
        t = time.perf_counter()
        initialize_distributed(f"file://{os.path.join(tmp, 'nccl_store')}", 1, 0, backend="nccl",
                               timeout=P11_COLLECTIVE_S)
        try:
            mesh = make_mesh()
            x = torch.arange(6.0, device="cuda").reshape(2, 3)
            g, s_ = all_gather(mesh, x), all_reduce_sum(mesh, x)
            if not (torch.equal(g, x) and torch.equal(s_, x) and g.is_cuda and mesh.backend == "nccl"):
                raise AssertionError(f"phase 11 (a) collectives: {g} {s_} {mesh.backend}")
            rows = {"fp32": S.shard_index(mesh, emb_a), "bf16": S.shard_index(mesh, emb_b),
                    "int8": S.shard_index_q8(mesh, vq, sc)}
            n_valid = {dtype: len(emb_a) if dtype != "bf16" else len(emb_b) for dtype in P11_DTYPES}
            one = _p11_searches(torch, mesh, rows, q, n_valid, timed=True)
        finally:
            dist.destroy_process_group()
        del rows
        for key, row in one.items():
            add(row["counts"])
            ref = refs[key]
            if not (torch.equal(row["scores"], ref[0].cpu()) and torch.equal(row["ids"], ref[1].cpu())):
                raise AssertionError(f"phase 11 (a) {key}: the 1-rank NCCL search differs from the unsharded one")
        log(f"phase 11 (a) NCCL, 1 rank on {mesh.device}: all_gather and all_reduce of CUDA tensors; "
            f"{len(one)} sharded searches bit-equal to phase 4's unsharded route "
            f"({time.perf_counter() - t:.1f} s)")
        del vq, sc, whole, emb_a, emb_b
        torch.cuda.empty_cache()

        # -- (b)-(d) gloo worlds of 2 and 4 ranks sharing the card ----------------
        out = corpus.communicate(timeout=600)[0]
        if corpus.returncode != 0:
            raise AssertionError(f"phase 11: generate_fashion_corpus.py exited {corpus.returncode}: {out}")
        csv = os.path.join(tmp, "fashion", "val_fashion_synth.csv")
        worlds = {}
        for world, parts in ((2, ["search", "build", "train"]), (4, ["search"])):
            t = time.perf_counter()
            worlds[world] = _p11_spawn(torch, tmp, f"gloo{world}", world, dict(
                backend="gloo", parts=parts, csv=csv, eot=eot))
            log(f"phase 11 gloo world of {world} ranks: {time.perf_counter() - t:.1f} s "
                f"(rank 0 loaded its shards in {worlds[world][0]['load_s']:.1f} s; rank 0 "
                f"{worlds[world][0]['memory']})")
        table = {1: one}
        for world, ranks in worlds.items():
            table[world] = ranks[0]["searches"]
            for r, res in enumerate(ranks):
                if res["device"] != "cuda:0":
                    raise AssertionError(f"phase 11 gloo{world} rank {r} on {res['device']}")
                for key, row in res["searches"].items():
                    add(row["counts"])
                    tol = 0.0 if key.startswith("int8") else 1e-6
                    _p11_same(torch, f"phase 11 (b) gloo{world} rank {r} {key}",
                              (row["scores"], row["ids"]), refs[key], tol)
                neg = res["negative"]
                add(neg["counts"])
                _p11_same(torch, f"phase 11 (b) gloo{world} rank {r} all-negative", neg["got"],
                          ranks[0]["negative"]["whole"], 1e-6)
                if not (neg["max_score"] < 0 and int(neg["got"][1].max()) < neg["n_valid"] < neg["padded"]):
                    raise AssertionError(f"phase 11 (b) gloo{world} all-negative: {neg}")
                if neg["small"][0] != neg["small"][1] or set(neg["small"][0]) != set(range(31, 41)):
                    raise AssertionError(f"phase 11 (b) gloo{world} rank {r} 41 all-negative rows: "
                                         f"ids {neg['small'][0]}, exact {neg['small'][1]}")
            log(f"phase 11 (b) gloo, {world} ranks on cuda:0: every rank's {len(table[world])} searches "
                f"tie-aware equal to (a)'s (scores within 1e-6, int8 exact); the all-negative index "
                f"({P11_NEG_ROWS} rows padded to {ranks[0]['negative']['padded']}, its 10 best in the last "
                f"shard) gives no pad id and the unsharded top 10, and so do 41 such rows, each shard "
                f"on the oracle route")
            for r, res in enumerate(ranks):
                log(f"  rank {r} pass 1: " + json.dumps({key: row["bodies"] for key, row in res["searches"].items()}))
        log(f"phase 11 search times by world size (wall ms of one search, median of 5 / gather-and-merge ms "
            f"alone, rank 0; gloo ranks time-share one card: no measure of scaling) [{card}]:")
        for key in one:
            log(f"  {key}: " + "; ".join(f"{w} rank{'s' if w > 1 else ''} "
                                        f"{'nccl' if w == 1 else 'gloo'} {table[w][key]['ms']:.3f} / "
                                        f"{table[w][key]['merge_ms']:.3f}" for w in sorted(table)))

        # -- (c) the sharded build against one process ---------------------------
        ranks = worlds[2]
        for r, res in enumerate(ranks):
            c = res["build"]["counts"]
            add(c)
            if c["attention_small"] == 0 or c["lora_matmul"] == 0:
                raise AssertionError(f"phase 11 (c) rank {r} build-text launches {c}")
        t = time.perf_counter()
        index_cli.run(["build-text", "--csv", csv, "--weights", os.path.join(tmp, "base.npz"),
                       "--lora", os.path.join(tmp, "lora"), "--out", os.path.join(tmp, "built1.npz")])
        one_s = time.perf_counter() - t
        two = np.load(os.path.join(tmp, "built2.npz"))["embeddings"]
        ref1 = np.load(os.path.join(tmp, "built1.npz"))["embeddings"]
        cos = (two * ref1).sum(1) / (np.linalg.norm(two, axis=1) * np.linalg.norm(ref1, axis=1))
        with open(os.path.join(tmp, "built2.json")) as f:
            side = json.load(f)
        if two.shape != ref1.shape or two.shape[0] != EVAL_ROWS or not cos.min() >= 0.99999:
            raise AssertionError(f"phase 11 (c) sharded build: {two.shape} vs {ref1.shape}, min cosine {cos.min()}")
        # self-retrieval: the 1-process build's first 64 rows as queries find
        # their own rows of the sharded build first (or a row of the same text,
        # or one scoring within 1e-5 of their own)
        qs, built = torch.from_numpy(ref1[:64]).cuda(), torch.from_numpy(two).cuda()
        top_s, top_i = R.topk_retrieve_auto(qs, built, 1)
        own = (qs * built[:64]).sum(1)
        misses = [j for j, g in enumerate(top_i[:, 0].tolist()) if g != j and side["texts"][g] != side["texts"][j]
                  and float(own[j]) < float(top_s[j, 0]) - 1e-5]
        if misses:
            raise AssertionError(f"phase 11 (c) self-retrieval misses {misses}")
        log(f"phase 11 (c) index.cli build-text at 2 gloo ranks over {EVAL_ROWS} rows: rows against the "
            f"1-process build min cosine {cos.min():.7f}; 64 rows find their own rows first; launches a rank "
            f"{json.dumps({k: v for k, v in ranks[0]['build']['counts'].items() if v})}; "
            f"{ranks[0]['build']['s']:.1f} s a rank against {one_s:.1f} s in one process [{card}]")

        # -- (d) the data-parallel step and train.cli under torchrun ---------------
        lora, _ = load_lora(os.path.join(tmp, "lora"), device="cuda")
        single = _p11_dp_steps(torch, enc.params, lora, enc.arch, eot, batch, None)
        for r, res in enumerate(ranks):
            dp = res["train"]
            add(res["train_counts"])
            for g, ref in zip(dp["losses"] + dp["norms"], single["losses"] + single["norms"]):
                if not abs(g - ref) <= 1e-5 * abs(ref):
                    raise AssertionError(f"phase 11 (d) rank {r}: loss / grad_norm {dp['losses']} {dp['norms']} "
                                         f"vs {single['losses']} {single['norms']}")
            worst = max(_normrel(torch, a, b) for (_, a), (_, b) in zip(_leaves(dp["lora"]), _leaves(single["lora"])))
            if not worst <= 1e-5:
                raise AssertionError(f"phase 11 (d) rank {r}: LoRA leaves within {worst:.3e} of one process")
        log(f"phase 11 (d) B={TRAIN_B} fp32 step, 2 gloo ranks (64 rows a rank) on cuda:0 against one process: "
            f"losses {[round(v, 6) for v in single['losses']]}, grad norms and every LoRA leaf within rel 1e-5; "
            f"step {ranks[0]['train']['ms']:.2f} ms (2 ranks on one card, gloo) against {single['ms']:.2f} ms "
            f"(one process): the cost of gloo on one card, not a data-parallel speed-up [{card}]")
        for name in ("dp", "one"):  # dropout 0: the ranks' masks cannot match one process's
            _train_yaml(os.path.join(tmp, f"{name}.yaml"), os.path.join(tmp, f"run_{name}"), 2, dropout=0.0)
        t = time.perf_counter()
        torchrun = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
             "-m", "clip_lora_match_tpu_torch.train.cli", "--config", os.path.join(tmp, "dp.yaml"),
             "--weights", os.path.join(tmp, "base.npz"), "--dist-backend", "gloo"],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        one_run = train_cli.run(["--config", os.path.join(tmp, "one.yaml"), "--weights",
                                 os.path.join(tmp, "base.npz")])
        tr_out, _ = torchrun.communicate(timeout=P11_JOIN_S)
        tr_s = time.perf_counter() - t
        if torchrun.returncode != 0:
            raise AssertionError(f"phase 11 (d) torchrun train.cli exited {torchrun.returncode}:\n{tr_out[-4000:]}")
        dp_dir, one_dir = os.path.join(tmp, "run_dp"), os.path.join(tmp, "run_one")
        listing = sorted(os.listdir(dp_dir))
        lines = [open(os.path.join(d_, "training_metrics.jsonl")).read().count("\n") for d_ in (dp_dir, one_dir)]
        if listing != sorted(os.listdir(one_dir)) or lines[0] != lines[1] or tr_out.count("[train] done") != 1:
            raise AssertionError(f"phase 11 (d) torchrun outputs {listing}, metrics lines {lines}, "
                                 f"'done' printed {tr_out.count('[train] done')} times")
        got_lora, _ = load_lora(os.path.join(dp_dir, "epoch_2"), device="cpu")
        ref_lora, _ = load_lora(os.path.join(one_dir, "epoch_2"), device="cpu")
        worst = max(_normrel(torch, a, b) for (_, a), (_, b) in zip(_leaves(got_lora), _leaves(ref_lora)))
        if not worst <= 1e-5:
            raise AssertionError(f"phase 11 (d) torchrun epoch_2 adapter within {worst:.3e} of one process")
        log(f"phase 11 (d) torchrun --nproc-per-node 2 train.cli (gloo, batch 6, 2 epochs, dropout 0): only "
            f"rank 0 wrote ({listing}, {lines[0]} metrics lines, as one process); its epoch_2 adapter within "
            f"rel {worst:.3e} of the 1-process run's (final loss {one_run.train_losses[-1]:.5f}); "
            f"{tr_s:.1f} s with the 1-process run beside it [{card}]")
    finally:
        for p in (corpus, torchrun):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
    for name in ("tilemax", "tilemax_sup", "tilemax_sup_q8", "attention_small", "lora_matmul"):
        if launches[name] == 0:
            raise AssertionError(f"phase 11: {name} was not launched ({launches})")
    log(f"phase 11: launches of its counted runs (every rank) {json.dumps(launches)}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 12: the model axes (tensor, sequence, pipeline) over spawned ranks
# ---------------------------------------------------------------------------

P12_ENCODE_B = 8  # (a): the serving encode's batch, image and text
P12_STEPS = 2  # checked steps a case, then as many timed
# world -> cases: (name, kind, mesh arguments, "encode" or "step", microbatches)
P12_CASES = {
    2: [("tp2 encode", "tp", {"n_model": 2}, "encode", None),
        ("sp2 encode", "sp", {"n_seq": 2}, "encode", None),
        ("pp2 encode", "pp", {"n_stage": 2}, "encode", 4),
        ("tp2 step", "tp", {"n_model": 2}, "step", None),
        ("sp2 step", "sp", {"n_seq": 2}, "step", None),
        ("pp2 step", "pp", {"n_stage": 2}, "step", 4)],
    4: [("dp2xtp2 step", "tp", {"n_data": 2, "n_model": 2}, "step", None),
        ("dp1xtp2xsp2 step", "sp", {"n_seq": 2, "n_model": 2}, "step", None),
        ("pp2xsp2 step", "pp", {"n_stage": 2, "n_seq": 2}, "step", 4),
        ("pp4 encode", "pp", {"n_stage": 4}, "encode", 4)],
}


def _p12_mesh(P, kind: str, axes: dict):
    if kind == "tp":
        return P.make_mesh(device="cuda", **axes)
    if kind == "sp":
        return P.make_sp_mesh(device="cuda", **axes)
    return P.make_pp_mesh(device="cuda", **axes)


def _p12_place(P, kind: str, mesh, params, lora, M):
    """(params, lora, the state's splits, transformer_fn) for this rank."""
    from clip_lora_match_tpu_torch.models.io import tree_map

    if kind == "tp" or (kind == "sp" and mesh.size(P.MODEL_AXIS) > 1):
        fn = P.make_tp_transformer(mesh) if kind == "tp" else P.make_sp_transformer(mesh)
        sl = P.shard_lora_tp(lora, mesh)
        return P.shard_params_tp(params, mesh), sl, P.lora_tp_pspecs(sl), fn
    if kind == "sp":
        return (P.shard_clip_sp(params, mesh), P.shard_clip_sp(lora, mesh), tree_map(lambda _: None, lora),
                P.make_sp_transformer(mesh))
    sl = P.shard_clip_pp(lora, mesh)
    return P.shard_clip_pp(params, mesh), sl, P.clip_pp_pspecs(sl), P.make_pipeline_transformer(mesh, M)


def _p12_encode(torch, P, kind, mesh, params, lora, scaling, arch, eot, inputs, M) -> dict:
    """(a): the serving encode of both towers on this rank's shards, bf16,
    the kernels under "auto"; its launches."""
    from clip_lora_match_tpu_torch import ops
    from clip_lora_match_tpu_torch.models import clip as C

    p, lo, _, fn = _p12_place(P, kind, mesh, params, lora, M)
    pix = torch.from_numpy(inputs["pixels"]).cuda()
    ids, am = (torch.from_numpy(inputs[k]).cuda() for k in ("input_ids", "attention_mask"))
    with torch.no_grad():
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t = time.perf_counter()
        img = C.encode_image_features(p, pix, arch, lora=lo, lora_scaling=scaling, compute_dtype=torch.bfloat16,
                                      transformer_fn=fn)
        txt = C.encode_text_features(p, ids, arch, attention_mask=am, eot_id=eot, lora=lo, lora_scaling=scaling,
                                     compute_dtype=torch.bfloat16, transformer_fn=fn)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        counts = ops.launch_counts()
    return dict(image=img.float().cpu(), text=txt.float().cpu(), counts=counts, ms=ms)


def _p12_step(torch, P, kind, mesh, params, lora, arch, eot, batch, M) -> dict:
    """(a), (b): the B=128 fp32 step (phase 9 (c) (ii): the trainer's flags,
    dropout 0) on this rank's shards: P12_STEPS counted steps (losses, the
    LoRA tree gathered whole, launches, peak memory), then P12_STEPS timed
    ones (ms, the collectives by axis)."""
    from clip_lora_match_tpu_torch import ops
    from clip_lora_match_tpu_torch.core.config import LoraConfig, TrainingConfig
    from clip_lora_match_tpu_torch.nn.layers import kernel_flags
    from clip_lora_match_tpu_torch.train.step import make_optimizer, make_train_step

    p, lo, specs, fn = _p12_place(P, kind, mesh, params, lora, M)
    tcfg = TrainingConfig()
    tx, _ = make_optimizer(tcfg, 1000)
    placed = P.shard_batch(mesh, batch)
    with kernel_flags(fused_lora=False, small_attention=False, flash_attention=False):
        step = make_train_step(p, arch, LoraConfig(dropout=0.0), tcfg, tx, eot_id=eot, mesh=mesh,
                               transformer_fn=fn)
        state = P.init_sharded_train_state(lo, tx, specs, seed=42)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        losses = []
        for _ in range(P12_STEPS):
            state, m = step(state, placed)
            losses.append(m["loss"].item())
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        final = {k: v.cpu() for k, v in _leaves(P.gather_sharded(state.lora, specs, mesh))}
        mesh.stats.clear()
        walls = []
        for _ in range(P12_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = step(state, placed)
            m["loss"].item()
            walls.append((time.perf_counter() - t) * 1e3)
        stats = {axis: (calls / P12_STEPS, sec * 1e3 / P12_STEPS) for axis, (calls, sec) in mesh.stats.items()}
    return dict(losses=losses, lora=final, counts=counts, peak_gib=peak, ms=statistics.median(walls),
                collectives=stats)


def p12_rank_main(d: str, rank: int, world: int) -> int:
    """One spawned rank of phase 12 (``chip_smoke.py --phase12-rank DIR RANK
    WORLD``): join the world's gloo group through a file store in ``DIR``,
    run the cases ``DIR/job.json`` names (each on its own mesh), save what
    they give to ``DIR/rank{RANK}.pt``. The kernels were built by the
    parent: the rank only loads them."""
    import torch

    from clip_lora_match_tpu_torch import parallel as P
    from clip_lora_match_tpu_torch.core.config import ClipArchConfig
    from clip_lora_match_tpu_torch.lora.adapter import load_lora
    from clip_lora_match_tpu_torch.models.io import load_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(d, "job.json")) as f:
        job = json.load(f)
    P.initialize_distributed(f"file://{os.path.join(d, 'store')}", world, rank, backend="gloo",
                             timeout=P11_COLLECTIVE_S)
    import torch.distributed as dist

    out = {"cases": {}}
    try:
        top = os.path.dirname(d)
        params = load_params(os.path.join(top, "base.npz"), device="cuda")
        lora, scaling = load_lora(os.path.join(top, "lora"), device="cuda")
        out["device"] = str(params["logit_scale"].device)
        arch, eot = ClipArchConfig(), int(job["eot"])
        inputs = dict(np.load(os.path.join(top, "encode_batch.npz")))
        batch = dict(np.load(os.path.join(top, "train_batch.npz")))
        for name, kind, axes, what, M in P12_CASES[world]:
            mesh = _p12_mesh(P, kind, axes)
            if what == "encode":
                res = _p12_encode(torch, P, kind, mesh, params, lora, scaling, arch, eot, inputs, M)
            else:
                res = _p12_step(torch, P, kind, mesh, params, lora, arch, eot, batch, M)
            out["cases"][name] = dict(res, coords=mesh.coords, shape=mesh.shape)
            torch.cuda.empty_cache()
        out["memory"] = _host_memory()
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))
    return 0


def _cos_min(a, b) -> float:
    a, b = a.double(), b.double()
    return float(((a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1))).min())


def model_axes_path(torch, card, enc) -> dict:
    """Phase 12: the model axes over gloo worlds of 2 and 4 spawned ranks
    sharing the card, at full ViT-B/32 width (phase 3's weights and adapter):
    (a) the serving encode (image and text, B=8, bf16, the kernels under
    "auto") through the TP, SP and PP executors (world 2) and a pp4 one
    (M=4, world 4), each rank's against the unsharded encode (cosine >=
    0.999), lora_matmul launched on every rank and attention_small on every
    TP and PP rank; (b) the B=128 fp32 step (phase 9 (c) (ii), dropout 0,
    S=77 text: SP's pad path) as tp2, sp2, pp2 (M=4) in the world of 2 and
    dp2×tp2, dp1×tp2×sp2, pp2×sp2 (M=4) in the world of 4, each rank's
    losses over 2 steps and LoRA tree after them within rel 1e-5 of one
    process's; the step ms, the collectives' count and ms by axis, the peak
    memory and launches by rank. Returns the launches of every rank's
    counted runs."""
    from clip_lora_match_tpu_torch import ops
    from clip_lora_match_tpu_torch.core.config import ClipArchConfig, LoraConfig
    from clip_lora_match_tpu_torch.lora.adapter import load_lora, save_lora
    from clip_lora_match_tpu_torch.models import clip as C
    from clip_lora_match_tpu_torch.models.io import load_params

    t_phase = time.perf_counter()
    launches = {name: 0 for name in KERNELS}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p12_")
    try:
        t = time.perf_counter()
        enc.save(os.path.join(tmp, "base.npz"))
        save_lora(os.path.join(tmp, "lora"), enc.lora, LoraConfig())
        eot = enc.preprocessor.tokenizer.eot_id
        batch = train_batch(enc, TRAIN_B, 77, SEED + 31)
        np.savez(os.path.join(tmp, "train_batch.npz"), **batch)
        text = train_batch(enc, P12_ENCODE_B, 77, SEED + 32)
        rng = np.random.default_rng(SEED + 33)
        pixels = rng.standard_normal((P12_ENCODE_B, 224, 224, 3)).astype(np.float32)
        np.savez(os.path.join(tmp, "encode_batch.npz"), pixels=pixels, input_ids=text["input_ids"],
                 attention_mask=text["attention_mask"])
        # one process: the unsharded encode (bf16, "auto") and the step
        arch = ClipArchConfig()
        params = load_params(os.path.join(tmp, "base.npz"), device="cuda")
        lora, scaling = load_lora(os.path.join(tmp, "lora"), device="cuda")
        with torch.no_grad():
            ref_img = C.encode_image_features(params, torch.from_numpy(pixels).cuda(), arch, lora=lora,
                                              lora_scaling=scaling, compute_dtype=torch.bfloat16).float().cpu()
            ref_txt = C.encode_text_features(
                params, torch.from_numpy(text["input_ids"]).cuda(), arch,
                attention_mask=torch.from_numpy(text["attention_mask"]).cuda(), eot_id=eot, lora=lora,
                lora_scaling=scaling, compute_dtype=torch.bfloat16).float().cpu()
        single = _p12_one_process(torch, params, lora, arch, eot, batch)
        del params
        torch.cuda.empty_cache()
        log(f"phase 12 set-up: {time.perf_counter() - t:.1f} s (phase 3's weights and adapter written for the "
            f"ranks; the one-process encode and B={TRAIN_B} step: {single['ms']:.2f} ms, peak "
            f"{single['peak_gib']:.2f} GiB) [{card}]")

        worlds = {}
        for world in (2, 4):
            t = time.perf_counter()
            worlds[world] = _p11_spawn(torch, tmp, f"gloo{world}", world, dict(eot=eot), "--phase12-rank",
                                       "phase 12")
            log(f"phase 12 gloo world of {world} ranks: {time.perf_counter() - t:.1f} s (rank 0 "
                f"{worlds[world][0]['memory']})")
        for world, ranks in worlds.items():
            for name, kind, axes, what, M in P12_CASES[world]:
                for r, res in enumerate(ranks):
                    if res["device"] != "cuda:0":
                        raise AssertionError(f"phase 12 world {world} rank {r} on {res['device']}")
                    got = res["cases"][name]
                    for k, v in got["counts"].items():
                        launches[k] += v
                    if what == "encode":
                        cos = min(_cos_min(got["image"], ref_img), _cos_min(got["text"], ref_txt))
                        need = ["lora_matmul"] + (["attention_small"] if kind in ("tp", "pp") else [])
                        missing = [k for k in need if got["counts"][k] == 0]
                        if not cos >= 0.999 or missing:
                            raise AssertionError(f"phase 12 {name} rank {r}: min cosine {cos:.6f} against the "
                                                 f"unsharded encode, launches {got['counts']} (none of {missing})")
                        got["cos"] = cos
                        continue
                    loss_rel = max(abs(g - ref) / abs(ref) for g, ref in zip(got["losses"], single["losses"],
                                                                             strict=True))
                    worst = max(_normrel(torch, got["lora"][k], single["lora"][k]) for k in single["lora"])
                    if not (loss_rel <= 1e-5 and worst <= 1e-5):
                        raise AssertionError(f"phase 12 {name} rank {r}: losses {got['losses']} against one "
                                             f"process's {single['losses']} (rel {loss_rel:.3e}), LoRA tree "
                                             f"within rel {worst:.3e}")
                    got["worst"], got["loss_rel"] = worst, loss_rel
                head = ranks[0]["cases"][name]
                if what == "encode":
                    log(f"phase 12 (a) {name} ({kind}, mesh {head['shape']}): every rank's image and text rows "
                        f"against the unsharded bf16 encode, min cosine "
                        f"{min(r['cases'][name]['cos'] for r in ranks):.6f}; {head['ms']:.2f} ms on rank 0 (first "
                        f"call); launches by rank "
                        + "; ".join(json.dumps({k: v for k, v in r['cases'][name]['counts'].items() if v})
                                    for r in ranks) + f" [{card}]")
                    continue
                coll = "; ".join(f"{axis} {calls:.0f} calls {ms:.2f} ms" for axis, (calls, ms)
                                 in sorted(head["collectives"].items()))
                log(f"phase 12 (b) {name} (mesh {head['shape']}, B={TRAIN_B} fp32, {P12_STEPS} steps): losses "
                    f"{[round(v, 6) for v in head['losses']]}, every rank's within rel "
                    f"{max(r['cases'][name]['loss_rel'] for r in ranks):.2e} of one process's, LoRA within rel "
                    f"{max(r['cases'][name]['worst'] for r in ranks):.2e}; step "
                    f"{head['ms']:.2f} ms against {single['ms']:.2f} ms in one process (gloo ranks sharing one card: "
                    f"no measure of scaling); collectives a step on rank 0: {coll}; peak GiB by rank "
                    f"{[round(r['cases'][name]['peak_gib'], 2) for r in ranks]}; launches by rank "
                    f"{[sum(r['cases'][name]['counts'].values()) for r in ranks]} [{card}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name in ("attention_small", "lora_matmul"):
        if launches[name] == 0:
            raise AssertionError(f"phase 12: {name} was not launched ({launches})")
    log(f"phase 12: launches of its counted runs (every rank) {json.dumps(launches)}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def _p12_one_process(torch, params, lora, arch, eot, batch) -> dict:
    """The B=128 fp32 step of (b) in this process: P12_STEPS counted steps
    (losses, the LoRA tree), then P12_STEPS timed."""
    from clip_lora_match_tpu_torch.core.config import LoraConfig, TrainingConfig
    from clip_lora_match_tpu_torch.nn.layers import kernel_flags
    from clip_lora_match_tpu_torch.train.step import init_train_state, make_optimizer, make_train_step

    tcfg = TrainingConfig()
    tx, _ = make_optimizer(tcfg, 1000)
    with kernel_flags(fused_lora=False, small_attention=False, flash_attention=False):
        step = make_train_step(params, arch, LoraConfig(dropout=0.0), tcfg, tx, eot_id=eot)
        state = init_train_state(lora, tx, seed=42)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = []
        for _ in range(P12_STEPS):
            state, m = step(state, batch)
            losses.append(m["loss"].item())
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        final = {k: v.cpu() for k, v in _leaves(state.lora)}
        walls = []
        for _ in range(P12_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = step(state, batch)
            m["loss"].item()
            walls.append((time.perf_counter() - t) * 1e3)
    return dict(losses=losses, lora=final, peak_gib=peak, ms=statistics.median(walls))


def _leaves(tree):
    from clip_lora_match_tpu_torch.models.io import tree_leaves

    return tree_leaves(tree)


# ---------------------------------------------------------------------------
# phase 13: approximate top-k and the last entry points
# ---------------------------------------------------------------------------

APPROX_GRID = [(Q, k, r) for Q in (1, 64) for k in (5, 10, 100) for r in (0.9, 0.95, 0.99)]
# the 524,298-row bf16 arena's rows: search_batch's, and the two-launch selection (L = 32,896)
ARENA_GRID = [(64, 10, 0.95), (64, 256, 0.99)]


def approx_grid(torch, card, emb, gen, where: str) -> list:
    """Phase 13 (a)'s rows: the bin-max kernel and the whole approximate
    selection over ``emb`` (44,446 fp32 rows) at every (Q, k, r) of
    APPROX_GRID and over a 524,298-row bf16 arena (ARENA_GRID), recall pooled
    over each (k, r)'s 65 queries >= r - 0.05. Logged and returned."""
    from clip_lora_match_tpu_torch.ops import approx_topk as AT
    from clip_lora_match_tpu_torch.ops import retrieval_topk as R

    rows = []
    for Q, k, r in APPROX_GRID:
        q = torch.randn(Q, emb.shape[1], device="cuda", generator=gen)
        rows.append(approx_row(torch, AT, R, emb, q, k, r, where))
    arena = torch.nn.functional.normalize(
        torch.randn(BF16_ROWS + 10, emb.shape[1], device="cuda", generator=gen), dim=1).to(torch.bfloat16)
    for Q, k, r in ARENA_GRID:
        q = torch.randn(Q, emb.shape[1], device="cuda", generator=gen)
        rows.append(approx_row(torch, AT, R, arena, q, k, r, "bf16 arena"))
    del arena
    for row in rows:
        log(f"phase 13 (a) {approx_line(row)} [{card}]")
    # recall is an expectation: each (k, r) pooled over its 65 queries
    for k, r in sorted({(k, r) for _, k, r in APPROX_GRID}):
        pooled = [(row["recall"], Q) for row, (Q, kk, rr) in zip(rows, APPROX_GRID) if (kk, rr) == (k, r)]
        recall = sum(x * Q for x, Q in pooled) / sum(Q for _, Q in pooled)
        if not recall >= r - 0.05:
            raise AssertionError(f"phase 13 (a) k={k} r={r}: recall {recall} over 65 queries < {r - 0.05}")
    for row, (_, k, r) in zip(rows[len(APPROX_GRID):], ARENA_GRID):
        if not row["recall"] >= r - 0.05:
            raise AssertionError(f"phase 13 (a) arena k={k} r={r}: recall {row['recall']} < {r - 0.05}")
    return rows


def approx_path(torch, card, enc, index, texts, gen) -> tuple:
    """Phase 13 (a): the bin-max kernel and the whole approximate selection
    against their plain versions over phase 3's 44,446-row fp32 index (Q 1
    and 64, k 5, 10, 100, r 0.9, 0.95, 0.99) and a 524,298-row bf16 arena
    (phase 4 (b)'s size: Q = 64, k = 10, r = 0.95 and k = 256, r = 0.99),
    then 15 counted text requests through SearchIndex(approximate=True), each
    finding its own row (phase 3's text rows), each one bin-max launch and
    one fused selection and no sort. Returns their launches and the rows."""
    from clip_lora_match_tpu_torch import ops
    from clip_lora_match_tpu_torch.ops import approx_topk as AT
    from clip_lora_match_tpu_torch.ops import retrieval_topk as R
    from clip_lora_match_tpu_torch.retrieval.search import SearchIndex

    t0 = time.perf_counter()
    emb = index.embeddings[:INDEX_ROWS + 10]  # phase 3's rows (phase 9 appended its own after them)
    rows = approx_grid(torch, card, emb, gen, "phase 3's index")

    search = SearchIndex(index, enc, approximate=True, recall_target=0.95)
    L, lg = AT.reduction_bins(len(index), 5, 0.95)
    ops.reset_launch_counts()
    s0, n0 = AT.approx_topk.select_launches, AT.approx_topk.sorts
    res = [search.search_by_text(texts[i % len(texts)], 5) for i in range(15)]
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    selects, sorts = AT.approx_topk.select_launches - s0, AT.approx_topk.sorts - n0
    if (selects, sorts) != (15, 0):
        raise AssertionError(f"phase 13 (a) 15 requests: {selects} fused selection launches, {sorts} sorts")
    layers = enc.arch.text_layers
    want = {name: 0 for name in counts}
    want.update(approx_topk=15, attention_small=15 * layers, lora_matmul=15 * LORA_PER_LAYER * layers)
    if counts != want:
        raise AssertionError(f"phase 13 (a) launches {counts} != {want}")
    for i, rr in enumerate(res):
        if len(rr) != 5 or rr[0].index != INDEX_ROWS + i % len(texts):
            raise AssertionError(f"phase 13 (a) approximate text search {i}: top {rr[0].index if rr else None}")
    lat = []
    for i in range(10):
        torch.cuda.synchronize()
        t = time.perf_counter()
        search.search_by_text(texts[i % len(texts)], 5)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    log(f"phase 13 (a) SearchIndex(approximate=True, recall_target=0.95) over {len(index)} rows (L={L}, "
        f"lg={lg}): 15 text requests, launches {json.dumps({k: v for k, v in counts.items() if v})}, fused "
        f"selection launches {selects}, sorts {sorts}, each its own row first; request latency, median of 10: "
        f"{statistics.median(lat):.4f} ms [{card}]")
    qc = R._normalize_div(torch.randn(1, emb.shape[1], device="cuda", generator=gen)).to(emb.dtype)
    profiler_window_check(torch, lambda: AT.binmax(qc, emb, 384), "binmax_core")
    log(f"phase 13 (a): {time.perf_counter() - t0:.1f} s")
    return {**counts, "select_launches": selects, "sorts": sorts}, rows


def _heldout_labels(tmp: str) -> str:
    """Five rendered detection photos, one of them filed under two
    directories (as data/real_labels/real_boxes.json files one photo twice),
    and their labels in that file's layout."""
    import random

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import generate_fashion_corpus as gen

    rng = random.Random(1234)
    entries = []
    for i, sub in enumerate(("reported", "reported", "reported", "custom", "custom")):
        path = os.path.join("photos", sub, f"photo{i}.jpg")
        os.makedirs(os.path.join(tmp, "photos", sub), exist_ok=True)
        img, boxes = gen.render_detect_image(rng, 320, max_objects=1)
        img.save(os.path.join(tmp, path), quality=92)
        x1, y1, x2, y2, c = boxes[0]
        entries.append({"path": path, "width": 320, "height": 320, "boxes": [
            {"class": gen.ARTICLE_CLASSES[c], "xyxy": [float(x1), float(y1), float(x2), float(y2)]}]})
    twin = dict(entries[3], path=os.path.join("photos", "reported", "photo3.jpg"))
    shutil.copy(os.path.join(tmp, entries[3]["path"]), os.path.join(tmp, twin["path"]))
    labels = os.path.join(tmp, "labels.json")
    with open(labels, "w") as f:
        json.dump({"classes": list(gen.ARTICLE_CLASSES), "images": entries + [twin]}, f)
    return labels


def entry_points_path(torch, card, enc, texts, paths) -> None:
    """Phase 13 (b): every entry point of services.cli, lora.cli,
    tokenizer.cli, models.cli and models.yolo.cli heldout, in this process at
    full ViT-B/32 width over phase 3's weights and adapter (saved to a
    temporary .npz and adapter directory), from a temporary working directory."""
    import contextlib
    import io

    from clip_lora_match_tpu_torch.core.config import LoraConfig
    from clip_lora_match_tpu_torch.index import cli as index_cli
    from clip_lora_match_tpu_torch.lora import cli as lora_cli
    from clip_lora_match_tpu_torch.lora.adapter import save_lora
    from clip_lora_match_tpu_torch.models import cli as models_cli
    from clip_lora_match_tpu_torch.models.encoder import ClipEncoder
    from clip_lora_match_tpu_torch.models.yolo import cli as yolo_cli
    from clip_lora_match_tpu_torch.services import cli as services_cli
    from clip_lora_match_tpu_torch.tokenizer import cli as tokenizer_cli

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p13_")
    cwd = os.getcwd()
    try:
        os.chdir(tmp)
        weights, adapter = os.path.join(tmp, "b32.npz"), os.path.join(tmp, "adapter")
        enc.save(weights)
        save_lora(adapter, enc.lora, LoraConfig())
        clip_yaml = os.path.join(REPO, "config", "clip_config.yaml")
        yaml32 = os.path.join(tmp, "clip_fp32.yaml")
        with open(clip_yaml) as f:
            text = f.read()
        with open(yaml32, "w") as f:
            f.write(text.replace('compute_dtype: "bfloat16"', 'compute_dtype: "float32"'))
        E = ["--clip-config", clip_yaml, "--weights", weights, "--lora", adapter, "--device", "cuda"]
        custom_csv, val_csv = os.path.join(tmp, "custom.csv"), os.path.join(tmp, "val.csv")
        with open(custom_csv, "w", encoding="utf-8") as f:
            f.write("image_path,text\n" + "".join(f"{p},{t}\n" for p, t in zip(paths, texts)))
        import csv as csv_mod

        with open(os.path.join(REPO, "data", "text", "val_fashion.csv"), newline="", encoding="utf-8") as f:
            val = list(csv_mod.DictReader(f))
        with open(val_csv, "w", newline="", encoding="utf-8") as f:
            w = csv_mod.writer(f)
            w.writerow(["image_path", "text"])
            w.writerows([(os.path.join(REPO, r["image_path"]), r["text"]) for r in val])
        custom, fashion = os.path.join(tmp, "custom_items_index.npz"), os.path.join(tmp, "fashion_text_index.npz")
        log(f"phase 13 (b) set-up (B/32 weights, adapter, CSVs): {time.perf_counter() - t0:.1f} s")

        def run(name, cli, argv, check):
            t = time.perf_counter()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                out = cli.run(argv)
            printed = buf.getvalue()
            torch.cuda.synchronize()
            msg = check(out, printed)
            last = printed.strip().splitlines()
            log(f"phase 13 (b) {name}: {time.perf_counter() - t:.2f} s; {msg}; last line: "
                f"{last[-1][:140] if last else ''!r}")
            return out

        def results(n):
            def check(res, printed):
                if len(res) != n or not all(np.isfinite(r.score) for r in res):
                    raise AssertionError(f"{len(res)} results, expected {n}")
                return f"top {res[0].index} ({res[0].score:.4f})"
            return check

        idx = run("index.cli build-custom", index_cli, ["build-custom", "--csv", custom_csv, "--out", custom, *E],
                  lambda ix, p: f"{len(ix)} rows, verify ok" if "verify=ok" in p and len(ix) == len(texts)
                  else _fail("build-custom"))
        run("index.cli build-text", index_cli, ["build-text", "--csv", val_csv, "--out", fashion, *E],
            lambda ix, p: f"{len(ix)} rows, verify ok" if "verify=ok" in p and len(ix) == len(val)
            else _fail("build-text"))
        copy = os.path.join(tmp, "report", "custom_items_index.npz")
        os.makedirs(os.path.dirname(copy))
        for ext in (".npz", ".json"):
            shutil.copy(custom[:-4] + ext, copy[:-4] + ext)
        desc = "tas ransel biru tertinggal di perpustakaan"
        rep = run("services.cli finder-report", services_cli,
                  ["finder-report", "--index", copy, "--image", paths[0], "--description", desc,
                   "--location", "perpustakaan", "--db", os.path.join(tmp, "found.sqlite"), *E],
                  lambda r, p: f"row {r.index_row}, item id {r.item_id}" if r.index_row == len(texts)
                  and r.item_id == 1 else _fail("finder-report"))
        run("services.cli search-text-custom (the reported copy)", services_cli,
            ["search-text-custom", "--index", copy, "--query", f"{desc}, ditemukan di perpustakaan", *E],
            lambda res, p: f"the report (row {rep.index_row}) first, {res[0].score:.4f}"
            if res[0].index == rep.index_row else _fail(f"search after report: top {res[0].index}"))
        run("services.cli seeker", services_cli,
            ["seeker", "--index", custom, "--description", texts[1], "--image", paths[1], *E], results(5))
        run("services.cli search-text", services_cli, ["search-text", "--index", fashion, "--query", val[0]["text"],
                                                       *E], results(5))
        run("services.cli search-text-custom", services_cli,
            ["search-text-custom", "--index", custom, "--query", texts[2], *E],
            lambda res, p: f"its own row first ({res[0].score:.4f})" if res[0].index == 2 else _fail("text"))
        run("services.cli search-image", services_cli,
            ["search-image", "--index", fashion, "--image", os.path.join(REPO, val[1]["image_path"]), *E],
            results(5))
        run("services.cli search-image-custom", services_cli,
            ["search-image-custom", "--index", custom, "--image", paths[3], *E], results(5))
        synth = os.path.join(REPO, "models", "yolo_synth", "yolov8n_synth.npz")
        Y = ["--index", custom, "--image", paths[4], "--yolo-weights", synth,
             "--yolo-config", os.path.join(REPO, "config", "yolo_config.yaml"), *E]

        def staged_check(res, printed):  # the demo searches with the whole image when the crop fails
            if "crop failed" in printed or f"query crop: {paths[4]}\n" in printed:
                raise AssertionError(f"phase 13 (b) staged yolo: the crop stage did not crop: {printed!r}")
            return results(5)(res, printed)

        staged = run("services.cli search-image-yolo (staged)", services_cli, ["search-image-yolo", *Y], staged_check)
        run("services.cli search-image-yolo --fused", services_cli, ["search-image-yolo", *Y, "--fused"],
            lambda out, p: f"detected {out[3]}, ids {out[1].tolist()}, staged ids "
            f"{[r.index for r in staged]}" if len(out[1]) == 5 and np.isfinite(out[0]).all()
            else _fail("fused"))

        merged = os.path.join(tmp, "merged.npz")
        run("lora.cli merge", lora_cli, ["merge", "--adapter", adapter, "--out", merged, *E],
            lambda t, p: f"{os.path.getsize(merged) / 1e6:.0f} MB")
        run("lora.cli peft", lora_cli, ["peft", "--adapter", adapter, "--out", os.path.join(tmp, "peft"), *E],
            lambda t, p: "adapter_model.safetensors written")
        back = run("lora.cli native", lora_cli, ["native", "--adapter", os.path.join(tmp, "peft"),
                                                 "--out", os.path.join(tmp, "native"), *E],
                   lambda t, p: "read back from PEFT")
        same_tree(torch, "phase 13 (b) peft -> native adapter", back, enc.lora)
        cos = {}
        for name, yaml in (("fp32", yaml32), ("bf16", clip_yaml)):
            unmerged = ClipEncoder.from_config(yaml, weights, adapter, device="cuda")
            folded = ClipEncoder.from_config(yaml, merged, None, device="cuda")
            a = np.concatenate([unmerged.encode_text(list(texts)), unmerged.encode_image(paths[0])[None]])
            b = np.concatenate([folded.encode_text(list(texts)), folded.encode_image(paths[0])[None]])
            cos[name] = float(((a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))).min())
            del unmerged, folded
        if not cos["fp32"] > 0.9999:
            raise AssertionError(f"phase 13 (b) merged vs unmerged encoder: min cosine {cos}")
        log(f"phase 13 (b) merged weights vs the unmerged encoder (5 texts, 1 image): min cosine fp32 "
            f"{cos['fp32']:.7f}, bf16 compute {cos['bf16']:.7f}")
        run("tokenizer.cli", tokenizer_cli, ["--csv", val_csv, "--merges", "200", "--out", os.path.join(tmp, "bpe")],
            lambda vm, p: f"{len(vm[1])} merges, vocab {len(vm[0])}")
        run("models.cli load", models_cli, ["load", *E],
            lambda o, p: f"dim {o['dim']}, norm {o['norm']:.4f}" if o["dim"] == enc.arch.projection_dim
            else _fail("load"))
        run("models.cli lora-inference (fp32 compute)", models_cli,
            ["lora-inference", "--csv", val_csv, "--clip-config", yaml32, "--weights", weights, "--lora", adapter,
             "--device", "cuda"],
            lambda o, p: f"ranks {o['ranks']}, merged-vs-unmerged cosine {o['cosine']:.6f}")
        labels = _heldout_labels(tmp)
        t = time.perf_counter()
        pooled = run("models.yolo.cli heldout", yolo_cli, [
            "heldout", "--labels", labels, "--reference-root", tmp, "--init-weights", synth,
            "--out", os.path.join(tmp, "heldout.json"), "--per-image", "8", "--epochs", "1", "--folds", "2",
            "--batch-size", "8", "--workdir", os.path.join(tmp, "heldout"), "--device", "cuda"],
            lambda o, p: f"{o['num_unique_photos']} unique photos, {len(o['folds'])} folds"
            if o["num_unique_photos"] == 5 and o["num_images"] == 5 else _fail("heldout"))
        log(f"phase 13 (b) heldout pooled ({time.perf_counter() - t:.1f} s): "
            f"{json.dumps({k: v for k, v in pooled.items() if k != 'folds'})}")
        if len(idx) != len(texts):
            raise AssertionError("phase 13 (b): custom index")
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 13 (b): {time.perf_counter() - t0:.1f} s")


def _fail(what: str):
    raise AssertionError(f"phase 13 (b) {what}")


def main() -> int:
    if "--phase11-rank" in sys.argv:  # a spawned rank of phase 11
        i = sys.argv.index("--phase11-rank")
        return p11_rank_main(sys.argv[i + 1], int(sys.argv[i + 2]), int(sys.argv[i + 3]))
    if "--phase12-rank" in sys.argv:  # a spawned rank of phase 12
        i = sys.argv.index("--phase12-rank")
        return p12_rank_main(sys.argv[i + 1], int(sys.argv[i + 2]), int(sys.argv[i + 3]))
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
    from clip_lora_match_tpu_torch.ops import approx_topk as ops_approx
    from clip_lora_match_tpu_torch.ops import attention_small as ops_attn
    from clip_lora_match_tpu_torch.ops import flash_attention as ops_flash
    from clip_lora_match_tpu_torch.ops import lora_matmul as ops_lora
    from clip_lora_match_tpu_torch.ops import mlp_fused as ops_mlp
    from clip_lora_match_tpu_torch.ops import retrieval_topk as ops_topk

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --only topk_retrieve[,...]: build those kernels' sources and run only
    # their phase-2 checks (a kernel's development loop; the run prints the
    # rows and the card, and no result line)
    only = sys.argv[sys.argv.index("--only") + 1].split(",") if "--only" in sys.argv else None
    t = time.perf_counter()
    logs = _build.build_all(sorted({KERNELS[n][0] for n in only}) if only else _build.KERNEL_SOURCES)
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
        if only is None or name in only:
            results[name] = fn(torch, mod, gen)
    pass1 = ("tilemax", "tilemax_sup", "tilemax_sup_q8")
    if only is None or any(n in only for n in pass1):
        results.update(check_pass1(torch, ops_topk, gen))
        if hasattr(ops_topk, "tilemax_plan"):
            pass1_crossover(torch, ops_topk, gen, card)
    if only is None or "mlp_fused" in only:
        results["mlp_fused"] = check_mlp_fused(torch, ops_mlp, gen)
    if only is None or "flash_attention" in only:
        results["flash_attention"] = check_flash(torch, ops_flash, gen)
    if only is None or "approx_topk" in only:
        results["approx_topk"] = check_approx(torch, ops_approx, ops_topk, gen)
    if only is not None and "approx_topk" in only:
        # phase 13 (a)'s rows over a seeded index of phase 3's size (an A/B without the main path)
        seeded = torch.nn.functional.normalize(torch.randn(INDEX_ROWS + 10, 512, device="cuda", generator=gen), dim=1)
        approx_grid(torch, card, seeded, gen, "seeded 44,446 rows")
        del seeded
    torch.cuda.empty_cache()
    for name, (rows, _) in results.items():
        for row in rows:
            log(f"{name} {row['shape']}: kernel_ms {row['ms']:.5f} device_ms {fmt(row['device_ms'])} "
                f"plain_ms {row['plain_ms']:.5f} library_ms {fmt(row['library_ms'])} "
                f"library_device_ms {fmt(row['library_device_ms'])} bound_ms {row['bound_ms']:.5f} "
                f"({row['bound_by']}) max_abs_err {row['max_abs_err']:.3e}"
                + (f" span_ms {fmt(row['span_ms'])} library_span_ms {fmt(row['library_span_ms'])} select_ms "
                   f"{row['select_ms']:.5f} select_device_ms {fmt(row['select_device_ms'])} select_span_ms "
                   f"{fmt(row['select_span_ms'])} exact_ms {row['exact_ms']:.5f} exact_span_ms "
                   f"{fmt(row['exact_span_ms'])} recall {row['recall']:.4f} "
                   + " ".join(f"{key} {fmt(v)}" for key, v in row.items() if key.startswith("fused_select"))
                   if "recall" in row else "")
                + f" [{card}]")
    if only is not None:
        log(f"device readings refused (torch.profiler records incomplete): {len(DEVICE_GAPS)}")
        log(card)
        return 0

    stop_after = sys.argv[sys.argv.index("--stop-after") + 1] if "--stop-after" in sys.argv else None
    counts, (enc, texts, images, paths), (index, lat3) = main_path(torch, card)
    if stop_after == "3":
        log(card)
        return 0
    hbm = hbm_path(torch, card, enc, texts, images, paths)
    for name, tags in (("tilemax_sup", "a"), ("tilemax", "b"), ("tilemax_sup_q8", "cd")):
        counts[name] = sum(hbm[tag][name] for tag in tags)
    torch.cuda.empty_cache()
    # phase 7's files, made here: its part (b) runs inside phase 5
    tmp7 = None if stop_after == "6" else tempfile.mkdtemp(prefix="chip_smoke_p7_")
    try:
        files = None
        if tmp7 is not None:
            loader = native_loader_check()
            t = time.perf_counter()
            files = (loader, *file_corpus(tmp7))
            log(f"phase 7 files: {len(files[1])} renders (224^2, quality 92) and {len(files[2])} "
                f"photos (1200x1600, quality 90) written in {time.perf_counter() - t:.2f} s")
        l14 = l14_path(torch, card, texts, images, paths, files, w8a8=stop_after in (None, "8", "9", "10", "11", "12"))
        for name in OFF_BY_DEFAULT:
            counts[name] = l14[name]
        torch.cuda.empty_cache()
        crop, http = crop_http_path(torch, card, enc, index, texts, paths, lat3)
        if files is not None:
            image_files_path(torch, card, enc, files)
        if stop_after in (None, "8", "9", "10", "11", "12"):
            torch.cuda.empty_cache()
            w8a8_path(torch, card, enc, texts, images, index, lat3)
    finally:
        if tmp7 is not None:
            shutil.rmtree(tmp7, ignore_errors=True)
    bwd, train_counts = {}, {name: 0 for name in KERNELS}
    eval_counts = {name: 0 for name in KERNELS}
    axis_counts = {name: 0 for name in KERNELS}
    model_counts = {name: 0 for name in KERNELS}
    if stop_after in (None, "9", "10", "11", "12"):
        tmp9 = tempfile.mkdtemp(prefix="chip_smoke_p9_")
        try:
            torch.cuda.empty_cache()
            bwd, train_counts = training_path(torch, card, enc, texts, index, gen, tmp9)
            if stop_after != "9":
                torch.cuda.empty_cache()
                eval_counts = evaluation_path(torch, card, index, tmp9)
        finally:
            shutil.rmtree(tmp9, ignore_errors=True)
    if stop_after in (None, "11", "12"):
        torch.cuda.empty_cache()
        axis_counts = data_axis_path(torch, card, enc, texts, images)
    if stop_after in (None, "12"):
        torch.cuda.empty_cache()
        model_counts = model_axes_path(torch, card, enc)
    approx_counts = {name: 0 for name in KERNELS}
    if stop_after is None:
        torch.cuda.empty_cache()
        approx_counts, _ = approx_path(torch, card, enc, index, texts, gen)
        counts["approx_topk"] = approx_counts["approx_topk"]
        torch.cuda.empty_cache()
        entry_points_path(torch, card, enc, texts, paths)

    table = []
    for name, (rows, worst) in results.items():
        stem, site = KERNELS[name]
        row = rows[0]  # the shape of one request on the kernel's main path
        table.append({
            "name": name, "route": "cuda",
            "source": f"clip_lora_match_tpu_torch/ops/csrc/{stem}.cu",
            "replaces": site, "launches": counts[name], "max_abs_err": worst,
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"], "shape": row["shape"],
            "device_ms": row["device_ms"], "library_device_ms": row["library_device_ms"],
            # phase 6's counted runs: the device-crop seeker and the HTTP text searches
            "launches_phase6": crop[name] + http[name],
            # phase 9 (c) (iii): one B=128 train step with fused_lora and small_attention on
            "launches_phase9": train_counts[name],
            # phase 10's counted runs: run-all, evaluate-model (4,441 rows), similarity
            "launches_phase10": eval_counts[name],
            # phase 11's counted runs, every rank: the sharded searches and the sharded build
            "launches_phase11": axis_counts[name],
            # phase 12's counted runs, every rank: the TP / SP / PP serving encodes and sharded steps
            "launches_phase12": model_counts[name],
            # phase 13 (a)'s counted run: 15 text requests through SearchIndex(approximate=True)
            "launches_phase13": approx_counts[name],
        })
        if "recall" in row:  # approx_topk: the whole selection beside the exact route
            table[-1].update({key: row[key] for key in (
                "span_ms", "library_span_ms", "select_ms", "select_device_ms", "select_span_ms", "select_plain_ms",
                "select_library_ms", "exact_ms", "exact_span_ms", "recall", "L", "lg", "body", "select_launches",
                "sorts")})
            table[-1].update({key: row[key] for key in row if key.startswith("fused_select")})
            # phase 13 (a)'s counted run: the fused selection's launches and the sorts beside the 15 searches
            table[-1].update(select_launches_phase13=approx_counts.get("select_launches"),
                             sorts_phase13=approx_counts.get("sorts"))
        if name in bwd:  # phase 9 (a): the backward (plain fp32 products) at the fp32 image-tower shape
            b = bwd[name][0]
            table[-1].update(backward_shape=b["shape"], backward_ms=b["ms"], backward_device_ms=b["device_ms"],
                             backward_plain_ms=b["plain_ms"], backward_bound_ms=b["bound_ms"],
                             backward_bound_by=b["bound_by"], backward_max_rel_err=b["max_rel_err"])
    log(f"device readings refused (torch.profiler records incomplete): {len(DEVICE_GAPS)} "
        f"{json.dumps(dict(collections.Counter(DEVICE_GAPS)))}")
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
