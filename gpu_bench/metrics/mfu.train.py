"""The training step's share of the card's peak: the steps of the window,
each counted as both towers forward and backward with LoRA's gradients and
the loss, the captions at their own token lengths
(``counts/clip_flops.py``), over the window's wall time, at 989 TFLOP/s
(dense bf16). Steps that overlap the profiler's start and stop are left
out, with that time."""

from gpu_bench.counts.clip_flops import train_step
from gpu_bench.harness.peaks import MFU_PEAK_FLOPS


def read(r):
    d = r.driver
    h0, h1 = r.trace.overhead
    w, rank = r.ctx.config["widths"], r.ctx.config["lora"]["r"]
    per_batch = [train_step(w, lengths, d.tr["batch"], rank) for lengths in d.lengths]
    kept = [i for i, (s, e) in enumerate(d.step_spans) if e < h0 or s > h1]
    if not kept:
        return None
    flops = sum(per_batch[(d.first_steps + i) % len(per_batch)] for i in kept)
    return 100.0 * flops / (d.window_s - (h1 - h0)) / MFU_PEAK_FLOPS
