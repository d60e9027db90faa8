"""The image tower's share of the card's peak: the images of every batch of
the window, counted through the LoRA image tower (``counts/clip_flops.py``),
over the window's wall time, at 989 TFLOP/s (dense bf16). Batches that
overlap the profiler's start and stop are left out, with that time."""

from gpu_bench.counts.clip_flops import image_tower
from gpu_bench.harness.peaks import MFU_PEAK_FLOPS
from gpu_bench.harness.spans import outside_profile


def read(r):
    d = r.driver
    kept = [sp for sp in outside_profile(d.spans, r.trace) if sp[2]]
    if not kept:
        return None
    seconds = d.window_s - (r.trace.overhead[1] - r.trace.overhead[0])
    flops = len(kept) * d.tr["batch"] * image_tower(r.ctx.config["widths"], r.ctx.config["lora"]["r"])
    return 100.0 * flops / seconds / MFU_PEAK_FLOPS
