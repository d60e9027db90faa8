"""The whole request's share of the card's peak: the requests completed in
the profiled sub-window, each counted as its text at its own token length
through the LoRA text tower plus the 2·N·D products of its search
(``counts/clip_flops.py``), over the device's busy time in the sub-window,
at 989 TFLOP/s (dense bf16)."""

from gpu_bench.counts.clip_flops import text_tower
from gpu_bench.harness import trace as tracing
from gpu_bench.harness.peaks import MFU_PEAK_FLOPS


def read(r):
    d = r.driver
    h0, h1 = r.trace.host_window
    w = r.ctx.config["widths"]
    done = [i for i, t in d.done.items() if h0 <= t <= h1]
    if not done:
        return None
    flops = sum(text_tower(w, d.length(i), r.ctx.config["lora"]["r"]) + 2 * d.N * d.D for i in done)
    return 100.0 * flops / tracing.busy_s(r.trace) / MFU_PEAK_FLOPS
