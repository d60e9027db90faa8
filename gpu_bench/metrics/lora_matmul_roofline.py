"""Share of its roofline of ``lora_matmul`` in the image tower. Each image
batch begins with one upload of its pixels, so the device intervals from
one host-to-device copy to the next inside the profiled sub-window are whole
batches: over them, the least time of the tower's adapted attention
projections (q/k/v over one read of their input, and out_proj, bf16, at M =
images x tokens rows; ``counts/kernels.py``) over the device time of the
``lora_matmul`` kernels that ran inside them."""

from gpu_bench.counts.clip_flops import image_tokens
from gpu_bench.counts.kernels import lora_tower_bound_s
from gpu_bench.harness import trace as tracing


def read(r):
    batches = tracing.between_copies(r.trace)
    launches = tracing.kernels(r.trace, ("lora_matmul",))
    inside = [k for k in launches if any(s <= k.start < e for s, e in batches)]
    if not batches or not inside:
        return None
    w = r.ctx.config["widths"]
    M = r.driver.tr["batch"] * image_tokens(w)
    bound = lora_tower_bound_s(M, w["vision_width"], w["vision_layers"], r.ctx.config["lora"]["r"])
    return 100.0 * bound * len(batches) / sum(k.end - k.start for k in inside)
