"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit). Every share of a peak or
of a roofline that the benchmark prints is taken against these numbers."""

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {
    "bf16": 989e12,
    "tf32": 495e12,
    "fp32": 67e12,  # outside the tensor cores
    "int8": 1979e12,
    # fp32 products as three TF32 tensor-core products (hi.hi + hi.lo + lo.hi)
    "3xtf32": 495e12 / 3,
}
# the one peak of every ``mfu`` metric: no precision these cells may use runs
# faster, so no change of precision can push a share past 100%
MFU_PEAK_FLOPS = PEAK_FLOPS["bf16"]


def bound_s(nbytes: float, flops: float, kind: str) -> tuple[float, str]:
    """The least time the card could take for ``nbytes`` of HBM traffic and
    ``flops`` at the ``kind`` peak, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[kind]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
