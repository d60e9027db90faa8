"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

Every wrapper counts the launches of its kernel in a plain integer attribute
``<wrapper>.launches``; ``launch_counts`` reads them and
``reset_launch_counts`` sets them to 0. The submodules keep their names
(``ops.attention_small`` is the module; its wrapper is
``ops.attention_small.attention_small``).
"""

from clip_lora_match_tpu_torch.ops import (
    approx_topk,
    attention_small,
    flash_attention,
    lora_matmul,
    mlp_fused,
    retrieval_topk,
)

KERNEL_WRAPPERS = {
    "attention_small": attention_small.attention_small,
    "lora_matmul": lora_matmul.lora_matmul,
    "topk_retrieve": retrieval_topk.topk_retrieve,
    "tilemax": retrieval_topk.tilemax,
    "tilemax_sup": retrieval_topk.tilemax_sup,
    "tilemax_sup_q8": retrieval_topk.tilemax_sup_q8,
    "mlp_fused": mlp_fused.mlp_fused,
    "flash_attention": flash_attention.flash_attention,
    "approx_topk": approx_topk.approx_topk,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


__all__ = ["KERNEL_WRAPPERS", "launch_counts", "reset_launch_counts"]
