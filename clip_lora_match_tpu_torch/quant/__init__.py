from clip_lora_match_tpu_torch.quant.int8 import (
    dequantize_linear_params,
    int8_matmul,
    is_quantized,
    quantize_clip_params,
    quantize_linear_params,
)

__all__ = [
    "dequantize_linear_params",
    "int8_matmul",
    "is_quantized",
    "quantize_clip_params",
    "quantize_linear_params",
]
