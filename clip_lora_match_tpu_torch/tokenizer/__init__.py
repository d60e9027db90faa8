from clip_lora_match_tpu_torch.tokenizer.bpe import (
    ClipTokenizer,
    build_fallback_vocab_and_merges,
    bytes_to_unicode,
)

__all__ = ["ClipTokenizer", "build_fallback_vocab_and_merges", "bytes_to_unicode"]
