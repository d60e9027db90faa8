from clip_lora_match_tpu_torch.data.dataset import (
    ClipPairDataset,
    batch_iterator,
    prefetch,
    train_val_iterators,
)

__all__ = ["ClipPairDataset", "batch_iterator", "prefetch", "train_val_iterators"]
