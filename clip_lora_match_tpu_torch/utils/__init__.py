from clip_lora_match_tpu_torch.utils.seeding import set_seed
from clip_lora_match_tpu_torch.utils.tree import tree_bytes, tree_size

__all__ = ["set_seed", "tree_size", "tree_bytes"]
