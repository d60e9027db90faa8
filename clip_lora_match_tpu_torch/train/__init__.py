from clip_lora_match_tpu_torch.train.checkpoint import CheckpointManager
from clip_lora_match_tpu_torch.train.loss import (
    clip_contrastive_loss,
    clip_contrastive_loss_learned_scale,
)
from clip_lora_match_tpu_torch.train.step import (
    TrainState,
    init_train_state,
    make_chained_train_step,
    make_eval_step,
    make_optimizer,
    make_train_step,
    warmup_linear_schedule,
)
from clip_lora_match_tpu_torch.train.trainer import TrainResult, train

__all__ = [
    "CheckpointManager",
    "clip_contrastive_loss",
    "clip_contrastive_loss_learned_scale",
    "TrainState",
    "init_train_state",
    "make_chained_train_step",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
    "warmup_linear_schedule",
    "TrainResult",
    "train",
]
