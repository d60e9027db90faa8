"""LoRA fine-tuning orchestration: the ``train()`` entry point (port of
``train/trainer.py``).

The reference's recipe (ref:scripts/train_lora.py:111-249): seed 42,
AdamW (lr 1e-4, wd 0.01) over the adapter only, warmup ratio 0.1 with linear
decay, clip 1.0, symmetric InfoNCE at temperature 0.07, the running loss
logged every ``logging_steps`` steps, a validation loss and the adapter
(``output_dir/epoch_{k}``, native and PEFT) after every epoch; plus resume
from the last checkpoint. It runs on one device, the card unless
``device="cpu"``; the JAX package's data-parallel branch is not ported.

The augmenter draws one stream across the epochs, as the JAX trainer's
does. An epoch reads exactly its ``steps_per_epoch`` batches (the prefetch
thread augments no image past ``max_steps_per_epoch``), and the checkpoint
keeps the stream's state, so a resumed run is bit-equal to an uninterrupted
one. ``chain_steps`` is read and has no effect: every batch takes one call
of the single step, the trajectory ``make_chained_train_step`` gives.
"""

from __future__ import annotations

import itertools
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from clip_lora_match_tpu_torch.core.config import (
    ClipArchConfig,
    LoraConfig,
    PreprocessConfig,
    TrainingConfig,
    load_lora_config,
)
from clip_lora_match_tpu_torch.core.device import resolve_device
from clip_lora_match_tpu_torch.core.logging import MetricsWriter, get_logger
from clip_lora_match_tpu_torch.data.dataset import ClipPairDataset, batch_iterator, prefetch
from clip_lora_match_tpu_torch.lora.adapter import init_lora, save_lora
from clip_lora_match_tpu_torch.lora.peft_io import save_peft_adapter
from clip_lora_match_tpu_torch.models.clip import init_params
from clip_lora_match_tpu_torch.models.io import load_params, tree_map
from clip_lora_match_tpu_torch.nn.layers import set_kernel_flags
from clip_lora_match_tpu_torch.preprocess.augment import ImageAugmenter
from clip_lora_match_tpu_torch.tokenizer import ClipTokenizer
from clip_lora_match_tpu_torch.train.checkpoint import CheckpointManager
from clip_lora_match_tpu_torch.train.step import (
    init_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from clip_lora_match_tpu_torch.utils.seeding import set_seed

log = get_logger("train")


@dataclass
class TrainResult:
    train_losses: list[float] = field(default_factory=list)
    val_losses: list[float] = field(default_factory=list)
    steps: int = 0
    epochs: int = 0
    output_dir: str = ""
    final_lora: Optional[dict] = None  # CPU tensors


def train(
    config_path: Optional[str] = None,
    lora_cfg: Optional[LoraConfig] = None,
    train_cfg: Optional[TrainingConfig] = None,
    arch: Optional[ClipArchConfig] = None,
    params: Optional[dict] = None,
    weights_path: Optional[str] = None,
    tokenizer: Optional[ClipTokenizer] = None,
    max_steps_per_epoch: Optional[int] = None,
    metrics_path: Optional[str] = None,
    device: str | torch.device = "cuda",
) -> TrainResult:
    """Run the LoRA fine-tune. Programmatic arguments override the YAML.
    Without ``params`` or a ``weights_path`` that exists, the base is drawn
    at random from the training seed (``models.clip.init_params``)."""
    dev = resolve_device(device)
    if lora_cfg is None or train_cfg is None:
        file_lora, file_train = load_lora_config(config_path)
        lora_cfg = lora_cfg or file_lora
        train_cfg = train_cfg or file_train
    arch = arch or ClipArchConfig()
    tokenizer = tokenizer or ClipTokenizer.from_dir(None, arch.max_text_length)
    set_seed(train_cfg.seed)  # ref:train_lora.py:116

    if params is None:
        if weights_path and os.path.exists(weights_path):
            params = load_params(weights_path, device=dev)
        else:
            log.warning("no base weights; random-initializing CLIP (seed=%d)", train_cfg.seed)
            params = init_params(train_cfg.seed, arch, device=dev)

    pre = PreprocessConfig(image_size=arch.image_size, max_text_length=arch.max_text_length)
    # the uint8 feed, normalized on the device with the CLIP constants the
    # step uses (the same numbers as the float feed at a quarter of the bytes)
    u8_feed = tuple(pre.mean) == tuple(PreprocessConfig().mean) and tuple(pre.std) == tuple(
        PreprocessConfig().std
    )
    train_ds = ClipPairDataset(
        train_cfg.train_csv, tokenizer, pre, image_root=train_cfg.image_root_dir,
        augmenter=ImageAugmenter(seed=train_cfg.seed), uint8_pixels=u8_feed,
    )
    val_ds = None
    if train_cfg.val_csv and os.path.exists(train_cfg.val_csv):
        val_ds = ClipPairDataset(
            train_cfg.val_csv, tokenizer, pre, image_root=train_cfg.image_root_dir,
            augment=False, uint8_pixels=u8_feed,
        )
    steps_per_epoch = len(train_ds) // train_cfg.batch_size
    if max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, max_steps_per_epoch)
    total_steps = max(1, steps_per_epoch * train_cfg.num_epochs)

    tx, _ = make_optimizer(train_cfg, total_steps)
    lora = init_lora(train_cfg.seed, arch, lora_cfg, device=dev)
    # training runs the plain products, as in the JAX trainer: the kernels'
    # backward passes recompute through plain products, so they would make
    # a step slower; an encoder built earlier in this process may have set
    # the flags, and they come back in the finally below
    prev_flags = set_kernel_flags(fused_lora=False, flash_attention=False, small_attention=False)
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        log.info("%d devices visible; training runs on %s alone", torch.cuda.device_count(), dev)

    state = init_train_state(lora, tx, seed=train_cfg.seed)
    step_kw = dict(eot_id=tokenizer.eot_id, remat=train_cfg.remat, unroll=train_cfg.scan_unroll)
    train_step = make_train_step(params, arch, lora_cfg, train_cfg, tx, **step_kw)
    eval_step = make_eval_step(params, arch, lora_cfg, train_cfg, eot_id=tokenizer.eot_id)

    seq_slice = train_cfg.text_seq_slice or 0
    eot_id = tokenizer.eot_id

    def slice_batch(b):
        """Drop the trailing text columns that are padding in every row, down
        to ``text_seq_slice``: exact under the causal mask (a trailing pad
        reaches no earlier position nor the EOT pooling)."""
        ids, mask = b["input_ids"], b["attention_mask"]
        if (
            seq_slice
            and ids.shape[1] > seq_slice
            and not mask[:, seq_slice:].any()
            and (ids[:, :seq_slice] == eot_id).any(axis=1).all()
        ):
            b = dict(b, input_ids=ids[:, :seq_slice], attention_mask=mask[:, :seq_slice])
        return b

    os.makedirs(train_cfg.output_dir, exist_ok=True)
    metrics = MetricsWriter(metrics_path or os.path.join(train_cfg.output_dir, "training_metrics.jsonl"))
    ckpt = CheckpointManager(os.path.join(train_cfg.output_dir, "checkpoints"))
    start_epoch = 0
    if train_cfg.resume:
        restored = ckpt.restore(state, augmenter=train_ds.augmenter)
        if restored is not None:
            state, start_epoch = restored

    result = TrainResult(output_dir=train_cfg.output_dir)
    try:
        _run_epochs(
            result, state, train_step, eval_step, train_ds, val_ds, train_cfg, lora_cfg,
            steps_per_epoch, metrics, ckpt, start_epoch, time.time(), slice_batch,
        )
    finally:
        set_kernel_flags(**prev_flags)
        ckpt.close()
        metrics.close()
    return result


def _run_epochs(
    result, state, train_step, eval_step, train_ds, val_ds, train_cfg, lora_cfg,
    steps_per_epoch, metrics, ckpt, start_epoch, t0, slice_batch,
):
    for epoch in range(start_epoch, train_cfg.num_epochs):
        # exactly this epoch's batches: the prefetch thread draws no
        # augmentation past the cut, so the stream at the epoch's end is
        # what the checkpoint keeps
        it = prefetch(itertools.islice(batch_iterator(
            train_ds, train_cfg.batch_size, shuffle=True, seed=train_cfg.seed, epoch=epoch,
        ), steps_per_epoch))
        # losses stay device tensors in the loop (reading one waits for the
        # device); they are read at the logging cadence
        pending: list = []
        for i, batch in enumerate(it, start=1):
            state, m = train_step(state, slice_batch(batch))
            pending.append(m["loss"])
            result.steps += 1
            # the running-loss cadence (ref:train_lora.py:204-211)
            if result.steps % train_cfg.logging_steps == 0:
                losses = torch.stack(pending).tolist()
                result.train_losses.extend(losses)
                log.info(
                    "epoch %d step %d/%d loss %.4f (run avg %.4f) %.1f s",
                    epoch + 1, i, steps_per_epoch, losses[-1], float(np.mean(losses)), time.time() - t0,
                )
                metrics.write(
                    "train_step", epoch=epoch + 1, step=result.steps, loss=losses[-1],
                    grad_norm=float(m["grad_norm"]),
                )
                pending = []
        if pending:
            result.train_losses.extend(torch.stack(pending).tolist())

        # per-epoch validation loss (ref:train_lora.py:214-241)
        if val_ds is not None and len(val_ds) < train_cfg.batch_size:
            log.warning(
                "val set (%d rows) smaller than batch_size %d; skipping per-epoch validation "
                "(drop-last batching needs one full batch)", len(val_ds), train_cfg.batch_size,
            )
        if val_ds is not None and len(val_ds) >= train_cfg.batch_size:
            vlosses = [
                float(eval_step(state.lora, b))
                for b in batch_iterator(val_ds, train_cfg.batch_size, shuffle=False)
            ]
            vloss = float(np.mean(vlosses)) if vlosses else float("nan")
            result.val_losses.append(vloss)
            log.info("epoch %d val loss %.4f", epoch + 1, vloss)
            metrics.write("val", epoch=epoch + 1, loss=vloss)

        # per-epoch adapter directories, the reference's epoch_{k} naming
        epoch_dir = os.path.join(train_cfg.output_dir, f"epoch_{epoch + 1}")
        save_lora(epoch_dir, state.lora, lora_cfg)
        save_peft_adapter(epoch_dir, state.lora, lora_cfg)
        ckpt.save(int(state.step), state, epoch + 1, augmenter=train_ds.augmenter)
        result.epochs = epoch + 1

    result.final_lora = tree_map(lambda t: t.detach().cpu(), state.lora)
