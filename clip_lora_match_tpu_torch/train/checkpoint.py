"""Training checkpoints and resume (port of ``train/checkpoint.py``).

The reference saves per-epoch PEFT adapter directories and cannot resume
(ref:scripts/train_lora.py:243-247). A checkpoint here holds
``{lora, opt_state, step, epoch, generator}`` (the generator's state) and,
when the trainer passes its augmenter, the augmenter's numpy bit-generator
state, so a run restarts where it stopped and draws the images it would
have drawn. It is written with ``torch.save`` as
``<directory>/<step>.pt`` (through a temporary file and a rename), the
newest ``max_to_keep`` are kept. The format is the port's own, not the JAX
package's Orbax one: the adapters cross between the packages through the
per-epoch native and PEFT exports.
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional

import torch

from clip_lora_match_tpu_torch.core.logging import get_logger
from clip_lora_match_tpu_torch.models.io import tree_map
from clip_lora_match_tpu_torch.train.step import TrainState, tree_device

log = get_logger("ckpt")
_NAME = re.compile(r"^(\d+)\.pt$")


def _to(tree, device):
    """Tensor leaves moved to ``device``; the int counters as they are."""
    return tree_map(lambda t: t.to(device) if isinstance(t, torch.Tensor) else t, tree)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m)

    def save(self, step: int, state: TrainState, epoch: int, augmenter=None) -> None:
        payload = {
            "lora": _to(state.lora, "cpu"),
            "opt_state": _to(state.opt_state, "cpu"),
            "step": int(state.step),
            "epoch": int(epoch),
            "generator": state.generator.get_state(),
        }
        if augmenter is not None:  # as JSON: its 128-bit ints are no tensors
            payload["augmenter"] = json.dumps(augmenter.rng.bit_generator.state)
        path = os.path.join(self.directory, f"{step}.pt")
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in self._steps()[:-self.max_to_keep]:
            os.remove(os.path.join(self.directory, f"{old}.pt"))
        log.info("saved checkpoint step=%d epoch=%d", step, epoch)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, template_state: TrainState, augmenter=None) -> Optional[tuple[TrainState, int]]:
        """The newest checkpoint as (state, epoch), its tensors on the
        template's LoRA device; None when there is none. ``augmenter``, when
        given, takes the stream state saved with it."""
        step = self.latest_step()
        if step is None:
            return None
        payload = torch.load(os.path.join(self.directory, f"{step}.pt"), weights_only=True)
        device = tree_device(template_state.lora)
        generator = torch.Generator(device=template_state.generator.device)
        generator.set_state(payload["generator"])
        state = TrainState(
            lora=_to(payload["lora"], device),
            opt_state=_to(payload["opt_state"], device),
            step=int(payload["step"]),
            generator=generator,
        )
        if augmenter is not None and "augmenter" in payload:
            augmenter.rng.bit_generator.state = json.loads(payload["augmenter"])
        log.info("restored checkpoint step=%d epoch=%d", step, payload["epoch"])
        return state, int(payload["epoch"])

    def close(self) -> None:
        """Nothing is held open between calls; kept for the JAX package's
        interface."""

