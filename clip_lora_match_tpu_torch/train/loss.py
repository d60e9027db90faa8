"""Contrastive (InfoNCE) losses (port of ``train/loss.py``).

The reference's ``compute_clip_contrastive_loss`` (ref:scripts/
train_lora.py:83-108): L2-normalize both feature sets, logits =
(img @ txt.T) / temperature in fp32, symmetric cross-entropy against the
diagonal. The port runs on one device, so the negatives are the batch.
"""

from __future__ import annotations

import torch

from clip_lora_match_tpu_torch.models.clip import l2_normalize


def _xent_diagonal(logits: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy with the matched diagonal as the targets."""
    return -torch.log_softmax(logits, dim=-1).diagonal().mean()


def clip_contrastive_loss(
    image_features: torch.Tensor, text_features: torch.Tensor, temperature: float = 0.07
) -> torch.Tensor:
    """Symmetric InfoNCE at a fixed temperature (ref:train_lora.py:83-108)."""
    img = l2_normalize(image_features).float()
    txt = l2_normalize(text_features).float()
    logits = (img @ txt.t()) / temperature
    return 0.5 * (_xent_diagonal(logits) + _xent_diagonal(logits.t()))


def clip_contrastive_loss_learned_scale(
    image_features: torch.Tensor, text_features: torch.Tensor, logit_scale: torch.Tensor
) -> torch.Tensor:
    """The same with CLIP's learned logit scale (exp-parameterized)."""
    img = l2_normalize(image_features).float()
    txt = l2_normalize(text_features).float()
    logits = torch.exp(logit_scale.float()) * (img @ txt.t())
    return 0.5 * (_xent_diagonal(logits) + _xent_diagonal(logits.t()))
