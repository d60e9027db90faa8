"""Contrastive (InfoNCE) losses (port of ``train/loss.py``).

The reference's ``compute_clip_contrastive_loss`` (ref:scripts/
train_lora.py:83-108): L2-normalize both feature sets, logits =
(img @ txt.T) / temperature in fp32, symmetric cross-entropy against the
diagonal. Under a data mesh the negatives span the global batch:
``clip_contrastive_loss_sharded`` is one rank's share of that loss.
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


def clip_contrastive_loss_sharded(
    image_features: torch.Tensor, text_features: torch.Tensor, mesh, temperature: float = 0.07
) -> torch.Tensor:
    """This rank's share of the global-batch InfoNCE, whose sum over the
    ranks is ``clip_contrastive_loss`` of the global batch (B rows, b a
    rank): the features are gathered from every rank (differentiably: the
    backward sums each rank's gradient into the rows it came from), and
    this rank takes its rows of the global logits, its images against every
    text and its texts against every image, divided by the global B. So the
    gradients summed over the ranks are the single-process gradients at the
    global batch, each counted once."""
    from clip_lora_match_tpu_torch.parallel.mesh import gather_rows

    img = l2_normalize(image_features).float()
    txt = l2_normalize(text_features).float()
    img_all, txt_all = gather_rows(mesh, img), gather_rows(mesh, txt)
    b, B = img.shape[0], img_all.shape[0]
    target = torch.arange(mesh.rank * b, (mesh.rank + 1) * b, device=img.device)[:, None]
    rows = torch.log_softmax((img @ txt_all.t()) / temperature, dim=-1).gather(1, target)
    cols = torch.log_softmax((txt @ img_all.t()) / temperature, dim=-1).gather(1, target)
    return -0.5 * (rows.sum() + cols.sum()) / B
