"""Plain contrastive LoRA steps: both towers (``reference.clip``), symmetric
InfoNCE at a fixed temperature over L2-normalized features, the gradient of
the LoRA leaves alone, clipping to a global norm, AdamW (bias-corrected
moments, eps outside the square root, decoupled weight decay on every leaf)
at a linear warm-up then linear decay, whose first step has rate 0.

``half_batch=True`` is a planted fault: the loss is the mean over the first
half of the rows alone. Imports nothing of the port.
"""

from __future__ import annotations

import torch

from gpu_bench.reference import clip
from gpu_bench.reference.clip import precision


def leaves(tree, path=()):
    """[(path, tensor)] of a nested dict, in key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(leaves(tree[k], path + (k,)))
        return out
    return [(path, tree)]


def _unflatten(pairs):
    tree: dict = {}
    for path, t in pairs:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return tree


def learning_rate(count: int, base: float, total: int, warmup_ratio: float) -> float:
    warmup = max(1, int(total * warmup_ratio))
    if count < warmup:
        return base * count / warmup
    decay = max(1, total - warmup)
    return base * (1.0 - min(count - warmup, decay) / decay)


def contrastive_loss(img, txt, temperature: float):
    img, txt = clip.unit(img), clip.unit(txt)
    logits = img @ txt.t() / temperature
    target = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (torch.nn.functional.cross_entropy(logits, target)
                  + torch.nn.functional.cross_entropy(logits.t(), target))


def steps(params, lora, batches, w: dict, opt: dict, eot: int, tf32: bool = False,
          half_batch: bool = False) -> dict:
    """Run ``len(batches)`` steps from ``lora``. Each batch is (uint8 pixels
    (B, H, W, 3), ids (B, 77)) on the device. → {"losses": [...],
    "first_grad": [(path, clipped gradient of step 1)], "lora": [(path,
    final leaf)]}."""
    mean = torch.tensor((0.48145466, 0.4578275, 0.40821073), device=batches[0][0].device)
    std = torch.tensor((0.26862954, 0.26130258, 0.27577711), device=batches[0][0].device)
    pairs = [(p, t.detach().clone()) for p, t in leaves(lora)]
    mu = [torch.zeros_like(t) for _, t in pairs]
    nu = [torch.zeros_like(t) for _, t in pairs]
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses, first = [], None
    with precision(tf32):
        for step, (u8, ids) in enumerate(batches):
            if half_batch:
                u8, ids = u8[: u8.shape[0] // 2], ids[: ids.shape[0] // 2]
            live = [t.clone().requires_grad_(True) for _, t in pairs]
            tree = _unflatten([(p, t) for (p, _), t in zip(pairs, live)])
            pix = (u8.float() / 255.0 - mean) / std
            img = clip.image_features(params, tree, pix, w, opt["scaling"])
            txt = clip.text_features(params, tree, ids, w, eot, opt["scaling"])
            loss = contrastive_loss(img, txt, opt["temperature"])
            grads = torch.autograd.grad(loss, live)
            losses.append(float(loss.detach()))
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            if float(norm) >= opt["max_grad_norm"]:
                grads = [g / norm * opt["max_grad_norm"] for g in grads]
            if first is None:
                first = [(p, g.detach().clone()) for (p, _), g in zip(pairs, grads)]
            lr = learning_rate(step, opt["learning_rate"], opt["total_steps"], opt["warmup_ratio"])
            c = step + 1
            new = []
            for i, ((p, t), g) in enumerate(zip(pairs, grads)):
                mu[i] = (1 - b1) * g + b1 * mu[i]
                nu[i] = (1 - b2) * g.square() + b2 * nu[i]
                u = (mu[i] / (1 - b1 ** c)) / (torch.sqrt(nu[i] / (1 - b2 ** c)) + eps)
                new.append((p, t - lr * (u + opt["weight_decay"] * t)))
            pairs = new
    return {"losses": losses, "first_grad": first, "lora": pairs}
