"""LoRA train and eval steps (port of ``train/step.py``).

The reference's per-step loop (ref:scripts/train_lora.py:170-211): forward
both towers, symmetric InfoNCE, backward, clip the global norm to 1.0,
AdamW, warmup then linear decay. Only the LoRA tree is differentiated; the
base parameters take no gradient and are never written.

The optimizer is optax's chain written out in plain PyTorch (``init`` /
``update`` objects over nested dicts of tensors), in its order and with its
counters, so that a run follows the JAX package's trajectory:

- ``warmup_linear_schedule``: optax's ``join_schedules`` of two
  ``linear_schedule``s, evaluated in float32 at the count *before* the
  increment, so the first update has learning rate 0
  (``warmup_cosine_decay_schedule``, the YOLOv8 trainer's, likewise);
- ``ClipByGlobalNorm``: ``t`` if the global norm is below the limit, else
  ``(t / norm) * limit``;
- ``AdamW``: optax's ``adamw``: ``scale_by_adam`` (bias-corrected moments,
  eps outside the square root), then ``add_decayed_weights`` over every
  leaf, then the step size ``-lr``;
- ``MultiSteps``: gradient accumulation as ``optax.MultiSteps``: the running
  mean of k micro-gradients goes through the inner chain once per window
  (so clipping sees the mean and the schedule ticks once per window); in
  between the parameters stay as they are.

``make_chained_train_step`` runs K single steps a call over (K, B, ...)
batches: the same trajectory as K calls of the single step (PyTorch runs
eagerly, so chaining saves no dispatch here; it keeps the JAX package's
interface and its per-step ``losses`` / ``grad_norms`` vectors). TF32 is not
enabled anywhere: with ``compute_dtype`` None training runs in fp32.

Under a data mesh (``parallel.mesh``; the JAX package's GSPMD step over a
sharded batch) a step takes this rank's rows of the global batch
(``shard_batch``): each rank runs its rows through the towers, takes its
share of the global-batch InfoNCE (``clip_contrastive_loss_sharded``), and
the LoRA gradients are summed over the ranks (one all-reduce); clipping,
``MultiSteps`` and the logged ``grad_norm`` see the summed gradient, the
logged loss is the global one, and AdamW runs the same on every rank. The
dropout masks of rank r come from the (2r, 2r+1)th of 2n seeds drawn from
the shared generator: per-rank masks, the generator the same everywhere.

The model axes (``parallel/tp.py``, ``sp.py``, ``pp.py``) come in through
``transformer_fn``, the executor of both towers' layer stacks, and the
mesh's other axes; the state built by ``init_sharded_train_state`` carries
the LoRA leaves' splits (``TrainState.specs``). InfoNCE's feature all-gather
and the loss's sum run over the data axis alone: the model, seq and stage
ranks of one data rank hold the same features. A gradient is summed over
every axis whose ranks each hold a part of it: the data axis (other rows),
the seq axis (other tokens) and, for a leaf the model axis does not split,
the model axis (a replicated LoRA factor, a column-parallel ``a`` or a
row-parallel ``b``, sees only this rank's heads or hidden units); never
over the stage axis, whose ranks hold other layers. The global norm that
clipping and the ``grad_norm`` metric read sums the squares of a split leaf
over its axis and counts a replicated leaf once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from clip_lora_match_tpu_torch.core.config import (
    CLIP_IMAGE_MEAN,
    CLIP_IMAGE_STD,
    ClipArchConfig,
    LoraConfig,
    TrainingConfig,
)
from clip_lora_match_tpu_torch.core.profiling import annotate
from clip_lora_match_tpu_torch.models import clip as clip_model
from clip_lora_match_tpu_torch.models.io import tree_leaves, tree_map, unflatten
from clip_lora_match_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS, STAGE_AXIS, all_reduce_sum
from clip_lora_match_tpu_torch.train.loss import clip_contrastive_loss, clip_contrastive_loss_sharded

Params = dict[str, Any]


@dataclass
class TrainState:
    """``lora``: fp32 tensors on the training device; ``opt_state``: the
    optimizer's nested dicts (tensors and int counters); ``step``: optimizer
    calls so far; ``generator``: the CPU generator the dropout seeds are
    drawn from; ``specs``: the LoRA leaves' splits over the mesh
    (``parallel.mesh.Split`` or None, a tree like ``lora``), None where every
    leaf is whole. A step returns a new state and leaves its input as it was."""

    lora: Params
    opt_state: Any
    step: int
    generator: torch.Generator
    specs: Any = None


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, an fp32 0-dim tensor."""
    return torch.sqrt(sum(t.float().square().sum() for _, t in tree_leaves(tree)))


def _scalar(value, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim tensor on ``like``'s device: dividing by it is a true division
    on every device (CUDA divides by a Python scalar as a product with its
    reciprocal)."""
    return torch.full((), float(value), dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# schedule and optimizer
# ---------------------------------------------------------------------------


def _linear_schedule(init: float, end: float, steps: int) -> Callable[[int], np.float32]:
    """optax.linear_schedule in float32."""
    if steps <= 0:
        return lambda count: np.float32(init)

    def schedule(count: int) -> np.float32:
        c = min(max(int(count), 0), steps)
        frac = np.float32(1) - np.float32(c) / np.float32(steps)
        return np.float32(init - end) * frac + np.float32(end)

    return schedule


def warmup_linear_schedule(
    base_lr: float, total_steps: int, warmup_ratio: float = 0.1
) -> Callable[[int], np.float32]:
    """Linear warmup from 0 to ``base_lr`` over max(1, total·ratio) steps,
    then linear decay to 0 (ref:train_lora.py:154-166)."""
    warmup = max(1, int(total_steps * warmup_ratio))
    up = _linear_schedule(0.0, base_lr, warmup)
    down = _linear_schedule(base_lr, 0.0, max(1, total_steps - warmup))
    return lambda count: up(count) if count < warmup else down(count - warmup)


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
    end_value: float = 0.0,
) -> Callable[[int], np.float32]:
    """optax.warmup_cosine_decay_schedule (exponent 1) in float32: a linear
    warmup from ``init_value`` to ``peak_value`` over ``warmup_steps``, then
    a cosine decay to ``end_value`` at ``decay_steps`` (the warmup counted
    in), flat after it. The YOLOv8 trainer's schedule."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup_steps {warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    up = _linear_schedule(init_value, peak_value, warmup_steps)
    T = np.float32(decay_steps - warmup_steps)

    def down(count: int) -> np.float32:
        c = np.minimum(np.float32(count), T)
        cosine = np.float32(0.5) * (np.float32(1) + np.cos(np.float32(np.pi) * c / T))
        return np.float32(peak_value) * (np.float32(1 - alpha) * cosine + np.float32(alpha))

    return lambda count: up(count) if count < warmup_steps else down(count - warmup_steps)


class ClipByGlobalNorm:
    def __init__(self, max_norm: float):
        self.max_norm = float(max_norm)

    def init(self, params) -> dict:
        return {}

    def update(self, grads, state, params=None, norm=global_norm):
        norm = norm(grads)
        keep = norm < self.max_norm
        return tree_map(lambda t: torch.where(keep, t, t / norm * self.max_norm), grads), state


class AdamW:
    """optax.adamw(learning_rate, b1, b2, eps, weight_decay): state
    ``count`` (Adam's), ``mu``, ``nu`` and ``schedule_count`` (the step size
    schedule's)."""

    def __init__(self, learning_rate, weight_decay: float = 1e-4, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr = learning_rate if callable(learning_rate) else (lambda count: np.float32(learning_rate))
        self.wd, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps

    def init(self, params) -> dict:
        zeros = lambda t: torch.zeros_like(t, dtype=torch.float32)  # noqa: E731
        return {"count": 0, "mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
                "schedule_count": 0}

    def update(self, grads, state, params, norm=global_norm):
        b1, b2 = self.b1, self.b2
        count = state["count"] + 1
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
        nu = tree_map(lambda g, v: (1 - b2) * g.square() + b2 * v, grads, state["nu"])
        bc1 = np.float32(1) - np.float32(b1) ** np.float32(count)
        bc2 = np.float32(1) - np.float32(b2) ** np.float32(count)
        step_size = -float(self.lr(state["schedule_count"]))

        def direction(m, v, p):
            u = (m / _scalar(bc1, m)) / (torch.sqrt(v / _scalar(bc2, v)) + self.eps)
            return step_size * (u + self.wd * p)

        updates = tree_map(direction, mu, nu, params)
        return updates, {"count": count, "mu": mu, "nu": nu,
                         "schedule_count": state["schedule_count"] + 1}


class Chain:
    def __init__(self, *transforms):
        self.transforms = transforms

    def init(self, params) -> list:
        return [t.init(params) for t in self.transforms]

    def update(self, grads, state, params, norm=global_norm):
        new = []
        for t, s in zip(self.transforms, state):
            grads, s = t.update(grads, s, params, norm=norm)
            new.append(s)
        return grads, new


class MultiSteps:
    """optax.MultiSteps(inner, every_k) with the mean of the micro-gradients
    (Welford form ``acc + (g - acc) / (n + 1)``). Between windows the
    update is None: the parameters stay as they are (optax's zero update),
    and the inner chain, whose result optax drops there, is not run."""

    def __init__(self, inner, every_k: int):
        self.inner, self.k = inner, int(every_k)

    def init(self, params) -> dict:
        return {"mini_step": 0, "gradient_step": 0, "inner": self.inner.init(params),
                "acc": tree_map(lambda t: torch.zeros_like(t, dtype=torch.float32), params)}

    def update(self, grads, state, params, norm=global_norm):
        n = state["mini_step"]
        acc = tree_map(lambda g, a: a + (g - a) / _scalar(n + 1, a), grads, state["acc"])
        if n != self.k - 1:
            return None, {**state, "mini_step": n + 1, "acc": acc}
        updates, inner = self.inner.update(acc, state["inner"], params, norm=norm)
        return updates, {"mini_step": 0, "gradient_step": state["gradient_step"] + 1,
                         "inner": inner, "acc": tree_map(torch.zeros_like, acc)}


def make_optimizer(cfg: TrainingConfig, total_steps: int):
    """(tx, schedule): clip-by-global-norm then AdamW (adapter leaves only),
    with the warmup/linear-decay schedule, wrapped in ``MultiSteps`` when
    ``gradient_accumulation_steps`` > 1. ``total_steps`` counts micro-batches;
    the schedule ticks once per accumulation window, so its horizon is
    total_steps // accumulation (ref:train_lora.py:156)."""
    accum = max(1, cfg.gradient_accumulation_steps)
    sched = warmup_linear_schedule(cfg.learning_rate, max(1, total_steps // accum), cfg.warmup_ratio)
    tx = Chain(ClipByGlobalNorm(cfg.max_grad_norm), AdamW(sched, weight_decay=cfg.weight_decay))
    if cfg.gradient_accumulation_steps > 1:
        tx = MultiSteps(tx, cfg.gradient_accumulation_steps)
    return tx, sched


def apply_updates(params, updates):
    """optax.apply_updates: p + u in p's dtype; None leaves p as it is."""
    if updates is None:
        return params
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

_PIX_NORM: dict = {}


def _pixel_norm(device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(255, mean, std) as fp32 tensors on ``device``, made once a device."""
    key = str(device)
    if key not in _PIX_NORM:
        _PIX_NORM[key] = tuple(
            torch.tensor(v, dtype=torch.float32).to(device)
            for v in (255.0, CLIP_IMAGE_MEAN, CLIP_IMAGE_STD)
        )
    return _PIX_NORM[key]


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """numpy arrays or tensors → tensors on ``device``; to a card through
    pinned memory without blocking the host."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t.to(device)
    return out


def tree_device(tree) -> torch.device:
    """The device of ``tree``'s first leaf."""
    return tree_leaves(tree)[0][1].device


def tower_features(params, lora, batch, arch, lora_cfg, eot_id, compute_dtype, remat,
                    generator: Optional[torch.Generator] = None, mesh=None, transformer_fn=None):
    """Both towers' features; LoRA dropout iff a generator is given (under
    ``mesh``, this data rank's pair of the data ranks' seeds);
    ``transformer_fn`` runs both towers' layer stacks. uint8
    ``pixel_values`` (resized and cropped, not normalized) are normalized on
    the device in the JAX package's order: fp32, / 255, - mean, / std."""
    pix = batch["pixel_values"]
    if pix.dtype == torch.uint8:
        scale, mean, std = _pixel_norm(pix.device)
        pix = (pix.to(torch.float32) / scale - mean) / std
    rate = lora_cfg.dropout if generator is not None else 0.0
    gens = (None, None)
    if generator is not None:
        n, r = (1, 0) if mesh is None else (mesh.n_data, mesh.rank)
        seeds = torch.randint(0, 2 ** 62, (2 * n,), generator=generator).tolist()
        gens = tuple(torch.Generator().manual_seed(s) for s in seeds[2 * r:2 * r + 2])
    kw = dict(lora=lora, lora_scaling=lora_cfg.scaling, compute_dtype=compute_dtype,
              remat=remat, lora_dropout=rate, transformer_fn=transformer_fn)
    img = clip_model.encode_image_features(params, pix, arch, generator=gens[0], **kw)
    txt = clip_model.encode_text_features(
        params, batch["input_ids"], arch, attention_mask=batch.get("attention_mask"),
        eot_id=eot_id, generator=gens[1], **kw,
    )
    return img, txt


def _loss(img, txt, temperature: float, mesh) -> torch.Tensor:
    if mesh is None or mesh.n_data == 1:
        return clip_contrastive_loss(img, txt, temperature)
    return clip_contrastive_loss_sharded(img, txt, mesh, temperature)


def _sum_over_ranks(mesh, tensors, axis: str) -> list:
    """Every ``axis`` rank's tensors summed, in one all-reduce of their
    concatenation."""
    flat = all_reduce_sum(mesh, torch.cat([t.reshape(-1) for t in tensors]), axis)
    return [f.view_as(t) for f, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def _split_of(specs, paths) -> list:
    """Each path's ``Split`` (None: whole) under ``specs``."""
    if specs is None:
        return [None] * len(paths)
    table = dict(tree_leaves(specs))
    return [table[p] for p in paths]


def _reduce(mesh, loss, raw: list, splits: list) -> tuple:
    """The global loss and gradients from this rank's (module docstring):
    the loss over the data axis; each gradient over the data and seq axes,
    and over the model axis unless the model axis splits it."""
    if mesh.n_data > 1:
        loss, *raw = _sum_over_ranks(mesh, [loss, *raw], DATA_AXIS)
    for axis in (SEQ_AXIS, MODEL_AXIS):
        if mesh.size(axis) > 1:
            idx = [i for i, sp in enumerate(splits) if sp is None or sp.axis != axis]
            if idx:
                for i, g in zip(idx, _sum_over_ranks(mesh, [raw[i] for i in idx], axis)):
                    raw[i] = g
    return loss, raw


def sharded_global_norm(mesh, specs):
    """The global norm of a gradient tree whose leaves are split by
    ``specs``: a split leaf's squares summed over its axis, a whole leaf's
    counted once. One all-reduce a split axis."""

    def norm(tree) -> torch.Tensor:
        pairs = tree_leaves(tree)
        splits = _split_of(specs, [p for p, _ in pairs])
        whole = sum(t.float().square().sum() for (_, t), sp in zip(pairs, splits) if sp is None)
        for axis in sorted({sp.axis for sp in splits if sp is not None}):
            part = sum(t.float().square().sum() for (_, t), sp in zip(pairs, splits)
                       if sp is not None and sp.axis == axis)
            whole = whole + all_reduce_sum(mesh, part.reshape(1), axis)[0]
        return torch.sqrt(whole)

    return norm


def _clone_generator(gen: torch.Generator) -> torch.Generator:
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out


def make_train_step(
    params: Params,
    arch: ClipArchConfig,
    lora_cfg: LoraConfig,
    train_cfg: TrainingConfig,
    tx,
    eot_id: Optional[int] = None,
    compute_dtype: Optional[torch.dtype] = None,
    remat: bool | str = False,
    unroll: int | bool = True,
    mesh=None,
    transformer_fn=None,
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """``step(state, batch) -> (state, {"loss", "grad_norm"})``: forward,
    InfoNCE, the LoRA gradients by autograd, the optimizer update. The
    metrics are 0-dim device tensors (nothing waits for the device);
    ``grad_norm`` is the norm of this step's raw gradients. ``batch`` holds
    numpy arrays or tensors; they go to the LoRA tree's device. With
    ``mesh`` the batch is this data rank's rows (``parallel.shard_batch``)
    and the step is the global batch's (module docstring);
    ``transformer_fn`` runs both towers' layer stacks (the model axes'
    executors), ``params`` and the state's LoRA tree are then this rank's
    shards. ``step.loss_and_grads(lora, batch, specs)`` gives the global
    loss and gradients (this rank's shard of each) without an update. ``unroll`` is
    accepted and has no effect. A step records the spans ``train.step``,
    ``train.backward`` and ``train.optimizer`` (``core/profiling.py``)."""

    def loss_and_grads(lora_tree, batch, specs=None, generator=None):
        batch = batch_to_device(batch, tree_device(lora_tree))
        pairs = tree_leaves(lora_tree)
        live = [t.detach().requires_grad_(True) for _, t in pairs]
        lora = unflatten({path: t for (path, _), t in zip(pairs, live)})
        img, txt = tower_features(
            params, lora, batch, arch, lora_cfg, eot_id, compute_dtype, remat,
            generator if lora_cfg.dropout > 0 else None, mesh, transformer_fn,
        )
        loss = _loss(img, txt, train_cfg.temperature, mesh)
        with annotate("train.backward"):
            raw = list(torch.autograd.grad(loss, live))
            loss = loss.detach()
            if mesh is not None:
                loss, raw = _reduce(mesh, loss, raw, _split_of(specs, [p for p, _ in pairs]))
        return loss, unflatten({path: g for (path, _), g in zip(pairs, raw)})

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        with annotate("train.step"):
            gen = _clone_generator(state.generator)
            split = mesh is not None and (mesh.size(MODEL_AXIS) > 1 or mesh.size(STAGE_AXIS) > 1)
            if split and state.specs is None:
                raise ValueError("the model and stage axes split the LoRA tree: build the state with "
                                 "init_tp_train_state / init_pp_train_state (parallel/)")
            loss, grads = loss_and_grads(state.lora, batch, state.specs, gen)
            norm = global_norm if state.specs is None else sharded_global_norm(mesh, state.specs)
            with annotate("train.optimizer"):
                updates, opt_state = tx.update(grads, state.opt_state, state.lora, norm=norm)
                new = TrainState(apply_updates(state.lora, updates), opt_state, state.step + 1, gen,
                                 state.specs)
                grad_norm = norm(grads)
            return new, {"loss": loss, "grad_norm": grad_norm}

    step.loss_and_grads = loss_and_grads
    return step


def make_chained_train_step(
    params: Params,
    arch: ClipArchConfig,
    lora_cfg: LoraConfig,
    train_cfg: TrainingConfig,
    tx,
    chain: int,
    eot_id: Optional[int] = None,
    compute_dtype: Optional[torch.dtype] = None,
    remat: bool | str = False,
    unroll: int | bool = True,
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """K = ``chain`` optimizer steps a call over batches stacked (K, B, ...):
    the single step K times. Returns the mean loss, the last grad norm and
    the per-step ``losses`` / ``grad_norms`` vectors."""
    single = make_train_step(params, arch, lora_cfg, train_cfg, tx, eot_id=eot_id,
                             compute_dtype=compute_dtype, remat=remat)

    def step(state: TrainState, batches: dict) -> tuple[TrainState, dict]:
        losses, norms = [], []
        for i in range(chain):
            state, m = single(state, {k: v[i] for k, v in batches.items()})
            losses.append(m["loss"])
            norms.append(m["grad_norm"])
        losses, norms = torch.stack(losses), torch.stack(norms)
        return state, {"loss": losses.mean(), "losses": losses, "grad_norm": norms[-1],
                       "grad_norms": norms}

    return step


def make_eval_step(
    params: Params,
    arch: ClipArchConfig,
    lora_cfg: LoraConfig,
    train_cfg: TrainingConfig,
    eot_id: Optional[int] = None,
    compute_dtype: Optional[torch.dtype] = None,
    mesh=None,
) -> Callable[[Params, dict], torch.Tensor]:
    """``step(lora, batch) -> loss``: the validation loss, no dropout, no
    gradients (ref:train_lora.py:214-241); with ``mesh``, of the global
    batch whose rows of this rank ``batch`` holds."""

    def step(lora: Params, batch: dict) -> torch.Tensor:
        with torch.no_grad():
            batch = batch_to_device(batch, tree_device(lora))
            img, txt = tower_features(params, lora, batch, arch, lora_cfg, eot_id, compute_dtype, False)
            loss = _loss(img, txt, train_cfg.temperature, mesh)
            return loss if mesh is None else all_reduce_sum(mesh, loss)

    return step


def init_train_state(lora: Params, tx, seed: int = 42, rng_impl: Optional[str] = None) -> TrainState:
    """A fresh state: fp32 copies of ``lora``, the optimizer's initial state,
    step 0, and a CPU generator seeded with ``seed``. ``rng_impl`` (the JAX
    package's PRNG choice) is accepted and has no effect."""
    lora = tree_map(lambda t: t.detach().to(torch.float32).clone(), lora)
    return TrainState(lora=lora, opt_state=tx.init(lora), step=0,
                      generator=torch.Generator().manual_seed(seed))
