"""Pipeline parallelism (GPipe) for the stacked CLIP towers (port of
``parallel/pp.py``).

The towers' parameters are stacked on a leading layer axis, so PP is a
split of that axis: stage s of n holds layers ``[s·L/n, (s+1)·L/n)``
(``shard_clip_pp``). ``make_pipeline_transformer`` runs the GPipe loop over
``M + n - 1`` ticks, one process a stage. At tick t, microbatch
``u = clip(t - stage, 0, M - 1)`` enters stage 0, every stage runs its
layers on its current microbatch, the last stage banks tick ``t - (n - 1)``
when it is one, and ``ppermute`` hands each activation to the next stage.
The last stage's outputs reach every stage through ``gather_axis`` (the
JAX package's ``all_gather(...)[n - 1]``).

The backward is derived, not scheduled: autograd runs the tick loop in
reverse through ``ppermute``'s reverse shift, as JAX's AD transposes its
scan. For that, every rank builds one graph: each stage computes every tick
(bubbles included), its input chosen by ``torch.where`` rather than by a
branch, and banks by ``torch.where`` too, so the ranks meet the same
collectives in the same order forward and backward. The fill's last
``ppermute`` is left out on every rank, as its result is never read.

A ``seq`` axis on the mesh (``make_pp_mesh(n_seq=...)``) composes dp×pp×sp:
each microbatch's tokens split over it and every stage's attention runs as
the ring (``parallel/sp.py``), the sequence padded as SP pads it.

The bubble is ``(n-1)/(M+n-1)``. At ViT-B/32's 12 layers PP is not needed:
it exists so that the towers scale to depths where it is. LoRA dropout is
not supported inside the pipeline. Each stage is a single-device program:
its layers run the kernels its flags pick.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from clip_lora_match_tpu_torch.models.io import tree_leaves, unflatten
from clip_lora_match_tpu_torch.nn.layers import transformer
from clip_lora_match_tpu_torch.parallel.distributed import process_count
from clip_lora_match_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SEQ_AXIS,
    STAGE_AXIS,
    Mesh,
    Split,
    build_mesh,
    copy_to,
    gather_axis,
    ppermute,
    replica_grad,
    shard_leaf,
    split_axis,
)
from clip_lora_match_tpu_torch.parallel.tp import refuse_dropout

Params = dict[str, Any]


def make_pp_mesh(n_stage: int, n_data: Optional[int] = None, device: str | torch.device = "cuda",
                 n_seq: Optional[int] = None) -> Mesh:
    """The (data, stage[, seq]) mesh over every rank of the default group,
    the communicating axes minor as in the JAX package; ``n_seq`` adds the
    sequence axis of dp×pp×sp."""
    world = process_count()
    per_data = n_stage * (n_seq or 1)
    if n_data is None:
        n_data = world // per_data
    if n_data < 1 or n_data * per_data != world:
        raise ValueError(f"need {max(n_data, 1)}×{per_data}={max(n_data, 1) * per_data} ranks for the mesh, "
                         f"have {world}: start one rank a device of the mesh")
    axes = ((DATA_AXIS, n_data), (STAGE_AXIS, n_stage)) + (((SEQ_AXIS, n_seq),) if n_seq else ())
    return build_mesh(axes, device)


def clip_pp_pspecs(tree: Params) -> Params:
    """The split of a CLIP parameter or LoRA tree: the stacked blocks' layer
    axis over ``stage``; everything else whole."""
    return unflatten({path: Split(STAGE_AXIS, 0) if "blocks" in path.split("/") else None
                      for path, _ in tree_leaves(tree)})


def shard_clip_pp(tree: Params, mesh: Mesh) -> Params:
    """This rank's stage of the full tree (numpy arrays or tensors), as
    tensors on its device."""
    from clip_lora_match_tpu_torch.models.io import to_device

    specs = dict(tree_leaves(clip_pp_pspecs(tree)))
    return to_device(unflatten({path: shard_leaf(leaf, specs[path], mesh) for path, leaf in tree_leaves(tree)}),
                     mesh.device)


def check_pp_divisibility(arch, n_stage: int) -> None:
    for name, layers in (("vision", arch.vision_layers), ("text", arch.text_layers)):
        if layers % n_stage:
            raise ValueError(f"{name} tower has {layers} layers, not divisible by stage-axis size {n_stage}")


def make_pipeline_transformer(mesh: Mesh, n_microbatches: int):
    """A drop-in for ``nn.layers.transformer`` that runs this rank's stage of
    the blocks (``shard_clip_pp``) in a GPipe pipeline over ``mesh``'s stage
    axis. ``x``: this data rank's rows, which must split into
    ``n_microbatches``; the result is the whole stack's, the same on every
    stage. With a ``seq`` axis every stage's attention is the ring."""
    from clip_lora_match_tpu_torch.parallel.sp import _local_mask, pad_seq_and_mask, ring_core

    n = mesh.size(STAGE_AXIS)
    stage = mesh.index(STAGE_AXIS)
    M = n_microbatches
    seq_mode = SEQ_AXIS in mesh.axis_names

    def pipeline_transformer(blocks, x, num_heads, mask=None, lora_blocks=None, lora_scaling=1.0, eps=1e-5,
                             compute_dtype=None, remat=False, lora_dropout=0.0, generator=None, unroll=1):
        refuse_dropout(lora_dropout, generator, "the pipeline")
        B, S = x.shape[:2]
        if B % M:
            raise ValueError(f"the local batch of {B} rows must split into {M} microbatches")
        pad = 0
        core = None
        if seq_mode:
            x, mask, pad = pad_seq_and_mask(x, mask, mesh.size(SEQ_AXIS))
            x = split_axis(x, mesh, SEQ_AXIS, 1)
            mask = _local_mask(mask, mesh, SEQ_AXIS)
            core = ring_core(mesh)
        # every stage holds x; stage 0 reads it, and the stages' cotangents sum
        mb = copy_to(x, mesh, STAGE_AXIS).reshape(M, B // M, *x.shape[1:])
        batch_mask = mask is not None and mask.shape[0] > 1
        mask_mb = mask.reshape(M, -1, *mask.shape[1:]) if batch_mask else None
        first = torch.tensor(stage == 0, device=x.device)
        state = torch.zeros_like(mb[0])
        outputs = [torch.zeros_like(mb[0]) for _ in range(M)]
        T = M + n - 1
        for t in range(T):
            u = min(max(t - stage, 0), M - 1)
            inp = torch.where(first, mb[u], state)
            out = transformer(blocks, inp, num_heads, mask=mask_mb[u] if batch_mask else mask,
                              lora_blocks=lora_blocks, lora_scaling=lora_scaling, eps=eps,
                              compute_dtype=compute_dtype, remat=remat, core_attn_fn=core)
            o = t - (n - 1)
            slot = min(max(o, 0), M - 1)
            bank = torch.tensor(stage == n - 1 and o >= 0, device=x.device)
            outputs[slot] = torch.where(bank, out, outputs[slot])
            if t < T - 1:
                state = ppermute(out, mesh, STAGE_AXIS, 1)
        # the last stage's outputs on every stage: its block of the gather
        gathered = gather_axis(torch.cat(outputs)[None], mesh, STAGE_AXIS, 0)
        out = replica_grad(gathered, mesh, STAGE_AXIS)[n - 1]
        if seq_mode:
            out = replica_grad(gather_axis(out, mesh, SEQ_AXIS, 1), mesh, SEQ_AXIS)
        return out[:, :S] if pad else out

    return pipeline_transformer


def init_pp_train_state(sharded_lora: Params, tx, seed: int = 42, rng_impl: Optional[str] = None):
    """A train state over this rank's stage of the LoRA tree
    (``shard_clip_pp``), its stage split recorded."""
    from clip_lora_match_tpu_torch.parallel.state import init_sharded_train_state

    return init_sharded_train_state(sharded_lora, tx, clip_pp_pspecs(sharded_lora), seed=seed,
                                    rng_impl=rng_impl)


def make_pp_train_step(params: Params, arch, lora_cfg, train_cfg, tx, mesh: Mesh, n_microbatches: int,
                       eot_id: Optional[int] = None, compute_dtype=None, remat: bool | str = False):
    """The dp×pp (or dp×pp×sp) LoRA train step: both towers run as GPipe
    pipelines over ``stage``, the batch split over ``data``
    (``shard_batch``); InfoNCE and the gradient sums as in
    ``train.step.make_train_step``, whose program this is with the pipeline
    executor in both towers. ``params`` are this rank's stage
    (``shard_clip_pp``), the state built by ``init_pp_train_state``. LoRA
    dropout is refused."""
    from clip_lora_match_tpu_torch.train.step import make_train_step

    if lora_cfg.dropout > 0.0:
        raise ValueError("LoRA dropout is unsupported inside the pipeline; pass a LoraConfig with dropout=0.0 "
                         "(disabling it quietly would train another recipe than the DP/TP steps)")
    check_pp_divisibility(arch, mesh.size(STAGE_AXIS))
    return make_train_step(params, arch, lora_cfg, train_cfg, tx, eot_id=eot_id, compute_dtype=compute_dtype,
                           remat=remat, mesh=mesh, transformer_fn=make_pipeline_transformer(mesh, n_microbatches))
