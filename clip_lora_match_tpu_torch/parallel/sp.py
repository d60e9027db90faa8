"""Sequence parallelism for the CLIP towers: ring attention over a ``seq``
axis (port of ``parallel/sp.py``).

- Every op of a block but attention (LN, the projections, the MLP, the LoRA
  deltas, the residuals) acts on each token alone, so each ``seq`` rank runs
  them on its own block of the sequence with the parameters replicated.
- Attention runs as ring attention (``ops/ring_attention.py``) behind the
  layers' ``core_attn_fn``: each rank keeps its query rows and the KV
  blocks go round the axis. Autograd through ``ppermute`` derives the
  reverse ring.
- Any sequence length works: it is padded to a multiple of the axis size,
  the pad key columns held at the mask's floor in every layer (they never
  receive attention mass) and the pad query rows cut off after the tower
  (CLIP's S = 50 and 77 are mostly indivisible).

The executor takes this data rank's rows of the batch (the train step's
``shard_batch``) and the full sequence; it splits the sequence, runs the
layers, and gathers the blocks back, the same full result on every seq
rank. A ``model`` axis on the mesh (``make_sp_mesh(n_model=...)``) adds
Megatron tensor parallelism inside every layer (``parallel/tp.py``): the
parameters are then this rank's TP shards (``shard_clip_sp_tp``).

At CLIP's 50-77 tokens SP buys nothing: it exists so that attention scales
to sequences that do not fit one card. Not supported inside the sequence
shard: LoRA dropout (per-shard draws would differ from the whole batch's)
and the single-device attention kernels (the ring replaces the core; the
projections still dispatch as the kernel flags say).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from clip_lora_match_tpu_torch.models.io import to_device
from clip_lora_match_tpu_torch.parallel.distributed import process_count
from clip_lora_match_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
    Mesh,
    Split,
    build_mesh,
    gather_axis,
    replica_grad,
    split_axis,
)
from clip_lora_match_tpu_torch.parallel.tp import refuse_dropout, transformer_tp

Params = dict[str, Any]

def make_sp_mesh(n_seq: int, n_data: Optional[int] = None, n_model: int = 1,
                 device: str | torch.device = "cuda") -> Mesh:
    """The (data, seq) mesh, or (data, model, seq) with ``n_model`` > 1
    (dp×tp×sp), over every rank of the default group: seq minor, as in the
    JAX package. ``n_data`` defaults to the world over n_model·n_seq."""
    world = process_count()
    if n_data is None:
        n_data = world // (n_seq * n_model)
    need = max(n_data, 1) * n_seq * n_model
    if n_data < 1 or need != world:
        raise ValueError(f"need {need} ranks for a (data, model, seq)=({max(n_data, 1)}, {n_model}, {n_seq}) "
                         f"mesh, have {world}: start one rank a device of the mesh")
    axes = ((DATA_AXIS, n_data),) + (((MODEL_AXIS, n_model),) if n_model > 1 else ()) + ((SEQ_AXIS, n_seq),)
    return build_mesh(axes, device)


def shard_clip_sp(tree: Params, mesh: Mesh) -> Params:
    """A CLIP parameter or LoRA tree for SP: every leaf whole (replicated),
    on this rank's device; only the activations are split."""
    return to_device(tree, mesh.device)


def shard_clip_sp_tp(tree: Params, mesh: Mesh, lora: bool = False) -> Params:
    """A tree for dp×tp×sp: this rank's Megatron shards over the mesh's
    ``model`` axis (``parallel/tp.py``), whole over data and seq."""
    from clip_lora_match_tpu_torch.parallel.tp import shard_lora_tp, shard_params_tp

    return (shard_lora_tp if lora else shard_params_tp)(tree, mesh)


def pad_seq_and_mask(x: torch.Tensor, mask: Optional[torch.Tensor], n_seq: int):
    """Check and pad (x, mask) for an ``n_seq``-way sequence split. Returns
    (x padded, mask padded or None, pad).

    The ring slices key columns by global position and splits query rows,
    so a mask must be 4-dim with the full key dim and query rows either
    full or a broadcast 1. On padding, key columns always extend at the
    floor (pad keys never receive attention mass in any layer); query rows
    extend only for a per-row mask (a broadcast row must stay broadcast, or
    ranks past the first would see all-floor rows). Pad query rows compute
    unmasked values that the caller cuts off."""
    # imported here: ops/ring_attention.py imports parallel.mesh, whose
    # package imports this module
    from clip_lora_match_tpu_torch.ops.ring_attention import _MASK_FLOOR

    B, S, D = x.shape
    if mask is not None:
        if mask.dim() != 4:
            raise ValueError(f"SP needs an explicit 4-dim additive mask (broadcastable dims of size 1 "
                             f"allowed), got ndim={mask.dim()}")
        if mask.shape[3] != S or mask.shape[2] not in (1, S):
            raise ValueError(f"SP mask must have key dim {S} and query-row dim 1 or {S}, got "
                             f"{tuple(mask.shape)}")
    S_pad = -(-S // n_seq) * n_seq
    pad = S_pad - S
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        if mask is not None:
            mask = torch.nn.functional.pad(mask.float(), (0, pad), value=_MASK_FLOOR)
            if mask.shape[2] > 1:
                mask = torch.nn.functional.pad(mask, (0, 0, 0, pad), value=_MASK_FLOOR)
        else:
            cols = torch.where(torch.arange(S_pad, device=x.device) < S, 0.0, _MASK_FLOOR)
            mask = cols.reshape(1, 1, 1, S_pad)
    return x, mask, pad


def seq_mask_spec(mask: torch.Tensor) -> Optional[Split]:
    """The split of a checked (maybe padded) SP mask: query rows over
    ``seq`` where they are explicit, else none; key columns always whole
    (the ring slices them a block at a time). Its batch rows are this data
    rank's already: the mask is made from the rank's rows of the batch."""
    return Split(SEQ_AXIS, 2) if mask.shape[2] > 1 else None


def _local_mask(mask: Optional[torch.Tensor], mesh: Mesh, axis: str) -> Optional[torch.Tensor]:
    if mask is None or seq_mask_spec(mask) is None:
        return mask
    b = mask.shape[2] // mesh.size(axis)
    return mask[:, :, mesh.index(axis) * b:(mesh.index(axis) + 1) * b]


def ring_core(mesh: Mesh):
    """The layers' ``core_attn_fn``: ring attention over ``mesh``'s seq axis."""
    from clip_lora_match_tpu_torch.ops.ring_attention import ring_attention

    def core(qh, kh, vh, m):
        return ring_attention(qh, kh, vh, mesh, SEQ_AXIS, mask=m)

    return core


def make_sp_transformer(mesh: Mesh):
    """A drop-in for ``nn.layers.transformer`` that splits the sequence over
    ``mesh``'s ``seq`` axis and runs attention as a KV ring. ``x``: this
    data rank's rows, the whole sequence; the result likewise, the same on
    every seq rank. With a ``model`` axis, ``blocks`` and ``lora_blocks``
    are this rank's TP shards."""
    n_seq = mesh.size(SEQ_AXIS)

    def sp_transformer(blocks, x, num_heads, mask=None, lora_blocks=None, lora_scaling=1.0, eps=1e-5,
                       compute_dtype=None, remat=False, lora_dropout=0.0, generator=None, unroll=1):
        refuse_dropout(lora_dropout, generator, "the sequence shard")
        S = x.shape[1]
        x, mask, pad = pad_seq_and_mask(x, mask, n_seq)
        out = transformer_tp(blocks, split_axis(x, mesh, SEQ_AXIS, 1), num_heads, mesh,
                             mask=_local_mask(mask, mesh, SEQ_AXIS), lora_blocks=lora_blocks,
                             lora_scaling=lora_scaling, eps=eps, compute_dtype=compute_dtype, remat=remat,
                             core_attn_fn=ring_core(mesh))
        out = replica_grad(gather_axis(out, mesh, SEQ_AXIS, 1), mesh, SEQ_AXIS)
        return out[:, :S] if pad else out

    return sp_transformer


def init_sp_train_state(sharded_lora: Params, tx, seed: int = 42, rng_impl: Optional[str] = None):
    """A train state over a whole LoRA tree (``shard_clip_sp``): SP splits
    activations, not parameters."""
    from clip_lora_match_tpu_torch.models.io import tree_map
    from clip_lora_match_tpu_torch.parallel.state import init_sharded_train_state

    return init_sharded_train_state(sharded_lora, tx, tree_map(lambda _: None, sharded_lora), seed=seed,
                                    rng_impl=rng_impl)


def make_sp_train_step(params: Params, arch, lora_cfg, train_cfg, tx, mesh: Mesh,
                       eot_id: Optional[int] = None, compute_dtype=None, remat: bool | str = False):
    """The dp×sp (or dp×tp×sp) LoRA train step: both towers run with the
    sequence split and ring attention, the batch split over ``data``
    (``shard_batch``); InfoNCE and the gradient sums as in
    ``train.step.make_train_step``, whose program this is with the ring
    executor in both towers. ``params`` are placed (``shard_clip_sp``, or
    ``shard_clip_sp_tp`` under a model axis), the state built by
    ``init_sp_train_state`` (``init_tp_train_state`` under a model axis).
    LoRA dropout is refused."""
    from clip_lora_match_tpu_torch.train.step import make_train_step

    if lora_cfg.dropout > 0.0:
        raise ValueError("LoRA dropout is unsupported inside the sequence shard; pass a LoraConfig with "
                         "dropout=0.0 (disabling it quietly would train another recipe than the DP/TP steps)")
    if mesh.size(MODEL_AXIS) > 1:
        from clip_lora_match_tpu_torch.parallel.tp import check_tp_divisibility

        check_tp_divisibility(arch, mesh.size(MODEL_AXIS))
    return make_train_step(params, arch, lora_cfg, train_cfg, tx, eot_id=eot_id, compute_dtype=compute_dtype,
                           remat=remat, mesh=mesh, transformer_fn=make_sp_transformer(mesh))
