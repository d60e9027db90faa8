"""Tensor parallelism for the CLIP towers, Megatron-style (port of
``parallel/tp.py``).

The JAX package shards every block's weight matrices over the mesh's
``model`` axis and lets GSPMD derive the activations' shardings and the
collectives. The port has no partitioner: each model rank holds its shards
(``shard_params_tp`` / ``shard_lora_tp``) and ``make_tp_transformer``, the
towers' ``transformer_fn``, writes the splits and the collectives out:

- **column-parallel** (q/k/v, mlp fc1): the kernel and bias split on the
  output dim. The layer's input passes Megatron's f (``copy_to_model``:
  identity forward, its cotangent summed over the model ranks backward);
  each rank runs its ``H / n_model`` heads (head-major layout, so a rank's
  q/k/v columns are whole heads) or its slice of the hidden units, with no
  communication;
- **row-parallel** (attn out_proj, mlp fc2): the kernel splits on the input
  dim. Each rank's product is a partial sum; g (``reduce_from_model``:
  all-reduce forward, identity backward) sums them, and then the bias,
  replicated, is added once;
- LoRA mirrors the base split: a column-parallel target's ``b`` splits on
  its output dim (``a`` replicated), a row-parallel target's ``a`` on its
  input dim (``b`` replicated). The rank-r bottleneck stays whole, so the
  adapter adds no collective beyond the base layer's. A replicated factor
  takes part in this rank's share of the product only, so its gradient on
  each model rank is a partial sum: the train step sums it over the model
  axis (``train/step.py``), and every rank applies the same update.

Everything else (LayerNorms, embeddings, projection heads, row-parallel
biases) is replicated. Each rank is a single-device program, so under
``"auto"`` on the card its projections and its local heads' attention run
the port's kernels (``lora_matmul``, ``attention_small``) as any call does.
The int8 (W8A8) weights are refused under TP (their per-channel scales
would need re-sharding; int8 is a single-card serving path), and so is LoRA
dropout (a row-parallel adapter's input mask would be drawn per shard, not
over the whole input).

The ``*_pspecs`` functions return the port's PartitionSpec: for each leaf a
``parallel.mesh.Split`` (the axis and the leaf's dim) or None (replicated).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from clip_lora_match_tpu_torch.core.config import ClipArchConfig
from clip_lora_match_tpu_torch.models.io import to_device, tree_leaves, unflatten
from clip_lora_match_tpu_torch.nn.layers import (
    _lora_get,
    _run_block,
    attention,
    layer_norm,
    mlp,
    transformer,
    unstack_blocks,
)
from clip_lora_match_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    Mesh,
    Split,
    copy_to_model,
    reduce_from_model,
    shard_leaf,
)

Params = dict[str, Any]

# projections whose OUTPUT dim is split (Megatron column-parallel)
_COLUMN_PARALLEL = ("q_proj", "k_proj", "v_proj", "fc1")
# projections whose INPUT dim is split (Megatron row-parallel)
_ROW_PARALLEL = ("out_proj", "fc2")


def check_tp_divisibility(arch: ClipArchConfig, n_model: int) -> None:
    """TP splits the attention heads and the MLP hidden dim evenly."""
    for name, heads, mlp_dim in (
        ("vision", arch.vision_heads, arch.vision_mlp_dim),
        ("text", arch.text_heads, arch.text_mlp_dim),
    ):
        if heads % n_model:
            raise ValueError(f"{name} tower has {heads} heads, not divisible by model-axis size {n_model}")
        if mlp_dim % n_model:
            raise ValueError(f"{name} tower mlp_dim {mlp_dim} not divisible by model-axis size {n_model}")


def _projection(names: list[str]) -> Optional[str]:
    return next((n for n in names if n in _COLUMN_PARALLEL + _ROW_PARALLEL), None)


def _base_leaf_spec(names: list[str], leaf) -> Optional[Split]:
    proj = _projection(names)
    if proj is None:
        return None
    leafname = names[-1]
    if proj in _COLUMN_PARALLEL:
        # kernel (L, in, out), bias (L, out), int8 kernel_q / w_scale: the
        # trailing (output, channel) dim
        return Split(MODEL_AXIS, -1) if leafname in ("kernel", "bias", "kernel_q", "w_scale") else None
    # row-parallel: the kernel's input dim; the bias adds to the summed output
    if leafname in ("kernel", "kernel_q") and leaf.ndim >= 2:
        return Split(MODEL_AXIS, -2)
    return None


def _lora_leaf_spec(names: list[str], leaf) -> Optional[Split]:
    proj = _projection(names)
    if proj in _COLUMN_PARALLEL and names[-1] == "b":
        return Split(MODEL_AXIS, -1)  # b: (L, r, out)
    if proj in _ROW_PARALLEL and names[-1] == "a":
        return Split(MODEL_AXIS, -2)  # a: (L, in, r)
    return None


def _specs(tree: Params, leaf_spec) -> Params:
    return unflatten({path: leaf_spec(path.split("/"), leaf) for path, leaf in tree_leaves(tree)})


def clip_tp_pspecs(params: Params) -> Params:
    """The split of every base leaf (a tree like ``params``)."""
    return _specs(params, _base_leaf_spec)


def lora_tp_pspecs(lora: Params) -> Params:
    """The split of every LoRA leaf (a tree like ``lora``)."""
    return _specs(lora, _lora_leaf_spec)


def _shard(tree: Params, specs: Params, mesh: Mesh) -> Params:
    table = dict(tree_leaves(specs))
    return to_device(unflatten({path: shard_leaf(leaf, table[path], mesh)
                                for path, leaf in tree_leaves(tree)}), mesh.device)


def _refuse_int8(tree: Params) -> None:
    if any(path.endswith("kernel_q") for path, _ in tree_leaves(tree)):
        raise NotImplementedError("int8 (W8A8) weights are not supported under tensor parallelism: their "
                                  "per-channel scales would need re-sharding; serve int8 on one card")


def shard_params_tp(params: Params, mesh: Mesh) -> Params:
    """This rank's Megatron shards of the full base tree (numpy arrays or
    tensors), as tensors on its device."""
    _refuse_int8(params)
    return _shard(params, clip_tp_pspecs(params), mesh)


def shard_lora_tp(lora: Params, mesh: Mesh) -> Params:
    """This rank's shards of the full LoRA tree, the base layers' splits
    mirrored."""
    return _shard(lora, lora_tp_pspecs(lora), mesh)


def init_tp_train_state(sharded_lora: Params, tx, seed: int = 42, rng_impl: Optional[str] = None):
    """A train state whose moments are this rank's shards, its LoRA splits
    recorded (``parallel.state.init_sharded_train_state``)."""
    from clip_lora_match_tpu_torch.parallel.state import init_sharded_train_state

    return init_sharded_train_state(sharded_lora, tx, lora_tp_pspecs(sharded_lora), seed=seed,
                                    rng_impl=rng_impl)


def _unbiased(p: Params, name: str) -> Params:
    return {**p, name: {**p[name], "bias": None}}


def _add_bias(y: torch.Tensor, p: Params) -> torch.Tensor:
    b = p.get("bias")
    return y if b is None else y + b.to(y.dtype)


def tp_block(p: Params, x: torch.Tensor, num_heads: int, mesh: Mesh, mask=None, lora=None,
             lora_scaling: float = 1.0, eps: float = 1e-5, compute_dtype=None,
             core_attn_fn=None) -> torch.Tensor:
    """One pre-LN block on this rank's shards: ``num_heads`` is the tower's
    head count; the rank runs its ``num_heads / n_model``."""
    heads = num_heads // mesh.size(MODEL_AXIS)
    a, m = p["attn"], p["mlp"]
    h = copy_to_model(layer_norm(p["ln_1"], x, eps), mesh)
    y = attention(_unbiased(a, "out_proj"), h, heads, mask=mask, lora=_lora_get(lora, "attn"),
                  lora_scaling=lora_scaling, compute_dtype=compute_dtype, core_attn_fn=core_attn_fn)
    x = x + _add_bias(reduce_from_model(y, mesh), a["out_proj"])
    h = copy_to_model(layer_norm(p["ln_2"], x, eps), mesh)
    y = mlp(_unbiased(m, "fc2"), h, lora=_lora_get(lora, "mlp"), lora_scaling=lora_scaling,
            compute_dtype=compute_dtype)
    return x + _add_bias(reduce_from_model(y, mesh), m["fc2"])


def transformer_tp(blocks, x: torch.Tensor, num_heads: int, mesh: Mesh, mask=None, lora_blocks=None,
                   lora_scaling: float = 1.0, eps: float = 1e-5, compute_dtype=None,
                   remat: bool | str = False, core_attn_fn=None) -> torch.Tensor:
    """The layer stack on this rank's model shards (``nn.layers.transformer``
    where the model axis has size 1)."""
    if mesh.size(MODEL_AXIS) == 1:
        return transformer(blocks, x, num_heads, mask=mask, lora_blocks=lora_blocks,
                           lora_scaling=lora_scaling, eps=eps, compute_dtype=compute_dtype, remat=remat,
                           core_attn_fn=core_attn_fn)
    layers = unstack_blocks(blocks)
    lora_layers = unstack_blocks(lora_blocks) if lora_blocks is not None else [None] * len(layers)
    for blk, lb in zip(layers, lora_layers):
        def block_fn(h, blk=blk, lb=lb):
            return tp_block(blk, h, num_heads, mesh, mask=mask, lora=lb, lora_scaling=lora_scaling,
                            eps=eps, compute_dtype=compute_dtype, core_attn_fn=core_attn_fn)

        x = _run_block(block_fn, x, remat)
    return x


def refuse_dropout(lora_dropout: float, generator, where: str) -> None:
    if generator is not None and lora_dropout > 0.0:
        raise NotImplementedError(f"LoRA dropout inside {where} is unsupported; its recipes set dropout=0")


def make_tp_transformer(mesh: Mesh):
    """A drop-in for ``nn.layers.transformer`` (the towers' ``transformer_fn``)
    over this rank's Megatron shards of the blocks and the LoRA blocks
    (``shard_params_tp``, ``shard_lora_tp``); ``x`` is the same on every
    model rank and so is the result."""
    n_model = mesh.size(MODEL_AXIS)

    def tp_transformer(blocks, x, num_heads, mask=None, lora_blocks=None, lora_scaling=1.0, eps=1e-5,
                       compute_dtype=None, remat=False, lora_dropout=0.0, generator=None, unroll=1):
        refuse_dropout(lora_dropout, generator, "the tensor-parallel shard")
        if num_heads % n_model:
            raise ValueError(f"{num_heads} heads do not split over model-axis size {n_model}")
        return transformer_tp(blocks, x, num_heads, mesh, mask=mask, lora_blocks=lora_blocks,
                              lora_scaling=lora_scaling, eps=eps, compute_dtype=compute_dtype, remat=remat)

    return tp_transformer
