"""Optimizer state for sharded LoRA training, and the whole tree back from
its shards (port of ``parallel/state.py``).

The JAX package places every param-shaped leaf of the optimizer state with
its param's PartitionSpec (``optax.tree_map_params``), since the partitioner
leaves zero-initialized moments unsharded. In the port a rank holds its
shards only, so moments made from them (``tx.init``) are this rank's shards
already, and the step count is a Python int on every rank. What the port
adds is the record of the splits, ``TrainState.specs``, which the train step
reads to sum each gradient over the right axes and to take the global norm
(``train/step.py``). JAX arrays are global and the port's are not:
``gather_sharded`` gives the full tree on every rank, for tests and for
``save_lora`` on rank 0.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from clip_lora_match_tpu_torch.models.io import tree_leaves, unflatten
from clip_lora_match_tpu_torch.parallel.mesh import Mesh, all_gather

Params = dict[str, Any]


def init_sharded_train_state(sharded_lora: Params, tx, specs: Params, seed: int = 42,
                             rng_impl: Optional[str] = None):
    """A fresh ``TrainState`` over this rank's LoRA shards: moments of their
    shapes (this rank's shards), step 0, the CPU generator seeded with
    ``seed`` (the same on every rank), and ``specs`` (a tree like the LoRA
    tree of ``parallel.mesh.Split`` or None). ``rng_impl`` is accepted and
    has no effect."""
    from clip_lora_match_tpu_torch.train.step import init_train_state

    paths = [p for p, _ in tree_leaves(sharded_lora)]
    if paths != [p for p, _ in tree_leaves(specs)]:
        raise ValueError("specs must have the LoRA tree's structure")
    state = init_train_state(sharded_lora, tx, seed=seed)
    state.specs = specs
    return state


def gather_sharded(tree: Params, specs: Params, mesh: Mesh) -> Params:
    """The full tree on every rank from each rank's shards under ``specs``:
    a split leaf's blocks gathered over its axis along its dim (every rank
    calls it at once, leaves in one order), a whole leaf as it is."""
    table = dict(tree_leaves(specs))
    out = {}
    for path, leaf in tree_leaves(tree):
        split = table[path]
        if split is None or mesh.size(split.axis) == 1:
            out[path] = leaf
            continue
        with torch.no_grad():
            dim = split.dim % leaf.ndim
            moved = leaf.movedim(dim, 0).contiguous()
            full = all_gather(mesh, moved, split.axis)
            out[path] = full.movedim(0, dim).contiguous()
    return unflatten(out)
