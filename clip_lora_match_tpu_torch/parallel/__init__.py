"""The data axis over ``torch.distributed`` ranks (port of ``parallel/``):
process-group start-up, the data mesh and its placement helpers, the sharded
encoder. The tensor, pipeline and sequence-parallel names of the JAX
package (``tp.py``, ``pp.py``, ``sp.py``, ``state.py``) are not ported yet.
Importing this package starts no process group."""

from clip_lora_match_tpu_torch.parallel.distributed import (
    initialize_distributed,
    is_primary,
    process_count,
    process_index,
    rank_device,
)
from clip_lora_match_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    all_gather,
    all_reduce_sum,
    barrier,
    gather_rows,
    global_batch_from_local,
    global_replicated,
    global_shard_batch,
    make_mesh,
    pad_to_multiple,
    replicated,
    shard_batch,
)
from clip_lora_match_tpu_torch.parallel.sharded_encode import ShardedEncoder, sharded_text_encode_fn

__all__ = [
    "initialize_distributed",
    "is_primary",
    "process_count",
    "process_index",
    "rank_device",
    "ShardedEncoder",
    "sharded_text_encode_fn",
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "all_gather",
    "all_reduce_sum",
    "barrier",
    "gather_rows",
    "global_batch_from_local",
    "global_replicated",
    "global_shard_batch",
    "make_mesh",
    "pad_to_multiple",
    "replicated",
    "shard_batch",
]
