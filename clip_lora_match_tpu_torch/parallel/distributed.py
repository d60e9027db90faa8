"""Process-group start-up for the data axis (port of ``parallel/distributed.py``).

The JAX package joins hosts with ``jax.distributed.initialize``; the port
joins processes with ``torch.distributed.init_process_group``: one process a
rank, one device a rank. ``initialize_distributed`` reads ``torchrun``'s
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR`` / ``MASTER_PORT``) or explicit arguments; with neither it
does nothing and returns False (one process).

The backend is the caller's to state; ``None`` takes ``nccl`` for a CUDA
device and ``gloo`` for the CPU, and nothing falls back to another:

- ``nccl``: CUDA tensors, one card a rank. Where ranks would share a card
  it raises and names gloo, since NCCL refuses two ranks on one card: when
  the ranks on this host (``LOCAL_WORLD_SIZE`` or ``local_world``) outnumber
  its cards, or when this rank's local rank has no card of its own;
- ``gloo``: the CPU, and ranks that share a card.

A rank's device is ``cuda:{local_rank % device_count}`` unless the caller
asks for the CPU. The local rank is ``local_rank``, else ``LOCAL_RANK``
(``torchrun``), else the rank: one host. A rank on a second host started
with explicit arguments passes ``local_rank`` (and ``local_world``) or sets
``LOCAL_RANK``. ``process_count`` and ``process_index`` stand for
``jax.process_count`` / ``jax.process_index``: the world size and the rank,
1 and 0 without a group.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from clip_lora_match_tpu_torch.core.device import resolve_device
from clip_lora_match_tpu_torch.core.logging import get_logger

log = get_logger("distributed")

BACKENDS = ("nccl", "gloo")


def process_count() -> int:
    """Ranks in the default group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank; 0 without a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that writes checkpoints, metrics and files."""
    return process_index() == 0


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", process_index()))


def rank_device(device: str | torch.device = "cuda", local_rank: Optional[int] = None) -> torch.device:
    """This rank's device: the CPU when asked for; a CUDA device with an
    index as given; else ``cuda:{local_rank % device_count}``."""
    dev = resolve_device(device)
    if dev.type == "cpu" or dev.index is not None:
        return dev
    rank = _local_rank() if local_rank is None else local_rank
    return torch.device("cuda", rank % torch.cuda.device_count())


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: str | torch.device = "cuda",
    timeout: Optional[float] = None,
    local_rank: Optional[int] = None,
    local_world: Optional[int] = None,
) -> bool:
    """Join the process group (idempotent). Returns True in a group, False
    for one process (neither ``torchrun``'s environment nor arguments).

    ``coordinator_address``: an ``init_method`` URL (``tcp://host:port``,
    ``file:///path``) or ``host:port``, with ``num_processes`` and
    ``process_id``; they override the environment. An explicit request that
    fails raises, as in the JAX package: a quiet single-process run would
    split the job into trainers that overwrite each other's outputs.
    ``timeout``: seconds a collective may wait (torch's default otherwise).
    ``local_rank`` / ``local_world``: this rank's index among the ranks of
    its host and their number (``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``
    otherwise).
    """
    if dist.is_initialized():
        return True
    explicit = (coordinator_address, num_processes, process_id) != (None, None, None)
    env = os.environ
    if not explicit and not ("RANK" in env and "WORLD_SIZE" in env):
        log.info("single-process mode: no torchrun environment and no explicit arguments")
        return False
    if explicit:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError("initialize_distributed: give coordinator_address, num_processes and "
                             "process_id together")
        init_method = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    else:
        init_method, world, rank = "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    if local_world is None and "LOCAL_WORLD_SIZE" in env:
        local_world = int(env["LOCAL_WORLD_SIZE"])
    dev = rank_device(device, local_rank)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("nccl runs on CUDA devices; the CPU takes backend='gloo'")
        cards = torch.cuda.device_count()
        if local_world is not None and local_world > cards:
            raise ValueError(
                f"nccl needs one card a rank: {local_world} ranks on this host share {cards} "
                "card(s); pass backend='gloo' to let ranks share a card"
            )
        if torch.device(device).index is None and local_rank >= cards:
            raise ValueError(
                f"nccl needs one card a rank: local rank {local_rank} has none of its own among "
                f"{cards} card(s); for a rank on another host set LOCAL_RANK or pass local_rank, "
                "or pass backend='gloo' to let ranks share a card"
            )
        torch.cuda.set_device(dev)
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank, **kw)
    log.info("process group: rank %d of %d (%s) on %s", rank, world, backend, dev)
    return True
