"""The data axis over ``torch.distributed`` ranks (port of ``parallel/mesh.py``).

The JAX package lays its devices out as a (data, model) ``Mesh`` and lets
GSPMD place arrays on it. The port runs one process a rank with one device
each, so its ``Mesh`` is that rank's view of the data axis: the process
group, ``n_data`` ranks, this rank and its device. Index rows and batch rows
are split over the ranks in contiguous blocks, ``[r·B/n, (r+1)·B/n)``;
parameters are replicated.

- ``shard_batch`` / ``global_shard_batch``: every rank holds the whole
  global batch and keeps its rows, on its device;
- ``global_batch_from_local``: each rank holds only its rows;
- ``replicated`` / ``global_replicated``: a tree on this rank's device,
  checked once (a checksum gathered from every rank) to hold the same values
  everywhere; the JAX package assumes that its processes share a seed, the
  port checks it;
- ``all_gather``, ``all_reduce_sum``, ``gather_rows`` (differentiable) and
  ``barrier``: the collectives the data axis needs.

``compat_shard_map`` and ``data_sharded`` have no counterpart: there is no
shard_map or sharding annotation in eager PyTorch; each rank runs its own
part and the collectives above join them. The model axes (tensor, pipeline
and sequence parallelism) are not ported yet: ``make_mesh`` refuses
``n_model > 1``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from clip_lora_match_tpu_torch.models.io import to_device, tree_leaves
from clip_lora_match_tpu_torch.parallel.distributed import process_count, process_index, rank_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    """This rank's view of the data axis: ``n_data`` ranks of the default
    process group (none for one process), ``rank``, and its ``device``."""

    n_data: int
    rank: int
    device: torch.device

    @property
    def backend(self) -> Optional[str]:
        """The group's backend, None without a group."""
        return dist.get_backend() if dist.is_initialized() else None


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device: str | torch.device = "cuda") -> Mesh:
    """The data axis over every rank of the default group (one rank and no
    group for a single process). ``device``: ``"cpu"``, or CUDA (this rank's
    card, ``distributed.rank_device``)."""
    if n_model != 1:
        raise NotImplementedError(
            "model axes (tensor, pipeline and sequence parallelism) are not ported yet: n_model must be 1"
        )
    world = process_count()
    if n_data is not None and n_data != world:
        raise ValueError(f"the data axis spans every rank, one device a rank: n_data={n_data}, "
                         f"world size {world}")
    return Mesh(world, process_index(), rank_device(device))


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0) -> tuple[np.ndarray, int]:
    """Pad ``axis`` with zeros to a multiple (even shards a rank). Returns
    (padded, original length)."""
    n = x.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return x, n
    pad_width = [(0, 0)] * x.ndim
    pad_width[axis] = (0, target - n)
    return np.pad(x, pad_width), n


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _collective(fn, tensor: torch.Tensor) -> torch.Tensor:
    """Run ``fn(t)`` (a collective that writes its result into the tensors
    it is given) on ``tensor`` and return the tensor that holds the result.

    gloo runs its collectives in host memory, and its CUDA paths cover some
    collectives and not others (the list form of all_gather and all_reduce,
    but not all_gather_into_tensor or reduce_scatter in every release). So a
    CUDA tensor under gloo is copied to the host here, explicitly, and its
    result back to the device after: the one place the port makes that copy.
    NCCL takes the device tensor as it is and is never given a host copy."""
    if tensor.device.type == "cuda" and dist.get_backend() == "gloo":
        host = tensor.cpu()
        return fn(host).to(tensor.device)
    return fn(tensor)


def all_gather(mesh: Mesh, tensor: torch.Tensor) -> torch.Tensor:
    """Every rank's ``tensor`` (one shape on every rank), concatenated in
    rank order along dim 0."""
    if not dist.is_initialized():
        return tensor

    def gather(t):
        parts = [torch.empty_like(t) for _ in range(mesh.n_data)]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts)

    return _collective(gather, tensor)


def all_reduce_sum(mesh: Mesh, tensor: torch.Tensor) -> torch.Tensor:
    """The sum of ``tensor`` over the ranks (a new tensor; the input is kept)."""
    if not dist.is_initialized():
        return tensor

    def reduce(t):
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t

    return _collective(reduce, tensor)


def barrier(mesh: Mesh) -> None:
    """Wait until every rank has come here."""
    all_reduce_sum(mesh, torch.zeros(1, device=mesh.device)).cpu()


class _GatherRows(torch.autograd.Function):
    """``all_gather`` whose backward sums the incoming gradient over the
    ranks and keeps this rank's rows: each rank's loss reaches every rank's
    features through the gathered matrix."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        return all_gather(mesh, x)

    @staticmethod
    def backward(ctx, grad):
        r, rows = ctx.mesh.rank, ctx.rows
        return all_reduce_sum(ctx.mesh, grad.contiguous())[r * rows:(r + 1) * rows], None


def gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Differentiable ``all_gather`` of each rank's (b, ...) rows → (n·b, ...)."""
    return _GatherRows.apply(x, mesh)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def _rows(mesh: Mesh, n: int, what: str) -> slice:
    if n % mesh.n_data:
        raise ValueError(f"{what}: {n} rows do not split over {mesh.n_data} ranks (pad_to_multiple first)")
    b = n // mesh.n_data
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """Every rank holds the whole global batch (numpy arrays or tensors);
    each keeps its contiguous rows, as tensors on its device. Leading dims
    must divide over the ranks."""
    return to_device({k: v[_rows(mesh, v.shape[0], f"shard_batch[{k!r}]")] for k, v in batch.items()},
                     mesh.device)


global_shard_batch = shard_batch


def global_batch_from_local(mesh: Mesh, local_batch: dict) -> dict:
    """Each rank holds only its rows (rank r: global rows ``[r·b, (r+1)·b)``);
    they go to its device. The ranks' leading dims must be equal."""
    sizes = {k: np.shape(v)[0] for k, v in local_batch.items()}
    got = all_gather(mesh, torch.tensor([sizes[k] for k in sorted(sizes)], device=mesh.device))
    got = got.reshape(mesh.n_data, -1).cpu()
    if not bool((got == got[0]).all()):
        raise ValueError(f"global_batch_from_local: the ranks' local batch sizes differ: {got.tolist()}")
    return to_device(local_batch, mesh.device)


def replicated(mesh: Mesh, tree: Any):
    """``tree`` (numpy arrays or tensors) on this rank's device, dtypes kept,
    after checking once that every rank holds the same values: each leaf's
    float64 sum and sum of squares, gathered from every rank, must agree."""
    tree = to_device(tree, mesh.device)
    leaves = tree_leaves(tree)
    if dist.is_initialized() and mesh.n_data > 1 and leaves:
        sums = torch.stack([
            torch.stack([t.double().sum(), t.double().square().sum()]) for _, t in leaves
        ])
        every = all_gather(mesh, sums[None]).cpu()
        bad = (every != every[0]).any(dim=(0, 2)).nonzero().flatten().tolist()
        if bad:
            raise ValueError(f"replicated: the ranks hold different values at {leaves[bad[0]][0]!r} "
                             "(were they made from one seed?)")
    return tree


global_replicated = replicated
