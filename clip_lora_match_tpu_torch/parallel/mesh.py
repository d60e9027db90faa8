"""The mesh over ``torch.distributed`` ranks (port of ``parallel/mesh.py``).

The JAX package lays its devices out as a named ``Mesh`` and lets GSPMD and
``shard_map`` place arrays on it. The port runs one process a rank with one
device each, so its ``Mesh`` is one rank's view of a named mesh: the axis
names and sizes, this rank's coordinate on each axis, its device, and for
every axis the ``dist.new_group`` subgroup of the ranks that differ from it
on that axis alone. Rank ``r`` sits at the row-major position ``r`` of the
JAX device array of the same shape, so it holds the shard that JAX device
``r`` holds:

- ``make_mesh``: (data, model), the JAX package's ``make_mesh``; the
  sequence and pipeline meshes (``sp.make_sp_mesh``, ``pp.make_pp_mesh``)
  are built by ``build_mesh`` with their own axes;
- ``shard_batch`` / ``global_shard_batch``: every rank holds the whole
  global batch and keeps its rows of the data axis, ``[d·B/n, (d+1)·B/n)``
  for data coordinate d, on its device; ``global_batch_from_local``: each
  rank holds only its rows;
- ``global_put`` / ``data_sharded``: one host array's block under a split;
- ``replicated`` / ``global_replicated``: a tree on this rank's device,
  checked once (a checksum gathered from every rank) to hold the same values
  everywhere; the JAX package assumes that its processes share a seed, the
  port checks it;
- ``Split``, ``shard_leaf``: one leaf's split over an axis (the port's
  PartitionSpec) and this rank's block of it;
- ``all_gather``, ``all_reduce_sum`` and ``barrier`` (not differentiable),
  over the data axis unless another is named;
- autograd Functions where a collective needs a gradient, JAX's collectives
  with the transposes JAX's AD gives them: ``ppermute`` (its backward the
  reverse shift), ``copy_to_model`` / ``reduce_from_model`` (Megatron's f
  and g: identity forward and all-reduce backward, and the reverse),
  ``gather_axis`` (its backward sums each cotangent into the owner's block;
  ``gather_rows`` is it over the data axis), ``split_axis`` (this rank's
  block; its backward gathers the blocks' cotangents), ``copy_to`` (f over
  any axis) and ``replica_grad`` (the cotangent of a value that every rank
  of an axis holds and goes on to use alike, divided by the axis size).

A collective over an axis of size 1 is the identity and communicates
nothing. ``compat_shard_map`` has no counterpart: there is no shard_map in
eager PyTorch; each rank runs its own part and the collectives above join
them.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from clip_lora_match_tpu_torch.models.io import to_device, tree_leaves
from clip_lora_match_tpu_torch.parallel.distributed import process_count, process_index, rank_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"  # parallel/sp.py's sequence axis
STAGE_AXIS = "stage"  # parallel/pp.py's pipeline axis


@dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of a named mesh: ``axis_names`` and ``axis_sizes``
    (row-major over the ranks of the default group), this rank's ``coords``
    on them and its ``device``; ``groups[axis]`` is the subgroup of the
    ranks along ``axis`` through this rank (None where the axis spans the
    whole world: the default group) and ``members[axis]`` their global ranks
    in axis order. An axis the mesh does not name has size 1.
    ``stats[axis]`` is (calls, seconds) of the collectives run over it
    ("world" for the whole mesh's): the host's wall time in each call. Under
    gloo that is the whole collective, its host copies included (the call
    returns when its result is back on the device); under NCCL only its
    enqueue. Clear it to count afresh."""

    axis_names: tuple
    axis_sizes: tuple
    coords: tuple
    device: torch.device
    groups: dict = field(default_factory=dict, repr=False)
    members: dict = field(default_factory=dict, repr=False)
    stats: dict = field(default_factory=dict, repr=False)

    @property
    def shape(self) -> dict:
        """{axis: size}, as JAX's ``Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 on an axis the mesh lacks)."""
        return dict(zip(self.axis_names, self.coords)).get(axis, 0)

    @property
    def n_data(self) -> int:
        return self.size(DATA_AXIS)

    @property
    def rank(self) -> int:
        """This rank's coordinate on the data axis."""
        return self.index(DATA_AXIS)

    @property
    def world(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def backend(self) -> Optional[str]:
        """The group's backend, None without a group."""
        return dist.get_backend() if dist.is_initialized() else None


def build_mesh(axes: Sequence[tuple[str, int]], device: str | torch.device = "cuda") -> Mesh:
    """The mesh of ``axes`` ((name, size) pairs, major to minor) over every
    rank of the default group, whose size must be their product. Every rank
    calls it at once: it makes every axis's subgroups (``dist.new_group``
    is collective), in one order. ``device``: ``"cpu"``, or CUDA (this
    rank's card, ``distributed.rank_device``)."""
    names = tuple(n for n, _ in axes)
    sizes = tuple(int(s) for _, s in axes)
    world, me = process_count(), process_index()
    if any(s < 1 for s in sizes) or math.prod(sizes) != world:
        raise ValueError(f"a {dict(zip(names, sizes))} mesh needs {math.prod(sizes)} ranks, the world has "
                         f"{world}")
    grid = np.arange(world).reshape(sizes)
    coords = tuple(int(c) for c in np.unravel_index(me, sizes))
    groups, members = {}, {}
    for i, name in enumerate(names):
        lines = np.moveaxis(grid, i, -1).reshape(-1, sizes[i])
        for line in lines:
            line = tuple(int(r) for r in line)
            group = None
            if 1 < sizes[i] < world:
                group = dist.new_group(list(line))
            if me in line:
                groups[name], members[name] = group, line
    return Mesh(names, sizes, coords, rank_device(device), groups, members)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device: str | torch.device = "cuda") -> Mesh:
    """The (data, model) mesh over every rank of the default group (one rank
    and no group for a single process): ``n_data`` defaults to the world
    over ``n_model``, and the world must be ``n_data·n_model``. Rank r sits
    at (r // n_model, r % n_model), as JAX device r of
    ``make_mesh(n_data, n_model)``."""
    world = process_count()
    if n_model < 1 or world % n_model:
        raise ValueError(f"the model axis of size {n_model} does not divide the world of {world} ranks")
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a (data, model) = ({n_data}, {n_model}) mesh needs {n_data * n_model} ranks, "
                         f"world size {world}")
    return build_mesh(((DATA_AXIS, n_data), (MODEL_AXIS, n_model)), device)


@dataclass(frozen=True)
class Split:
    """One leaf's split over a mesh axis: ``dim`` of the leaf in
    ``mesh.size(axis)`` equal blocks, block i on the ranks at coordinate i.
    A leaf with no split (None) is replicated."""

    axis: str
    dim: int


def shard_leaf(x, split: Optional[Split], mesh: Mesh):
    """This rank's block of the full leaf ``x`` (numpy or a tensor) under
    ``split``, contiguous; ``x`` itself when it is None."""
    if split is None:
        return x
    n, i = mesh.size(split.axis), mesh.index(split.axis)
    dim = split.dim % np.ndim(x)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of a {tuple(x.shape)} leaf does not split over {split.axis} "
                         f"of size {n}")
    b = x.shape[dim] // n
    block = x[(slice(None),) * dim + (slice(i * b, (i + 1) * b),)]
    return block.contiguous() if isinstance(block, torch.Tensor) else np.ascontiguousarray(block)


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


def _collective(fn, tensor: torch.Tensor, mesh: Mesh, axis: Optional[str]) -> torch.Tensor:
    """Run ``fn(t)`` (a collective over ``mesh``'s ``axis`` that writes its
    result into the tensors it is given) on ``tensor`` and return the tensor
    that holds the result; counted in ``mesh.stats``.

    gloo runs its collectives in host memory, and its CUDA paths cover some
    collectives and not others (the list form of all_gather and all_reduce,
    but not all_gather_into_tensor, reduce_scatter or send / recv in every
    release). So a CUDA tensor under gloo is copied to the host here,
    explicitly, and its result back to the device after: the one place the
    port makes that copy. NCCL takes the device tensor as it is and is
    never given a host copy."""
    t0 = time.perf_counter()
    if tensor.device.type == "cuda" and dist.get_backend() == "gloo":
        out = fn(tensor.cpu()).to(tensor.device)
    else:
        out = fn(tensor)
    calls, seconds = mesh.stats.get(axis or "world", (0, 0.0))
    mesh.stats[axis or "world"] = (calls + 1, seconds + time.perf_counter() - t0)
    return out


def _quiet(mesh: Mesh, axis: str) -> bool:
    """True where a collective over ``axis`` has nothing to do: an axis of
    size 1 (one process's mesh has no other)."""
    return mesh.size(axis) == 1


def all_gather(mesh: Mesh, tensor: torch.Tensor, axis: str = DATA_AXIS) -> torch.Tensor:
    """Every ``axis`` rank's ``tensor`` (one shape on every rank),
    concatenated in axis order along dim 0."""
    if _quiet(mesh, axis):
        return tensor

    def gather(t):
        parts = [torch.empty_like(t) for _ in range(mesh.size(axis))]
        dist.all_gather(parts, t.contiguous(), group=mesh.groups[axis])
        return torch.cat(parts)

    return _collective(gather, tensor, mesh, axis)


def all_reduce_sum(mesh: Mesh, tensor: torch.Tensor, axis: Optional[str] = DATA_AXIS) -> torch.Tensor:
    """The sum of ``tensor`` over the ranks of ``axis`` (None: every rank of
    the mesh); a new tensor, the input is kept."""
    if (mesh.size(axis) if axis else mesh.world) == 1:
        return tensor

    def reduce(t):
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.groups[axis] if axis else None)
        return t

    return _collective(reduce, tensor, mesh, axis)


def barrier(mesh: Mesh) -> None:
    """Wait until every rank of the mesh has come here."""
    all_reduce_sum(mesh, torch.zeros(1, device=mesh.device), axis=None).cpu()


def _shift(mesh: Mesh, axis: str, x: torch.Tensor, shift: int) -> torch.Tensor:
    """``x`` sent to the rank ``shift`` places on along ``axis`` (cyclic),
    the tensor of the rank ``shift`` places back received: one send and one
    receive a rank, as ``lax.ppermute`` with a cyclic shift."""
    n = mesh.size(axis)
    if _quiet(mesh, axis) or shift % n == 0:
        return x.clone()
    me, line = mesh.index(axis), mesh.members[axis]
    group = mesh.groups[axis]

    def exchange(t):
        t = t.contiguous()
        out = torch.empty_like(t)
        ops = [dist.P2POp(dist.isend, t, line[(me + shift) % n], group),
               dist.P2POp(dist.irecv, out, line[(me - shift) % n], group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return out

    return _collective(exchange, x, mesh, axis)


class _PPermute(torch.autograd.Function):
    """``lax.ppermute`` with a cyclic shift; its transpose is the reverse
    shift."""

    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return _shift(mesh, axis, x, shift)

    @staticmethod
    def backward(ctx, grad):
        return _shift(ctx.mesh, ctx.axis, grad, -ctx.shift), None, None, None


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str, shift: int = 1) -> torch.Tensor:
    """Differentiable cyclic shift of ``x`` over ``axis``: rank i's ``x``
    arrives at rank (i + shift) mod n."""
    return _PPermute.apply(x, mesh, axis, shift)


class _CopyTo(torch.autograd.Function):
    """Megatron's f over ``axis``: identity forward, the cotangent summed
    over the axis backward (each rank's is a partial sum)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(ctx.mesh, grad.contiguous(), ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    """Megatron's g over ``axis``: the partial sums summed forward, the
    cotangent passed on as it is backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce_sum(mesh, x.contiguous(), axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def copy_to(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """f over ``axis``: where every rank of the axis holds ``x`` alike and
    uses it on its own part, the sum of their cotangents is ``x``'s."""
    return x if _quiet(mesh, axis) else _CopyTo.apply(x, mesh, axis)


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Megatron's f: before a column-parallel projection."""
    return copy_to(x, mesh, MODEL_AXIS)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Megatron's g: after a row-parallel projection, the model ranks'
    partial sums summed."""
    return x if _quiet(mesh, MODEL_AXIS) else _ReduceFrom.apply(x, mesh, MODEL_AXIS)


def _gather(mesh, axis, x, dim):
    n = mesh.size(axis)
    moved = x.movedim(dim, 0).contiguous()
    return all_gather(mesh, moved, axis).reshape(n * moved.shape[0], *moved.shape[1:]).movedim(0, dim)


def _block(mesh, axis, x, dim):
    b = x.shape[dim] // mesh.size(axis)
    return x.narrow(dim, mesh.index(axis) * b, b)


class _GatherAxis(torch.autograd.Function):
    """``all_gather`` over ``axis`` along ``dim``; its transpose sums every
    rank's cotangent and keeps this rank's block (``psum_scatter``)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _gather(mesh, axis, x, dim)

    @staticmethod
    def backward(ctx, grad):
        total = all_reduce_sum(ctx.mesh, grad.contiguous(), ctx.axis)
        return _block(ctx.mesh, ctx.axis, total, ctx.dim).contiguous(), None, None, None


class _SplitAxis(torch.autograd.Function):
    """This rank's block of ``x`` along ``dim``; its transpose gathers the
    blocks' cotangents over ``axis``."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _block(mesh, axis, x, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _gather(ctx.mesh, ctx.axis, grad, ctx.dim), None, None, None


class _ReplicaGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.n, None


def gather_axis(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """Differentiable all-gather of each ``axis`` rank's block along ``dim``
    (axis order); the backward sums each cotangent into the owner's block."""
    return x if _quiet(mesh, axis) else _GatherAxis.apply(x, mesh, axis, dim)


def split_axis(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (``x.shape[dim]`` divides
    over the axis); the backward gathers every block's cotangent."""
    if mesh.size(axis) == 1:
        return x
    if x.shape[dim] % mesh.size(axis):
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {axis} of size {mesh.size(axis)}")
    return _SplitAxis.apply(x, mesh, axis, dim)


def replica_grad(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``x`` as it is, for a value that every rank of ``axis`` holds from
    here on and uses alike, so that each rank's loss is the one loss: its
    cotangent is divided by the axis size, the transpose JAX's
    ``shard_map`` gives an output that the axis does not map (the ranks'
    equal cotangents, summed back into one owner, count once)."""
    n = mesh.size(axis)
    return x if n == 1 else _ReplicaGrad.apply(x, n)


def gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Differentiable ``all_gather`` of each data rank's (b, ...) rows →
    (n·b, ...): the backward sums the incoming gradient over the data ranks
    and keeps this rank's rows, so each rank's share of a loss reaches every
    rank's features."""
    return gather_axis(x, mesh, DATA_AXIS, 0)


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


def data_sharded(mesh: Mesh, rank: int = 1) -> Split:
    """The split of a leaf whose leading axis shards over ``data`` (the
    port's form of the JAX package's NamedSharding; ``rank`` is accepted
    and has no effect)."""
    return Split(DATA_AXIS, 0)


def global_put(mesh: Mesh, x, spec: Optional[Split]) -> torch.Tensor:
    """This rank's block of the full host array ``x`` under ``spec`` (a
    ``Split`` or None), on its device; every rank holds the full value."""
    block = shard_leaf(x, spec, mesh)
    t = block if isinstance(block, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(block))
    return t.to(mesh.device).contiguous()


def global_batch_from_local(mesh: Mesh, local_batch: dict) -> dict:
    """Each rank holds only its rows (rank r: global rows ``[r·b, (r+1)·b)``);
    they go to its device. The ranks' leading dims must be equal."""
    sizes = {k: np.shape(v)[0] for k, v in local_batch.items()}
    got = all_gather(mesh, torch.tensor([sizes[k] for k in sorted(sizes)], device=mesh.device))
    got = got.reshape(mesh.n_data, -1).cpu()
    if not bool((got == got[0]).all()):
        raise ValueError(f"global_batch_from_local: the ranks' local batch sizes differ: {got.tolist()}")
    return to_device(local_batch, mesh.device)


def _world_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(mesh.world)]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts)


def replicated(mesh: Mesh, tree: Any):
    """``tree`` (numpy arrays or tensors) on this rank's device, dtypes kept,
    after checking once that every rank holds the same values: each leaf's
    float64 sum and sum of squares, gathered from every rank, must agree."""
    tree = to_device(tree, mesh.device)
    leaves = tree_leaves(tree)
    if mesh.world > 1 and leaves:
        sums = torch.stack([
            torch.stack([t.double().sum(), t.double().square().sum()]) for _, t in leaves
        ])
        every = _collective(lambda t: _world_gather(mesh, t), sums[None], mesh, None).cpu()
        bad = (every != every[0]).any(dim=(0, 2)).nonzero().flatten().tolist()
        if bad:
            raise ValueError(f"replicated: the ranks hold different values at {leaves[bad[0]][0]!r} "
                             "(were they made from one seed?)")
    return tree


global_replicated = replicated
