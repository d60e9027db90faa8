"""Ring attention: exact attention over a sequence-sharded KV ring (port of
``ops/ring_attention.py``).

The sequence-parallel core (``parallel/sp.py``): each rank on the ``seq``
axis of a mesh holds its local query rows and one rotating KV block. A loop
over the axis size runs the flash-style online softmax (running row max,
running denominator, rescaled accumulator) against the current KV block,
then hands the block to the next rank with ``parallel.mesh.ppermute`` (one
send and one receive a rank). After n blocks every query row has seen every
key once; the result equals exact softmax attention up to fp reassociation.

Plain fp32 PyTorch: the JAX function has no Pallas kernel (plain einsums
that XLA fuses), so neither has this one. The gradient comes from autograd:
``ppermute``'s backward is the reverse shift, so the reverse ring is derived,
as JAX's AD derives it through ``lax.scan`` + ``lax.ppermute``. The first
n - 1 blocks each end with the hop; the last is folded without a send.

A fully masked query row (a pad row: every logit at the floor) keeps its
denominator at 0 across the blocks and emits 0, never 0/0.
"""

from __future__ import annotations

from typing import Optional

import torch

from clip_lora_match_tpu_torch.parallel.mesh import SEQ_AXIS, Mesh, ppermute

# finfo.min-style additive masks stay NaN-free through the online softmax: a
# fully masked (padded) query row keeps m at _MASK_FLOOR and l at 0, and the
# final divide is guarded so such rows emit 0 instead of 0/0
_MASK_FLOOR = -3.4e38


def ring_attention(
    qh: torch.Tensor,
    kh: torch.Tensor,
    vh: torch.Tensor,
    mesh: Mesh,
    axis_name: str = SEQ_AXIS,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Exact attention with the KV blocks rotating around ``axis_name`` of
    ``mesh`` (every rank of the axis calls it at once).

    qh/kh/vh: (B, S_loc, H, hd), this rank's block of the sequence.
    mask: additive, broadcastable to (B, 1, S_loc, S_global): the local query
        rows against ALL key columns (the ring slices the columns of each
        block's origin rank). None: dense.
    scale: hd ** -0.5 by default.

    Returns (B, S_loc, H, hd) in qh's dtype.
    """
    B, S_loc, H, hd = qh.shape
    if scale is None:
        scale = hd ** -0.5
    n, me = mesh.size(axis_name), mesh.index(axis_name)
    q32 = (qh * scale).float()
    mask32 = None if mask is None else mask.float()
    m = torch.full((B, H, S_loc, 1), _MASK_FLOOR, dtype=torch.float32, device=qh.device)
    l = torch.zeros((B, H, S_loc, 1), dtype=torch.float32, device=qh.device)
    acc = torch.zeros((B, H, S_loc, hd), dtype=torch.float32, device=qh.device)
    k_blk, v_blk = kh, vh
    for r in range(n):
        # after r hops this rank holds the KV block that started on rank
        # (me - r) mod n; its key columns sit at src·S_loc globally
        src = (me - r) % n
        s = torch.einsum("bqhd,bkhd->bhqk", q32, k_blk.float())
        if mask32 is not None:
            s = s + mask32[..., src * S_loc:(src + 1) * S_loc]
        # new_m >= _MASK_FLOOR (its start), so no exp below sees +inf
        new_m = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - new_m)
        p = torch.exp(s - new_m)
        if mask32 is not None:
            # a fully masked row keeps l == 0: without this its p would be
            # exp(0) = 1 a column (s == new_m == the floor)
            p = torch.where(s <= _MASK_FLOOR * 0.5, torch.zeros((), device=p.device), p)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bkhd->bhqd", p, v_blk.float())
        m = new_m
        if r < n - 1:
            k_blk = ppermute(k_blk, mesh, axis_name, 1)
            v_blk = ppermute(v_blk, mesh, axis_name, 1)
    out = acc / torch.where(l > 0.0, l, torch.ones((), device=l.device))
    return out.transpose(1, 2).to(qh.dtype)


def ring_attention_oracle(
    qh: torch.Tensor,
    kh: torch.Tensor,
    vh: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The single-device exact reference, with the same guard for fully
    masked rows."""
    hd = qh.shape[-1]
    if scale is None:
        scale = hd ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", (qh * scale).float(), kh.float())
    if mask is not None:
        s = s + mask.float()
    p = torch.exp(s - s.amax(-1, keepdim=True))
    if mask is not None:
        p = torch.where(s <= _MASK_FLOOR * 0.5, torch.zeros((), device=p.device), p)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bhqd", p, vh.float()) / torch.where(l > 0.0, l, torch.ones((), device=l.device))
    return out.transpose(1, 2).to(qh.dtype)
