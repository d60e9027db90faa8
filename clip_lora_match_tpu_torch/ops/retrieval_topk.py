"""Exact top-k cosine retrieval: CUDA kernel, plain version, wrapper, bands.

Port of the streaming band of ``clip_lora_match_tpu/ops/retrieval_topk.py``.
``topk_retrieve`` normalizes the raw queries (``q·rsqrt(Σq²+1e-12)``), scores
them against an L2-normalized fp32 or bf16 index in fp32, and returns
(scores (Q, k) fp32 descending, ids (Q, k) int32), ties to the lower row id.
The kernel is ``csrc/retrieval_topk.cu``. ``topk_retrieve_auto`` keeps the JAX
package's size bands; the two-pass band (N >= ``TWOPASS_MIN_N``) is not
ported yet and raises on CUDA.
"""

from __future__ import annotations

import ctypes

import torch

from clip_lora_match_tpu_torch.ops import _build

K_MAX = 256
MAX_CHUNKS = 12 * 1024  # the merge pass keeps one int head per 256-row chunk
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Band edges of the JAX package's dispatch (ops/retrieval_topk.py there).
TWOPASS_MIN_N = 65_536
MIDSCALE_MIN_N = 32_768


def _normalize(queries: torch.Tensor) -> torch.Tensor:
    q = queries.float()
    return q * torch.rsqrt((q * q).sum(1, keepdim=True) + 1e-12)


def _sorted_topk(sims: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of each row, descending, ties to the lower column."""
    s, i = torch.sort(sims, dim=1, descending=True, stable=True)
    return s[:, :k].contiguous(), i[:, :k].to(torch.int32).contiguous()


def topk_retrieve_plain(queries, index, k: int = 5):
    """The kernel's contract in plain PyTorch."""
    k = min(k, index.shape[0])
    sims = _normalize(queries) @ index.float().T
    return _sorted_topk(sims, k)


def _launch(queries, index, k: int):
    Q, D = queries.shape
    N = index.shape[0]
    if index.dtype not in _DTYPES:
        raise TypeError(f"topk_retrieve: float32 or bfloat16 index, got {index.dtype}")
    if index.shape[1] != D or index.device != queries.device:
        raise ValueError(
            f"topk_retrieve: queries {tuple(queries.shape)} and index "
            f"{tuple(index.shape)} must share D and device"
        )
    if k > K_MAX:
        raise ValueError(f"topk_retrieve kernel: k <= {K_MAX}, got {k}")
    if D > 4096:
        raise ValueError(f"topk_retrieve kernel: D <= 4096, got {D}")
    lib = _build.load("retrieval_topk")
    chunks = lib.topk_num_chunks(ctypes.c_int(N))
    if chunks > MAX_CHUNKS:
        raise ValueError(f"topk_retrieve kernel: N <= {MAX_CHUNKS * 256}, got {N}")
    q = queries.to(torch.float32).contiguous()
    index = index.contiguous()
    dev = q.device
    cand_s = torch.empty((Q, chunks, k), dtype=torch.float32, device=dev)
    cand_i = torch.empty((Q, chunks, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    rc = lib.topk_retrieve_fwd(
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(index.data_ptr()),
        ctypes.c_void_p(cand_s.data_ptr()), ctypes.c_void_p(cand_i.data_ptr()),
        ctypes.c_void_p(out_s.data_ptr()), ctypes.c_void_p(out_i.data_ptr()),
        ctypes.c_int(Q), ctypes.c_int(N), ctypes.c_int(D), ctypes.c_int(k),
        ctypes.c_int(_DTYPES[index.dtype]), ctypes.c_void_p(_build.stream_ptr(q)),
    )
    _build.check(rc, "topk_retrieve_fwd")
    topk_retrieve.launches += 1
    return out_s, out_i


def topk_retrieve(queries: torch.Tensor, index: torch.Tensor, k: int = 5):
    """Fused top-k cosine retrieval (k clamped to N). CUDA tensors launch the
    kernel; CPU tensors run ``topk_retrieve_plain``."""
    if queries.dim() != 2 or index.dim() != 2:
        raise ValueError("topk_retrieve: queries (Q, D) and index (N, D)")
    k = min(int(k), index.shape[0])
    if k < 1:
        raise ValueError(f"topk_retrieve: k >= 1 and a non-empty index, got k={k}")
    if queries.device.type == "cpu":
        return topk_retrieve_plain(queries, index, k)
    return _launch(queries, index, k)


topk_retrieve.launches = 0


def topk_retrieve_midscale(queries, index, k: int = 5):
    """Mid band: one matmul (the normalized query cast to the index dtype,
    fp32 accumulation) and an exact sorted top-k. Not a kernel: the JAX
    package runs an XLA dot here too."""
    q = queries.float()
    q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True).clamp_min(1e-12)
    sims = q.to(index.dtype).float() @ index.float().T
    return _sorted_topk(sims, min(k, index.shape[0]))


def topk_retrieve_auto(queries, index, k: int = 5):
    """Size bands of the JAX package: streaming kernel below
    ``MIDSCALE_MIN_N`` (and for fp32 up to ``TWOPASS_MIN_N``), the mid-band
    matmul for bf16 in between, two-pass at and above ``TWOPASS_MIN_N``."""
    n = index.shape[0]
    if n >= TWOPASS_MIN_N:
        if index.device.type == "cuda":
            raise NotImplementedError(
                f"N={n} >= {TWOPASS_MIN_N} needs the two-pass tile-max kernels "
                "(_tilemax_pallas, _tilemax_sup_pallas), which are not ported "
                "to CUDA yet"
            )
        return topk_retrieve_plain(queries, index, k)
    if n >= MIDSCALE_MIN_N and index.dtype == torch.bfloat16:
        return topk_retrieve_midscale(queries, index, k)
    return topk_retrieve(queries, index, k)
