"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: they need an NVIDIA GPU with nvcc and skip elsewhere. Run on
the card with ``python -m pytest tests/test_torch_cuda.py -q -m cuda``. These
cover the edges the main-path shapes in chip_smoke.py do not: ragged tiles,
the largest rank / sequence / k each kernel takes, fully masked rows, shared
and per-batch additive masks, index sizes that are no multiple of a tile or
a block, rows declared invalid, D = 1024 for the int8 index, small attention
at every S from 1 to 128 that straddles a 16-row tile under every mask mode
(fully masked and zero-length rows included) and on an unaligned view, flash
attention from S = 1 to 577 under every mask kind at the phase-2 shapes in
both types (3xTF32 for fp32), the fused MLP from one row to a 32-image batch
at every CLIP width through the wgmma body, every hidden split count,
bit-equal reruns, ragged and unaligned inputs through the WMMA body (each
test checks the body the wrapper's plan picks), the LoRA matmul's grouped
q/k/v launch from one row to a 96-image batch (its (3, M, N) slabs against
per-projection launches), every tile, every rank up to R_MAX through both
bf16 bodies, the attention layer's grouping only up to R_MAX, the top-k
kernel at every query tile its plan picks (Q from 1 to 100, k from 1 to 256,
both index types, D = 512 and 768 through the bulk and cp.async rings and
D = 102 or a misaligned base through the plain body, N from 1 to 44,441),
equal rows across blocks going to the lower id, bit-equal reruns, its body
counts, a k = 300 search through SearchIndex on the mid-band route, the
pass-1 tile-max kernels on both bodies of their plan (Q from 1 to 130 across
the switch at 9, D from 64 to 1024, tiles 8 and 16 on the mma body and odd
tiles on the CUDA-core body, N no multiple of a tile, a round or a group,
pad rows scoring 0, group maxima equal to the maxima of the kernel's own tile
maxima, the two-pass route against the plain route at Q = 64), and the
wrappers' refusals. Each kernel test asserts that the wrapper's launch
counter moved. The YOLO crop stage (no kernel of its own: cuDNN convs) is
held against its CPU run: the committed detector in fp32 and bf16,
``nms_fixed``, the device crop, and the fused search through
``topk_retrieve``. The W8A8 int8 product (``torch._int_mm``, a library call)
is held against its CPU run at M = 1 to 577 (padded below 17 rows), a PEFT
adapter is loaded onto the card, and a quantized encoder launches neither
``lora_matmul`` nor ``mlp_fused``.
"""

import pytest
import torch

from clip_lora_match_tpu_torch.ops import _build
from clip_lora_match_tpu_torch.ops import attention_small as A
from clip_lora_match_tpu_torch.ops import flash_attention as F
from clip_lora_match_tpu_torch.ops import lora_matmul as L
from clip_lora_match_tpu_torch.ops import mlp_fused as MF
from clip_lora_match_tpu_torch.ops import retrieval_topk as R

pytestmark = pytest.mark.cuda

NEG = torch.finfo(torch.float32).min


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rand(gen, *shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(*shape, device="cuda", generator=gen) * scale).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,S,H,mode",
    [(2, 1, 2, "none"), (3, 33, 3, "none"), (2, 128, 2, "none"),
     (3, 77, 2, "lengths"), (2, 80, 4, "causal"), (2, 50, 2, "shared_mask"),
     (2, 50, 2, "batch_mask")],
)
def test_attention_small_kernel(gen, B, S, H, mode, dtype):
    q, k, v = (_rand(gen, B, S, H, 64, dtype=dtype) for _ in range(3))
    kw = {}
    if mode == "lengths":
        kw = dict(causal=True, lengths=torch.tensor([S, 9, 0], device="cuda", dtype=torch.int32))
    elif mode == "causal":
        kw = dict(causal=True)
    elif mode == "shared_mask":
        m = torch.zeros(1, 1, S, S, device="cuda")
        m[..., S // 2:] = NEG
        kw = dict(mask=m)
    elif mode == "batch_mask":
        m = torch.zeros(B, 1, S, S, device="cuda")
        m[1, 0, 3, :] = NEG  # a fully masked query row
        kw = dict(mask=m)
    got = A.attention_small(q, k, v, **kw)
    ref = A.attention_small_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    atol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=0)
    if mode == "batch_mask":
        assert torch.all(got[1, 3] == 0)
    if mode == "lengths":
        assert torch.all(got[2] == 0)


def _attn_kwargs(mode, B, S):
    """Keyword arguments of one mask mode; each masked mode holds a fully masked
    query row (batch row 1, query 0) or a zero-length row (batch row 1)."""
    if mode == "none":
        return {}
    if mode == "causal":
        return dict(causal=True)
    if mode == "lengths":  # causal + key lengths: batch row 1 has none
        return dict(causal=True, lengths=torch.tensor([S, 0] + [max(1, S // 2)] * (B - 2),
                                                      device="cuda", dtype=torch.int32))
    m = torch.zeros(B if mode == "batch_mask" else 1, 1, S, S, device="cuda")
    m[..., (S + 1) // 2:] = NEG  # keys past the middle masked for every row
    if mode == "batch_mask":
        m[1, 0, 0, :] = NEG  # query 0 of batch row 1 sees nothing
    return dict(mask=m)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["none", "causal", "lengths", "shared_mask", "batch_mask"])
@pytest.mark.parametrize("S", [1, 15, 16, 17, 50, 64, 77, 128])
def test_attention_small_kernel_every_length(gen, S, mode, dtype):
    B, H = 3, 2
    q, k, v = (_rand(gen, B, S, H, 64, dtype=dtype) for _ in range(3))
    kw = _attn_kwargs(mode, B, S)
    before = A.attention_small.launches
    got = A.attention_small(q, k, v, **kw)
    assert A.attention_small.launches == before + 1
    ref = A.attention_small_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    atol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=0)
    if mode == "lengths":
        assert torch.all(got[1] == 0)
    if mode == "batch_mask":
        assert torch.all(got[1, 0] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H", [(1, 50, 12), (96, 50, 12), (256, 77, 8)])
def test_attention_small_kernel_at_request_and_batch_shapes(gen, B, S, H, dtype):
    # one warp per block at a request, the whole head per block at a batch
    q, k, v = (_rand(gen, B, S, H, 64, dtype=dtype) for _ in range(3))
    causal = S == 77
    got = A.attention_small(q, k, v, causal=causal)
    ref = A.attention_small_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    atol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_small_kernel_on_an_unaligned_view(gen, dtype):
    # q starts one element into its storage: the kernel stages element by element
    B, S, H = 2, 50, 3
    n = B * S * H * 64
    q = _rand(gen, n + 1, dtype=dtype)[1:].view(B, S, H, 64)
    k, v = (_rand(gen, B, S, H, 64, dtype=dtype) for _ in range(2))
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    for kw in ({}, dict(causal=True)):
        got = A.attention_small(q, k, v, **kw)
        ref = A.attention_small_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        atol = 1e-5 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "M,K,N,r",
    [(1, 1, 1, 1), (65, 130, 70, 8), (33, 96, 80, 20), (257, 768, 3072, 32), (50, 768, 768, 8)],
)
def test_lora_matmul_kernel(gen, M, K, N, r, dtype):
    x = _rand(gen, M, K, dtype=dtype)
    w = _rand(gen, K, N, dtype=dtype, scale=K ** -0.5)
    a = _rand(gen, K, r, dtype=dtype, scale=K ** -0.5)
    b = _rand(gen, r, N, dtype=dtype, scale=0.1)
    got = L.lora_matmul(x, w, a, b, 2.0)
    ref = L.lora_matmul_plain(x, w, a, b, 2.0)
    torch.cuda.synchronize()
    scale = ref.float().abs().max().item() + 1e-6
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert (got.float() - ref.float()).abs().max().item() <= tol * scale


@pytest.mark.parametrize("groups", [1, 3])
def test_lora_matmul_kernel_on_an_unaligned_view(gen, groups):
    # a contiguous view that starts one element into its storage: no TMA, the
    # WMMA body takes it, and its tile loads must not assume 16-byte alignment
    M, K, N, r = 70, 64, 64 * groups, 8
    bf = torch.bfloat16
    x = _rand(gen, M * K + 1, dtype=bf)[1:].view(M, K)
    w = _rand(gen, K, N, dtype=bf, scale=K ** -0.5)
    a = _rand(gen, K, r, dtype=bf, scale=K ** -0.5)
    b = _rand(gen, r, N, dtype=bf, scale=0.1)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    assert L.plan(M, N, K, r, bf, False, _build.sm_count(x.device), groups).body == "wmma"
    got = L.lora_matmul(x, w, a, b, 2.0, groups=groups)
    ref = L.lora_matmul_plain(x, w, a, b, 2.0, groups=groups)
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert (got.float() - ref.float()).abs().max().item() <= 1e-2 * ref.float().abs().max().item()


def _lora_group(gen, K, N, r, dtype=torch.bfloat16):
    """Three projections' operands and their grouped form, as the serving copy
    builds it (A held as the transposed view of a contiguous (r, K) tensor)."""
    from clip_lora_match_tpu_torch.nn.layers import QKV, group_qkv

    per = [(_rand(gen, K, N, dtype=dtype, scale=K ** -0.5),
            _rand(gen, r, K, dtype=dtype, scale=K ** -0.5).t(),
            _rand(gen, r, N, dtype=dtype, scale=0.1)) for _ in QKV]
    g = group_qkv({n: {"kernel": t[0]} for n, t in zip(QKV, per)},
                  {n: {"a": t[1], "b": t[2]} for n, t in zip(QKV, per)})
    return per, (g["kernel"], g["a"], g["b"])


def _assert_lora_close(got, ref):
    # bf16: one bf16 step of the output, or of a rank-r partial that rounds the other way
    assert got.shape == ref.shape and got.dtype == ref.dtype
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 1e-2 * (ref.float().abs().max().item() + 1e-6), f"max err {err}"


@pytest.mark.parametrize("KN", [768, 512, 1024], ids=["B32_image_L14_text", "B32_text", "L14_image"])
@pytest.mark.parametrize("M", [1, 50, 64, 577, 4_800])
def test_lora_matmul_grouped_qkv(gen, M, KN):
    # one launch for q, k and v: (3, M, N) out, each slab the projection's own
    # product (against its own launch too), through the wgmma body
    per, (w, a, b) = _lora_group(gen, KN, KN, 8)
    x = _rand(gen, M, KN, dtype=torch.bfloat16)
    assert L.plan(M, 3 * KN, KN, 24, torch.bfloat16, True, _build.sm_count(x.device), 3).body == "wgmma"
    before = L.lora_matmul.launches
    got = L.lora_matmul(x, w, a, b, 2.0, groups=3)
    assert L.lora_matmul.launches == before + 1
    assert got.shape == (3, M, KN) and got.is_contiguous()
    _assert_lora_close(got, L.lora_matmul_plain(x, w, a, b, 2.0, groups=3))
    for i, (wi, ai, bi) in enumerate(per):
        _assert_lora_close(got[i], L.lora_matmul(x, wi, ai, bi, 2.0))
    torch.cuda.synchronize()


@pytest.mark.parametrize("M,K,N,groups", [(64, 768, 2304, 3), (50, 1024, 1024, 1), (7, 512, 1536, 3)])
def test_lora_matmul_every_split_and_tile(gen, M, K, N, groups):
    # each tile shape the plan can give (K is not split): held to the plain
    # version and run twice bit-equal
    from clip_lora_match_tpu_torch.ops.lora_matmul import Plan

    r = 8 * groups
    x = _rand(gen, M, K, dtype=torch.bfloat16)
    if groups == 3:
        _, (w, a, b) = _lora_group(gen, K, N // 3, 8)
    else:
        w = _rand(gen, K, N, dtype=torch.bfloat16, scale=K ** -0.5)
        a = _rand(gen, r, K, dtype=torch.bfloat16, scale=K ** -0.5).t()
        b = _rand(gen, r, N, dtype=torch.bfloat16, scale=0.1)
    ref = L.lora_matmul_plain(x, w, a, b, 2.0, groups=groups)
    plans = [Plan("wgmma", bm, bn) for bm, bn in L._TILES]
    at = a.t().contiguous()
    for p in plans:
        got = L._run(x, w, at, b, 2.0, groups, p)
        again = L._run(x, w, at, b, 2.0, groups, p)
        torch.cuda.synchronize()
        assert torch.equal(got, again), f"{p}: two runs differ"
        _assert_lora_close(got if groups > 1 else got.view(M, N), ref)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("r", [1, 8, 16, 17, 24, 33, 48, 64])
def test_lora_matmul_every_rank_up_to_r_max(gen, r, aligned):
    M, K, N = 100, 512, 384
    bf = torch.bfloat16
    x = _rand(gen, M, K, dtype=bf)
    if not aligned:
        x = _rand(gen, M * K + 1, dtype=bf)[1:].view(M, K)
    w = _rand(gen, K, N, dtype=bf, scale=K ** -0.5)
    a = _rand(gen, K, r, dtype=bf, scale=K ** -0.5)
    b = _rand(gen, r, N, dtype=bf, scale=0.1)
    assert r <= L.R_MAX
    body = L.plan(M, N, K, r, bf, aligned, _build.sm_count(x.device)).body
    assert body == ("wgmma" if aligned else "wmma")
    _assert_lora_close(L.lora_matmul(x, w, a, b, 2.0), L.lora_matmul_plain(x, w, a, b, 2.0))
    torch.cuda.synchronize()
    with pytest.raises(ValueError):
        L.lora_matmul(x, w, _rand(gen, K, L.R_MAX + 1, dtype=bf), _rand(gen, L.R_MAX + 1, N, dtype=bf))


@pytest.mark.parametrize("M,KN", [(50, 768), (577, 1024)])
def test_lora_matmul_grouped_is_bit_equal_across_runs(gen, M, KN):
    # no atomics, one block per output tile: the same bits each run
    _, (w, a, b) = _lora_group(gen, KN, KN, 8)
    x = _rand(gen, M, KN, dtype=torch.bfloat16)
    first = L.lora_matmul(x, w, a, b, 2.0, groups=3)
    for _ in range(2):
        assert torch.equal(L.lora_matmul(x, w, a, b, 2.0, groups=3), first)


@pytest.mark.parametrize("r", [8, 21, 22, 32])
def test_attention_groups_qkv_only_up_to_r_max(gen, r):
    # q/k/v group while 3r fits under R_MAX (2 launches: q/k/v, out_proj);
    # past it each projection launches on its own (4), against the plain path
    from clip_lora_match_tpu_torch.nn import layers as T

    D, H, bf = 128, 2, torch.bfloat16
    names = T.QKV + ("out_proj",)
    p = {n: {"kernel": _rand(gen, D, D, dtype=bf, scale=D ** -0.5),
             "bias": _rand(gen, D, dtype=bf, scale=0.1)} for n in names}
    lora = {n: {"a": _rand(gen, D, r, dtype=bf, scale=D ** -0.5),
                "b": _rand(gen, r, D, dtype=bf, scale=0.1)} for n in names}
    group = T.group_qkv(p, lora, bf)
    grouped = 3 * r <= L.R_MAX
    assert (group is not None) == grouped
    x = _rand(gen, 2, 50, D, dtype=bf)
    with T.kernel_flags(fused_lora="auto", small_attention=False, flash_attention=False):
        before = L.lora_matmul.launches
        got = T.attention(p, x, H, lora={**lora, "qkv": group} if grouped else lora, lora_scaling=2.0)
        assert L.lora_matmul.launches - before == (2 if grouped else 4)
    with T.kernel_flags(fused_lora=False):
        ref = T.attention(p, x, H, lora=lora, lora_scaling=2.0)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    assert got.shape == ref.shape and err <= 2e-2 * ref.float().abs().max().item(), f"max err {err}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Q,N,D,k", [(1, 1, 8, 1), (9, 257, 40, 7), (3, 5000, 512, 256), (17, 3001, 64, 10)])
def test_topk_retrieve_kernel(gen, Q, N, D, k, dtype):
    index = torch.nn.functional.normalize(_rand(gen, N, D), dim=1).to(dtype)
    queries = _rand(gen, Q, D)
    s, i = R.topk_retrieve(queries, index, k)
    rs, ri = R.topk_retrieve_plain(queries, index, k)
    torch.cuda.synchronize()
    torch.testing.assert_close(s, rs, atol=1e-5, rtol=0)
    # ids equal except where plain scores are within 1e-5 of a neighbour
    near = torch.zeros_like(rs, dtype=torch.bool)
    if k > 1:
        close = (rs[:, :-1] - rs[:, 1:]) <= 1e-5
        near[:, :-1] |= close
        near[:, 1:] |= close
    assert torch.equal(i[~near], ri[~near])


def test_topk_retrieve_kernel_ties_take_the_lower_id(gen):
    index = torch.nn.functional.normalize(_rand(gen, 1000, 64), dim=1)
    index[700] = index[3]
    index[300] = index[3]
    s, i = R.topk_retrieve(index[3:4] * 2, index, 3)
    assert i[0].tolist() == [3, 300, 700]


def _assert_topk_matches_plain(s, i, rs, ri, what=""):
    """Scores within 1e-5 of the plain version; ids equal except where the
    plain scores are within 1e-5 of a neighbour (chip_smoke.py's rule)."""
    assert s.shape == rs.shape and i.shape == ri.shape, what
    torch.testing.assert_close(s, rs, atol=1e-5, rtol=0, msg=what)
    near = torch.zeros_like(rs, dtype=torch.bool)
    if rs.shape[1] > 1:
        close = (rs[:, :-1] - rs[:, 1:]) <= 1e-5
        near[:, :-1] |= close
        near[:, 1:] |= close
    assert torch.equal(i[~near], ri[~near]), what


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 5, 64, 256])
@pytest.mark.parametrize("Q", [1, 3, 8, 9, 64, 100])
def test_topk_retrieve_every_body_tile_and_ragged_n(gen, Q, k, dtype):
    """Every query tile the plan picks (rows body at Q <= 8, the tile body
    above), D = 512 and 768 through the bulk / cp.async rings and D = 102
    (a row pitch no multiple of 16 bytes) through the plain body, and N = 1,
    k, 257 and 44,441 rows."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    base = torch.nn.functional.normalize(_rand(gen, 44_441, 768), dim=1)
    queries = _rand(gen, Q, 768)
    for D in (512, 768, 102):
        for N in (1, k, 257, 44_441):
            index = torch.nn.functional.normalize(base[:N, :D], dim=1).to(dtype).contiguous()
            q = queries[:, :D].contiguous()
            p = R.plan(Q, N, D, min(k, N), dtype, True, sms)
            before = dict(R.topk_retrieve.bodies)
            s, i = R.topk_retrieve(q, index, k)
            rs, ri = R.topk_retrieve_plain(q, index, k)
            torch.cuda.synchronize()
            assert R.topk_retrieve.bodies[p.body] == before[p.body] + 1
            assert p.body == ("plain" if D == 102 else "tile" if Q > 8 and p.qt >= 32 else "rows")
            _assert_topk_matches_plain(s, i, rs, ri, f"D={D} N={N} {p}")


@pytest.mark.parametrize("Q", [1, 3, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topk_retrieve_duplicate_rows_take_the_lower_id(gen, Q, dtype):
    """Equal rows score bit-equal in every body, so ties go to the lower id,
    across blocks too (copies 40,000 rows apart)."""
    index = torch.nn.functional.normalize(_rand(gen, 44_441, 512), dim=1).to(dtype)
    for dst in (300, 700, 20_000, 44_000):
        index[dst] = index[3]
    queries = index[3:4].float().repeat(Q, 1) * 2.0
    for idx in (index, _misaligned(index)):
        s, i = R.topk_retrieve(queries, idx, 8)
        torch.cuda.synchronize()
        assert (i[:, :5] == torch.tensor([3, 300, 700, 20_000, 44_000], device="cuda",
                                         dtype=torch.int32)).all(), i[:, :5]
        assert (s[:, :5] == s[:, :1]).all()


def _misaligned(index):
    """The same rows at a base 4 bytes past a 16-byte boundary (the plain body)."""
    flat = torch.empty(index.numel() + 8, dtype=index.dtype, device=index.device)
    off = 4 // index.element_size()
    view = flat[off:off + index.numel()].view(index.shape)
    view.copy_(index)
    assert view.data_ptr() % 16 != 0
    return view


@pytest.mark.parametrize("Q,k,dtype", [(1, 5, torch.float32), (1, 64, torch.bfloat16),
                                       (64, 5, torch.float32), (64, 64, torch.bfloat16),
                                       (9, 256, torch.float32)])
def test_topk_retrieve_reruns_are_bit_equal(gen, Q, k, dtype):
    index = torch.nn.functional.normalize(_rand(gen, 44_441, 512), dim=1).to(dtype)
    queries = _rand(gen, Q, 512)
    s1, i1 = R.topk_retrieve(queries, index, k)
    s2, i2 = R.topk_retrieve(queries, index, k)
    torch.cuda.synchronize()
    assert torch.equal(s1, s2) and torch.equal(i1, i2)


def test_topk_retrieve_counts_each_body(gen):
    index = torch.nn.functional.normalize(_rand(gen, 5000, 512), dim=1)
    before = dict(R.topk_retrieve.bodies)
    launches = R.topk_retrieve.launches
    for queries, idx, body in ((_rand(gen, 1, 512), index, "rows"),
                               (_rand(gen, 64, 512), index, "tile"),
                               (_rand(gen, 2, 512), _misaligned(index), "plain")):
        s, i = R.topk_retrieve(queries, idx, 10)
        rs, ri = R.topk_retrieve_plain(queries, idx, 10)
        torch.cuda.synchronize()
        _assert_topk_matches_plain(s, i, rs, ri, body)
    assert {b: R.topk_retrieve.bodies[b] - before[b] for b in before} == {
        "rows": 1, "tile": 1, "plain": 1}
    assert R.topk_retrieve.launches - launches == 3


def test_search_index_past_k_max_takes_the_mid_band_route(gen):
    """k = 300 through SearchIndex over 44,446 fp32 rows on the card: 300
    results equal to the plain route, and no kernel launch (the kernel's own
    k <= 256 refusal stays)."""
    import numpy as np

    from clip_lora_match_tpu_torch.index.store import EmbeddingIndex
    from clip_lora_match_tpu_torch.retrieval.search import SearchIndex

    rows = torch.nn.functional.normalize(_rand(gen, 44_446, 512), dim=1).cpu().numpy()
    index = EmbeddingIndex(rows, device="cuda")
    query = rows[17] + 0.1 * np.random.default_rng(0).standard_normal(512).astype(np.float32)
    launches = R.topk_retrieve.launches
    res = SearchIndex(index).search_with_embedding(query, 300)
    assert R.topk_retrieve.launches == launches and len(res) == 300 and res[0].index == 17
    rs, ri = R.topk_retrieve_plain(torch.from_numpy(query)[None].cuda(), index.embeddings, 300)
    got_s = torch.tensor([[r.score for r in res]], device="cuda")
    got_i = torch.tensor([[r.index for r in res]], device="cuda", dtype=torch.int32)
    _assert_topk_matches_plain(got_s, got_i, rs, ri)


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    q = _rand(gen, 1, 8, 2, 32)
    with pytest.raises(ValueError):
        A.attention_small(q, q, q)  # head_dim 32
    h = torch.float16
    with pytest.raises(TypeError):
        L.lora_matmul(_rand(gen, 4, 8, dtype=h), _rand(gen, 8, 8, dtype=h),
                      _rand(gen, 8, 2, dtype=h), _rand(gen, 2, 8, dtype=h))
    with pytest.raises(ValueError):
        R.topk_retrieve(_rand(gen, 1, 8), _rand(gen, 300, 8), 300)  # k > 256


def test_launch_counters_count_kernel_launches(gen):
    from clip_lora_match_tpu_torch import ops

    ops.reset_launch_counts()
    q = _rand(gen, 1, 5, 2, 64)
    A.attention_small(q, q, q)
    A.attention_small(q.cpu(), q.cpu(), q.cpu())  # CPU: the plain version, no launch
    R.topk_retrieve(_rand(gen, 1, 8), torch.nn.functional.normalize(_rand(gen, 20, 8), dim=1), 2)
    R.tilemax(_rand(gen, 2, 16), _rand(gen, 40, 16), 16)
    F.flash_attention(q, q, q)
    MF.mlp_fused(q[0, :, 0].cpu(), torch.randn(64, 8), torch.randn(8), torch.randn(8, 4), torch.randn(4))
    assert ops.launch_counts() == {
        "attention_small": 1, "lora_matmul": 0, "topk_retrieve": 1,
        "tilemax": 1, "tilemax_sup": 0, "tilemax_sup_q8": 0,
        "mlp_fused": 0, "flash_attention": 1,
    }


def test_a_cpu_encoder_leaves_the_card_encoders_kernels_on(gen):
    import numpy as np

    from clip_lora_match_tpu_torch import ops
    from clip_lora_match_tpu_torch.core.config import ClipArchConfig, ClipConfig, LoraConfig
    from clip_lora_match_tpu_torch.lora.adapter import init_lora
    from clip_lora_match_tpu_torch.models.clip import init_params
    from clip_lora_match_tpu_torch.models.encoder import ClipEncoder

    arch = ClipArchConfig(
        image_size=64, patch_size=32, vision_width=128, vision_layers=2, vision_heads=2,
        vision_mlp_dim=256, text_width=128, text_layers=2, text_heads=2, text_mlp_dim=256,
        projection_dim=64,
    )
    lcfg = LoraConfig()
    encs = {}
    for dev in ("cuda", "cpu"):  # the CPU encoder is built after the card's
        enc = ClipEncoder(init_params(0, arch, device=dev), arch=arch,
                          config=ClipConfig(arch=arch), device=dev)
        enc.attach_lora(init_lora(1, arch, lcfg, device=dev), lcfg.scaling)
        encs[dev] = enc
    pix = np.zeros((1, 64, 64, 3), np.float32)
    per_pair = {  # 2 towers x 2 layers (grouped q/k/v + out_proj); flash and the fused MLP are off by default
        "attention_small": 4, "lora_matmul": 8, "topk_retrieve": 0,
        "tilemax": 0, "tilemax_sup": 0, "tilemax_sup_q8": 0,
        "mlp_fused": 0, "flash_attention": 0,
    }
    ops.reset_launch_counts()
    for dev in ("cuda", "cpu", "cuda"):
        encs[dev].encode_text("tas pink")
        encs[dev].encode_image_batch(pix)
    assert ops.launch_counts() == {k: 2 * v for k, v in per_pair.items()}


def _unit_index(gen, N, D, dtype=torch.float32):
    return torch.nn.functional.normalize(_rand(gen, N, D), dim=1).to(dtype)


def _qc(gen, Q, D, dtype):
    return R._normalize(_rand(gen, Q, D)).to(dtype)


def _assert_body(wrapper, before, qc, index, tile, group):
    """The wrapper ran the body its plan picks, once."""
    p = R.tilemax_plan(qc.shape[0], index.shape[0], index.shape[1], index.dtype, tile, group,
                       _build.sm_count(qc.device))
    assert {b: wrapper.bodies[b] - before[b] for b in before} == {
        b: int(b == p.body) for b in before}
    return p


# Q across the body switch (8 | 9) and ragged query blocks; N no multiple of
# the tile, of a block's rows or of a round; D from 64 to the L/14 index and
# 1024 (fp32: a query block of 32); tiles 8 and 16 on the mma body, odd tiles
# on the CUDA-core body
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Q,N,D,tile", [(1, 1, 128, 16), (7, 4097, 128, 16), (64, 70_001, 512, 16),
                                         (3, 1000, 256, 8), (9, 5003, 64, 32),
                                         (8, 4099, 512, 16), (9, 4097, 64, 16), (16, 10_007, 512, 8),
                                         (63, 70_001, 768, 16), (64, 33_333, 1024, 8), (65, 20_011, 1024, 16),
                                         (130, 20_013, 512, 16), (16, 1, 64, 8), (64, 5003, 768, 5)])
def test_tilemax_kernel(gen, Q, N, D, tile, dtype):
    qc, index = _qc(gen, Q, D, dtype), _unit_index(gen, N, D, dtype)
    before = dict(R.tilemax.bodies)
    got = R.tilemax(qc, index, tile)
    p = _assert_body(R.tilemax, before, qc, index, tile, None)
    assert p.body == ("mma" if Q >= 9 and tile in (8, 16) else "cuda_core")
    ref = R.tilemax_plain(qc, index, tile)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (Q, -(-N // tile))
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Q,N,D,tile,group", [(1, 4096, 512, 16, 16), (7, 8692, 512, 16, 16),
                                               (64, 70_003, 512, 16, 8), (2, 33, 512, 16, 16),
                                               (9, 8692, 64, 16, 16), (16, 70_003, 768, 8, 16),
                                               (63, 100_001, 512, 16, 32), (65, 40_961, 1024, 16, 16),
                                               (130, 30_011, 512, 8, 3), (64, 33, 768, 16, 16),
                                               (64, 9001, 512, 12, 16)])
def test_tilemax_sup_kernel(gen, Q, N, D, tile, group, dtype):
    qc, index = _qc(gen, Q, D, dtype), _unit_index(gen, N, D, dtype)
    before = dict(R.tilemax_sup.bodies)
    tmax, gmax = R.tilemax_sup(qc, index, tile, group)
    p = _assert_body(R.tilemax_sup, before, qc, index, tile, group)
    assert p.body == ("mma" if Q >= 9 and tile in (8, 16) else "cuda_core")
    rt, rg = R.tilemax_sup_plain(qc, index, tile, group)
    torch.cuda.synchronize()
    torch.testing.assert_close(tmax, rt, atol=1e-5, rtol=0)
    torch.testing.assert_close(gmax, rg, atol=1e-5, rtol=0)
    # the group maxima are maxima of the kernel's own tile maxima
    assert torch.equal(gmax, R._group_max(tmax, group))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Q,tile", [(1, 16), (1, 8), (16, 16), (16, 8), (64, 16), (64, 8)])
def test_tilemax_pad_rows_score_zero(gen, Q, tile, dtype):
    """Every real row scores below 0, so the last tile's maximum is its pad
    rows' 0 and every other tile's is negative, on both bodies."""
    N, D = 64 * tile + 3, 512
    qc = R._normalize(_rand(gen, Q, D).abs() + 0.1).to(dtype)
    index = (-torch.nn.functional.normalize(_rand(gen, N, D).abs() + 0.1, dim=1)).to(dtype)
    tmax = R.tilemax(qc, index, tile)
    tmax_s, gmax = R.tilemax_sup(qc, index, tile, 16)
    torch.cuda.synchronize()
    assert torch.equal(tmax, tmax_s)
    assert (tmax[:, -1] == 0).all() and (tmax[:, :-1] < 0).all()
    assert (gmax[:, -1] == 0).all() and (gmax[:, :-1] < 0).all()
    torch.testing.assert_close(tmax, R.tilemax_plain(qc, index, tile), atol=1e-5, rtol=0)


# Q across the body switch and ragged query blocks (17, 33, 65, 130); N no
# multiple of 256 nor of a group's rows; D from one k-chunk (64: a round's
# scales loaded in the step of its epilogue) to the 1024 of the exactness
# bound; groups of 3, 8 and 16
@pytest.mark.parametrize("mxu", ["int8", "bf16"])
@pytest.mark.parametrize("Q,N,D,group", [(1, 4096, 512, 16), (7, 8692, 1024, 16), (64, 70_009, 512, 8),
                                          (5, 17, 128, 16), (9, 4099, 512, 16), (16, 10_007, 768, 8),
                                          (17, 8692, 1024, 16), (33, 70_009, 512, 16),
                                          (64, 33_333, 768, 16), (65, 20_011, 1024, 8),
                                          (130, 30_011, 512, 3), (16, 5003, 64, 16), (64, 4097, 128, 16),
                                          (64, 1_048_586, 512, 16)])
def test_tilemax_sup_q8_kernel_is_bit_equal(gen, Q, N, D, group, mxu):
    values, scales = R.quantize_index_int8(_unit_index(gen, N, D))
    qq, _ = R._quantize_queries(_rand(gen, Q, D))
    before = dict(R.tilemax_sup_q8.bodies)
    tmax, gmax = R.tilemax_sup_q8(qq, values, scales, 16, group, mxu)
    p = _assert_body(R.tilemax_sup_q8, before, qq, values, 16, group)
    assert p.body == ("mma" if Q >= 9 and D % 64 == 0 else "cuda_core")
    rt, rg = R.tilemax_sup_q8_plain(qq, values, scales, 16, group)
    torch.cuda.synchronize()
    assert torch.equal(tmax, rt) and torch.equal(gmax, rg)


@pytest.mark.parametrize("tile", [8, 16])
@pytest.mark.parametrize("D", [512, 1024])
def test_tilemax_sup_q8_both_bodies_are_bit_equal_at_q16(gen, D, tile):
    """Each body forced through the private launcher with its own plan."""
    N, group = 70_009, 16
    values, scales = R.quantize_index_int8(_unit_index(gen, N, D))
    qq, _ = R._quantize_queries(_rand(gen, 16, D))
    rt, rg = R.tilemax_sup_q8_plain(qq, values, scales, tile, group)
    mma = R.tilemax_plan(16, N, D, torch.int8, tile, group, _build.sm_count(qq.device))
    core = R.tilemax_plan(8, N, D, torch.int8, tile, group, _build.sm_count(qq.device))
    assert (mma.body, core.body) == ("mma", "cuda_core")
    for p in (mma, core):  # the CUDA-core body takes its query block and grid from Q
        tmax, gmax = R._pass1_launch(qq, values, tile, group, p, scales)
        torch.cuda.synchronize()
        assert torch.equal(tmax, rt) and torch.equal(gmax, rg), p.body


@pytest.mark.parametrize("Q,tile", [(1, 16), (1, 8), (16, 16), (16, 8), (64, 16), (64, 8)])
def test_tilemax_sup_q8_pad_rows_score_zero(gen, Q, tile):
    """Every real row scores below 0, so the last tile's maximum is its pad
    rows' 0 and every other tile's is negative, on both bodies."""
    N, D = 64 * tile + 3, 512
    values, scales = R.quantize_index_int8(
        -torch.nn.functional.normalize(_rand(gen, N, D).abs() + 0.1, dim=1))
    qq, _ = R._quantize_queries(_rand(gen, Q, D).abs() + 0.1)
    tmax, gmax = R.tilemax_sup_q8(qq, values, scales, tile, 16)
    torch.cuda.synchronize()
    assert (tmax[:, -1] == 0).all() and (tmax[:, :-1] < 0).all()
    assert (gmax[:, -1] == 0).all() and (gmax[:, :-1] < 0).all()
    rt, rg = R.tilemax_sup_q8_plain(qq, values, scales, tile, 16)
    assert torch.equal(tmax, rt) and torch.equal(gmax, rg)


def _ids_equal_where_apart(s, i, rs, ri, tol=1e-5):
    near = torch.zeros_like(rs, dtype=torch.bool)
    if rs.shape[1] > 1:
        close = (rs[:, :-1] - rs[:, 1:]) <= tol
        near[:, :-1] |= close
        near[:, 1:] |= close
    assert torch.equal(i[~near], ri[~near])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Q,N,k,n_valid,group", [(1, 70_001, 1, None, None), (7, 70_001, 64, 69_000, None),
                                                  (64, 300_007, 10, None, 16), (3, 40_000, 5, 39_990, 8),
                                                  (64, 300_007, 5, None, 16), (64, 150_011, 64, 149_000, None),
                                                  (64, 1_048_586, 64, None, None), (16, 524_298, 5, None, None)])
def test_twopass_kernel_route_matches_plain_route(gen, Q, N, k, n_valid, group, dtype):
    index = _unit_index(gen, N, 512, dtype)
    queries = _rand(gen, Q, 512)
    s, i = R.topk_retrieve_twopass(queries, index, k, n_valid=n_valid, group=group)
    rs, ri = R.topk_retrieve_twopass(queries, index, k, n_valid=n_valid, pallas_pass1=False)
    torch.cuda.synchronize()
    torch.testing.assert_close(s, rs, atol=1e-5, rtol=0)
    _ids_equal_where_apart(s, i, rs, ri)
    if n_valid is not None:
        assert i.max().item() < n_valid


@pytest.mark.parametrize("Q,N,D,k,n_valid", [(1, 300_001, 512, 1, None), (64, 270_000, 512, 64, 269_000),
                                              (7, 70_000, 1024, 10, None)])
def test_q8_kernel_route_equals_plain_route(gen, Q, N, D, k, n_valid):
    values, scales = R.quantize_index_int8(_unit_index(gen, N, D))
    queries = _rand(gen, Q, D)
    before = dict(R.tilemax_sup_q8.bodies)
    s, i = R.topk_retrieve_q8(queries, values, scales, k, n_valid=n_valid, group=16)
    body = "mma" if Q >= 9 else "cuda_core"  # Q = 64 reads the index once, on the tensor cores
    assert {b: R.tilemax_sup_q8.bodies[b] - before[b] for b in before} == {
        b: int(b == body) for b in before}
    rs, ri = R.topk_retrieve_q8(queries, values, scales, k, n_valid=n_valid, pallas_pass1=False)
    torch.cuda.synchronize()
    assert torch.equal(s, rs)
    _ids_equal_where_apart(s, i, rs, ri, tol=0.0)


@pytest.mark.parametrize("D,tile,dtype", [(64, 16, torch.float32), (320, 16, torch.bfloat16),
                                          (512, 32, torch.float32), (64, 32, torch.bfloat16)])
def test_twopass_takes_the_kernel_at_any_width_and_tile(gen, D, tile, dtype):
    # the JAX package's D % 128 and tile <= 16 conditions are Mosaic's: on
    # CUDA the default route is the kernel whatever the width or tile
    from clip_lora_match_tpu_torch import ops

    index = _unit_index(gen, 70_001, D, dtype)
    queries = _rand(gen, 3, D)
    ops.reset_launch_counts()
    s, i = R.topk_retrieve_twopass(queries, index, 10, tile=tile)
    assert ops.launch_counts()["tilemax"] == 1
    rs, ri = R.topk_retrieve_twopass(queries, index, 10, tile=tile, pallas_pass1=False)
    assert ops.launch_counts()["tilemax"] == 1
    torch.cuda.synchronize()
    torch.testing.assert_close(s, rs, atol=1e-5, rtol=0)
    _ids_equal_where_apart(s, i, rs, ri)


@pytest.mark.parametrize("Q,N,D,tile", [(1, 44_446, 512, 16), (64, 100_003, 512, 16),
                                         (3, 70_000, 64, 32)])
def test_q8_flat_route_takes_the_kernel(gen, Q, N, D, tile):
    # below the hierarchical gate the int8 index still reads its int8 bytes
    # through tilemax_sup_q8, never through an fp32 copy of the index
    from clip_lora_match_tpu_torch import ops

    values, scales = R.quantize_index_int8(_unit_index(gen, N, D))
    queries = _rand(gen, Q, D)
    ops.reset_launch_counts()
    s, i = R.topk_retrieve_q8(queries, values, scales, 10, tile=tile)
    assert ops.launch_counts()["tilemax_sup_q8"] == 1
    rs, ri = R.topk_retrieve_q8(queries, values, scales, 10, tile=tile, pallas_pass1=False)
    assert ops.launch_counts()["tilemax_sup_q8"] == 1
    torch.cuda.synchronize()
    assert torch.equal(s, rs)
    _ids_equal_where_apart(s, i, rs, ri, tol=0.0)


def test_pass1_wrappers_refuse_what_the_kernel_does_not_take(gen):
    index = _unit_index(gen, 100, 50)  # 200-byte rows: no 16-byte vectors
    with pytest.raises(ValueError, match="16-byte"):
        R.tilemax(_qc(gen, 1, 50, torch.float32), index)
    with pytest.raises(TypeError):
        R.tilemax(_qc(gen, 1, 64, torch.float32), _unit_index(gen, 100, 64, torch.bfloat16))
    with pytest.raises(ValueError, match="16-byte"):
        R.tilemax(_qc(gen, 1, 32, torch.float32), _unit_index(gen, 100, 64)[:, :32])
    # the two-pass default route raises too: it never gives way to the plain route
    with pytest.raises(ValueError, match="16-byte"):
        R.topk_retrieve_twopass(_rand(gen, 1, 50), _unit_index(gen, 70_000, 50), 5)


# ---------------------------------------------------------------------------
# flash attention and the fused MLP
# ---------------------------------------------------------------------------


def _flash_mask(kind, B, S):
    if kind == "none":
        return None
    if kind == "causal":
        return torch.triu(torch.full((S, S), NEG, device="cuda"), diagonal=1)[None, None]
    if kind == "per_batch":
        m = torch.zeros(B, 1, S, S, device="cuda")
        m[0, 0, :, S // 2:] = NEG
        m[-1, 0, 5, :] = NEG  # a fully masked query row: uniform, as softmax(s + mask)
        return m
    lengths = torch.arange(B, device="cuda") * 7 + 1  # key padding, (B, 1, 1, S)
    keep = torch.arange(S, device="cuda")[None, :] < lengths[:, None]
    return torch.where(keep, 0.0, NEG)[:, None, None, :]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,S,H,mask",
    [(1, 577, 3, "none"), (1, 65, 3, "none"), (3, 145, 1, "none"), (1, 197, 5, "none"),
     (1, 257, 3, "none"), (2, 77, 3, "causal"), (3, 145, 1, "per_batch"),
     (3, 257, 1, "key_padding"), (2, 577, 16, "causal")],
)
def test_flash_attention_kernel(gen, B, S, H, mask, dtype):
    q, k, v = (_rand(gen, B, S, H, 64, dtype=dtype) for _ in range(3))
    m = _flash_mask(mask, B, S)
    before = F.flash_attention.launches
    got = F.flash_attention(q, k, v, mask=m)
    assert F.flash_attention.launches == before + 1
    ref = F.flash_attention_plain(q, k, v, mask=m)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.float32:  # summation order only
        torch.testing.assert_close(got, ref, atol=2e-5, rtol=1e-4)
    else:  # one bf16 step of the output
        torch.testing.assert_close(got.float(), ref.float(), atol=2e-2, rtol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,S,H,mask",
    [(1, 577, 16, "none"), (32, 577, 16, "none"), (1, 197, 12, "none"), (1, 257, 16, "none"),
     (1, 77, 12, "causal"), (2, 1, 2, "none"), (2, 63, 2, "per_batch"), (2, 64, 2, "per_batch"),
     (2, 65, 2, "causal"), (3, 129, 2, "per_batch")],
)
def test_flash_attention_kernel_at_main_path_and_ragged_shapes(gen, B, S, H, mask, dtype):
    # the phase-2 shapes of chip_smoke.py in both types, and ragged S with a
    # fully masked query row (per_batch: batch row B-1, query 5 or the last)
    q, k, v = (_rand(gen, B, S, H, 64, dtype=dtype) for _ in range(3))
    m = _flash_mask(mask, B, S) if mask != "per_batch" or S > 5 else None
    if mask == "per_batch" and S <= 5:
        m = torch.zeros(B, 1, S, S, device="cuda")
        m[-1, 0, S - 1, :] = NEG
    got = F.flash_attention(q, k, v, mask=m)
    ref = F.flash_attention_plain(q, k, v, mask=m)
    torch.cuda.synchronize()
    if dtype == torch.float32:  # 3xTF32 and summation order
        torch.testing.assert_close(got, ref, atol=2e-5, rtol=1e-4)
    else:  # one bf16 step of the output
        torch.testing.assert_close(got.float(), ref.float(), atol=2e-2, rtol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_scale_that_is_no_power_of_two(gen, dtype):
    # bf16 q times a scale off a power of two is not exact in TF32: q is split too
    q, k, v = (_rand(gen, 2, 145, 3, 64, dtype=dtype) for _ in range(3))
    got = F.flash_attention(q, k, v, scale=0.1)
    ref = F.flash_attention_plain(q, k, v, scale=0.1)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=2e-5, rtol=1e-4)
    else:
        torch.testing.assert_close(got.float(), ref.float(), atol=2e-2, rtol=1e-2)


def test_flash_attention_on_an_unaligned_view(gen):
    B, S, H = 1, 100, 2
    n = B * S * H * 64
    q = _rand(gen, n + 1)[1:].view(B, S, H, 64)
    k, v = (_rand(gen, B, S, H, 64) for _ in range(2))
    assert q.data_ptr() % 16 != 0
    got = F.flash_attention(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, F.flash_attention_plain(q, k, v), atol=2e-5, rtol=1e-4)


def test_flash_attention_refuses_what_the_kernel_does_not_take(gen):
    q = _rand(gen, 1, 65, 2, 32)
    before = F.flash_attention.launches
    with pytest.raises(ValueError, match="head_dim"):
        F.flash_attention(q, q, q)
    q16 = _rand(gen, 1, 65, 2, 64, dtype=torch.float16)
    with pytest.raises(TypeError):
        F.flash_attention(q16, q16, q16)
    assert F.flash_attention.launches == before


def _mlp_inputs(gen, M, K, H, N, dtype):
    return (_rand(gen, M, K, dtype=dtype), _rand(gen, K, H, dtype=dtype, scale=K ** -0.5),
            _rand(gen, H, scale=0.1), _rand(gen, H, N, dtype=dtype, scale=H ** -0.5),
            _rand(gen, N, scale=0.1))


def _check_mlp(gen, M, K, H, N, dtype, body=None, args=None):
    args = args if args is not None else _mlp_inputs(gen, M, K, H, N, dtype)
    before = MF.mlp_fused.launches
    got = MF.mlp_fused(*args)
    assert MF.mlp_fused.launches == before + 1
    if body is not None:  # the body the wrapper's plan gave these inputs
        x, w1, _, w2, _ = args
        aligned = (x.data_ptr() | w1.data_ptr() | w2.data_ptr()) % 16 == 0
        assert MF.plan(M, K, H, N, dtype, aligned, _build.sm_count(x.device)).body == body
    ref = MF.mlp_fused_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (M, N)
    scale = ref.float().abs().max().item()
    # fp32: summation order only; bf16: one bf16 step of the output, or of a
    # hidden value that rounds the other way
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert (got.float() - ref.float()).abs().max().item() <= tol * scale


@pytest.mark.parametrize("KHN", [(768, 3072, 768), (1024, 4096, 1024), (512, 2048, 512)],
                         ids=["L14_text", "L14_vision", "B32_text"])
@pytest.mark.parametrize("M", [1, 50, 63, 64, 65, 577, 18_464])
def test_mlp_fused_kernel_bf16(gen, M, KHN):
    # every CLIP width takes the wgmma body (N = 768: a cluster of 3 CTAs)
    _check_mlp(gen, M, *KHN, torch.bfloat16, body="wgmma")


@pytest.mark.parametrize("KHN", [(768, 3072, 768), (1024, 4096, 1024), (512, 2048, 512)],
                         ids=["L14_text", "L14_vision", "B32_text"])
@pytest.mark.parametrize("M", [1, 64, 577])
def test_mlp_fused_kernel_fp32(gen, M, KHN):
    _check_mlp(gen, M, *KHN, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,H,N", [(50, 768, 3000, 768), (33, 100, 200, 300), (70, 1024, 4100, 1000)],
                         ids=["ragged_H", "ragged_K_N_unaligned", "ragged_all"])
def test_mlp_fused_kernel_ragged(gen, M, K, H, N, dtype):
    # H = 3000: the wgmma body, its last chunk zero-filled by TMA; rows of 200
    # and 600 bytes, N off the 256-column tile: the WMMA body
    body = "fp32" if dtype == torch.float32 else ("wgmma" if H == 3000 else "wmma")
    _check_mlp(gen, M, K, H, N, dtype, body=body)


def test_mlp_fused_kernel_on_an_unaligned_view(gen):
    # x starts one element into its storage: no TMA, the WMMA body takes it
    M, K, H, N = 70, 768, 3072, 768
    args = list(_mlp_inputs(gen, M, K, H, N, torch.bfloat16))
    args[0] = _rand(gen, M * K + 1, dtype=torch.bfloat16)[1:].view(M, K)
    assert args[0].data_ptr() % 16 != 0
    _check_mlp(gen, M, K, H, N, torch.bfloat16, body="wmma", args=args)


@pytest.mark.parametrize("KHN", [(768, 3072, 768), (1024, 4096, 1024), (512, 2048, 512)],
                         ids=["L14_text", "L14_vision", "B32_text"])
def test_mlp_fused_every_split_count(gen, KHN):
    # each split count the plan can give for this width (one 64-row tile, so
    # every count fits the card), held to the plain version and run twice
    K, H, N = KHN
    M = 64
    x, w1, b1, w2, b2 = _mlp_inputs(gen, M, K, H, N, torch.bfloat16)
    ref = MF.mlp_fused_plain(x, w1, b1, w2, b2).float()
    chunk = 64 * (N // 256)
    n_chunks = -(-H // chunk)
    counts = sorted({-(-n_chunks // -(-n_chunks // s)) for s in range(1, n_chunks + 1)})
    assert counts[0] == 1 and counts[-1] == n_chunks
    for splits in counts:
        p = MF.Plan("wgmma", N // 256, chunk, splits)
        got = MF._run(x, w1, b1, w2, b2, p)
        again = MF._run(x, w1, b1, w2, b2, p)
        torch.cuda.synchronize()
        assert torch.equal(got, again), f"splits={splits}: two runs differ"
        err = (got.float() - ref).abs().max().item()
        assert err <= 1e-2 * ref.abs().max().item(), f"splits={splits}: max err {err}"


@pytest.mark.parametrize("M", [577, 18_464])
def test_mlp_fused_is_bit_equal_across_runs(gen, M):
    # the hidden splits are added in order: no atomics, the same bits each run
    args = _mlp_inputs(gen, M, 1024, 4096, 1024, torch.bfloat16)
    first = MF.mlp_fused(*args)
    for _ in range(2):
        assert torch.equal(MF.mlp_fused(*args), first)


def test_mlp_fused_refuses_what_the_kernel_does_not_take(gen):
    x, w1, b1, w2, b2 = _mlp_inputs(gen, 4, 64, 128, 64, torch.float16)
    with pytest.raises(TypeError):
        MF.mlp_fused(x, w1, b1, w2, b2)
    x, w1, b1, w2, b2 = _mlp_inputs(gen, 4, 64, 128, 64, torch.bfloat16)
    with pytest.raises(ValueError):
        MF.mlp_fused(x, w1, b1[:5], w2, b2)
    with pytest.raises(TypeError):
        MF.mlp_fused(x, w1.float(), b1, w2, b2)


def test_tower_layers_launch_flash_and_the_fused_mlp_when_forced(gen):
    from clip_lora_match_tpu_torch import ops
    from clip_lora_match_tpu_torch.nn import layers

    D, Hh, S = 128, 2, 145
    def lin(i, o):
        return {"kernel": _rand(gen, i, o, scale=i ** -0.5), "bias": _rand(gen, o, scale=0.1)}
    attn = {n: lin(D, D) for n in ("q_proj", "k_proj", "v_proj", "out_proj")}
    mlp = {"fc1": lin(D, 4 * D), "fc2": lin(4 * D, D)}
    x = _rand(gen, 2, S, D)
    ops.reset_launch_counts()
    plain_a, plain_m = layers.attention(attn, x, Hh), layers.mlp(mlp, x, compute_dtype=torch.bfloat16)
    assert ops.launch_counts()["flash_attention"] == ops.launch_counts()["mlp_fused"] == 0  # defaults off
    with layers.kernel_flags(flash_attention=True, fused_mlp=True):
        got_a, got_m = layers.attention(attn, x, Hh), layers.mlp(mlp, x, compute_dtype=torch.bfloat16)
    assert ops.launch_counts()["flash_attention"] == 1 and ops.launch_counts()["mlp_fused"] == 1
    torch.cuda.synchronize()
    torch.testing.assert_close(got_a, plain_a, atol=1e-4, rtol=1e-4)
    assert (got_m - plain_m).abs().max().item() <= 3e-2 * plain_m.abs().max().item()


# -- the YOLO crop stage on the card against its CPU run -------------------------

_SYNTH = "models/yolo_synth/yolov8n_synth.npz"


def _renders(n):
    import os
    import random
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))
    import generate_fashion_corpus as gen

    rng = random.Random(999)
    return [gen.render_detect_image(rng, 320, max_objects=1)[0] for _ in range(n)]


def test_detector_on_cuda_matches_the_cpu(gen):
    from clip_lora_match_tpu_torch.models.yolo import yolov8 as Y
    from clip_lora_match_tpu_torch.models.yolo.postprocess import box_iou

    torch.backends.cudnn.allow_tf32 = False
    cpu = Y.load_detector(_SYNTH, device="cpu")
    fp32 = Y.load_detector(_SYNTH, device="cuda", compute_dtype=torch.float32)
    bf16 = Y.load_detector(_SYNTH, device="cuda")
    assert bf16.compute_dtype == torch.bfloat16
    assert all(t.device.type == "cuda" for t in bf16._params_c["backbone"]["0"].values())
    for img in _renders(4):
        want = cpu.detect(img, 0.25, 0.45, 5)
        got = fp32.detect(img, 0.25, 0.45, 5)
        assert [d.class_id for d in got] == [d.class_id for d in want]
        for a, b in zip(got, want):
            assert max(abs(x - y) for x, y in zip(a.box, b.box)) <= 0.5
        low = bf16.detect(img, 0.25, 0.45, 5)
        if want and low:
            iou = box_iou(torch.tensor([want[0].box]), torch.tensor([low[0].box]))[0, 0]
            assert iou >= 0.9 and low[0].class_id == want[0].class_id


@pytest.mark.parametrize("agnostic", [False, True])
def test_nms_fixed_on_cuda_equals_the_cpu(gen, agnostic):
    from clip_lora_match_tpu_torch.models.yolo.postprocess import nms_fixed

    g = torch.Generator().manual_seed(1)
    xy = torch.rand(3, 500, 2, generator=g) * 300
    boxes = torch.cat([xy, xy + 10 + torch.rand(3, 500, 2, generator=g) * 60], -1)
    scores = torch.rand(3, 500, generator=g)
    scores[1, 10:20] = scores[1].max()  # ties: the first index wins on both devices
    classes = torch.randint(0, 10, (3, 500), dtype=torch.int32, generator=g)
    want = nms_fixed(boxes, scores, classes, 0.25, 0.45, max_det=8, agnostic=agnostic)
    got = nms_fixed(boxes.cuda(), scores.cuda(), classes.cuda(), 0.25, 0.45, max_det=8, agnostic=agnostic)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and torch.equal(g.cpu(), w)


def test_crop_resize_on_cuda_matches_the_cpu(gen):
    from clip_lora_match_tpu_torch.models.yolo.device_crop import crop_resize_normalize

    imgs = torch.rand(3, 480, 640, 3, generator=torch.Generator().manual_seed(2))
    boxes = torch.tensor([[10.3, 5.7, 620.9, 470.2], [300.5, 200.25, 320.75, 215.5], [0, 0, 640, 480]])
    want = crop_resize_normalize(imgs, boxes, 224)
    got = crop_resize_normalize(imgs.cuda(), boxes.cuda(), 224)
    assert (got.cpu() - want).abs().max().item() <= 1e-4


def test_fused_search_on_cuda_launches_topk(gen):
    import numpy as np

    from clip_lora_match_tpu_torch.core.config import ClipArchConfig, ClipConfig
    from clip_lora_match_tpu_torch.models.clip import init_params
    from clip_lora_match_tpu_torch.models.encoder import ClipEncoder
    from clip_lora_match_tpu_torch.models.yolo import yolov8 as Y
    from clip_lora_match_tpu_torch.models.yolo.device_crop import crop_embed_pipeline, make_fused_search

    arch = ClipArchConfig(image_size=64, patch_size=32, vision_width=128, vision_layers=2, vision_heads=2,
                          vision_mlp_dim=256, text_width=128, text_layers=2, text_heads=2, text_mlp_dim=256,
                          projection_dim=64)
    enc = ClipEncoder(init_params(0, arch, device="cuda"), arch=arch, config=ClipConfig(arch=arch),
                      compute_dtype="float32", device="cuda")
    det = Y.load_detector(_SYNTH, device="cuda", compute_dtype=torch.float32)
    index = torch.nn.functional.normalize(_rand(gen, 3000, 64), dim=1)
    search = make_fused_search(det, enc, index, k=5)
    img = _renders(1)[0]
    before = R.topk_retrieve.launches
    scores, ids, box, detected = search(np.asarray(img, np.uint8))
    assert detected and R.topk_retrieve.launches == before + 1
    emb, dets = crop_embed_pipeline(det, enc, img)
    staged = index.cpu().numpy() @ emb[0]
    assert int(ids[0]) == int(np.argmax(staged)) and abs(float(scores[0]) - float(staged.max())) <= 1e-3


# -- the image-file encode path and k = 0 on the card ----------------------------


def _file_encoders(tmp_path, n_files=7):
    import numpy as np
    from PIL import Image

    from clip_lora_match_tpu_torch.core.config import ClipArchConfig, ClipConfig, PreprocessConfig
    from clip_lora_match_tpu_torch.models.clip import init_params
    from clip_lora_match_tpu_torch.models.encoder import ClipEncoder

    arch = ClipArchConfig(image_size=64, patch_size=32, vision_width=128, vision_layers=2, vision_heads=2,
                          vision_mlp_dim=256, text_width=128, text_layers=2, text_heads=2, text_mlp_dim=256,
                          projection_dim=64)
    cfg = ClipConfig(arch=arch, preprocess=PreprocessConfig(image_size=64))
    params = init_params(0, arch, device="cpu")
    rng = np.random.default_rng(3)
    paths = []
    for i in range(n_files):
        p = tmp_path / f"f{i}.jpg"
        Image.fromarray(rng.integers(0, 255, (90 + i, 120, 3), dtype=np.uint8), "RGB").save(p, quality=92)
        paths.append(str(p))
    cpu = ClipEncoder(params, arch=arch, config=cfg, compute_dtype="float32", device="cpu")
    card = ClipEncoder(params, arch=arch, config=cfg, compute_dtype="float32", device="cuda")
    return paths, cpu, card


def test_encode_image_files_on_cuda_matches_the_cpu(gen, tmp_path):
    import numpy as np

    from clip_lora_match_tpu_torch import ops

    paths, cpu, card = _file_encoders(tmp_path)
    want = cpu.encode_image_files(paths, batch_size=3, dct_scale=False)
    ops.reset_launch_counts()
    got = card.encode_image_files(paths, batch_size=3, dct_scale=False)
    counts = ops.launch_counts()
    assert got.shape == want.shape == (7, 64)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # 3 batches through 2 layers, one attention_small launch each (no adapter: no lora_matmul)
    assert counts["attention_small"] == 3 * 2


def test_encode_image_files_pinned_path_equals_the_pageable_one(gen, tmp_path):
    import numpy as np

    paths, _, card = _file_encoders(tmp_path, n_files=11)
    assert card.host_staging == "pinned"
    pinned = card.encode_image_files(paths, batch_size=2)  # 6 batches: every ring slot reused
    card.host_staging = "pageable"
    pageable = card.encode_image_files(paths, batch_size=2)
    np.testing.assert_allclose(pageable, pinned, atol=1e-6, rtol=0)


def test_search_index_k0_on_cuda(gen):
    from clip_lora_match_tpu_torch.index.store import EmbeddingIndex
    from clip_lora_match_tpu_torch.retrieval.search import SearchIndex

    rows = torch.nn.functional.normalize(_rand(gen, 3000, 64), dim=1).cpu().numpy()
    for quantize in ("none", "int8"):
        idx = SearchIndex(EmbeddingIndex(rows, dim=64, device="cuda"), dim=64, quantize=quantize)
        assert idx.search_with_embedding(rows[5], 0) == []
        assert idx.search_batch(rows[:3], 0) == [[], [], []]
        assert [r.index for r in idx.search_with_embedding(rows[5], 1)] == [5]
        with pytest.raises(ValueError):
            idx.search_with_embedding(rows[5], -1)


# -- W8A8 int8 serving and PEFT adapters on the card -------------------------------


@pytest.mark.parametrize("M", [1, 16, 17, 50, 577])
def test_int8_matmul_on_cuda_matches_the_cpu(gen, M):
    """torch._int_mm takes more than 16 rows on CUDA: M <= 16 is padded.
    Weight codes, activation codes and int32 products bit-equal to the CPU's,
    outputs to fp32 rounding, for row- and column-major weights."""
    from clip_lora_match_tpu_torch.quant import int8 as Q

    for K, N in ((768, 2304), (3072, 768)):
        x = _rand(gen, M, K, dtype=torch.bfloat16)
        w = _rand(gen, K, N, scale=K ** -0.5)
        qp, qc = Q.quantize_linear_params({"kernel": w}), Q.quantize_linear_params({"kernel": w.cpu()})
        assert torch.equal(qp["kernel_q"].cpu(), qc["kernel_q"]) and torch.equal(qp["w_scale"].cpu(), qc["w_scale"])
        xq, s = Q.quantize_rows(x)
        xqc, sc = Q.quantize_rows(x.cpu())
        assert torch.equal(xq.cpu(), xqc) and torch.equal(s.cpu(), sc)
        for wq in (qp["kernel_q"], qp["kernel_q"].t().contiguous().t()):
            before = Q.int8_mm.calls
            yi = Q.int8_mm(xq, wq)
            assert Q.int8_mm.calls == before + 1
            assert yi.shape == (M, N) and yi.dtype == torch.int32 and yi.is_contiguous()
            assert torch.equal(yi.cpu(), Q.int8_mm(xqc, wq.cpu()))
            y = Q.int8_matmul(x, wq, qp["w_scale"])
            yc = Q.int8_matmul(x.cpu(), wq.cpu(), qc["w_scale"])
            torch.cuda.synchronize()
            assert ((y.cpu() - yc).abs() <= yc.abs() * 2.0 ** -23).all()


def test_load_lora_of_a_peft_dir_on_cuda(gen, tmp_path):
    from clip_lora_match_tpu_torch.core.config import ClipArchConfig, LoraConfig
    from clip_lora_match_tpu_torch.lora import init_lora, load_lora, save_lora, save_peft_adapter

    arch = ClipArchConfig(vision_layers=2, text_layers=3)
    lora = init_lora(0, arch, LoraConfig(), device="cuda")
    lora["text"]["blocks"]["attn"]["v_proj"]["b"] = _rand(gen, 3, 8, 512, scale=0.02)
    save_peft_adapter(str(tmp_path / "peft"), lora, LoraConfig())
    save_lora(str(tmp_path / "native"), lora, LoraConfig())
    for d in ("peft", "native"):
        tree, scale = load_lora(str(tmp_path / d), device="cuda", arch=arch)
        assert scale == 2.0 and set(tree) == {"visual", "text"}
        for tower in tree:
            for proj, ab in tree[tower]["blocks"]["attn"].items():
                for k in ("a", "b"):
                    ref = lora[tower]["blocks"]["attn"][proj][k]
                    assert ab[k].is_cuda and ab[k].dtype == torch.float32 and torch.equal(ab[k], ref)


def test_quantized_encoder_launches_no_lora_or_mlp_kernel(gen):
    """Under int8 the attention core takes attention_small as the float
    encoder does, and neither lora_matmul nor mlp_fused runs, with the fused
    MLP forced on; four int8 products a layer a tower pass."""
    import numpy as np

    from clip_lora_match_tpu_torch import ops
    from clip_lora_match_tpu_torch.core.config import ClipArchConfig, ClipConfig, LoraConfig
    from clip_lora_match_tpu_torch.lora import init_lora
    from clip_lora_match_tpu_torch.models.clip import init_params
    from clip_lora_match_tpu_torch.models.encoder import ClipEncoder
    from clip_lora_match_tpu_torch.nn.layers import kernel_flags
    from clip_lora_match_tpu_torch.quant import int8 as Q

    arch = ClipArchConfig(image_size=64, patch_size=32, vision_width=128, vision_layers=2, vision_heads=2,
                          vision_mlp_dim=256, text_width=128, text_layers=2, text_heads=2, text_mlp_dim=256,
                          projection_dim=64)
    params = init_params(0, arch, device="cuda")
    lora = init_lora(1, arch, LoraConfig(), device="cuda")
    for tower in lora.values():
        for proj in tower["blocks"]["attn"].values():
            proj["b"] = _rand(gen, *proj["b"].shape, scale=0.02)
    encs = {}
    for mode in ("none", "int8"):
        encs[mode] = ClipEncoder(params, arch=arch, config=ClipConfig(arch=arch), quantize=mode, device="cuda")
        encs[mode].attach_lora(lora, 2.0)
    pix = np.random.default_rng(0).normal(size=(3, 64, 64, 3)).astype(np.float32)
    with kernel_flags(fused_mlp=True):
        ops.reset_launch_counts()
        Q.int8_mm.calls = 0
        got = encs["int8"].encode_image_batch(pix)
        encs["int8"].encode_text(["tas pink", "payung hitam"])
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert counts["lora_matmul"] == 0 and counts["mlp_fused"] == 0
        assert counts["attention_small"] == arch.vision_layers + arch.text_layers
        assert Q.int8_mm.calls == 4 * (arch.vision_layers + arch.text_layers)
        ref = encs["none"].encode_image_batch(pix)
    cos = (got * ref).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(ref, axis=1))
    assert cos.min() >= 0.995


# -- the kernels' backward passes (training) ------------------------------------


def _normrel(got, ref):
    return ((got.double() - ref.double()).norm() / ref.double().norm().clamp_min(1e-30)).item()


def _grads(fn, inputs, cot, need):
    ts = [t.detach().clone().requires_grad_(n) for t, n in zip(inputs, need)]
    fn(*ts).backward(cot)
    return [t.grad for t, n in zip(ts, need) if n]


# fp32: the same plain products in another order; bf16: the rank-r partials
# and the hidden rounded at other places (one bf16 step)
_GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,r", [(6400, 768, 768, 8), (8192, 512, 512, 8), (77, 768, 768, 24)])
def test_lora_matmul_grads_on_cuda(gen, M, K, N, r, dtype):
    ins = (_rand(gen, M, K, dtype=dtype), _rand(gen, K, N, dtype=dtype, scale=K ** -0.5),
           _rand(gen, K, r, dtype=dtype, scale=0.05), _rand(gen, r, N, dtype=dtype, scale=0.05))
    cot = _rand(gen, M, N, dtype=dtype)
    need = (True, False, True, True)  # the frozen base takes no gradient
    before = L.lora_matmul.launches
    got = _grads(lambda *t: L.lora_matmul(*t, scaling=2.0), ins, cot, need)
    assert L.lora_matmul.launches == before + 1
    ref = _grads(lambda *t: L.lora_matmul_plain(*t, scaling=2.0), ins, cot, need)
    for name, g, rf in zip(("dx", "dA", "dB"), got, ref):
        assert g.dtype == dtype and _normrel(g, rf) <= _GRAD_TOL[dtype], name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_lora_launch_grads_on_cuda(gen, dtype):
    from clip_lora_match_tpu_torch.nn.layers import QKV, group_qkv

    D, r, M = 768, 8, 6400
    p = {n: {"kernel": _rand(gen, D, D, dtype=dtype, scale=D ** -0.5), "bias": None} for n in QKV}
    leaves = {n: {"a": _rand(gen, D, r, dtype=dtype, scale=0.05).requires_grad_(True),
                  "b": _rand(gen, r, D, dtype=dtype, scale=0.05).requires_grad_(True)} for n in QKV}
    x, cot = _rand(gen, M, D, dtype=dtype), _rand(gen, 3, M, D, dtype=dtype)
    g = group_qkv(p, leaves)
    before = L.lora_matmul.launches
    (L.lora_matmul(x, g["kernel"], g["a"], g["b"], scaling=2.0, groups=3).float() * cot.float()).sum().backward()
    assert L.lora_matmul.launches == before + 1
    for i, n in enumerate(QKV):
        ref = _grads(lambda *t: L.lora_matmul(*t, scaling=2.0), (x, p[n]["kernel"], leaves[n]["a"], leaves[n]["b"]),
                     cot[i], (False, False, True, True))
        assert _normrel(leaves[n]["a"].grad, ref[0]) <= _GRAD_TOL[dtype], n
        assert _normrel(leaves[n]["b"].grad, ref[1]) <= _GRAD_TOL[dtype], n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,mode", [(128, 50, 12, "none"), (128, 64, 8, "lengths"), (128, 77, 8, "lengths"),
                                        (4, 50, 2, "mask")])
def test_attention_small_grads_on_cuda(gen, B, S, H, mode, dtype):
    ins = [_rand(gen, B, S, H, 64, dtype=dtype, scale=0.5) for _ in range(3)]
    cot = _rand(gen, B, S, H, 64, dtype=dtype)
    kw = {}
    if mode == "lengths":
        kw = dict(causal=True, lengths=torch.randint(1, S + 1, (B,), device="cuda", generator=gen, dtype=torch.int32))
    elif mode == "mask":
        kw = dict(mask=torch.where(torch.rand(B, 1, S, S, device="cuda", generator=gen) < 0.3, NEG, 0.0))
    before = A.attention_small.launches
    got = _grads(lambda *t: A.attention_small(*t, **kw), ins, cot, (True,) * 3)
    assert A.attention_small.launches == before + 1
    ref = _grads(lambda *t: A.attention_small_plain(*t, **kw), ins, cot, (True,) * 3)
    tol = 1e-4 if dtype == torch.float32 else 3e-2  # fp32: max-free vs exact softmax
    for name, g, rf in zip(("dq", "dk", "dv"), got, ref):
        assert _normrel(g, rf) <= tol, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,H", [(6400, 768, 3072), (8192, 512, 2048), (50, 768, 3072)])
def test_mlp_fused_grads_on_cuda(gen, M, K, H, dtype):
    ins = (_rand(gen, M, K, dtype=dtype), _rand(gen, K, H, dtype=dtype, scale=K ** -0.5),
           _rand(gen, H, scale=0.1), _rand(gen, H, K, dtype=dtype, scale=H ** -0.5), _rand(gen, K, scale=0.1))
    cot = _rand(gen, M, K, dtype=dtype)
    need = (True,) * 5
    before = MF.mlp_fused.launches
    got = _grads(MF.mlp_fused, ins, cot, need)
    assert MF.mlp_fused.launches == before + 1
    ref = _grads(MF.mlp_fused_plain, ins, cot, need)
    for name, g, rf in zip(("dx", "dW1", "db1", "dW2", "db2"), got, ref):
        assert _normrel(g, rf) <= _GRAD_TOL[dtype], name


def test_flash_attention_refuses_grad_on_cuda(gen):
    q, k, v = (_rand(gen, 2, 200, 2, 64) for _ in range(3))
    before = F.flash_attention.launches
    with pytest.raises(RuntimeError, match="no backward"):
        F.flash_attention(q.requires_grad_(True), k, v)
    assert F.flash_attention.launches == before
    with torch.no_grad():
        F.flash_attention(q, k, v)
    assert F.flash_attention.launches == before + 1


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16])
def test_tower_lora_grads_under_auto_equal_the_plain_paths(gen, compute_dtype):
    """The repaired fault: through the kernels under the default "auto"
    flags, the towers' q/k/v (and out_proj) adapters get the gradients they
    get with the kernels off."""
    import numpy as np

    from clip_lora_match_tpu_torch import ops
    from clip_lora_match_tpu_torch.core.config import ClipArchConfig, LoraConfig
    from clip_lora_match_tpu_torch.lora import init_lora
    from clip_lora_match_tpu_torch.models import clip as C
    from clip_lora_match_tpu_torch.models.io import tree_leaves, unflatten
    from clip_lora_match_tpu_torch.nn.layers import kernel_flags
    from clip_lora_match_tpu_torch.train.loss import clip_contrastive_loss

    arch = ClipArchConfig(image_size=64, patch_size=32, vision_width=128, vision_layers=2, vision_heads=2,
                          vision_mlp_dim=256, text_width=128, text_layers=2, text_heads=2, text_mlp_dim=256,
                          projection_dim=64)
    params = C.init_params(0, arch, device="cuda")
    lora = init_lora(1, arch, LoraConfig(), device="cuda")
    for tower in lora.values():
        for proj in tower["blocks"]["attn"].values():
            proj["b"] = _rand(gen, *proj["b"].shape, scale=0.05)
    rng = np.random.default_rng(0)
    pix = torch.from_numpy(rng.normal(size=(6, 64, 64, 3)).astype(np.float32)).cuda()
    ids = torch.from_numpy(rng.integers(1, 500, (6, 77))).cuda()
    mask = torch.ones(6, 77, dtype=torch.int32, device="cuda")
    mask[:, 20:] = 0

    def grads(**flags):
        pairs = tree_leaves(lora)
        live = [t.detach().clone().requires_grad_(True) for _, t in pairs]
        tree = unflatten({path: t for (path, _), t in zip(pairs, live)})
        with kernel_flags(**flags):
            img = C.encode_image_features(params, pix, arch, lora=tree, lora_scaling=2.0, compute_dtype=compute_dtype)
            txt = C.encode_text_features(params, ids, arch, attention_mask=mask, lora=tree, lora_scaling=2.0,
                                         compute_dtype=compute_dtype)
            loss = clip_contrastive_loss(img, txt)
        return loss, torch.autograd.grad(loss, live)

    ops.reset_launch_counts()
    loss_k, g_k = grads()
    counts = ops.launch_counts()
    assert counts["lora_matmul"] == 4 * 4 and counts["attention_small"] == 4
    loss_p, g_p = grads(fused_lora=False, small_attention=False)
    tol = 1e-4 if compute_dtype is None else 5e-2
    assert abs(loss_k.item() - loss_p.item()) <= tol * abs(loss_p.item())
    for (path, _), a, b in zip(tree_leaves(lora), g_k, g_p):
        assert b.norm() > 0 and _normrel(a, b) <= tol, path


@pytest.mark.parametrize("remat", [True, "dots"])
def test_remat_on_cuda_gives_the_loss_and_gradients_of_no_remat(gen, remat):
    """Checkpointed blocks (and the selective "dots" policy) redraw the same
    dropout masks from their per-layer generators on the card."""
    import numpy as np

    from clip_lora_match_tpu_torch.core.config import ClipArchConfig, LoraConfig
    from clip_lora_match_tpu_torch.lora import init_lora
    from clip_lora_match_tpu_torch.models.clip import init_params
    from clip_lora_match_tpu_torch.models.io import tree_leaves, unflatten
    from clip_lora_match_tpu_torch.train.loss import clip_contrastive_loss
    from clip_lora_match_tpu_torch.train.step import batch_to_device, tower_features

    arch = ClipArchConfig(image_size=64, patch_size=32, vision_width=128, vision_layers=2, vision_heads=2,
                          vision_mlp_dim=256, text_width=128, text_layers=2, text_heads=2, text_mlp_dim=256,
                          projection_dim=64)
    params = init_params(0, arch, device="cuda")
    lora = init_lora(1, arch, LoraConfig(), device="cuda")
    rng = np.random.default_rng(0)
    batch = {"pixel_values": rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8),
             "input_ids": rng.integers(1, 500, (4, 16)), "attention_mask": np.ones((4, 16), np.int32)}

    def run(mode):
        pairs = tree_leaves(lora)
        live = [t.detach().clone().requires_grad_(True) for _, t in pairs]
        tree = unflatten({p: t for (p, _), t in zip(pairs, live)})
        img, txt = tower_features(params, tree, batch_to_device(batch, torch.device("cuda")), arch,
                                  LoraConfig(dropout=0.1), None, None, mode, torch.Generator().manual_seed(2))
        loss = clip_contrastive_loss(img, txt)
        return loss, torch.autograd.grad(loss, live)

    ref_loss, ref = run(False)
    loss, got = run(remat)
    assert abs(loss.item() - ref_loss.item()) <= 1e-6 * abs(ref_loss.item())
    for a, b in zip(got, ref):
        assert _normrel(a, b) <= 1e-5


# -- the evaluation job and the detector's training on the card -----------------


def test_similarity_matrix_on_cuda_is_true_fp32(gen):
    """The evaluator's product on the card, with TF32 on in the process:
    within 1e-6 of numpy's fp64 product of the same unit rows, and the
    process's setting left as it was."""
    import numpy as np

    from clip_lora_match_tpu_torch.eval.protocols import similarity_matrix

    rng = np.random.default_rng(0)
    a = rng.normal(size=(300, 512)).astype(np.float32)
    b = rng.normal(size=(257, 512)).astype(np.float32)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = similarity_matrix(a, b, device="cuda")
        assert torch.backends.cuda.matmul.allow_tf32
        got_t = similarity_matrix(torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    unit = lambda x: x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)  # noqa: E731
    want = unit(a).astype(np.float64) @ unit(b).astype(np.float64).T
    assert got.dtype == np.float32 and got.shape == (300, 257)
    assert np.abs(got - want).max() <= 1e-6
    assert np.abs(got_t - want).max() <= 1e-6


def test_yolo_train_step_grads_on_cuda_match_the_cpu(gen):
    """One detection loss and its gradients (fp32, cuDNN TF32 off) from the
    committed synthetic-corpus detector's weights over two renders with
    their boxes, on the card against the CPU: normwise within 1e-4."""
    import numpy as np

    from clip_lora_match_tpu_torch.models.io import tree_leaves
    from clip_lora_match_tpu_torch.models.yolo import train as TT
    from clip_lora_match_tpu_torch.models.yolo import yolov8 as Y

    import os
    import random
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))
    import generate_fashion_corpus as g

    torch.backends.cudnn.allow_tf32 = False
    rng = random.Random(7)
    imgs, boxes = [], np.zeros((2, 4, 4), np.float32)
    cls, valid = np.zeros((2, 4), np.int32), np.zeros((2, 4), bool)
    for i in range(2):
        img, bs = g.render_detect_image(rng, 320, 2)
        imgs.append(np.asarray(img, np.uint8))
        for m, (x1, y1, x2, y2, c) in enumerate(bs):
            boxes[i, m], cls[i, m], valid[i, m] = (x1, y1, x2, y2), c, True
    tree = Y.read_detector(_SYNTH)[0]
    out = {}
    for dev in ("cpu", "cuda"):
        params = Y.params_from_jax(tree, dev)
        live = [t.detach().requires_grad_(True) for _, t in tree_leaves(params)]
        p = TT._rebuild(params, iter(live))
        anchors, spa = TT.make_anchors(320, device=dev)
        x = (torch.from_numpy(np.stack(imgs)).to(dev).float() / torch.tensor(255.0, device=dev)).permute(0, 3, 1, 2)
        loss, aux = TT.detection_loss(p, x.contiguous(), *(torch.from_numpy(a).to(dev) for a in (boxes, cls, valid)),
                                      anchors, spa)
        out[dev] = (loss.item(), aux["num_fg"].item(), [t.cpu() for t in torch.autograd.grad(loss, live)])
    assert out["cuda"][1] == out["cpu"][1] > 0
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * abs(out["cpu"][0])
    for a, b in zip(out["cuda"][2], out["cpu"][2]):
        assert _normrel(a, b) <= 1e-4


def test_evaluator_encode_launches_the_kernels_under_auto(gen):
    """``CLIPEvaluator.encode_dataset`` on the card runs attention_small
    and lora_matmul (q/k/v grouped, out_proj) in every layer of both towers,
    and its embeddings agree with the CPU's plain fp32 path."""
    import numpy as np

    from clip_lora_match_tpu_torch import ops
    from clip_lora_match_tpu_torch.core.config import ClipArchConfig, ClipConfig, LoraConfig
    from clip_lora_match_tpu_torch.eval import CLIPEvaluator, load_eval_csv
    from clip_lora_match_tpu_torch.lora import init_lora
    from clip_lora_match_tpu_torch.models.clip import init_params
    from clip_lora_match_tpu_torch.models.encoder import ClipEncoder

    arch = ClipArchConfig(image_size=64, patch_size=32, vision_width=128, vision_layers=2, vision_heads=2,
                          vision_mlp_dim=256, text_width=128, text_layers=2, text_heads=2, text_mlp_dim=256,
                          projection_dim=64)
    params = init_params(0, arch, device="cpu")
    lora = init_lora(1, arch, LoraConfig(), device="cpu")
    for tower in lora.values():
        for proj in tower["blocks"]["attn"].values():
            proj["b"] = torch.randn(proj["b"].shape, generator=torch.Generator().manual_seed(3)) * 0.05
    cfg = ClipConfig(arch=arch)
    data = load_eval_csv("data/text/val_fashion.csv", "data/text/images")
    embs = {}
    for dev in ("cuda", "cpu"):
        enc = ClipEncoder(params, arch=arch, config=cfg, device=dev, compute_dtype="float32")
        enc.attach_lora(lora, 2.0)
        ops.reset_launch_counts()
        embs[dev] = CLIPEvaluator(enc).encode_dataset(data)
        counts = ops.launch_counts()
        if dev == "cuda":
            torch.cuda.synchronize()
            layers = arch.vision_layers + arch.text_layers
            assert counts["attention_small"] == layers and counts["lora_matmul"] == 2 * layers
        else:
            assert not any(counts.values())
    for got, want in zip(embs["cuda"], embs["cpu"]):
        assert got.shape == want.shape == (len(data.texts), 64)
        assert np.abs(got - want).max() <= 1e-4


# -- the data axis on the card ---------------------------------------------------


@pytest.fixture(scope="module")
def data_axis_worlds(tmp_path_factory):
    """One NCCL rank and two gloo ranks sharing the card, the sharded search
    and the data-parallel step in each (``tests/_torch_dist.py``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import importlib.util
    import os

    # by path: a package named "tests" elsewhere on the path may shadow this directory
    spec = importlib.util.spec_from_file_location(
        "_torch_dist", os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_dist.py"))
    dist_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(dist_mod)
    run_worlds = dist_mod.run_worlds
    tmp = tmp_path_factory.mktemp("data_axis")
    _build.build_all()  # built once here: the ranks only load the libraries
    out = {}
    cards = torch.cuda.device_count()
    for case in ("cuda_retrieval", "cuda_dp_step"):
        out[case] = run_worlds({"nccl1": 1}, case, tmp / case, backend="nccl", device="cuda")
        out[case].update(run_worlds({"gloo2": 2}, case, tmp / case, backend="gloo", device="cuda"))
        if cards > 1:  # NCCL across cards, a card a rank
            out[case].update(run_worlds({"nccl_cards": cards}, case, tmp / case, backend="nccl", device="cuda"))
    return out


def _world(worlds, case, world):
    if world not in worlds[case]:
        pytest.skip("NCCL across cards needs more than one card")
    return worlds[case][world]


def _tie_aware(got, ref, tol):
    (gs, gi), (rs, ri) = got, ref
    assert torch.allclose(gs, rs, atol=tol, rtol=0)
    for q, j in (gi != ri).nonzero().tolist():
        tied = (rs[q] - rs[q, j]).abs() <= tol
        assert int(tied.sum()) > 1 and gi[q, j] in ri[q][tied]


@pytest.mark.parametrize("world", ["nccl1", "gloo2", "nccl_cards"])
@pytest.mark.parametrize("key", ["1/torch.float32", "1/torch.bfloat16", "1/int8", "64/torch.float32",
                                 "64/torch.bfloat16", "64/int8"])
def test_sharded_topk_on_cuda_equals_the_unsharded_search(data_axis_worlds, world, key):
    ranks = _world(data_axis_worlds, "cuda_retrieval", world)
    ref = data_axis_worlds["cuda_retrieval"]["nccl1"][0][f"{key}/whole"]
    kernel = "tilemax_sup_q8" if key.endswith("int8") else "tilemax"
    for res in ranks:
        got, counts = res[key]
        assert counts[kernel] >= 1, counts  # pass 1 ran on the kernel on every rank
        if world == "nccl1":  # one rank: the same two-pass route, bit for bit
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        else:
            _tie_aware(got, ref, 0.0 if key.endswith("int8") else 1e-6)


@pytest.mark.parametrize("world", ["nccl1", "gloo2", "nccl_cards"])
@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16", "int8"])
def test_sharded_topk_on_cuda_keeps_pad_rows_out_of_small_shards(data_axis_worlds, world, dtype):
    """41 rows that every query scores below 0, the 10 best of query 0 in the
    padded last shard: the shards' oracle route keeps the zero pad rows out,
    and the merged answer equals the unsharded search."""
    for res in _world(data_axis_worlds, "cuda_retrieval", world):
        got, ref = res[f"small/{dtype}"], res[f"small/{dtype}/whole"]
        _tie_aware(got, ref, 0.0 if dtype == "int8" else 1e-6)
        assert int(got[1].max()) < 41 and set(got[1][0].tolist()) == set(range(31, 41))


@pytest.mark.parametrize("world", ["nccl1", "gloo2", "nccl_cards"])
def test_dp_step_on_cuda_equals_the_single_step(data_axis_worlds, world):
    from clip_lora_match_tpu_torch.models.io import tree_leaves

    single = data_axis_worlds["cuda_dp_step"]["nccl1"][0]["single"]
    ranks = _world(data_axis_worlds, "cuda_dp_step", world)
    if world == "nccl_cards":  # a card a rank
        assert [r["device"] for r in ranks] == [f"cuda:{i}" for i in range(len(ranks))]
    for res in ranks:
        losses, norms, lora = res["dp"]
        for g, r in zip(losses + norms, single[0] + single[1]):
            assert abs(g - r) <= 1e-5 * abs(r), (g, r)
        for (path, a), (_, b) in zip(tree_leaves(lora), tree_leaves(single[2])):
            assert ((a.double() - b.double()).norm() / b.double().norm()).item() <= 1e-5, path


def test_nccl_refuses_ranks_that_share_a_card(gen, tmp_path):
    from clip_lora_match_tpu_torch.parallel import initialize_distributed

    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match="gloo"):  # the last rank has no card of its own
        initialize_distributed(f"file://{tmp_path}/store", n, n - 1, backend="nccl")
    with pytest.raises(ValueError, match="gloo"):  # more ranks on this host than cards
        initialize_distributed(f"file://{tmp_path}/store", n, 0, backend="nccl", local_world=n)


# -- the model axes at axis size 1 on the card ---------------------------------


@pytest.mark.parametrize("mask", ["none", "causal", "masked_rows"])
def test_ring_attention_on_cuda_matches_its_oracle(gen, mask):
    """One rank of the ring (its blocks never leave the card) against the
    single-device oracle at the B/32 image tower's shape."""
    from clip_lora_match_tpu_torch.ops.ring_attention import _MASK_FLOOR, ring_attention, ring_attention_oracle
    from clip_lora_match_tpu_torch.parallel import make_sp_mesh

    mesh = make_sp_mesh(n_seq=1)
    q, k, v = (_rand(gen, 2, 50, 12, 64) for _ in range(3))
    m = None
    if mask == "causal":
        m = torch.triu(torch.full((50, 50), NEG, device="cuda"), diagonal=1)[None, None]
    elif mask == "masked_rows":
        m = torch.zeros(2, 1, 50, 50, device="cuda")
        m[:, :, :, 40:] = _MASK_FLOOR
        m[:, :, 40:, :] = _MASK_FLOOR
    got = ring_attention(q, k, v, mesh, mask=m)
    ref = ring_attention_oracle(q, k, v, mask=m)
    assert got.is_cuda and not torch.isnan(got).any()
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-6)
    if mask == "masked_rows":
        assert float(got[:, 40:].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("kind", ["tp", "sp", "pp"])
def test_model_axis_executors_at_size_one_match_the_transformer_on_cuda(gen, kind, dtype):
    """Each executor over a mesh of one rank, at B/32 image width (2 layers,
    12 heads, S=50) with LoRA and the kernels under "auto", against the
    plain ``transformer``: TP takes its very dispatch (lora_matmul and
    attention_small), PP the same per microbatch, SP the ring in place of
    attention_small (lora_matmul still launched)."""
    import numpy as np

    from clip_lora_match_tpu_torch import ops
    from clip_lora_match_tpu_torch import parallel as P
    from clip_lora_match_tpu_torch.models.clip import _init_blocks
    from clip_lora_match_tpu_torch.models.io import to_device
    from clip_lora_match_tpu_torch.nn.layers import transformer

    blocks = to_device(_init_blocks(np.random.default_rng(0), 768, 3072, 2), "cuda")
    lora = {"attn": {n: {"a": _rand(gen, 2, 768, 8, scale=768 ** -0.5), "b": _rand(gen, 2, 8, 768, scale=0.05)}
                     for n in ("q_proj", "k_proj", "v_proj", "out_proj")}}
    x = _rand(gen, 4, 50, 768)
    fn = {"tp": lambda: P.make_tp_transformer(P.make_mesh()),
          "sp": lambda: P.make_sp_transformer(P.make_sp_mesh(n_seq=1)),
          "pp": lambda: P.make_pipeline_transformer(P.make_pp_mesh(n_stage=1), 2)}[kind]()
    ops.reset_launch_counts()
    got = fn(blocks, x, 12, lora_blocks=lora, lora_scaling=2.0, compute_dtype=dtype)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["lora_matmul"] > 0 and (counts["attention_small"] > 0) == (kind != "sp"), counts
    ref = transformer(blocks, x, 12, lora_blocks=lora, lora_scaling=2.0, compute_dtype=dtype)
    if kind == "tp":
        assert torch.equal(got, ref)
    elif dtype is None:
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    else:
        assert _normrel(got.float(), ref.float()) <= 2e-2
