"""Pass 1's launch plan (``ops.retrieval_topk.tilemax_plan``) and the mma
body's 3xTF32 and s8 arithmetic, on the CPU.

At every shape the main path and chip_smoke.py give ``tilemax``,
``tilemax_sup`` and ``tilemax_sup_q8``: shared memory fits a block, the grid
fills the card, a query batch of up to 64 reads the index once, the blocks
cover every tile with no empty block, a ``tilemax_sup`` block holds whole
groups, and Q <= 8, a tile outside {8, 16} or rows not of whole 64-byte
k-chunks take the CUDA-core body. A numpy emulation of the 3xTF32 product
(``hopper::split`` as written, the tensor core reading lo's TF32 bits, fp32
sums) states on the CPU the 1e-5 tolerance the card tests hold the fp32
kernel to. A numpy emulation of ``mma.sync.m16n8k32`` s8 as the int8 body
feeds it (the fragment map of the PTX ISA, the k permutation shared by both
operands, the epilogue's scale and maxima) shows that its sums are the exact
int32 dot and its tile maxima equal ``tilemax_sup_q8_plain`` bit for bit.
"""

import itertools

import numpy as np
import pytest
import torch

from clip_lora_match_tpu_torch.ops import retrieval_topk as R

SMS = 132  # H100 SXM
F32, BF16, I8 = torch.float32, torch.bfloat16, torch.int8

QS = (1, 2, 8, 9, 16, 64, 65, 256)
NS = (65_536, 524_298, 1_048_586)
DS = (512, 768, 1024)


def _blocks(p, N, tile):
    """Each block's tile range [first, end), as the source splits the work:
    mma blocks take whole units (block b: units [b U / gx, (b + 1) U / gx));
    CUDA-core blocks one ``rows_per_block`` run of tiles each."""
    nt = -(-N // tile)
    gx = p.grid[0]
    if p.body == "mma":
        units = -(-nt * tile // p.unit)
        return [((b * units // gx) * p.unit // tile,
                 min(nt, ((b + 1) * units // gx) * p.unit // tile)) for b in range(gx)]
    tpb = p.rows_per_block // tile
    return [(b * tpb, min(nt, (b + 1) * tpb)) for b in range(gx)]


def _check_cover(p, N, tile):
    blocks = _blocks(p, N, tile)
    assert all(end > first for first, end in blocks)  # no empty block
    assert blocks[0][0] == 0 and blocks[-1][1] == -(-N // tile)
    assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))  # contiguous, no overlap
    assert max(end - first for first, end in blocks) * tile <= p.rows_per_block


@pytest.mark.parametrize("group", [None, 8, 16])
@pytest.mark.parametrize("dtype", [F32, BF16, I8])
@pytest.mark.parametrize("Q", QS)
def test_plan_at_main_path_shapes(Q, dtype, group):
    tile = 16
    for N, D in itertools.product(NS, DS):
        p = R.tilemax_plan(Q, N, D, dtype, tile, group, SMS)
        assert p.smem <= R.SMEM_BLOCK
        assert p.grid[0] * p.grid[1] >= SMS  # the grid fills the card
        assert p.grid[1] == -(-Q // p.qb)
        if Q <= 8:
            assert p.body == "cuda_core" and p.qb == 1 << (Q - 1).bit_length()
        else:
            assert p.body == "mma"
            # one query block of up to 64 holds Q: the index is read once;
            # only fp32 at D = 1024 halves the block to fit shared memory
            want = 32 if dtype == F32 and D == 1024 else 64
            assert p.qb == min(want, next(b for b in (16, 32, 64) if b >= min(Q, 64)))
        if Q <= p.qb:
            assert p.grid[1] == 1
        _check_cover(p, N, tile)
        if group is not None:  # a tilemax_sup block holds whole groups
            assert p.unit % (group * tile) == 0
            for first, end in _blocks(p, N, tile):
                assert first % group == 0
                assert end % group == 0 or end == -(-N // tile)


@pytest.mark.parametrize("Q", [9, 64])
@pytest.mark.parametrize("tile", [1, 5, 7, 12, 24, 32])
def test_tiles_outside_8_and_16_take_the_cuda_core_body(Q, tile):
    for dtype, group in itertools.product((F32, BF16, I8), (None, 16)):
        p = R.tilemax_plan(Q, 524_298, 512, dtype, tile, group, SMS)
        assert p.body == "cuda_core" and p.qb == 8 and p.grid[1] == -(-Q // 8)
        assert p.smem <= R.SMEM_BLOCK
        _check_cover(p, 524_298, tile)


@pytest.mark.parametrize("tile", [8, 16])
def test_the_body_switches_above_eight_queries(tile):
    for Q, dtype in itertools.product(range(1, 80), (BF16, I8)):
        p = R.tilemax_plan(Q, 65_536, 512, dtype, tile, None, SMS)
        assert p.body == ("mma" if Q >= R.TILEMAX_MMA_MIN_Q else "cuda_core")
    assert R.TILEMAX_MMA_MIN_Q == 9  # Q <= 8, the seeker's batch, keeps its body


@pytest.mark.parametrize("D,dtype,body", [
    (40, BF16, "cuda_core"), (24, F32, "cuda_core"), (100, F32, "cuda_core"),  # rows not of whole 64-byte chunks
    (32, BF16, "mma"), (16, F32, "mma"), (96, BF16, "mma"),
    (4096, F32, "cuda_core"),  # no query block of 16 fits shared memory
    (4096, BF16, "mma"), (2048, F32, "mma"),
    (16, I8, "cuda_core"), (48, I8, "cuda_core"), (96, I8, "cuda_core"), (1000, I8, "cuda_core"),
    (64, I8, "mma"), (128, I8, "mma"), (768, I8, "mma"), (1024, I8, "mma"),
])
def test_rows_and_widths_the_mma_body_takes(D, dtype, body):
    p = R.tilemax_plan(64, 70_001, D, dtype, 16, 16, SMS)
    assert p.body == body and p.smem <= R.SMEM_BLOCK
    _check_cover(p, 70_001, 16)


@pytest.mark.parametrize("Q,N,D,tile,group", [
    (9, 1, 64, 16, None), (16, 33, 64, 8, 16), (65, 4097, 512, 16, 3), (130, 70_003, 768, 8, 32),
    (1000, 10_000, 512, 16, 1024), (17, 8692, 1024, 16, 16), (256, 257, 32, 8, None),
])
def test_plan_covers_any_shape(Q, N, D, tile, group):
    for dtype, sms in itertools.product((F32, BF16), (132, 114, 1)):
        p = R.tilemax_plan(Q, N, D, dtype, tile, group, sms)
        assert p.body == "mma" and p.smem <= R.SMEM_BLOCK
        assert p.unit % 256 == 0 and (group is None or p.unit % (group * tile) == 0)
        _check_cover(p, N, tile)


@pytest.mark.parametrize("Q,N,D,tile,group", [
    (9, 1, 64, 16, 16), (16, 33, 64, 8, 16), (65, 4097, 512, 16, 3), (130, 70_003, 768, 8, 32),
    (1000, 10_000, 512, 16, 1024), (17, 8692, 1024, 16, 16), (64, 44_446, 512, 16, 16),
    (64, 1_048_586, 512, 16, 8), (33, 20_011, 128, 8, 16),
])
def test_int8_plan_covers_any_shape(Q, N, D, tile, group):
    """``tilemax_sup_q8`` always asks for group maxima; D <= 1024 (the
    wrapper's exactness bound) leaves shared memory for a query block of 64."""
    for sms in (132, 114, 1):
        p = R.tilemax_plan(Q, N, D, I8, tile, group, sms)
        assert p.body == "mma" and p.smem <= R.SMEM_BLOCK
        assert p.qb == next(b for b in (16, 32, 64) if b >= min(Q, 64))
        assert p.unit % 256 == 0 and p.unit % (group * tile) == 0
        _check_cover(p, N, tile)


def test_smem_counts_match_the_layout():
    """``_mma_smem`` adds up ``mma_smem`` in the source: query rows at a
    stride of 64 mod 128 bytes, two stages of (tiles per round + 1) maxima."""
    assert R._mma_smem(64, 1024, 16) == 64 * (1024 + 64) + 2 * 4 * 64 * 17
    assert R._mma_smem(64, 3072, 8) == 64 * (3072 + 64) + 2 * 4 * 64 * 33
    assert R._mma_smem(16, 192, 16) == 16 * (256 + 64) + 2 * 4 * 16 * 17
    p = R.tilemax_plan(64, 1_048_586, 768, F32, 8, 16, SMS)
    assert (p.qb, p.smem) == (64, R._mma_smem(64, 3072, 8))
    p = R.tilemax_plan(64, 1_048_586, 512, I8, 16, 16, SMS)  # int8 rows: one byte a value
    assert (p.qb, p.smem) == (64, R._mma_smem(64, 512, 16)) == (64, 64 * 576 + 2 * 4 * 64 * 17)


# -- 3xTF32 ------------------------------------------------------------------


def _split(x: np.ndarray):
    """``hopper::split``: hi = x rounded to TF32 by integer arithmetic (ties
    away from zero), lo = x - hi in fp32."""
    bits = x.astype(np.float32).view(np.uint32)
    hi = ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    return hi, (x - hi).astype(np.float32)


def _tf32(x: np.ndarray) -> np.ndarray:
    """The TF32 value the tensor core reads from an fp32 register."""
    return (x.astype(np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _dot_3xtf32(a: np.ndarray, b: np.ndarray) -> np.float32:
    """hi.lo + lo.hi + hi.hi per element (products exact in fp32), summed in
    fp32 in the kernel's order of k-steps of 8."""
    ah, al = _split(a)
    bh, bl = _split(b)
    al, bl = _tf32(al), _tf32(bl)
    acc = np.float32(0.0)
    for k in range(0, a.size, 8):
        s = slice(k, k + 8)
        for x, y in ((ah, bl), (al, bh), (ah, bh)):
            for p in (x[s] * y[s]).astype(np.float32):
                acc = np.float32(acc + p)
    return acc


def _unit(rng, n, D):
    x = rng.standard_normal((n, D))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("D", [512, 768, 1024])
def test_3xtf32_product_is_within_the_card_tolerance(D):
    rng = np.random.default_rng(D)
    q, rows = _unit(rng, 4, D), _unit(rng, 16, D)
    rows[:4] = q  # the self-match: the largest score a tile can hold
    worst = 0.0
    for a, b in itertools.product(q, rows):
        exact = float(np.dot(a.astype(np.float64), b.astype(np.float64)))
        worst = max(worst, abs(float(_dot_3xtf32(a, b)) - exact))
    assert worst <= 1e-5


def test_split_is_exact_and_one_tf32_product_is_not_enough():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(4096).astype(np.float32)
    hi, lo = _split(x)
    assert np.array_equal(hi + lo, x)  # lo = x - hi exactly
    assert np.array_equal(_tf32(hi), hi)  # hi is a TF32 value
    assert np.all(np.abs(lo) <= np.abs(x) * 2.0 ** -11)
    # one TF32 product per element misses the tolerance the split keeps
    a, b = _unit(rng, 2, 1024)
    b = (0.999 * a + 0.045 * b).astype(np.float32)
    exact = float(np.dot(a.astype(np.float64), b.astype(np.float64)))
    one = float(np.sum((_tf32(a) * _tf32(b)).astype(np.float64)))
    assert abs(one - exact) > 1e-5 >= abs(float(_dot_3xtf32(a, b)) - exact)


# -- s8 on mma.sync.m16n8k32 -------------------------------------------------


def _words(x: np.ndarray) -> np.ndarray:
    """(..., 16) int8 -> (..., 4) 32-bit words, as one 16-byte load gives them."""
    return np.ascontiguousarray(x).view(np.uint32)


def _quads(w: np.ndarray) -> np.ndarray:
    """32-bit words (g, t, r) -> their int8 quadruples (g, t, r, 4), k order."""
    return np.ascontiguousarray(w).view(np.int8).reshape(*w.shape, 4)


def _mma_s8(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """One ``mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32`` by the PTX
    ISA's fragment map. ``a`` (g, t, 4) and ``b`` (g, t, 2) are the words of
    lane 4 g + t: a[0] row g, k 4t..4t+3; a[1] row g + 8; a[2], a[3] the same
    rows at k 16 + 4t; b0 k 4t..4t+3 of column g, b1 k 16 + 4t. Returns the C
    fragments (g, t, 4): c0, c1 row g, columns 2t, 2t + 1; c2, c3 row g + 8."""
    qa, qb = _quads(a), _quads(b)
    A = np.zeros((16, 32), np.int64)
    A[:8, :16], A[8:, :16] = qa[:, :, 0].reshape(8, 16), qa[:, :, 1].reshape(8, 16)
    A[:8, 16:], A[8:, 16:] = qa[:, :, 2].reshape(8, 16), qa[:, :, 3].reshape(8, 16)
    B = np.zeros((32, 8), np.int64)
    B[:16], B[16:] = qb[:, :, 0].reshape(8, 16).T, qb[:, :, 1].reshape(8, 16).T
    C = A @ B
    return np.stack([C[:8, 0::2], C[:8, 1::2], C[8:, 0::2], C[8:, 1::2]], -1)


def _fragment_sums(rows: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """The int8 body's sums for one 16-row fragment and one tile of 8 queries:
    at k-chunk c lane (g, t) holds bytes [64 c + 16 t, + 16) of rows g and
    g + 8 and of query g; words x, y feed k-step 0 and z, w k-step 1, as
    ``compute`` in csrc/retrieval_tilemax.cu builds a0, a1 and b."""
    acc = np.zeros((8, 4, 4), np.int64)
    for c in range(rows.shape[1] // 64):
        rw = _words(rows[:, 64 * c:64 * c + 64].reshape(16, 4, 16))  # (row, t, word)
        qw = _words(queries[:, 64 * c:64 * c + 64].reshape(8, 4, 16))
        for lo, hi in ((0, 1), (2, 3)):
            a = np.stack([rw[:8, :, lo], rw[8:, :, lo], rw[:8, :, hi], rw[8:, :, hi]], -1)
            acc += _mma_s8(a, np.stack([qw[:, :, lo], qw[:, :, hi]], -1))
    return acc


def _tile_maxima(values, scales, queries, tile):
    """The int8 body's tile maxima (8, ceil(N / tile)) for 8 queries: rows at
    or past N are zero fragments with no scale read (0), each sum turned into
    float32(sum) * scale[row], then per query column the max of a lane's two
    rows (tile 16) and the max over the 8 row groups."""
    N, D = values.shape
    nf = -(-N // 16)
    rows = np.zeros((nf * 16, D), np.int8)
    rows[:N] = values
    sc = np.zeros(nf * 16, np.float32)
    sc[:N] = scales
    out = []
    for f in range(nf):
        acc = _fragment_sums(rows[16 * f:16 * f + 16], queries)
        assert np.abs(acc).max() < 2 ** 24  # exact in fp32
        s = sc[16 * f:16 * f + 16]
        score = acc.astype(np.float32) * np.stack([s[:8], s[:8], s[8:], s[8:]], -1)[:, None, :]
        if tile == 16:
            m = np.maximum(score[..., 0:2], score[..., 2:4]).max(0)  # (t, query 2t | 2t + 1)
            out.append(m.reshape(8)[:, None])
        else:  # two 8-row tiles per fragment: rows g, then rows g + 8
            m = score.max(0)  # (t, 4)
            out.append(np.stack([m[:, 0:2].reshape(8), m[:, 2:4].reshape(8)], 1))
    return np.concatenate(out, 1)[:, :-(-N // tile)]


def _q8_case(rng, N, D):
    x = rng.standard_normal((N, D)).astype(np.float32)
    values, scales = R.quantize_index_int8(torch.from_numpy(x))
    q = rng.standard_normal((8, D)).astype(np.float32)
    q[:4] = x[rng.integers(0, N, 4)]  # self-matches: the largest sums
    qq, _ = R._quantize_queries(torch.from_numpy(q))
    return values.numpy(), scales.numpy()[:, 0], qq.numpy()


@pytest.mark.parametrize("D", [64, 512, 768, 1024])
def test_s8_fragments_sum_to_the_exact_dot(D):
    rng = np.random.default_rng(D)
    rows = rng.integers(-127, 128, (16, D)).astype(np.int8)
    queries = rng.integers(-127, 128, (8, D)).astype(np.int8)
    exact = rows.astype(np.int64) @ queries.astype(np.int64).T  # (16, 8)
    want = np.stack([exact[:8, 0::2], exact[:8, 1::2], exact[8:, 0::2], exact[8:, 1::2]], -1)
    assert np.array_equal(_fragment_sums(rows, queries), want)


@pytest.mark.parametrize("tile", [8, 16])
@pytest.mark.parametrize("N,D", [(64, 512), (40, 768), (35, 1024)])
def test_s8_tile_maxima_equal_the_plain_version_bit_for_bit(N, D, tile):
    values, scales, qq = _q8_case(np.random.default_rng(N + D), N, D)
    got = _tile_maxima(values, scales, qq, tile)
    t = torch.from_numpy
    ref, _ = R.tilemax_sup_q8_plain(t(qq), t(values), t(scales)[:, None], tile, 16)
    assert np.array_equal(got, ref.numpy())


@pytest.mark.parametrize("tile", [8, 16])
def test_s8_worst_case_at_d_1024_stays_exact(tile):
    """Every value at +-127 with the query's signs: a sum of 127 * 127 *
    1024 = 16,516,096 (and its negative), still below 2^24."""
    rng = np.random.default_rng(1024)
    sign = np.where(rng.random((24, 1024)) < 0.5, -1, 1).astype(np.int8)
    values = (127 * sign).astype(np.int8)
    qq = np.concatenate([values[:4], -values[4:8]])
    scales = (rng.random(24).astype(np.float32) + np.float32(0.5)) / np.float32(127)
    sums = _fragment_sums(values[:16], qq)
    assert sums.max() == 127 * 127 * 1024 == 16_516_096 < 2 ** 24 and sums.min() == -16_516_096
    got = _tile_maxima(values, scales, qq, tile)
    t = torch.from_numpy
    ref, _ = R.tilemax_sup_q8_plain(t(qq), t(values), t(scales)[:, None], tile, 16)
    assert np.array_equal(got, ref.numpy())
    assert got[0, 0] == np.float32(16_516_096) * scales[0]  # the self-match holds its tile's maximum
