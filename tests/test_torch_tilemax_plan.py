"""Pass 1's launch plan (``ops.retrieval_topk.tilemax_plan``) and the mma
body's 3xTF32 arithmetic, on the CPU.

At every shape the main path and chip_smoke.py give ``tilemax`` and
``tilemax_sup``: shared memory fits a block, the grid fills the card, a query
batch of up to 64 reads the index once, the blocks cover every tile with no
empty block, a ``tilemax_sup`` block holds whole groups, and Q <= 8 or a tile
outside {8, 16} takes the CUDA-core body. A numpy emulation of the 3xTF32
product (``hopper::split`` as written, the tensor core reading lo's TF32
bits, fp32 sums) states on the CPU the 1e-5 tolerance the card tests hold
the fp32 kernel to.
"""

import itertools

import numpy as np
import pytest
import torch

from clip_lora_match_tpu_torch.ops import retrieval_topk as R

SMS = 132  # H100 SXM
F32, BF16 = torch.float32, torch.bfloat16

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
@pytest.mark.parametrize("dtype", [F32, BF16])
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
    for dtype, group in itertools.product((F32, BF16), (None, 16)):
        p = R.tilemax_plan(Q, 524_298, 512, dtype, tile, group, SMS)
        assert p.body == "cuda_core" and p.qb == 8 and p.grid[1] == -(-Q // 8)
        assert p.smem <= R.SMEM_BLOCK
        _check_cover(p, 524_298, tile)


@pytest.mark.parametrize("tile", [8, 16])
def test_the_body_switches_above_eight_queries(tile):
    for Q in range(1, 80):
        p = R.tilemax_plan(Q, 65_536, 512, BF16, tile, None, SMS)
        assert p.body == ("mma" if Q >= R.TILEMAX_MMA_MIN_Q else "cuda_core")
    assert R.TILEMAX_MMA_MIN_Q == 9  # Q <= 8, the seeker's batch, keeps its body


@pytest.mark.parametrize("D,dtype,body", [
    (40, BF16, "cuda_core"), (24, F32, "cuda_core"), (100, F32, "cuda_core"),  # rows not of whole 64-byte chunks
    (32, BF16, "mma"), (16, F32, "mma"), (96, BF16, "mma"),
    (4096, F32, "cuda_core"),  # no query block of 16 fits shared memory
    (4096, BF16, "mma"), (2048, F32, "mma"),
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


def test_smem_counts_match_the_layout():
    """``_mma_smem`` adds up ``mma_smem`` in the source: query rows at a
    stride of 64 mod 128 bytes, two stages of (tiles per round + 1) maxima."""
    assert R._mma_smem(64, 1024, 16) == 64 * (1024 + 64) + 2 * 4 * 64 * 17
    assert R._mma_smem(64, 3072, 8) == 64 * (3072 + 64) + 2 * 4 * 64 * 33
    assert R._mma_smem(16, 192, 16) == 16 * (256 + 64) + 2 * 4 * 16 * 17
    p = R.tilemax_plan(64, 1_048_586, 768, F32, 8, 16, SMS)
    assert (p.qb, p.smem) == (64, R._mma_smem(64, 3072, 8))


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
