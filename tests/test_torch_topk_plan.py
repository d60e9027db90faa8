"""The streaming top-k kernel's launch plan (``ops.retrieval_topk.plan``) on
the CPU: at every shape the main path and chip_smoke.py give it, the grid
fills the card (at least one block per SM), shared memory fits a block, and
Q > 8 takes the query-tile body; at any shape, the row ranges cover the
index with no empty block and the bodies match the alignment.
"""

import itertools

import pytest
import torch

from clip_lora_match_tpu_torch.ops import retrieval_topk as R

SMS = 132  # H100 SXM
F32, BF16 = torch.float32, torch.bfloat16

# (Q, N, D, k, dtype): the seeker's text / image / fused searches over phase
# 3's 44,446-row B/32 index and phase 5's D=768 L/14-336 index (one query
# each), and chip_smoke.py's phase-2 rows (Q = 1 and 64, k = 5 and 64, both
# index types)
MAIN_PATH = [
    (1, 44_446, 512, 5, F32),
    (1, 44_446, 768, 5, F32),
    *[(Q, 44_441, 512, k, dt) for Q, k, dt in itertools.product((1, 64), (5, 64), (F32, BF16))],
]


def _check_cover(p, N):
    gx, _ = p.grid
    assert p.rows_per_block * gx >= N > p.rows_per_block * (gx - 1)


@pytest.mark.parametrize("Q,N,D,k,dtype", MAIN_PATH)
def test_plan_fills_the_card_at_main_path_shapes(Q, N, D, k, dtype):
    p = R.plan(Q, N, D, k, dtype, True, SMS)
    assert p.grid[0] * p.grid[1] >= SMS
    assert p.smem <= R.SMEM_BLOCK
    assert p.body == ("tile" if Q > 8 else "rows")
    assert p.qt == (64 if Q > 8 else 1) and p.grid[1] == 1  # the index is read once
    _check_cover(p, N)
    if p.body == "rows":  # at least 32 KB of index rows in flight per SM
        elem = 4 if dtype == F32 else 2
        per_sm = min(2, R.SMEM_SM // (p.smem + 1024))
        assert per_sm * (p.stages - 1) * p.rows * D * elem >= 32 * 1024


@pytest.mark.parametrize("Q,want", [(1, 1), (2, 2), (3, 4), (5, 8), (8, 8)])
def test_plan_query_tile_follows_q(Q, want):
    p = R.plan(Q, 44_441, 512, 5, F32, True, SMS)
    assert (p.body, p.qt, p.grid[1]) == ("rows", want, 1)


@pytest.mark.parametrize("Q", [9, 64, 100, 1000])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_plan_above_eight_queries_takes_the_tile_body(Q, dtype):
    p = R.plan(Q, 44_441, 512, 5, dtype, True, SMS)
    assert p.body == "tile" and p.qt == 64 and p.grid[1] == -(-Q // 64)
    assert p.grid[0] * p.grid[1] >= SMS and p.smem <= R.SMEM_BLOCK


@pytest.mark.parametrize("k,per_sm", [(5, 2), (64, 2), (128, 1), (256, 1)])
def test_plan_tile_body_keeps_64_queries_at_every_k(k, per_sm):
    """The k-lists live in shared memory: at k = 256 one block fits an SM."""
    for D in (512, 768, 4096):
        p = R.plan(64, 44_441, D, k, F32, True, SMS)
        assert (p.body, p.qt, p.grid[1]) == ("tile", 64, 1)
        assert min(2, R.SMEM_SM // (p.smem + 1024)) == per_sm and p.grid[0] >= per_sm * SMS - 1


@pytest.mark.parametrize("D,dtype,aligned,body", [
    (512, F32, False, "plain"), (102, F32, True, "plain"), (100, BF16, True, "plain"),
    (100, F32, True, "rows"), (104, BF16, True, "rows"),
])
def test_plan_takes_the_plain_body_where_no_bulk_copy_fits(D, dtype, aligned, body):
    for Q in (1, 64):
        p = R.plan(Q, 5000, D, 5, dtype, aligned, SMS)
        assert p.body == (body if body == "plain" or Q == 1 else "tile")
        assert p.smem <= R.SMEM_BLOCK
        if p.body == "plain":  # scalar loads, no ring, tiles of 8 queries
            assert (p.stages, p.qt) == (0, 8)


@pytest.mark.parametrize("Q,N,D,k,dtype", [
    (1, 1, 8, 1, F32), (3, 5, 40, 5, BF16), (9, 257, 40, 7, F32), (100, 3001, 64, 256, BF16),
    (8, 1_000_000, 4096, 256, F32), (64, 65_535, 4096, 256, F32), (17, 3001, 1024, 64, BF16),
    (1, 44_441, 4096, 256, BF16), (1000, 10_000, 512, 256, F32), (2, 33, 1, 1, F32),
])
def test_plan_covers_any_shape_within_shared_memory(Q, N, D, k, dtype):
    for aligned, sms in itertools.product((True, False), (132, 114, 1)):
        p = R.plan(Q, N, D, k, dtype, aligned, sms)
        assert p.smem <= R.SMEM_BLOCK and p.qt in (1, 2, 4, 8, 64)
        assert p.grid[1] == -(-Q // p.qt)
        _check_cover(p, N)
        if p.body != "plain":
            assert p.stages >= 3


def test_plan_smem_counts_match_the_layouts():
    """_rows_smem and _tile_smem add up the regions the kernel lays out."""
    assert R._rows_smem(1, 512, 5, 8, 4, 4, True) == 4 * 8 * 2048 + 2048 + 64 + 40 + 32
    assert R._rows_smem(8, 102, 5, 32, 0, 4, False) == 8 * 102 * 4 + 2 * 8 * 32 * 4 + 320
    assert R._tile_smem(5, 4) == 256 + 64 * 5 * 8 + 4 * (64 * 36 * 4 + 64 * 144)
    assert R._tile_smem(256, 2) == 256 + 64 * 256 * 8 + 4 * (64 * 36 * 4 + 64 * 80)
