"""Approximate top-k (``ops/approx_topk.py``, ``top_k_similar`` and
``SearchIndex`` with ``approximate=True``) against XLA's bin count and the
JAX package on the CPU.

On the CPU JAX's ``lax.approx_max_k`` returns the exact top-k, so the port
is held to the JAX package only where it is exact too (``L == N``, k = 1);
elsewhere the binned selection is held to a numpy statement of its
definition over the same score matrix, and its recall to the target.
"""

import numpy as np
import pytest
import torch

from jax._src.lib import _jax

from clip_lora_match_tpu.index.store import EmbeddingIndex as JIndex
from clip_lora_match_tpu.retrieval.search import SearchIndex as JSearch
from clip_lora_match_tpu.retrieval.similarity import top_k_similar as j_top_k_similar
from clip_lora_match_tpu_torch import ops
from clip_lora_match_tpu_torch.index.store import EmbeddingIndex as TIndex
from clip_lora_match_tpu_torch.ops import approx_topk as A
from clip_lora_match_tpu_torch.retrieval.search import SearchIndex as TSearch
from clip_lora_match_tpu_torch.retrieval.similarity import top_k_similar

# N from 1 to 1,048,586: the edges of the formula, powers of two and their
# neighbours, and a log-spaced sweep
GRID_N = sorted(
    {1, 2, 100, 127, 128, 129, 200, 255, 256, 257, 383, 384, 1000, 2048, 4095, 4096, 8192, 8195,
     16384, 40000, 44446, 65536, 100000, 131072, 524298, 1048576, 1048586}
    | {int(n) for n in np.logspace(0, np.log10(1_048_586), 48)}
)


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _xla_bins(N, k, r):
    return tuple(_jax.approx_top_k_reduction_output_size(N, 2, k, r, False, -1))


@pytest.mark.parametrize("r", [0.5, 0.7, 0.9, 0.95, 0.99, 1.0])
@pytest.mark.parametrize("k", [2, 5, 10, 64, 100, 256])
def test_reduction_bins_equal_xla(k, r):
    """XLA's ``approx_top_k_reduction_output_size`` (the function
    ``lax.approx_max_k`` reads) over N from 1 to 1,048,586: (L, lg) equal."""
    for N in GRID_N:
        if k <= N:
            assert A.reduction_bins(N, k, r) == _xla_bins(N, k, r), (N, k, r)


def test_reduction_bins_edges():
    assert A.reduction_bins(40_000, 1, 0.9) == (40_000, 0)  # k = 1: the exact route
    assert A.reduction_bins(44_446, 10, 0.95) == (384, 7)
    with pytest.raises(ValueError, match="recall_target"):
        A.reduction_bins(1000, 5, 0.0)


def _numpy_binned(sims: np.ndarray, L: int, k: int):
    """The definition: row j in bin j mod L (scores padded with -inf to whole
    windows), per-bin argmax with ties to the lowest row, then the exact top-k
    over the bins, descending, ties to the lower id."""
    Q, N = sims.shape
    W = -(-N // L)
    pad = np.full((Q, W * L), -np.inf, np.float32)
    pad[:, :N] = sims
    win = pad.reshape(Q, W, L)
    arg = win.argmax(axis=1)  # numpy: the first maximum
    vals = np.take_along_axis(win, arg[:, None, :], 1)[:, 0]
    ids = arg * L + np.arange(L)
    out_s, out_i = [], []
    for v, i in zip(vals, ids):
        order = np.lexsort((i, -v))[:k]
        out_s.append(v[order])
        out_i.append(i[order])
    return np.array(out_s), np.array(out_i)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [2048, 8195])
def test_plain_binned_selection_matches_definition(N, dtype):
    """Exact ids and scores within 1e-6 (the same score matrix; the bound is
    the fp32 gather). The index repeats rows inside a bin (j and j + L) and
    across bins, so both tie rules are exercised."""
    rng = np.random.default_rng(N)
    k, r = 10, 0.9
    L, lg = A.reduction_bins(N, k, r)
    assert L < N and lg > 0
    x = _unit(rng, N, 64)
    x[L + 3] = x[3]  # same bin, later window: bin 3 keeps row 3
    x[7] = x[5]  # bins 5 and 7 tie: row 5 ranks first
    x[L + 9] = x[11]  # bins 9 and 11 tie with rows L + 9 and 11: row 11 first
    index = torch.from_numpy(x).to(dtype)
    q = torch.from_numpy(np.concatenate([x[[3, 5, 11]], rng.standard_normal((5, 64))]).astype(np.float32))
    s, i = A.approx_topk_plain(q, index, k, r)
    qc = A._normalize_div(q).to(dtype)
    sims = (qc.float() @ index.float().T).numpy()
    ws, wi = _numpy_binned(sims, L, k)
    np.testing.assert_array_equal(i.numpy(), wi)
    np.testing.assert_allclose(s.numpy(), ws, atol=1e-6, rtol=0)
    assert i[0, 0] == 3 and i[1, :2].tolist() == [5, 7] and i[2, :2].tolist() == [11, L + 9]
    assert i.dtype == torch.int32 and s.dtype == torch.float32


def test_binmax_plain_is_the_per_bin_maximum():
    rng = np.random.default_rng(3)
    index = torch.from_numpy(_unit(rng, 1000, 32))
    q = torch.from_numpy(_unit(rng, 4, 32))
    vals, ids = A.binmax_plain(q, index, 256)
    sims = q @ index.T
    assert vals.shape == ids.shape == (4, 256)
    assert torch.equal(sims.gather(1, ids.long()), vals)
    assert torch.equal(ids.long() % 256, torch.arange(256).expand(4, -1))
    for b in (0, 100, 255):
        assert torch.equal(vals[:, b], sims[:, b::256].amax(1))


@pytest.mark.parametrize("case", ["exact_target", "small_n", "no_reduction", "k1"])
def test_exact_cases_match_jax(case):
    """Where the port is exact (L == N, k = 1) it equals the JAX package's
    ``top_k_similar(approximate=True)``: ids tie-aware, scores within 1e-5
    (the exact route normalizes by rsqrt, JAX by a division)."""
    N, k, r = {"exact_target": (3000, 10, 1.0), "small_n": (120, 10, 0.9),
               "no_reduction": (200, 10, 0.95), "k1": (3000, 1, 0.9)}[case]
    assert A.reduction_bins(N, k, r) == (N, 0)
    rng = np.random.default_rng(7)
    c = _unit(rng, N, 32)
    q = rng.standard_normal((6, 32)).astype(np.float32)
    ts, ti = top_k_similar(q, torch.from_numpy(c), k, approximate=True, recall_target=r)
    js, ji = j_top_k_similar(q, c, k, approximate=True, recall_target=r)
    np.testing.assert_allclose(ts, js, atol=1e-5, rtol=0)
    gap = np.minimum(np.abs(np.diff(js, prepend=np.inf)), np.abs(np.diff(js, append=-np.inf)))
    assert ((ti == ji) | (gap <= 1e-5)).all()
    s1, i1 = top_k_similar(q[0], torch.from_numpy(c), k, approximate=True, recall_target=r)
    assert s1.shape == (k,) and i1.shape == (k,)


@pytest.mark.parametrize("r", [0.9, 0.95])
def test_recall_at_target(r):
    """N = 8,192, Q = 64, k = 10: mean recall against the exact ids at least
    r - 0.02; every returned score is its id's exact dot (within 1e-5), and no
    id repeats."""
    rng = np.random.default_rng(11)
    N, Q, k = 8192, 64, 10
    L, _ = A.reduction_bins(N, k, r)
    assert L < N
    c = torch.from_numpy(_unit(rng, N, 64))
    q = torch.from_numpy(rng.standard_normal((Q, 64)).astype(np.float32))
    s, i = top_k_similar(q, c, k, assume_normalized=True, approximate=True, recall_target=r)
    es, ei = top_k_similar(q, c, k, assume_normalized=True)
    recall = np.mean([len(set(a) & set(b)) / k for a, b in zip(i, ei)])
    assert recall >= r - 0.02, recall
    qn = torch.nn.functional.normalize(q, dim=1)
    dots = (qn[:, None, :] * c[torch.from_numpy(i).long()]).sum(-1).numpy()
    np.testing.assert_allclose(s, dots, atol=1e-5, rtol=0)
    assert all(len(set(row)) == k for row in i)
    assert (np.diff(s, axis=1) <= 0).all()


def test_search_index_approximate_flag_matches_jax():
    """The case of the JAX package's own test (recall_target = 1.0: exact)."""
    rng = np.random.default_rng(0)
    emb = _unit(rng, 64, 16)
    jidx, tidx = JIndex(dim=16), TIndex(dim=16, device="cpu")
    for i in range(64):
        jidx.append(emb[i], f"p{i}", f"t{i}")
        tidx.append(emb[i], f"p{i}", f"t{i}")
    japprox = JSearch(jidx, approximate=True, recall_target=1.0)
    tapprox = TSearch(tidx, approximate=True, recall_target=1.0)
    texact = TSearch(tidx)
    got = tapprox.search_with_embedding(emb[7], k=5)
    want = japprox.search_with_embedding(emb[7], k=5)
    assert [r.index for r in got] == [r.index for r in want] == [
        r.index for r in texact.search_with_embedding(emb[7], k=5)]
    assert got[0].index == 7 and got[0].image_path == "p7"
    np.testing.assert_allclose([r.score for r in got], [r.score for r in want], atol=1e-5)
    batch = tapprox.search_batch(emb[:3], k=2)
    assert [b[0].index for b in batch] == [0, 1, 2]


def test_search_index_approximate_below_target_and_from_file(tmp_path):
    """A binned search over 4,096 rows finds each row's own embedding first;
    ``from_file`` threads ``recall_target`` through."""
    rng = np.random.default_rng(5)
    emb = _unit(rng, 4096, 16)
    idx = TIndex(emb, [f"p{i}" for i in range(4096)], device="cpu")
    s = TSearch(idx, approximate=True, recall_target=0.9)
    assert A.reduction_bins(4096, 5, 0.9)[0] < 4096
    assert [r[0].index for r in s.search_batch(emb[[0, 77, 4095]], k=5)] == [0, 77, 4095]
    path = str(tmp_path / "idx.npz")
    idx.save(path)
    loaded = TSearch.from_file(path, dim=16, approximate=True, recall_target=0.8, device="cpu")
    assert loaded.approximate and loaded.recall_target == 0.8
    assert loaded.search_with_embedding(emb[77], k=3)[0].index == 77


def test_int8_takes_precedence_over_approximate():
    """``quantize="int8"`` comes first and ignores ``approximate``, as in the
    JAX package's ``_topk``."""
    rng = np.random.default_rng(9)
    emb = _unit(rng, 5000, 32)
    idx = TIndex(emb, device="cpu")
    q = rng.standard_normal((4, 32)).astype(np.float32)
    both = TSearch(idx, quantize="int8", approximate=True, recall_target=0.5).search_batch(q, k=10)
    q8 = TSearch(idx, quantize="int8").search_batch(q, k=10)
    assert [[(r.index, r.score) for r in row] for row in both] == [
        [(r.index, r.score) for r in row] for row in q8]


def test_approx_topk_contract_and_cpu_launches_nothing():
    rng = np.random.default_rng(2)
    index = torch.from_numpy(_unit(rng, 3000, 32))
    q = torch.from_numpy(rng.standard_normal((2, 32)).astype(np.float32))
    ops.reset_launch_counts()
    s, i = A.approx_topk(q, index, 10, 0.9)
    assert s.shape == i.shape == (2, 10) and ops.launch_counts()["approx_topk"] == 0
    s0, i0 = A.approx_topk(q, index, 0, 0.9)
    assert s0.shape == i0.shape == (2, 0)
    with pytest.raises(ValueError, match="nonnegative"):
        A.approx_topk(q, index, -1, 0.9)
    s_all, _ = A.approx_topk(q, index[:20], 50, 0.9)  # k clamped to N
    assert s_all.shape == (2, 20)
    with pytest.raises(ValueError, match="multiple of 128"):
        A.binmax(q, index, 200)
    with pytest.raises(TypeError, match="its type"):
        A.binmax(q.bfloat16(), index, 256)


# the query block at each shape of test_binmax_plan: fp32 D=512, bf16 D=512, fp32 D=768
@pytest.mark.parametrize("Q, body, qbs", [(1, "cuda_core", (1, 1, 1)), (3, "cuda_core", (4, 4, 4)),
                                          (8, "cuda_core", (8, 8, 8)), (16, "cuda_core", (8, 8, 8)),
                                          (17, "mma", (32, 32, 16)), (32, "mma", (32, 32, 16)),
                                          (64, "mma", (32, 64, 16)), (200, "mma", (32, 64, 16))])
def test_binmax_plan(Q, body, qbs):
    """The body switch at Q = 17 and the grid at the main path's shapes:
    the bins in whole slabs, at most one split a window, one block an SM
    (about one wave), the wgmma body on blocks of up to 64 bf16 or 32 fp32
    queries (16 from D = 768)."""
    for (N, D, dtype, k, r), qb in zip(((44_446, 512, torch.float32, 10, 0.95),
                                        (524_298, 512, torch.bfloat16, 10, 0.95),
                                        (44_446, 768, torch.float32, 100, 0.9)), qbs):
        L, _ = A.reduction_bins(N, k, r)
        p = A.binmax_plan(Q, N, D, dtype, L, 132)
        assert (p.body, p.qb) == (body, qb)
        W = -(-N // L)
        assert p.grid == (L // p.bins, p.splits, -(-Q // p.qb)) and L % p.bins == 0
        assert 1 <= p.splits <= W
        blocks = p.grid[0] * p.grid[1] * p.grid[2]
        assert p.splits == W or blocks >= 100  # about one wave of 132 SMs
    # rows not of whole 128-byte slices take the CUDA-core body
    assert A.binmax_plan(64, 4096, 24, torch.float32, 256, 132).body == "cuda_core"


# every (k, r) of chip_smoke.py phases 2 and 13 (a), and the two-stage selection's row
_PHASE_KR = [(5, 0.9), (5, 0.95), (5, 0.99), (10, 0.9), (10, 0.95), (10, 0.99), (100, 0.9), (100, 0.95),
             (100, 0.99), (256, 0.99)]


# the wgmma body's largest query block beside three 32 KB stages (fp32: hi and lo queries)
_MMA_QB_MAX = {(torch.float32, 512): 32, (torch.float32, 768): 16, (torch.float32, 1024): 16,
               (torch.bfloat16, 512): 64, (torch.bfloat16, 768): 64, (torch.bfloat16, 1024): 64}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [512, 768, 1024])
@pytest.mark.parametrize("N", [44_446, 524_298])
def test_binmax_plan_rules(N, D, dtype):
    """The plan at every Q of the card tests and every (k, r) of phases 2 and
    13: the body by Q and slice, the shared memory of ``_core_smem`` /
    ``_mma_smem`` within 232,448 bytes with at least two ring stages (four
    for wgmma), splits within the windows and 65,535, the query block and
    blocks covering the queries, and the selection's chunks holding the
    candidates."""
    elem = 4 if dtype == torch.float32 else 2
    rb = D * elem
    for k, r in _PHASE_KR:
        L, _ = A.reduction_bins(N, k, r)
        if L == N or k > L:
            continue
        W = -(-N // L)
        for Q in (1, 2, 8, 16, 17, 32, 64, 65, 130):
            p = A.binmax_plan(Q, N, D, dtype, L, 132)
            assert p.body == ("mma" if Q >= A.BINMAX_MMA_MIN_Q else "cuda_core")
            assert p.smem <= 232_448 and 1 <= p.splits <= min(W, 65_535)
            if p.body == "mma":
                terms = 2 if dtype == torch.float32 else 1
                wg = p.bins // 64
                assert p.bins in (64, 128) and p.rows == 4 // wg and 3 <= p.stages <= 8
                assert (rb // 128) % p.rows == 0 and wg * p.rows * 8192 == 32_768  # 32 KB stages
                assert p.smem == A._mma_smem(p.qb, rb, terms, wg, p.rows, p.stages)
                assert A._mma_smem(p.qb, rb, terms, wg, p.rows, p.stages + 1) > 232_448 or p.stages == 8
                # the next power of two from Q, 16 up to the largest block that fits
                assert p.qb == min(_MMA_QB_MAX[dtype, D], max(16, 1 << (Q - 1).bit_length()))
                assert terms == 1 or p.qb < 32 or p.bins == 64  # fp32 at 32: one warpgroup
            else:
                assert p.qb == 1 << (min(Q, 8) - 1).bit_length()
                assert p.bins in (16, 32, 64, 128) and p.rows % 16 == 0 and p.bins % p.rows == 0
                assert p.stages >= 2 and p.smem == A._core_smem(p.qb, rb, p.bins, p.rows, p.stages)
                assert p.rows * rb <= 65_536 and (p.rows == 16 or p.rows * rb <= 32_768)
            assert p.grid == (L // p.bins, p.splits, -(-Q // p.qb))
        chunk = A.select_plan(L, k)
        assert chunk is not None  # every phase shape takes the fused selection
        if L <= A.SEL_CAP:
            assert chunk == L
        else:
            assert chunk < L and -(-L // chunk) * k <= A.SEL_CAP


def test_select_plan_threshold_and_refusals():
    """One launch up to 8,192 bins, two from 8,320 (the next multiple of
    128); none past ``K_MAX`` or L, or where the candidates overflow."""
    assert A.select_plan(8192, 256) == 8192
    assert A.select_plan(8320, 256) == 4096 and A.select_plan(8320, 10) == 4096
    assert A.select_plan(32_896, 256) == 4096  # phase 13's k=256 r=0.99 arena row: 9 chunks
    assert A.select_plan(140_000, 256) == 8192  # 18 chunks of 8,192
    assert A.select_plan(300_000, 256) is None  # 37 chunks of 256: 9,472 candidates
    assert A.select_plan(384, 257) is None and A.select_plan(128, 200) is None
    assert A.select_plan(128, 0) is None


def _split_partials(qc, index, L, splits):
    """Each split's bin maxima over its windows (the kernel's split_range),
    the lowest row on ties; (-inf, -1) where a split holds no row of a bin."""
    Q, N = qc.shape[0], index.shape[0]
    W = -(-N // L)
    sims = torch.nn.functional.pad(qc.float() @ index.float().T, (0, W * L - N), value=-float("inf")).view(Q, W, L)
    pv, pi = [], []
    for s in range(splits):
        w0, w1 = s * W // splits, (s + 1) * W // splits
        v, w = torch.max(sims[:, w0:w1], dim=1)
        ids = (w + w0) * L + torch.arange(L)
        real = v > -float("inf")
        pv.append(v)
        pi.append(torch.where(real, ids, torch.full_like(ids, -1)).to(torch.int32))
    return torch.stack(pv), torch.stack(pi)


@pytest.mark.parametrize("N, L, splits, k", [
    (N, L, splits, k)
    for N, L, splits in ((1000, 128, 1), (1000, 256, 3), (20_000, 8192, 2), (20_000, 8320, 2), (19_990, 9_984, 1),
                         (66_000, 32_896, 2))
    for k in (1, 2, 10, 100, 256) if k <= L
])
def test_select_plain_is_the_binned_selection(N, L, splits, k):
    """The fused selection's contract (``select_plain``: split maxima merged
    in split order, the top k of each chunk, then of the candidates) against
    ``_select_bins(*binmax_plain(...))``, bit for bit in scores and ids. The
    index repeats rows inside a bin (later windows, other splits) and across
    bins, and the queries are some of those rows, so every tie rule is hit;
    L up to N / 2."""
    rng = np.random.default_rng(N + L + k)
    D = 16
    x = _unit(rng, N, D)
    x[L + 3] = x[3]  # bin 3: rows 3 and L + 3 tie (same split or the next)
    x[(N // L - 1) * L + 3] = x[3]  # and a row in the last full window (the last split)
    x[7] = x[5]  # bins 5 and 7 tie: row 5 first
    x[2 * L + 9] = x[11]  # bins 9 and 11 tie at rows 2L + 9 and 11: row 11 first
    x = np.round(x * 64) / 64  # coarse values: many equal scores across bins
    index = torch.from_numpy(x.astype(np.float32))
    q = torch.from_numpy(np.concatenate([x[[3, 5, 11]], rng.standard_normal((3, D))]).astype(np.float32))
    qc = A._normalize_div(q)
    part_v, part_i = _split_partials(qc, index, L, splits)
    chunk = A.select_plan(L, k) if k > 1 else L
    s, i = A.select_plain(part_v, part_i, k, chunk)
    ws, wi = A._select_bins(*A.binmax_plain(qc, index, L), k)
    assert torch.equal(s, ws) and torch.equal(i, wi)
    assert s.dtype == torch.float32 and i.dtype == torch.int32 and s.shape == (6, k)
    if k >= 2:
        assert i[0, 0] == 3 and i[1, :2].tolist() == [5, 7] and i[2, :2].tolist() == [11, 2 * L + 9]


def test_select_plain_merges_in_split_order():
    """Equal maxima in two splits: the earlier split's (lower) row stays;
    -0 and +0 tie and go to the lower id, as torch.sort has them."""
    pv = torch.tensor([[[0.5, -0.0, 0.25]], [[0.5, 0.0, 0.75]]])
    pi = torch.tensor([[[0, 1, 2]], [[3, 4, 5]]], dtype=torch.int32)
    s, i = A.select_plain(pv, pi, 3, 3)
    assert i.tolist() == [[5, 0, 1]] and s.tolist() == [[0.75, 0.5, -0.0]]
    assert torch.signbit(s[0, 2])  # the kept -0's own bits


def test_select_bins_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(4)
    vals = torch.from_numpy(np.round(rng.standard_normal((3, 9000)) * 8).astype(np.float32) / 8)
    ids = torch.from_numpy(rng.permutation(9000 * 3)[:27_000].reshape(3, 9000).astype(np.int32))
    n0 = A.approx_topk.select_launches
    s, i = A.select_bins(vals, ids, 100)
    ws, wi = A._select_bins(vals, ids, 100)
    assert torch.equal(s, ws) and torch.equal(i, wi) and A.approx_topk.select_launches == n0
    for bad in (dict(k=257), dict(k=0), dict(ids=ids.long())):
        args = dict(vals=vals, ids=ids, k=10) | bad
        with pytest.raises(ValueError, match="select_bins"):
            A.select_bins(**args)


def test_binmax_refusals_before_any_launch():
    """What the kernel does not take raises on the CPU as on the card, in
    the wrapper (``binmax``) and in the plan, before any launch: rows not of
    whole 16-byte vectors or past 4,096 bytes, L off the multiple of 128 or
    outside [128, N], queries of another type, query blocks past 65,535."""
    rng = np.random.default_rng(6)
    index = torch.from_numpy(_unit(rng, 2048, 64))
    q = torch.from_numpy(_unit(rng, 2, 64))
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        A.binmax(q[:, :62].contiguous(), index[:, :62].contiguous(), 128)  # 248-byte rows
    with pytest.raises(ValueError, match="16-byte"):
        A.binmax(q.bfloat16()[:, :60].contiguous(), index.bfloat16()[:, :60].contiguous(), 128)  # 120 bytes
    wide = torch.zeros(256, 1028)
    with pytest.raises(ValueError, match="at most 4096"):
        A.binmax(wide[:1], wide, 128)  # 4,112-byte rows
    for L in (100, 64, 4096):  # off the multiple, under 128, past N
        with pytest.raises(ValueError, match="multiple of 128"):
            A.binmax(q, index, L)
    with pytest.raises(ValueError, match="multiple of 128"):
        A.binmax(q, index[:2000], 2048)
    with pytest.raises(TypeError, match="its type"):
        A.binmax(q.bfloat16(), index, 256)
    with pytest.raises(ValueError, match="query blocks"):
        A.binmax_plan(65_535 * 64 + 1, 1 << 20, 512, torch.bfloat16, 4096, 132)
    assert A.binmax_plan(65_535 * 64, 1 << 20, 512, torch.bfloat16, 4096, 132).grid[2] == 65_535
    assert sum(ops.launch_counts().values()) == 0
    assert A.binmax(torch.zeros(1, 1024), torch.zeros(256, 1024), 128)[0].shape == (1, 128)  # 4,096 bytes
