"""The port's sharded exact top-k against the JAX package's on the CPU.

One gloo world of 2 ranks and one of 4 run at once (``tests/_torch_dist.py``,
module fixture); each rank holds its shard of the padded index and runs
every case: JAX's ragged N = 10,001 case (``tests/test_ops_retrieval.py:417``),
its all-negative case (``:519``), the same with the best rows moved into the
padded last shard (at 1,001 rows, and at 41, where each shard's two-pass
search takes its oracle route), and shards of exactly k rows, each in fp32, bf16 and
int8, on the plain route and the two-pass route (plain pass 1 on the CPU).
The JAX package runs the same cases on meshes of its 8 virtual devices
(2 and 4 of them). Ids tie-aware, scores within 1e-5; int8 within the
quantized scorer's exactness.

A known difference: JAX's route without a kernel, and its two-pass search
where a shard has fewer tiles than the selection needs, mask the pad rows
after a shard's top-k, so where the best rows share the last shard with a
zero pad row, one of them is evicted. The port masks before selecting;
those cases are held to the unsharded oracle on every route.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_lora_match_tpu.ops import retrieval_topk as J
from clip_lora_match_tpu.parallel.mesh import make_mesh, pad_to_multiple
from clip_lora_match_tpu.retrieval.sharded import (
    shard_index,
    shard_index_q8,
    sharded_topk_retrieve,
    sharded_topk_retrieve_q8,
)
from clip_lora_match_tpu_torch.ops import retrieval_topk as T
from tests._torch_dist import retrieval_inputs, start_worlds

TOL = 1e-5
WORLDS = {"w2": 2, "w4": 4}
CASES = ("ragged", "all_negative", "best_in_pad_shard", "small_best_in_pad_shard", "exact_k")
# (case, route) where the JAX package lets a pad row evict a candidate
JAX_EVICTS = {("best_in_pad_shard", "plain"), ("small_best_in_pad_shard", "plain"),
              ("small_best_in_pad_shard", "twopass")}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds, joined where a test first reads them."""
    launched = start_worlds(WORLDS, "retrieval", tmp_path_factory.mktemp("sharded_retrieval"))
    yield launched
    launched.stop()


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _ids(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same(got, ref, tol=TOL):
    """Scores within ``tol``; ids equal except inside a run of reference
    scores tied within ``tol``, where the got id must be one of the run's."""
    gs, gi = _np(got[0]), _ids(got[1]).astype(np.int64)
    rs, ri = _np(ref[0]), _ids(ref[1]).astype(np.int64)
    assert gs.shape == rs.shape
    np.testing.assert_allclose(gs, rs, atol=tol)
    for q in range(rs.shape[0]):
        for j in np.nonzero(gi[q] != ri[q])[0]:
            tied = np.abs(rs[q] - rs[q, j]) <= tol
            assert tied.sum() > 1 and gi[q, j] in ri[q][tied], (q, j, gi[q], ri[q])


def _jax_mesh(n):
    return make_mesh(n_data=n, devices=jax.devices()[:n])


def _jax_sharded(case, n, dtype, use_kernel):
    mesh = _jax_mesh(n)
    padded, n_valid = pad_to_multiple(case["index"], n)
    with mesh:
        if dtype == "int8":
            vq, sc = J.quantize_index_int8(jnp.asarray(case["index"]))
            vp, _ = pad_to_multiple(np.asarray(vq), n)
            sp, _ = pad_to_multiple(np.asarray(sc), n)
            v, s = shard_index_q8(mesh, jnp.asarray(vp, jnp.int8), jnp.asarray(sp))
            return sharded_topk_retrieve_q8(case["queries"], v, s, k=case["k"], mesh=mesh, n_valid=n_valid)
        placed = shard_index(mesh, jnp.asarray(padded, jnp.bfloat16 if dtype == "bf16" else jnp.float32))
        return sharded_topk_retrieve(case["queries"], placed, k=case["k"], mesh=mesh, n_valid=n_valid,
                                     use_kernel=use_kernel)


def _oracle(case, dtype, route="plain"):
    """The unsharded exact search over the valid rows: the port's plain
    top-k, or its two-pass search over the whole index (the query cast to
    the index's type), or for int8 its quantized search."""
    q = torch.from_numpy(case["queries"])
    index = torch.from_numpy(case["index"])
    if dtype == "int8":
        return T.topk_retrieve_q8(q, *T.quantize_index_int8(index), case["k"])
    if dtype == "bf16":
        index = index.to(torch.bfloat16)
    if route == "twopass":
        return T.topk_retrieve_twopass(q, index, case["k"])
    return T.topk_retrieve_reference(q, index, case["k"])


def _rank_results(worlds, world, key):
    """Rank 0's result; every rank's must be the same."""
    got = [r[key] for r in worlds[world]]
    for other in got[1:]:
        assert torch.equal(other[0], got[0][0]) and torch.equal(other[1], got[0][1])
    return got[0]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("route", ["plain", "twopass"])
def test_sharded_topk_matches_jax(worlds, world, case, dtype, route):
    """The port's sharded search against JAX's at the same number of devices
    (the route with a kernel: JAX's two-pass with its fused XLA pass 1 on the
    CPU), and against the unsharded oracle."""
    inputs = retrieval_inputs(WORLDS[world])[case]
    ref = None
    if (case, route) not in JAX_EVICTS:  # JAX's known difference, below
        ref = _jax_sharded(inputs, WORLDS[world], dtype, route == "twopass")
    got = _rank_results(worlds, world, f"{case}/{dtype}/{route}")
    assert got[0].shape == (inputs["queries"].shape[0], inputs["k"]) and got[1].dtype == torch.int32
    if ref is not None:
        assert_same(got, ref)
    assert_same(got, _oracle(inputs, dtype, route))
    assert int(got[1].max()) < inputs["index"].shape[0]  # no pad id


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", CASES)
def test_sharded_q8_matches_jax(worlds, world, case):
    """int8: the unsharded quantized search bit for bit (one quantizer); JAX's
    sharded q8 search on every query whose int8 values the two packages'
    query quantizers agree on (XLA's CPU rsqrt and torch's differ by an ulp
    now and then, which can move one rounded value)."""
    inputs = retrieval_inputs(WORLDS[world])[case]
    got = _rank_results(worlds, world, f"{case}/int8")
    ref = _oracle(inputs, "int8")
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    js, ji = _jax_sharded(inputs, WORLDS[world], "int8", True)
    jq, _ = J._quantize_queries(jnp.asarray(inputs["queries"]))
    tq, _ = T._quantize_queries(torch.from_numpy(inputs["queries"]))
    same = (np.asarray(jq) == tq.numpy()).all(axis=1)
    assert same.sum() >= 1
    assert_same((got[0][same], got[1][same]), (np.asarray(js)[same], np.asarray(ji)[same]), tol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["ragged", "best_in_pad_shard"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_each_shard_matches_jax_twopass_with_max_pad(worlds, world, case, dtype):
    """Each rank's two-pass search over its shard, ``n_valid`` a Python int,
    against JAX's ``topk_retrieve_twopass`` with a traced ``n_valid`` and the
    static ``max_pad`` bound of the padded index."""
    n = WORLDS[world]
    inputs = retrieval_inputs(n)[case]
    padded, n_valid = pad_to_multiple(inputs["index"], n)
    shard_n = padded.shape[0] // n
    for rank, res in enumerate(worlds[world]):
        local, got = res[f"{case}/{dtype}/shard"]
        assert local == min(max(n_valid - rank * shard_n, 0), shard_n)
        rows = jnp.asarray(padded[rank * shard_n:(rank + 1) * shard_n],
                           jnp.bfloat16 if dtype == "bf16" else jnp.float32)
        ref = J.topk_retrieve_twopass(jnp.asarray(inputs["queries"]), rows, inputs["k"],
                                      n_valid=jnp.asarray(local), max_pad=padded.shape[0] - n_valid)
        assert_same(got, ref)
        assert int(got[1].max()) < local


def test_jax_plain_route_lets_a_pad_row_evict_a_candidate():
    """The JAX package's fault the port does not copy: its route without a
    kernel returns a wrong id where the best rows share the last shard with
    a zero pad row; the port's plain route (above) equals the oracle there."""
    inputs = retrieval_inputs(2)["best_in_pad_shard"]
    _, ji = _jax_sharded(inputs, 2, "fp32", False)
    _, oi = _oracle(inputs, "fp32")
    assert not np.array_equal(np.asarray(ji)[0], oi.numpy()[0])
    assert set(oi.numpy()[0]) == set(range(991, 1001))


@pytest.mark.parametrize("n", [2, 4])
def test_jax_oracle_route_of_a_shard_lets_a_pad_row_evict_a_candidate(n):
    """The same fault on JAX's two-pass route, where a shard of 41 padded
    rows has fewer tiles than the selection needs and the shard's search
    falls back to its oracle, masking after the top-k; the port's two-pass
    route (above) equals the oracle there."""
    inputs = retrieval_inputs(n)["small_best_in_pad_shard"]
    _, ji = _jax_sharded(inputs, n, "fp32", True)
    _, oi = _oracle(inputs, "fp32")
    assert not np.array_equal(np.asarray(ji)[0], oi.numpy()[0])
    assert set(oi.numpy()[0]) == set(range(31, 41))


def test_sharded_checks_its_arguments():
    from clip_lora_match_tpu_torch.parallel import make_mesh as t_mesh
    from clip_lora_match_tpu_torch.retrieval.sharded import sharded_topk_retrieve as t_sharded

    mesh = t_mesh(device="cpu")  # one process: one rank
    index = torch.from_numpy(np.random.default_rng(0).normal(size=(6, 8)).astype(np.float32))
    q = np.ones((2, 8), np.float32)
    with pytest.raises(ValueError, match="at least k"):
        t_sharded(q, index, 7, mesh)
    with pytest.raises(ValueError, match="nonnegative"):
        t_sharded(q, index, -1, mesh)
    with pytest.raises(ValueError, match="max_pad"):
        t_sharded(q, index, 2, mesh, n_valid=3, max_pad=2)
    s, i = t_sharded(q, index, 3, mesh, n_valid=4)
    assert int(i.max()) < 4 and s.shape == (2, 3)
