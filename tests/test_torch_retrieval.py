"""The port's HBM-scale retrieval (two-pass and int8 top-k) against the JAX
package on the CPU: the plain versions of the tile-max kernels against the
Pallas kernels in interpret mode, and the two-pass / q8 / auto entry points
end to end over forced routes, at the JAX tests' own sizes. Inputs are seeded
numpy arrays handed to both packages."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clip_lora_match_tpu.ops import retrieval_topk as J
from clip_lora_match_tpu_torch import ops as t_ops
from clip_lora_match_tpu_torch.ops import retrieval_topk as T


def _unit_rows(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _both(x: np.ndarray, dtype: str):
    """The same array in both packages, in fp32 or bf16."""
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype)), t


def _same(js, ji, ts, ti, **tol):
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **(tol or {"atol": 1e-5}))
    assert ti.dtype == torch.int32 and ts.dtype == torch.float32


def test_twopass_band_matches_jax_auto():
    """At N >= TWOPASS_MIN_N the port scores with the query cast to the index
    dtype, as the JAX package's two-pass path does (an fp32 query differs by
    up to ~4e-4 on a bf16 index)."""
    rng = np.random.default_rng(0)
    index = _unit_rows(rng, T.TWOPASS_MIN_N + 37, 128)
    queries = rng.normal(size=(4, 128)).astype(np.float32)
    j_index, t_index = _both(index, "bfloat16")
    js, ji = J.topk_retrieve_auto(jnp.asarray(queries), j_index, 10)
    ts, ti = T.topk_retrieve_auto(torch.from_numpy(queries), t_index, 10)
    _same(js, ji, ts, ti)


# -- the kernels' plain versions against the Pallas kernels -------------------


def _qc(rng, Q, D, dtype):
    """Normalized queries cast to the index dtype, the same in both packages."""
    q = rng.normal(size=(Q, D)).astype(np.float32)
    return _both(q / np.linalg.norm(q, axis=1, keepdims=True), dtype)


def _padded(index: np.ndarray, tile: int) -> np.ndarray:
    """The JAX kernels take an index already zero-padded to a tile multiple."""
    pad = -len(index) % tile
    return np.concatenate([index, np.zeros((pad, index.shape[1]), index.dtype)])


def _jax_maxima(main, tail, Q):
    parts = [np.asarray(main)[:Q]] if main is not None else []
    if tail is not None:
        parts.append(np.asarray(tail))
    return np.concatenate(parts, axis=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Q,N", [(1, 1000), (9, 4097), (7, 8192), (3, 8692)])
def test_tilemax_plain_matches_pallas(Q, N, dtype):
    rng = np.random.default_rng(N + Q)
    index = _unit_rows(rng, N, 128)
    j_qc, t_qc = _qc(rng, Q, 128, dtype)
    j_index, _ = _both(_padded(index, 16), dtype)
    _, t_index = _both(index, dtype)
    main, tail = J._tilemax_pallas(j_qc, j_index, 16, True)
    got = T.tilemax(t_qc, t_index, 16)
    assert got.shape == (Q, -(-N // 16)) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _jax_maxima(main, tail, Q), atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Q,N,group", [(1, 8192, 16), (7, 8692, 16), (9, 8192, 8), (4, 4097, 16)])
def test_tilemax_sup_plain_matches_pallas(Q, N, group, dtype):
    rng = np.random.default_rng(N + Q + group)
    index = _unit_rows(rng, N, 128)
    j_qc, t_qc = _qc(rng, Q, 128, dtype)
    j_index, _ = _both(_padded(index, 16), dtype)
    _, t_index = _both(index, dtype)
    main_t, sup_t, tail = J._tilemax_sup_pallas(j_qc, j_index, 16, group, True)
    tmax, gmax = T.tilemax_sup(t_qc, t_index, 16, group)
    main = None if main_t is None else np.asarray(main_t).T
    np.testing.assert_allclose(tmax.numpy(), _jax_maxima(main, tail, Q), atol=1e-6)
    n_sup = 0 if sup_t is None else sup_t.shape[0]
    np.testing.assert_allclose(gmax[:, :n_sup].numpy(), np.asarray(sup_t).T[:Q], atol=1e-6)
    # the port's groups run on over the tail: each the max of its tiles
    want = [tmax[:, g * group:(g + 1) * group].amax(1) for g in range(gmax.shape[1])]
    assert torch.equal(gmax, torch.stack(want, 1))


@pytest.mark.parametrize("mxu", ["int8", "bf16"])
@pytest.mark.parametrize("Q,N,D,group", [(1, 8192, 128, 16), (7, 8692, 128, 16), (9, 4097, 256, 8), (2, 2048, 1024, 16)])
def test_tilemax_sup_q8_plain_equals_pallas(Q, N, D, group, mxu):
    rng = np.random.default_rng(N + D + Q)
    vq, sc = J.quantize_index_int8(jnp.asarray(_unit_rows(rng, N, D)))
    qq, _ = J._quantize_queries(jnp.asarray(rng.normal(size=(Q, D)).astype(np.float32)))
    pad = -N % 16
    main_t, sup_t, tail = J._tilemax_sup_q8_pallas(
        qq, jnp.pad(vq, ((0, pad), (0, 0))), jnp.pad(sc, ((0, pad), (0, 0))),
        16, group, True, mxu,
    )
    tmax, gmax = T.tilemax_sup_q8(
        torch.from_numpy(np.array(qq)), torch.from_numpy(np.array(vq)),
        torch.from_numpy(np.array(sc)), 16, group, mxu,
    )
    # exact integers times the same fp32 scale: equal, not close
    np.testing.assert_array_equal(tmax.numpy(), _jax_maxima(np.asarray(main_t).T, tail, Q))
    np.testing.assert_array_equal(gmax[:, :sup_t.shape[0]].numpy(), np.asarray(sup_t).T[:Q])


# -- end to end over forced routes ---------------------------------------------


@pytest.mark.parametrize(
    "Q,N,D,dtype,n_valid,pallas,group",
    [
        (9, 1000, 128, "float32", None, True, None),    # no aligned main part
        (4, 4097, 128, "float32", None, True, None),    # main + one-tile tail
        (6, 2500, 128, "float32", None, True, None),    # multi-tile tail
        (5, 2048, 128, "float32", 2000, True, None),    # rows declared invalid
        (3, 1500, 256, "bfloat16", None, True, None),   # bf16 storage
        (7, 8192, 128, "float32", None, True, 16),      # hierarchical
        (7, 8692, 128, "float32", None, True, 16),      # hierarchical + tail
        (7, 8192, 128, "float32", 8000, True, 16),      # pad slack at group level
        (7, 8192, 128, "float32", None, True, 8),       # another group width
        (7, 8692, 128, "bfloat16", None, True, 16),     # hierarchical bf16
        (5, 3000, 128, "float32", 2990, False, None),   # the plain fused form
        (3, 100, 64, "float32", 90, False, None),       # tiny N: the oracle
    ],
)
def test_twopass_matches_jax(Q, N, D, dtype, n_valid, pallas, group):
    rng = np.random.default_rng(N + Q)
    index = _unit_rows(rng, N, D)
    queries = rng.normal(size=(Q, D)).astype(np.float32) * 3.0
    j_index, t_index = _both(index, dtype)
    js, ji = J.topk_retrieve_twopass(
        jnp.asarray(queries), j_index, 10, tile=16, n_valid=n_valid,
        pallas_pass1=pallas, interpret=True, group=group,
    )
    ts, ti = T.topk_retrieve_twopass(
        torch.from_numpy(queries), t_index, 10, tile=16, n_valid=n_valid,
        pallas_pass1=pallas, group=group,
    )
    _same(js, ji, ts, ti)
    if n_valid is not None:  # the tiny-N oracle leaves masked rows at NEG_INF
        assert (ti[ts > T.NEG_INF] < n_valid).all()


def test_twopass_fuzz_matches_jax():
    rng = np.random.default_rng(123)
    for _ in range(6):
        N, Q, k = int(rng.integers(300, 6000)), int(rng.integers(1, 12)), int(rng.integers(1, 16))
        tile = int(rng.choice([8, 16]))
        nv = int(rng.integers(max(1, N - 200), N)) if rng.random() < 0.4 else None
        pallas = bool(rng.random() < 0.5)
        index = _unit_rows(rng, N, 128)
        queries = rng.normal(size=(Q, 128)).astype(np.float32)
        cfg = dict(N=N, Q=Q, k=k, tile=tile, nv=nv, pallas=pallas)
        js, ji = J.topk_retrieve_twopass(
            jnp.asarray(queries), jnp.asarray(index), k, tile=tile, n_valid=nv,
            pallas_pass1=pallas, interpret=True,
        )
        ts, ti = T.topk_retrieve_twopass(
            torch.from_numpy(queries), torch.from_numpy(index), k, tile=tile,
            n_valid=nv, pallas_pass1=pallas,
        )
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji), str(cfg))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5, err_msg=str(cfg))


@pytest.fixture
def jax_query_quantizer(monkeypatch):
    """XLA's CPU rsqrt and torch's differ by an ulp on about half of all
    inputs, which can flip a rounded int8 query value; as the JAX package's
    own q8 tests do, hold selection and scoring to one query quantizer (the
    JAX package's) and test the port's quantizer on its own."""
    def quantize(queries):
        qq, s_q = J._quantize_queries(jnp.asarray(queries.numpy()))
        return torch.from_numpy(np.array(qq)), torch.from_numpy(np.array(s_q))

    monkeypatch.setattr(T, "_quantize_queries", quantize)


@pytest.mark.parametrize(
    "Q,N,D,n_valid,pallas,group,mxu",
    [
        (5, 120, 128, None, False, 0, "int8"),      # tiny N: the oracle
        (9, 1000, 128, None, True, 0, "int8"),      # no aligned main part
        (4, 4097, 128, None, True, 0, "int8"),      # flat: the plain fused form
        (5, 2048, 128, 2000, False, 0, "int8"),     # rows declared invalid
        (7, 8192, 128, None, True, 16, "int8"),     # hierarchical kernel route
        (7, 8692, 128, None, True, 16, "int8"),     # hierarchical + tail
        (7, 8192, 128, 8000, True, 16, "int8"),     # pad slack at group level
        (7, 8192, 128, None, True, 16, "bf16"),     # the other operand mode
        (3, 8692, 1024, 8600, True, 8, "int8"),     # the widest exact D
    ],
)
def test_q8_matches_jax(Q, N, D, n_valid, pallas, group, mxu, jax_query_quantizer):
    rng = np.random.default_rng(N + Q + D)
    index = _unit_rows(rng, N, D)
    queries = rng.normal(size=(Q, D)).astype(np.float32)
    vq, sc = J.quantize_index_int8(jnp.asarray(index))
    js, ji = J.topk_retrieve_q8(
        jnp.asarray(queries), vq, sc, 10, tile=16, n_valid=n_valid,
        pallas_pass1=pallas, interpret=True, group=group if group else None if pallas else 0,
        mxu=mxu,
    )
    tv, ts_ = T.quantize_index_int8(torch.from_numpy(index))
    ts, ti = T.topk_retrieve_q8(
        torch.from_numpy(queries), tv, ts_, 10, tile=16, n_valid=n_valid,
        pallas_pass1=pallas, group=group if group else None if pallas else 0, mxu=mxu,
    )
    _same(js, ji, ts, ti, rtol=1e-6)


def test_quantizers_match_jax():
    rng = np.random.default_rng(5)
    index = _unit_rows(rng, 300, 96)
    jv, js = J.quantize_index_int8(jnp.asarray(index))
    tv, ts = T.quantize_index_int8(torch.from_numpy(index))
    assert tv.dtype == torch.int8 and ts.shape == (300, 1)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    queries = rng.normal(size=(64, 96)).astype(np.float32) * 2.0
    jq, jsq = J._quantize_queries(jnp.asarray(queries))
    tq, tsq = T._quantize_queries(torch.from_numpy(queries))
    # one ulp of rsqrt apart at most: an int8 value moves by at most one
    assert np.abs(tq.numpy().astype(int) - np.asarray(jq).astype(int)).max() <= 1
    np.testing.assert_allclose(tsq.numpy(), np.asarray(jsq), rtol=1e-6)


def test_q8_chunked_pass12_matches_unchunked(monkeypatch):
    rng = np.random.default_rng(41)
    values, scales = T.quantize_index_int8(torch.from_numpy(_unit_rows(rng, 8192, 128)))
    queries = torch.from_numpy(rng.normal(size=(1300, 128)).astype(np.float32))
    args = dict(k=10, tile=16, pallas_pass1=True, group=16)
    s0, i0 = T.topk_retrieve_q8(queries, values, scales, **args)
    calls = []
    real = T.tilemax_sup_q8
    monkeypatch.setattr(T, "tilemax_sup_q8", lambda q, *a: calls.append(q.shape[0]) or real(q, *a))
    monkeypatch.setattr(T, "_Q8_MAXIMA_BYTES", 4 * 512 * 512)
    s1, i1 = T.topk_retrieve_q8(queries, values, scales, **args)
    assert calls == [512, 512, 276]
    assert torch.equal(i0, i1) and torch.equal(s0, s1)


def test_errors():
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.normal(size=(2, 128)).astype(np.float32))
    index = torch.from_numpy(_unit_rows(rng, 4096, 128))
    with pytest.raises(ValueError, match="divide 128"):
        T.topk_retrieve_twopass(q, index, 10, tile=16, group=9)
    values, scales = T.quantize_index_int8(index)
    with pytest.raises(ValueError, match="divide 128"):
        T.topk_retrieve_q8(q, values, scales, 10, group=9)
    wide = torch.zeros(2, 1040)
    with pytest.raises(ValueError, match="D <= 1024"):
        T.topk_retrieve_q8(wide, torch.zeros(64, 1040, dtype=torch.int8), torch.ones(64, 1), 5)
    with pytest.raises(ValueError, match="mxu"):
        T.topk_retrieve_q8(q, values, scales, 5, mxu="fp8")
    with pytest.raises(TypeError):
        T.tilemax(q, index.to(torch.bfloat16))  # the query must be cast to the index type


def test_cpu_pass1_wrappers_launch_nothing():
    t_ops.reset_launch_counts()
    rng = np.random.default_rng(3)
    index = torch.from_numpy(_unit_rows(rng, 5000, 128))
    q = torch.from_numpy(rng.normal(size=(3, 128)).astype(np.float32))
    T.topk_retrieve_twopass(q, index, 5, pallas_pass1=True)
    T.topk_retrieve_twopass(q, index, 5, pallas_pass1=True, group=16)
    values, scales = T.quantize_index_int8(index)
    T.topk_retrieve_q8(q, values, scales, 5, pallas_pass1=True, group=16)
    assert not any(t_ops.launch_counts().values())
