"""The port's kernel modules (plain versions, CPU) against the JAX package's
Pallas kernels in interpret mode and their jnp oracles."""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clip_lora_match_tpu.ops.attention_small import attention_small as j_attn
from clip_lora_match_tpu.ops.lora_matmul import lora_matmul as j_lora
from clip_lora_match_tpu.ops.retrieval_topk import (
    topk_retrieve as j_topk,
    topk_retrieve_midscale as j_topk_mid,
    topk_retrieve_reference as j_topk_ref,
)
from clip_lora_match_tpu_torch import ops as t_ops
from clip_lora_match_tpu_torch.ops import retrieval_topk as t_rt
from clip_lora_match_tpu_torch.ops.attention_small import attention_small as t_attn
from clip_lora_match_tpu_torch.ops.lora_matmul import lora_matmul as t_lora

NEG = float(np.finfo(np.float32).min)


def _qkv(seed, B, S, H, hd=64):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, H, hd)).astype(np.float32) for _ in range(3)]


def _attn_both(q, k, v, **kw):
    jkw = {n: (jnp.asarray(x) if isinstance(x, np.ndarray) else x) for n, x in kw.items()}
    tkw = {n: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x) for n, x in kw.items()}
    got_j = np.asarray(j_attn(*map(jnp.asarray, (q, k, v)), interpret=True, **jkw))
    got_t = t_attn(*map(torch.from_numpy, (q, k, v)), **tkw).numpy()
    return got_j, got_t


@pytest.mark.parametrize(
    "B,S,H,kw",
    [
        (3, 50, 4, {}),  # image tower: maskless (the JAX head-pair packed mode)
        (3, 77, 2, {"causal": True, "lengths": np.array([77, 10, 1], np.int32)}),
        (2, 64, 2, {"causal": True}),  # sliced text tower, causal only
    ],
    ids=["packed_s50", "causal_lengths_s77", "causal_s64"],
)
def test_attention_small_matches_jax(B, S, H, kw):
    q, k, v = _qkv(S + H, B, S, H)
    got_j, got_t = _attn_both(q, k, v, **kw)
    np.testing.assert_allclose(got_t, got_j, atol=1e-5)


def test_attention_small_additive_mask_and_fully_masked_row():
    B, S, H = 2, 50, 2
    q, k, v = _qkv(11, B, S, H)
    mask = np.zeros((B, 1, S, S), np.float32)
    mask[0, 0, :, 30:] = NEG  # keys past 30 masked for batch row 0
    mask[1, 0, 7, :] = NEG  # query row 7 of batch row 1 sees nothing
    got_j, got_t = _attn_both(q, k, v, mask=mask)
    np.testing.assert_allclose(got_t, got_j, atol=1e-5)
    assert np.all(got_t[1, 7] == 0.0) and np.all(got_j[1, 7] == 0.0)


def test_attention_small_zero_length_row_is_zero():
    q, k, v = _qkv(12, 2, 64, 2)
    lengths = np.array([64, 0], np.int32)
    got_j, got_t = _attn_both(q, k, v, causal=True, lengths=lengths)
    np.testing.assert_allclose(got_t, got_j, atol=1e-5)
    assert np.all(got_t[1] == 0.0)


@pytest.mark.parametrize(
    "M,K,N,r", [(64, 128, 128, 8), (100, 512, 512, 8), (32, 768, 3072, 4)]
)
def test_lora_matmul_matches_jax(M, K, N, r):
    rng = np.random.default_rng(M + N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(size=(K, N)).astype(np.float32) * 0.02
    a = rng.normal(size=(K, r)).astype(np.float32) * 0.02
    b = rng.normal(size=(r, N)).astype(np.float32) * 0.02
    ref = j_lora(
        *map(jnp.asarray, (x, w, a, b)), scaling=2.0,
        block_m=32, block_n=128, block_k=128, interpret=True,
    )
    got = t_lora(*map(torch.from_numpy, (x, w, a, b)), scaling=2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-3, rtol=1e-4)


def _unit_rows(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 5, 10])
def test_topk_retrieve_matches_jax(k, dtype):
    rng = np.random.default_rng(k)
    index = _unit_rows(rng, 3001, 64)
    queries = rng.normal(size=(5, 64)).astype(np.float32)
    j_index = jnp.asarray(index).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    t_index = torch.from_numpy(index).to(getattr(torch, dtype))
    js, ji = j_topk(jnp.asarray(queries), j_index, k, interpret=True)
    rs, ri = j_topk_ref(jnp.asarray(queries), j_index, k)
    ts, ti = t_rt.topk_retrieve(torch.from_numpy(queries), t_index, k)
    assert ti.dtype == torch.int32 and ts.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(rs), atol=1e-6)


def test_topk_retrieve_ties_take_the_lower_id_and_k_clamps():
    rng = np.random.default_rng(3)
    index = _unit_rows(rng, 300, 32)
    index[170] = index[40]
    index[250] = index[40]
    q = index[40:41] * 3.0
    ts, ti = t_rt.topk_retrieve(torch.from_numpy(q), torch.from_numpy(index), 3)
    js, ji = j_topk(jnp.asarray(q), jnp.asarray(index), 3, interpret=True)
    assert ti[0].tolist() == [40, 170, 250] == np.asarray(ji)[0].tolist()
    small = torch.from_numpy(index[:4])
    s, i = t_rt.topk_retrieve(torch.from_numpy(q), small, 10)
    assert s.shape == (1, 4) and sorted(i[0].tolist()) == [0, 1, 2, 3]


def test_topk_retrieve_auto_bands(monkeypatch):
    calls = []
    real = t_rt.topk_retrieve
    monkeypatch.setattr(
        t_rt, "topk_retrieve", lambda q, x, k: calls.append("stream") or real(q, x, k)
    )
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.normal(size=(3, 16)).astype(np.float32))
    small = torch.from_numpy(_unit_rows(rng, 2100, 16))
    t_rt.topk_retrieve_auto(q, small, 5)
    mid_rows = _unit_rows(rng, t_rt.MIDSCALE_MIN_N, 16)
    t_rt.topk_retrieve_auto(q, torch.from_numpy(mid_rows), 5)  # fp32 keeps the kernel
    assert calls == ["stream", "stream"]
    mid_bf16 = torch.from_numpy(mid_rows).to(torch.bfloat16)
    s, i = t_rt.topk_retrieve_auto(q, mid_bf16, 5)  # bf16 mid band: matmul + sort
    assert calls == ["stream", "stream"]
    js, ji = j_topk_mid(
        jnp.asarray(q.numpy()), jnp.asarray(mid_rows).astype(jnp.bfloat16), 5
    )
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-6)
    # the two-pass band on every device: a CUDA index goes the same way
    monkeypatch.setattr(
        t_rt, "topk_retrieve_twopass", lambda q, x, k: calls.append("two") or (None, None)
    )
    fake_cuda = types.SimpleNamespace(
        shape=(t_rt.TWOPASS_MIN_N, 512), device=torch.device("cuda"), dtype=torch.float32
    )
    t_rt.topk_retrieve_auto(q, fake_cuda, 5)
    t_rt.topk_retrieve_auto(q, torch.zeros(t_rt.TWOPASS_MIN_N, 16, dtype=torch.bfloat16), 5)
    assert calls == ["stream", "stream", "two", "two"]


def test_cpu_tensors_launch_nothing():
    t_ops.reset_launch_counts()
    q = torch.randn(1, 5, 2, 64)
    t_attn(q, q, q)
    t_lora(torch.randn(4, 8), torch.randn(8, 8), torch.randn(8, 2), torch.randn(2, 8))
    t_rt.topk_retrieve(torch.randn(1, 8), torch.randn(10, 8), 2)
    t_rt.tilemax(torch.randn(1, 16), torch.randn(40, 16), 16)
    t_rt.tilemax_sup(torch.randn(1, 16), torch.randn(40, 16), 16, 2)
    qq = torch.ones(1, 16, dtype=torch.int8)
    t_rt.tilemax_sup_q8(qq, torch.ones(40, 16, dtype=torch.int8), torch.ones(40, 1), 16, 2)
    t_ops.KERNEL_WRAPPERS["flash_attention"](q, q, q)
    t_ops.KERNEL_WRAPPERS["mlp_fused"](
        torch.randn(4, 8), torch.randn(8, 16), torch.randn(16), torch.randn(16, 8), torch.randn(8)
    )
    t_ops.KERNEL_WRAPPERS["approx_topk"](torch.randn(2, 16), torch.randn(3000, 16), 10, 0.9)
    assert t_ops.launch_counts() == {
        "attention_small": 0, "lora_matmul": 0, "topk_retrieve": 0,
        "tilemax": 0, "tilemax_sup": 0, "tilemax_sup_q8": 0,
        "mlp_fused": 0, "flash_attention": 0, "approx_topk": 0,
    }
