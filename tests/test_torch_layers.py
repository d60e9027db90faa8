"""The port's nn/layers.py against clip_lora_match_tpu.nn.layers on the CPU,
with the kernel branches off (exact paths) and on (JAX Pallas kernels in
interpret mode against the port's plain kernel versions). fp32, atol 1e-5."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clip_lora_match_tpu.nn import layers as J
from clip_lora_match_tpu_torch.nn import layers as T
from tests._torch_helpers import restore_flags, set_flags, to_jax, to_torch  # noqa: F401

ATOL = 1e-5


def _lin(rng, d_in, d_out, bias=True):
    p = {"kernel": rng.normal(0, d_in ** -0.5, (d_in, d_out)).astype(np.float32)}
    if bias:
        p["bias"] = rng.normal(0, 0.1, (d_out,)).astype(np.float32)
    return p


def _ab(rng, d_in, d_out, r=4, layers=None):
    lead = () if layers is None else (layers,)
    return {
        "a": rng.normal(0, 0.1, lead + (d_in, r)).astype(np.float32),
        "b": rng.normal(0, 0.1, lead + (r, d_out)).astype(np.float32),
    }


def _block(rng, d, mlp, layers=None):
    def lin(i, o):
        p = _lin(rng, i, o)
        if layers is None:
            return p
        return {k: np.stack([_lin(rng, i, o)[k] for _ in range(layers)]) for k in p}

    def ln():
        shape = (d,) if layers is None else (layers, d)
        return {"scale": 1 + rng.normal(0, 0.1, shape).astype(np.float32),
                "bias": rng.normal(0, 0.1, shape).astype(np.float32)}

    return {
        "ln_1": ln(),
        "attn": {n: lin(d, d) for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
        "ln_2": ln(),
        "mlp": {"fc1": lin(d, mlp), "fc2": lin(mlp, d)},
    }


def _close(got_t, got_j, atol=ATOL):
    np.testing.assert_allclose(got_t.detach().numpy(), np.asarray(got_j), atol=atol)


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("adapter", [False, True], ids=["base", "lora"])
def test_linear_matches_jax(adapter, bias, kernels, restore_flags):  # noqa: F811
    set_flags(kernels)
    rng = np.random.default_rng(1)
    p = _lin(rng, 32, 48, bias=bias)
    lora = _ab(rng, 32, 48) if adapter else None
    x = rng.normal(size=(2, 7, 32)).astype(np.float32)
    got_j = J.linear(to_jax(p), jnp.asarray(x), None if lora is None else to_jax(lora), 2.0)
    got_t = T.linear(to_torch(p), torch.from_numpy(x), None if lora is None else to_torch(lora), 2.0)
    _close(got_t, got_j)


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("adapter", [False, True], ids=["fused_qkv", "per_proj_lora"])
@pytest.mark.parametrize("tower", ["image", "text"])
def test_attention_matches_jax(tower, adapter, kernels, restore_flags):  # noqa: F811
    set_flags(kernels)
    rng = np.random.default_rng(2)
    D, H = 128, 2
    p = _block(rng, D, 256)["attn"]
    lora = {n: _ab(rng, D, D) for n in ("q_proj", "k_proj", "v_proj", "out_proj")} if adapter else None
    S = 50 if tower == "image" else 77
    x = rng.normal(size=(2, S, D)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if tower == "text":
        lengths = np.array([77, 12], np.int32)
        neg = np.finfo(np.float32).min
        mask = np.minimum(
            np.triu(np.full((S, S), neg, np.float32), 1)[None, None],
            ((np.arange(S)[None, :] >= lengths[:, None]) * neg).astype(np.float32)[:, None, None, :],
        )
        kw_j = dict(mask=jnp.asarray(mask), causal=True, key_lengths=jnp.asarray(lengths))
        kw_t = dict(mask=torch.from_numpy(mask), causal=True, key_lengths=torch.from_numpy(lengths))
    got_j = J.attention(to_jax(p), jnp.asarray(x), H,
                        lora=None if lora is None else to_jax(lora), lora_scaling=2.0, **kw_j)
    got_t = T.attention(to_torch(p), torch.from_numpy(x), H,
                        lora=None if lora is None else to_torch(lora), lora_scaling=2.0, **kw_t)
    _close(got_t, got_j)


def test_mlp_matches_jax():
    rng = np.random.default_rng(3)
    p = _block(rng, 64, 256)["mlp"]
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    _close(T.mlp(to_torch(p), torch.from_numpy(x)), J.mlp(to_jax(p), jnp.asarray(x)))


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_two_layer_transformer_matches_jax(kernels, restore_flags):  # noqa: F811
    set_flags(kernels)
    rng = np.random.default_rng(4)
    D, L = 128, 2
    blocks = _block(rng, D, 256, layers=L)
    lora = {"attn": {n: _ab(rng, D, D, layers=L) for n in ("q_proj", "k_proj", "v_proj", "out_proj")}}
    x = rng.normal(size=(2, 50, D)).astype(np.float32)
    got_j = J.transformer(to_jax(blocks), jnp.asarray(x), 2, lora_blocks=to_jax(lora), lora_scaling=2.0)
    got_t = T.transformer(to_torch(blocks), torch.from_numpy(x), 2,
                          lora_blocks=to_torch(lora), lora_scaling=2.0)
    _close(got_t, got_j)


def test_layer_norm_bf16_is_fp32_inside():
    rng = np.random.default_rng(5)
    p = {"scale": rng.normal(1, 0.1, (64,)).astype(np.float32),
         "bias": rng.normal(0, 0.1, (64,)).astype(np.float32)}
    x = rng.normal(size=(4, 64)).astype(np.float32)
    got_j = J.layer_norm(to_jax(p), jnp.asarray(x).astype(jnp.bfloat16))
    got_t = T.layer_norm(to_torch(p), torch.from_numpy(x).to(torch.bfloat16))
    assert got_t.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got_t.float().numpy(), np.asarray(got_j.astype(jnp.float32))
    )


def test_kernel_flags_take_true_auto_false_and_reject_junk(restore_flags):  # noqa: F811
    assert T._KERNEL_FLAGS["flash_attention"] is False and T._KERNEL_FLAGS["fused_mlp"] is False
    for val in (True, "auto", False):
        T.set_kernel_flags(fused_lora=val, flash_attention=val, small_attention=val, fused_mlp=val)
        kernels = ("fused_lora", "flash_attention", "small_attention", "fused_mlp")
        assert {T._KERNEL_FLAGS[n] for n in kernels} == {val}
    prev = T.set_kernel_flags(fused_mlp=True)
    assert prev["fused_mlp"] is False and T._KERNEL_FLAGS["fused_mlp"] is True
    for name in ("fused_lora", "flash_attention", "small_attention", "fused_mlp"):
        with pytest.raises(ValueError):
            T.set_kernel_flags(**{name: "on"})
    assert T.get_kernel_flags() == tuple(sorted(T._KERNEL_FLAGS.items()))


def test_small_attention_gate_follows_flag_device_and_length(restore_flags):  # noqa: F811
    def gate(flag, S, causal):
        with T.kernel_flags(small_attention=flag):
            return T.uses_small_attention(torch.zeros(1, S, 8), causal)

    # "auto" takes the kernel for CUDA tensors only; these lie on the CPU
    assert not gate("auto", 50, False) and not gate(False, 50, False)
    assert gate(True, 64, False) and not gate(True, 65, False)
    assert gate(True, 80, True) and not gate(True, 81, True)
    assert T._KERNEL_FLAGS["small_attention"] == "auto"  # the default, back after the with
    with pytest.raises(ValueError):
        T.set_kernel_flags(fused_lora="on")
