"""The port's W8A8 int8 serving path (``quant/int8.py`` and its dispatch in
``nn/layers.py`` and ``ClipEncoder``) against the JAX package on the CPU.

Same numpy-seeded inputs into both packages, fp32 compute. Bars: the weight
codes and scales, the activation codes and scales, and ``int8_matmul``'s
output bit-equal to the JAX package's (the rounding order is ported, and
``torch._int_mm`` is exact); a ``linear`` / ``attention`` layer and the
tiny towers within 1e-6 relative or cosine >= 0.99999 with equal top-1 ids;
the port's int8 encoder against its float encoder at cosine >= 0.995 (the
JAX package's own bar, ``tests/test_quant.py``). Under int8 neither
``lora_matmul`` nor ``mlp_fused`` runs, whatever the kernel flags say.
"""

import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from clip_lora_match_tpu.core.config import ClipArchConfig as JArch
from clip_lora_match_tpu.core.config import ClipConfig as JConfig
from clip_lora_match_tpu.core.config import LoraConfig as JLoraConfig
from clip_lora_match_tpu.lora.adapter import init_lora as j_init_lora
from clip_lora_match_tpu.models import clip as jclip
from clip_lora_match_tpu.models.encoder import ClipEncoder as JEncoder
from clip_lora_match_tpu.models.io import flatten_params as j_flatten
from clip_lora_match_tpu.nn import layers as jlayers
from clip_lora_match_tpu.quant import int8 as J
from clip_lora_match_tpu_torch.core.config import ClipArchConfig as TArch
from clip_lora_match_tpu_torch.core.config import ClipConfig as TConfig
from clip_lora_match_tpu_torch.models import clip as tclip
from clip_lora_match_tpu_torch.models.encoder import ClipEncoder as TEncoder
from clip_lora_match_tpu_torch.models.io import params_from_numpy
from clip_lora_match_tpu_torch.nn import layers as tlayers
from clip_lora_match_tpu_torch.ops import lora_matmul as L
from clip_lora_match_tpu_torch.ops import mlp_fused as MF
from clip_lora_match_tpu_torch.quant import int8 as T
from tests._torch_helpers import cosine_rows, random_like_tree, restore_flags, to_torch  # noqa: F401

# tests/test_quant.py's encoder geometry: 2 layers a tower, width 64
TINY_KW = dict(
    vision_layers=2, text_layers=2, vision_width=64, text_width=64,
    vision_heads=2, text_heads=2, vision_mlp_dim=256, text_mlp_dim=256,
    projection_dim=32, vocab_size=514, max_text_length=12, image_size=32,
    patch_size=16,
)
J_TINY, T_TINY = JArch(**TINY_KW), TArch(**TINY_KW)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _weights(seed, shape, bias=True):
    rng = np.random.default_rng(seed)
    p = {"kernel": (rng.normal(size=shape) * 0.1).astype(np.float32)}
    if bias:
        p["bias"] = (rng.normal(size=shape[-1:]) * 0.01).astype(np.float32)
    return p


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _jax_codes(x):
    """The activation codes and scales of the JAX package's ``int8_matmul``,
    computed with its own expressions (``quant/int8.py:110-114``), jitted as
    the encoder runs them."""
    def f(x):
        x32 = x.astype(jnp.float32)
        amax = jnp.max(jnp.abs(x32), axis=-1, keepdims=True)
        s_x = jnp.maximum(amax, 1e-8) * (1.0 / 127.0)
        return jnp.round(x32 / s_x).astype(jnp.int8), s_x

    return jax.jit(f)(x)


# ---------------------------------------------------------------------------
# quant/int8.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,bias", [((64, 96), False), ((64, 96), True), ((3, 64, 48), True),
                                        ((768, 2304), True)])
def test_quantize_linear_params_is_bit_equal_to_jax(shape, bias):
    p = _weights(0, shape, bias)
    jq = J.quantize_linear_params({k: jnp.asarray(v) for k, v in p.items()})
    tq = T.quantize_linear_params(to_torch(p))
    assert tq["kernel_q"].dtype == torch.int8 and tq["w_scale"].dtype == torch.float32
    assert np.array_equal(_np(tq["kernel_q"]), np.asarray(jq["kernel_q"]))
    assert np.array_equal(_np(tq["w_scale"]), np.asarray(jq["w_scale"]))
    assert ("bias" in tq) == ("bias" in jq) == bias
    assert np.array_equal(_np(T.dequantize_linear_params(tq)["kernel"]),
                          np.asarray(J.dequantize_linear_params(jq)["kernel"]))
    assert T.is_quantized(tq) and not T.is_quantized(to_torch(p))


def test_all_zero_weight_column_quantizes_as_jax():
    p = _weights(1, (32, 16), False)
    p["kernel"][:, 3] = 0.0
    jq = J.quantize_linear_params({"kernel": jnp.asarray(p["kernel"])})
    tq = T.quantize_linear_params(to_torch(p))
    assert np.array_equal(_np(tq["kernel_q"]), np.asarray(jq["kernel_q"]))
    assert np.array_equal(_np(tq["w_scale"]), np.asarray(jq["w_scale"]))
    assert (_np(tq["kernel_q"])[:, 3] == 0).all()


@pytest.mark.parametrize("xshape,wshape", [((8, 40, 64), (64, 96)), ((3, 17, 128), (128, 384)),
                                           ((1, 5, 64), (64, 64)), ((2000, 768), (768, 2304))])
def test_int8_matmul_is_bit_equal_to_jax(xshape, wshape):
    """tests/test_quant.py's shapes and the B/32 q/k/v one. XLA on the CPU
    divides and rounds as torch does here: no tie differs."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=xshape).astype(np.float32)
    w = (rng.normal(size=wshape) * 0.1).astype(np.float32)
    jq = J.quantize_linear_params({"kernel": jnp.asarray(w)})
    tq = T.quantize_linear_params({"kernel": torch.from_numpy(w)})
    jc, js = _jax_codes(jnp.asarray(x.reshape(-1, xshape[-1])))
    tc, ts = T.quantize_rows(torch.from_numpy(x.reshape(-1, xshape[-1])))
    assert np.array_equal(tc.numpy(), np.asarray(jc)) and np.array_equal(ts.numpy(), np.asarray(js))
    jy = np.asarray(jax.jit(J.int8_matmul)(jnp.asarray(x), jq["kernel_q"], jq["w_scale"]))
    ty = T.int8_matmul(torch.from_numpy(x), tq["kernel_q"], tq["w_scale"])
    assert ty.dtype == torch.float32 and ty.shape == xshape[:-1] + wshape[-1:]
    np.testing.assert_allclose(ty.numpy(), jy, rtol=1e-6, atol=0)
    assert np.array_equal(ty.numpy(), jy)


def test_int8_matmul_on_bf16_input_is_bit_equal_to_jax():
    """A bf16 activation (the text tower's residual under bf16 compute):
    the abs-max in bf16 and the fp32 division give JAX's codes."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 12, 64)).astype(ml_dtypes.bfloat16)
    w = (rng.normal(size=(64, 96)) * 0.1).astype(np.float32)
    jq = J.quantize_linear_params({"kernel": jnp.asarray(w)})
    tq = T.quantize_linear_params({"kernel": torch.from_numpy(w)})
    xt = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    jc, js = _jax_codes(jnp.asarray(x).reshape(-1, 64))
    tc, ts = T.quantize_rows(xt.reshape(-1, 64))
    assert np.array_equal(tc.numpy(), np.asarray(jc)) and np.array_equal(ts.numpy(), np.asarray(js))
    jy = np.asarray(J.int8_matmul(jnp.asarray(x), jq["kernel_q"], jq["w_scale"]))
    assert np.array_equal(T.int8_matmul(xt, tq["kernel_q"], tq["w_scale"]).numpy(), jy)


@pytest.mark.parametrize("M", [1, 16, 17, 50])
def test_int8_mm_is_exact_and_counted(M):
    rng = np.random.default_rng(M)
    xq = torch.from_numpy(rng.integers(-127, 128, (M, 64), dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (64, 24), dtype=np.int8))
    before = T.int8_mm.calls
    for w in (wq, wq.t().contiguous().t()):  # row- and column-major weights
        y = T.int8_mm(xq, w)
        assert y.dtype == torch.int32 and torch.equal(y, xq.int() @ wq.int())
    assert T.int8_mm.calls == before + 2


def test_quantize_clip_params_quantizes_the_block_linears_only():
    params = jclip.init_params(jax.random.PRNGKey(0), J_TINY)
    jq = J.quantize_clip_params(params)
    master = params_from_numpy(j_flatten(params), device="cpu")
    tq = T.quantize_clip_params(master)
    flat_j, flat_t = j_flatten(jq), {}
    from clip_lora_match_tpu_torch.models.io import flatten_params

    flat_t = flatten_params(tq)
    assert sorted(flat_t) == sorted(flat_j)
    for key in flat_j:
        assert flat_t[key].dtype == np.asarray(flat_j[key]).dtype, key
        assert np.array_equal(flat_t[key], np.asarray(flat_j[key])), key
    # the master is untouched and the non-block leaves are shared
    assert "kernel" in master["visual"]["blocks"]["mlp"]["fc1"]
    assert tq["visual"]["patch_embed"] is master["visual"]["patch_embed"]


# ---------------------------------------------------------------------------
# nn/layers.py dispatch
# ---------------------------------------------------------------------------


def _lora_pair(seed, d_in, d_out, r=4):
    rng = np.random.default_rng(seed)
    return {"a": (rng.normal(size=(d_in, r)) * 0.1).astype(np.float32),
            "b": (rng.normal(size=(r, d_out)) * 0.1).astype(np.float32)}


def test_linear_with_kernel_q_and_lora_matches_jax_and_adds_the_exact_delta():
    """JAX's test_linear_dispatches_on_kernel_q_and_lora_stays_exact, ported:
    (int8 with LoRA) - (int8 without) equals the float delta; and the port's
    layer against the JAX layer."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 10, 32)).astype(np.float32)
    p = _weights(4, (32, 48))
    lora = _lora_pair(5, 32, 48)
    tq = T.quantize_linear_params(to_torch(p))
    jq = J.quantize_linear_params({k: jnp.asarray(v) for k, v in p.items()})
    xt, tl = torch.from_numpy(x), to_torch(lora)
    y_q = tlayers.linear(tq, xt, lora=tl, lora_scaling=2.0)
    y_f = tlayers.linear(to_torch(p), xt, lora=tl, lora_scaling=2.0)
    delta_q = y_q - tlayers.linear(tq, xt)
    delta_f = y_f - tlayers.linear(to_torch(p), xt)
    np.testing.assert_allclose(delta_q.numpy(), delta_f.numpy(), atol=1e-5, rtol=1e-5)
    jy = np.asarray(jlayers.linear(jq, jnp.asarray(x), lora={k: jnp.asarray(v) for k, v in lora.items()},
                                   lora_scaling=2.0))
    np.testing.assert_allclose(y_q.numpy(), jy, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kernels", [False, True])
def test_attention_int8_matches_jax_and_never_runs_lora_matmul(kernels, restore_flags, monkeypatch):  # noqa: F811
    """The fused int8 q/k/v product with per-projection LoRA deltas and
    biases; with the kernel flags forced the attention core takes
    attention_small's plain version, but no lora_matmul runs."""
    D, H = 64, 2
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 9, D)).astype(np.float32)
    names = ("q_proj", "k_proj", "v_proj", "out_proj")
    p = {n: _weights(10 + i, (D, D)) for i, n in enumerate(names)}
    lora = {n: _lora_pair(20 + i, D, D) for i, n in enumerate(names)}
    jq = {n: J.quantize_linear_params({k: jnp.asarray(v) for k, v in p[n].items()}) for n in names}
    tq = {n: T.quantize_linear_params(to_torch(p[n])) for n in names}
    jl = {n: {k: jnp.asarray(v) for k, v in lora[n].items()} for n in names}
    jlayers.set_kernel_flags(fused_lora=kernels, small_attention=kernels, flash_attention=False,
                             interpret=True)
    tlayers.set_kernel_flags(fused_lora=kernels, small_attention=kernels)

    def refuse(*a, **k):
        raise AssertionError("lora_matmul ran under int8")

    monkeypatch.setattr(L, "lora_matmul", refuse)
    before = T.int8_mm.calls
    ty = tlayers.attention(tq, torch.from_numpy(x), H, lora=to_torch(lora), lora_scaling=2.0)
    assert T.int8_mm.calls == before + 2  # q/k/v as one product, out_proj
    jy = np.asarray(jlayers.attention(jq, jnp.asarray(x), H, lora=jl, lora_scaling=2.0))
    np.testing.assert_allclose(ty.numpy(), jy, rtol=1e-5, atol=1e-5)
    # the serving copy's concatenated operands give the same layer
    grouped = {n: dict(v) for n, v in tq.items()}
    tlayers.group_int8_qkv(grouped)
    assert torch.equal(tlayers.attention(grouped, torch.from_numpy(x), H, lora=to_torch(lora),
                                         lora_scaling=2.0), ty)


def test_mlp_fused_stays_off_under_int8(restore_flags, monkeypatch):  # noqa: F811
    called = []

    def counting(*args):
        called.append(1)
        return MF.mlp_fused_plain(*args)

    monkeypatch.setattr(MF, "mlp_fused", counting)
    tlayers.set_kernel_flags(fused_mlp=True)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(2, 5, 64)).astype(np.float32))
    p = {"fc1": _weights(30, (64, 256)), "fc2": _weights(31, (256, 64))}
    q = {n: T.quantize_linear_params(to_torch(v)) for n, v in p.items()}
    y = tlayers.mlp(q, x)
    assert not called and y.shape == x.shape
    jq = {n: J.quantize_linear_params({k: jnp.asarray(v) for k, v in p[n].items()}) for n in p}
    np.testing.assert_allclose(y.numpy(), np.asarray(jlayers.mlp(jq, jnp.asarray(x.numpy()))),
                               rtol=1e-5, atol=1e-6)
    tlayers.mlp(to_torch(p), x)  # the float weights do take the kernel branch
    assert called == [1]


# ---------------------------------------------------------------------------
# the towers and the encoder
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    params = jclip.init_params(jax.random.PRNGKey(1), J_TINY)
    lora = random_like_tree(j_init_lora(jax.random.PRNGKey(3), J_TINY, JLoraConfig(r=4, alpha=8)),
                            seed=9, scale=0.05)
    rng = np.random.default_rng(5)
    pix = rng.normal(size=(6, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(0, J_TINY.vocab_size - 2, (6, 12)).astype(np.int32)
    ids[:, -1] = J_TINY.vocab_size - 1
    return params, lora, pix, ids


@pytest.mark.parametrize("tower", ["image", "text"])
def test_quantized_towers_match_jax(tiny, tower):
    params, _, pix, ids = tiny
    jq = J.quantize_clip_params(params)
    tq = T.quantize_clip_params(params_from_numpy(j_flatten(params), device="cpu"))
    if tower == "image":
        jf = np.asarray(jclip.encode_image_features(jq, jnp.asarray(pix), J_TINY))
        tf = tclip.encode_image_features(tq, torch.from_numpy(pix), T_TINY)
    else:
        eot = J_TINY.vocab_size - 1
        jf = np.asarray(jclip.encode_text_features(jq, jnp.asarray(ids), J_TINY, eot_id=eot))
        tf = tclip.encode_text_features(tq, torch.from_numpy(ids).long(), T_TINY, eot_id=eot)
    cos = cosine_rows(tf.numpy(), jf)
    assert cos.min() >= 0.99999, cos
    # top-1 over a small index of the JAX package's embeddings
    assert (np.argmax(_unit(tf.numpy()) @ _unit(jf).T, 1) == np.arange(len(jf))).all()


def _encoders(tiny, quantize, with_lora=True):
    params, lora, _, _ = tiny
    jenc = JEncoder(params, arch=J_TINY, config=JConfig(arch=J_TINY, use_pallas_kernels=False),
                    quantize=quantize, lora=lora if with_lora else None, lora_scaling=2.0)
    tenc = TEncoder(params_from_numpy(j_flatten(params), device="cpu"), arch=T_TINY,
                    config=TConfig(arch=T_TINY), quantize=quantize, device="cpu")
    if with_lora:
        tenc.attach_lora(params_from_numpy(j_flatten(lora), device="cpu"), 2.0)
    return jenc, tenc


@pytest.mark.parametrize("with_lora", [False, True])
def test_int8_encoder_matches_the_jax_int8_encoder(tiny, with_lora):
    _, _, pix, ids = tiny
    jenc, tenc = _encoders(tiny, "int8", with_lora)
    mask = np.ones_like(ids)
    for got, ref in (
        (tenc.encode_image_batch(pix), jenc.encode_image_batch(pix)),
        (tenc.encode_text_batch(ids, mask), jenc.encode_text_batch(ids, mask)),
    ):
        assert got.shape == ref.shape and np.isfinite(got).all()
        cos = cosine_rows(got, ref)
        assert cos.min() >= 0.99999, cos
        assert (np.argmax(got @ ref.T, 1) == np.arange(len(ref))).all()


def test_int8_encoder_against_the_float_encoder(tiny):
    """JAX's bar (tests/test_quant.py): cosine >= 0.995 against the float
    encoder, and each item's top-1 against the float index kept."""
    _, _, pix, _ = tiny
    _, t_int8 = _encoders(tiny, "int8", with_lora=False)
    _, t_float = _encoders(tiny, "none", with_lora=False)
    e_q, e_f = t_int8.encode_image_batch(pix), t_float.encode_image_batch(pix)
    assert cosine_rows(e_q, e_f).min() > 0.995
    sims_f, sims_q = e_f @ e_f.T, e_q @ e_f.T
    np.fill_diagonal(sims_f, -2)
    np.fill_diagonal(sims_q, -2)
    assert (sims_f.argmax(1) == sims_q.argmax(1)).all()


def test_int8_encoder_runs_four_int8_products_per_layer(tiny):
    _, _, pix, ids = tiny
    _, tenc = _encoders(tiny, "int8")
    before = T.int8_mm.calls
    tenc.encode_image_batch(pix[:2])
    assert T.int8_mm.calls - before == 4 * T_TINY.vision_layers
    before = T.int8_mm.calls
    tenc.encode_text_batch(ids[:3])
    assert T.int8_mm.calls - before == 4 * T_TINY.text_layers


def test_int8_serving_copy_is_built_from_the_fp32_master(tiny):
    """Under bf16 compute the int8 leaves are the fp32 master's codes, the
    other matmul kernels take the float path's bf16, w_scale stays fp32, the
    adapter stays fp32 and ungrouped; attach_lora and merge_lora rebuild it."""
    params, lora, pix, _ = tiny
    enc = TEncoder(params_from_numpy(j_flatten(params), device="cpu"), arch=T_TINY,
                   config=TConfig(arch=T_TINY), compute_dtype="bfloat16", quantize="int8", device="cpu")
    enc.attach_lora(params_from_numpy(j_flatten(lora), device="cpu"), 2.0)
    sp, sl = enc._serving_state()
    jq = J.quantize_clip_params(params)
    for tower in ("visual", "text"):
        for i, layer in enumerate(sp[tower]["blocks"]):
            for grp, name in (("attn", "q_proj"), ("attn", "out_proj"), ("mlp", "fc1"), ("mlp", "fc2")):
                got = layer[grp][name]
                want = jq[tower]["blocks"][grp][name]
                assert np.array_equal(got["kernel_q"].numpy(), np.asarray(want["kernel_q"])[i])
                assert got["w_scale"].dtype == torch.float32
                assert np.array_equal(got["w_scale"].numpy(), np.asarray(want["w_scale"])[i])
                assert got["kernel_q"].stride(0) == 1  # column-major
            assert layer["attn"]["qkv"]["kernel_q"].shape[1] == 3 * layer["attn"]["q_proj"]["kernel_q"].shape[1]
        assert sp[tower]["proj"]["kernel"].dtype == torch.bfloat16
    assert sp["visual"]["patch_embed"]["kernel"].dtype == torch.bfloat16
    assert "qkv" not in sl["visual"]["blocks"][0]["attn"]
    assert sl["visual"]["blocks"][0]["attn"]["q_proj"]["a"].dtype == torch.float32
    assert enc.params["visual"]["blocks"]["mlp"]["fc1"]["kernel"].dtype == torch.float32
    assert np.isfinite(enc.encode_image_batch(pix)).all()
    enc.attach_lora(enc.lora, 1.0)
    assert enc._serving is None
    enc._serving_state()
    enc.merge_lora()
    assert enc._serving is None and enc.lora is None


@pytest.mark.parametrize("kernels", [True, "auto"])
def test_int8_encoder_under_forced_kernel_flags(tiny, kernels, restore_flags, monkeypatch):  # noqa: F811
    """Forced kernel flags: the int8 encoder takes attention_small's plain
    version as the float one does, and never lora_matmul or mlp_fused."""
    def refuse(*a, **k):
        raise AssertionError("a LoRA or MLP kernel ran under int8")

    monkeypatch.setattr(L, "lora_matmul", refuse)
    monkeypatch.setattr(MF, "mlp_fused", refuse)
    _, _, pix, ids = tiny
    _, tenc = _encoders(tiny, "int8")
    ref = tenc.encode_image_batch(pix)
    tlayers.set_kernel_flags(fused_lora=kernels, small_attention=kernels, fused_mlp=kernels)
    tenc.attach_lora(tenc.lora, tenc.lora_scaling)
    got = tenc.encode_image_batch(pix)
    assert cosine_rows(got, ref).min() >= 0.99999
    assert np.isfinite(tenc.encode_text_batch(ids)).all()


def test_unknown_quantize_mode_raises(tiny):
    params = params_from_numpy(j_flatten(tiny[0]), device="cpu")
    with pytest.raises(ValueError, match="int4"):
        TEncoder(params, arch=T_TINY, quantize="int4", device="cpu")
    with pytest.raises(ValueError):
        TEncoder(params, arch=T_TINY, config=TConfig(arch=T_TINY, quantize="fp8"), device="cpu")
    assert TEncoder(params, arch=T_TINY, device="cpu").quantize == "none"


def test_from_config_with_quantize_int8_serves_w8a8(tmp_path, tiny):
    """A YAML with model.quantize: int8 (the serve entry point's
    --clip-config) builds an int8 encoder; JAX's reads the same YAML."""
    path = str(tmp_path / "int8.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({"model": {"quantize": "int8", "arch": dict(TINY_KW, max_text_length=77)}}, f)
    with pytest.warns(UserWarning):
        tenc = TEncoder.from_config(path, device="cpu")
    assert tenc.quantize == "int8"
    assert dataclasses.asdict(tenc.arch) == dataclasses.asdict(TArch(**dict(TINY_KW, max_text_length=77)))
    before = T.int8_mm.calls
    emb = tenc.encode_text("tas pink")
    assert T.int8_mm.calls - before == 4 * T_TINY.text_layers
    assert emb.shape == (T_TINY.projection_dim,) and np.isfinite(emb).all()
    with pytest.warns(UserWarning):
        assert JEncoder.from_config(path).quantize == "int8"
