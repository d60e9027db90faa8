"""The port's CLIP towers, weight bridge, LoRA adapter, tokenizer and encoder
against the JAX package on the CPU (fp32). Tower bar: cosine >= 0.9999 per
row and atol 1e-4."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_lora_match_tpu.core.config import ClipConfig as JConfig
from clip_lora_match_tpu.core.config import LoraConfig as JLoraConfig
from clip_lora_match_tpu.index.build import read_custom_items_csv
from clip_lora_match_tpu.lora.adapter import init_lora as j_init_lora
from clip_lora_match_tpu.lora.adapter import merge_lora as j_merge_lora
from clip_lora_match_tpu.lora.adapter import save_lora as j_save_lora
from clip_lora_match_tpu.models import clip as jclip
from clip_lora_match_tpu.models.encoder import ClipEncoder as JEncoder
from clip_lora_match_tpu.models.io import flatten_params as j_flatten
from clip_lora_match_tpu.models.io import save_params as j_save_params
from clip_lora_match_tpu.tokenizer.bpe import ClipTokenizer as JTok
from clip_lora_match_tpu_torch.core.config import ClipConfig as TConfig
from clip_lora_match_tpu_torch.lora.adapter import init_lora as t_init_lora
from clip_lora_match_tpu_torch.lora.adapter import load_lora as t_load_lora
from clip_lora_match_tpu_torch.lora.adapter import merge_lora as t_merge_lora
from clip_lora_match_tpu_torch.models import clip as tclip
from clip_lora_match_tpu_torch.models import encoder as tenc_mod
from clip_lora_match_tpu_torch.models.encoder import ClipEncoder as TEncoder
from clip_lora_match_tpu_torch.models.io import load_params as t_load_params
from clip_lora_match_tpu_torch.models.io import params_from_numpy
from clip_lora_match_tpu_torch.nn import layers as tlayers
from clip_lora_match_tpu_torch.tokenizer.bpe import ClipTokenizer as TTok
from tests._torch_helpers import (  # noqa: F401
    J_SMALL,
    T_SMALL,
    cosine_rows,
    random_like_tree,
    restore_flags,
    set_flags,
    to_jax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSV = os.path.join(REPO, "data", "custom", "my_items.csv")
EOT = 513  # fallback vocab: 256 bytes + 256 end-of-word bytes + SOT + EOT


@pytest.fixture(scope="module")
def weights():
    """(JAX params, randomized JAX LoRA, flat numpy params, numpy LoRA)."""
    params = jclip.init_params(jax.random.PRNGKey(0), J_SMALL)
    lora = random_like_tree(j_init_lora(jax.random.PRNGKey(1), J_SMALL, JLoraConfig()))
    return params, to_jax(lora), j_flatten(params), j_flatten(lora)


def _tower_inputs():
    rng = np.random.default_rng(7)
    pix = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    tok = JTok.from_dir(None)(["tas pink di kantin", "payung hitam"])
    return pix, tok["input_ids"], tok["attention_mask"]


def _assert_tower_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert cosine_rows(got, ref).min() >= 0.9999
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_weight_bridge_round_trip(weights, tmp_path):
    params, _, flat, _ = weights
    path = str(tmp_path / "clip.npz")
    j_save_params(path, params)
    loaded = t_load_params(path, device="cpu")
    direct = params_from_numpy(flat, device="cpu")
    for key, value in flat.items():
        node_a, node_b = loaded, direct
        for part in key.split("/"):
            node_a, node_b = node_a[part], node_b[part]
        np.testing.assert_array_equal(node_a.numpy(), value)
        np.testing.assert_array_equal(node_b.numpy(), value)
    blocks = loaded["visual"]["blocks"]["attn"]["q_proj"]["kernel"]
    assert tuple(blocks.shape) == (J_SMALL.vision_layers, 128, 128)  # (L, in, out)


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("tower", ["image", "text"])
def test_towers_match_jax(weights, tower, kernels, restore_flags):  # noqa: F811
    set_flags(kernels)
    params, lora, flat, flat_lora = weights
    tp = params_from_numpy(flat, device="cpu")
    tl = params_from_numpy(flat_lora, device="cpu")
    pix, ids, mask = _tower_inputs()
    if tower == "image":
        ref = jclip.encode_image_features(params, jnp.asarray(pix), J_SMALL, lora=lora, lora_scaling=2.0)
        got = tclip.encode_image_features(tp, torch.from_numpy(pix), T_SMALL, lora=tl, lora_scaling=2.0)
    else:
        ref = jclip.encode_text_features(
            params, jnp.asarray(ids), J_SMALL, attention_mask=jnp.asarray(mask),
            eot_id=EOT, lora=lora, lora_scaling=2.0,
        )
        got = tclip.encode_text_features(
            tp, torch.from_numpy(ids), T_SMALL, attention_mask=torch.from_numpy(mask),
            eot_id=EOT, lora=tl, lora_scaling=2.0,
        )
    _assert_tower_close(got.numpy(), ref)


def test_patchify_keeps_channel_major_order():
    x = np.random.default_rng(0).normal(size=(2, 64, 96, 3)).astype(np.float32)
    got = tclip._patchify(torch.from_numpy(x), 32).numpy()
    np.testing.assert_array_equal(got, np.asarray(jclip._patchify(jnp.asarray(x), 32)))
    # patch (0, 1), channel 2, pixel (ph=3, pw=5)
    assert got[0, 1, 2 * 32 * 32 + 3 * 32 + 5] == x[0, 3, 32 + 5, 2]


def test_eot_pooling_takes_first_eot_and_ignores_the_pad_mask(weights):
    params, _, flat, _ = weights
    tp = params_from_numpy(flat, device="cpu")
    ids = np.full((2, 77), EOT, np.int32)
    ids[:, 0] = 512  # SOT
    ids[0, 1:6] = [70, 71, 72, 73, 74]  # EOT first at 6
    ids[1, 1:3] = [80, 81]  # EOT first at 3; a later non-EOT token after it
    ids[1, 4] = 90
    mask = (np.arange(77)[None] <= np.array([[6], [4]])).astype(np.int32)
    ref = jclip.encode_text_features(params, jnp.asarray(ids), J_SMALL, eot_id=EOT)
    no_mask = tclip.encode_text_features(tp, torch.from_numpy(ids), T_SMALL, eot_id=EOT)
    with_mask = tclip.encode_text_features(
        tp, torch.from_numpy(ids), T_SMALL, attention_mask=torch.from_numpy(mask), eot_id=EOT
    )
    _assert_tower_close(no_mask.numpy(), ref)
    np.testing.assert_allclose(with_mask.numpy(), no_mask.numpy(), atol=1e-5)


def test_encoder_text_slice_77_to_64(weights, monkeypatch, restore_flags):  # noqa: F811
    params, lora, flat, flat_lora = weights
    jenc = JEncoder(params, arch=J_SMALL, config=JConfig(arch=J_SMALL), lora=lora, lora_scaling=2.0)
    tenc = TEncoder(params_from_numpy(flat, device="cpu"), arch=T_SMALL, config=TConfig(arch=T_SMALL), device="cpu")
    tenc.attach_lora(params_from_numpy(flat_lora, device="cpu"), 2.0)
    texts = ["dompet coklat", "jam tangan silver tali rantai"]
    tok = tenc.preprocessor.preprocess_text(texts)
    widths = []
    real = tenc_mod.clip_model.encode_text_features
    monkeypatch.setattr(
        tenc_mod.clip_model, "encode_text_features",
        lambda p, ids, *a, **k: widths.append(ids.shape[1]) or real(p, ids, *a, **k),
    )
    sliced = tenc.encode_text_batch(tok["input_ids"], tok["attention_mask"])
    unsliced_mask = tok["attention_mask"].copy()
    unsliced_mask[:, 70] = 1  # defeats the slice; serving drops the mask anyway
    full = tenc.encode_text_batch(tok["input_ids"], unsliced_mask)
    assert widths == [64, 77]
    np.testing.assert_allclose(sliced, full, atol=1e-5)
    ref = jenc.encode_text_batch(tok["input_ids"], tok["attention_mask"])
    _assert_tower_close(sliced, ref)
    assert np.allclose(np.linalg.norm(sliced, axis=1), 1.0, atol=1e-5)


def test_lora_merge_and_load_match_jax(weights, tmp_path):
    params, lora, flat, flat_lora = weights
    merged_j = j_flatten(j_merge_lora(params, lora, 2.0))
    merged_t = t_merge_lora(
        params_from_numpy(flat, device="cpu"), params_from_numpy(flat_lora, device="cpu"), 2.0
    )
    got = merged_t["text"]["blocks"]["attn"]["v_proj"]["kernel"].numpy()
    np.testing.assert_allclose(got, merged_j["text/blocks/attn/v_proj/kernel"], atol=1e-6)
    j_save_lora(str(tmp_path), lora, JLoraConfig())
    loaded, scaling = t_load_lora(str(tmp_path), device="cpu")
    assert scaling == 2.0
    np.testing.assert_array_equal(
        loaded["visual"]["blocks"]["attn"]["q_proj"]["b"].numpy(),
        flat_lora["visual/blocks/attn/q_proj/b"],
    )
    fresh = t_init_lora(0, T_SMALL, device="cpu")
    b = fresh["text"]["blocks"]["attn"]["out_proj"]["b"]
    assert tuple(b.shape) == (T_SMALL.text_layers, 8, T_SMALL.text_width) and not b.any()


def _count_wrapper_calls(monkeypatch) -> list:
    """Record each call nn.layers makes to the two tower kernels' wrappers."""
    from clip_lora_match_tpu_torch.ops import attention_small as A
    from clip_lora_match_tpu_torch.ops import lora_matmul as L

    calls = []
    for mod, name in ((A, "attention_small"), (L, "lora_matmul")):
        real = getattr(mod, name)
        monkeypatch.setattr(
            mod, name, lambda *a, _real=real, _name=name, **k: calls.append(_name) or _real(*a, **k)
        )
    return calls


def test_encoder_dispatch_is_per_tensor_and_per_encoder(weights, monkeypatch, restore_flags):  # noqa: F811
    _, _, flat, flat_lora = weights
    calls = _count_wrapper_calls(monkeypatch)
    tlayers.set_kernel_flags(fused_lora="auto", small_attention="auto")
    before = tlayers.get_kernel_flags()

    def encoder(**cfg):
        enc = TEncoder(
            params_from_numpy(flat, device="cpu"), arch=T_SMALL,
            config=TConfig(arch=T_SMALL, **cfg), device="cpu",
        )
        enc.attach_lora(params_from_numpy(flat_lora, device="cpu"), 2.0)
        return enc

    enc = encoder()
    assert tlayers.get_kernel_flags() == before  # building an encoder sets no flag
    enc.encode_text("tas pink")
    assert calls == []  # "auto": CPU tensors take the exact plain paths
    tlayers.set_kernel_flags(fused_lora=True, small_attention=True)
    enc.encode_text("tas pink")
    assert set(calls) == {"attention_small", "lora_matmul"}  # the kernels' plain versions
    calls.clear()
    forced = tlayers.get_kernel_flags()
    encoder(use_pallas_kernels=False).encode_text("tas pink")
    assert calls == [] and tlayers.get_kernel_flags() == forced


def test_text_mask_is_built_only_for_the_plain_path(weights, monkeypatch, restore_flags):  # noqa: F811
    _, _, flat, _ = weights
    tp = params_from_numpy(flat, device="cpu")
    _, ids, _ = _tower_inputs()
    built = []
    real = tclip._text_mask
    monkeypatch.setattr(tclip, "_text_mask", lambda m, S, dev: built.append(S) or real(m, S, dev))
    for kernels in (True, False):
        tlayers.set_kernel_flags(fused_lora=kernels, small_attention=kernels)
        tclip.encode_text_features(tp, torch.from_numpy(ids), T_SMALL, eot_id=EOT)
    assert built == [77]  # the kernel branch rebuilds the causal mask itself


@pytest.mark.parametrize("vocab", ["fallback", "fashion_bpe"])
def test_tokenizer_ids_match_jax(vocab):
    path = None if vocab == "fallback" else os.path.join(REPO, "tests", "fixtures", "fashion_bpe")
    _, texts = read_custom_items_csv(CSV)
    jt, tt = JTok.from_dir(path), TTok.from_dir(path)
    a, b = jt(texts), tt(texts)
    np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
    np.testing.assert_array_equal(a["attention_mask"], b["attention_mask"])
    assert tt.eot_id == jt.eot_id and b["input_ids"].shape == (5, 77)
