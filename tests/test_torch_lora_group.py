"""The grouped q/k/v launch of ``lora_matmul`` and its launch plan, on the CPU.

The grouped operands ([Wq|Wk|Wv], [Aq|Ak|Av], blockdiag(Bq, Bk, Bv)) through
``lora_matmul_plain`` against the JAX package's three ``linear`` calls (its
Pallas ``lora_matmul`` in interpret mode), a tiny model whose attention
layers take the grouped path against the JAX encoder, the per-projection
path for mixed ranks, a missing adapter or a grouped rank past the kernel's
``R_MAX``, and the plan (pure Python: the
card runs what it says). fp32 tolerances: 1e-5 for one layer (summation
order), 1e-4 for a whole model, as the other parity tests."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_lora_match_tpu.core.config import ClipConfig as JConfig
from clip_lora_match_tpu.core.config import LoraConfig as JLoraConfig
from clip_lora_match_tpu.lora.adapter import init_lora as j_init_lora
from clip_lora_match_tpu.models import clip as jclip
from clip_lora_match_tpu.models.encoder import ClipEncoder as JEncoder
from clip_lora_match_tpu.models.io import flatten_params as j_flatten
from clip_lora_match_tpu.nn import layers as J
from clip_lora_match_tpu_torch.core.config import ClipConfig as TConfig
from clip_lora_match_tpu_torch.models.encoder import ClipEncoder as TEncoder
from clip_lora_match_tpu_torch.models.io import params_from_numpy
from clip_lora_match_tpu_torch.nn import layers as T
from clip_lora_match_tpu_torch.ops import lora_matmul as L
from tests._torch_helpers import J_SMALL, T_SMALL, random_like_tree, restore_flags, to_jax, to_torch  # noqa: F401

QKV = ("q_proj", "k_proj", "v_proj")


def _attn(rng, D, ranks, bias=True):
    p = {n: {"kernel": rng.normal(0, D ** -0.5, (D, D)).astype(np.float32)} for n in QKV + ("out_proj",)}
    if bias:
        for n in p:
            p[n]["bias"] = rng.normal(0, 0.1, (D,)).astype(np.float32)
    lora = {n: {"a": rng.normal(0, 0.1, (D, r)).astype(np.float32),
                "b": rng.normal(0, 0.1, (r, D)).astype(np.float32)}
            for n, r in zip(QKV + ("out_proj",), ranks) if r}
    return p, lora


def _force(restore_flags):  # noqa: F811
    J.set_kernel_flags(fused_lora=True, small_attention=False, flash_attention=False, interpret=True)
    T.set_kernel_flags(fused_lora=True, small_attention=False, flash_attention=False)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("D,r,M", [(128, 8, 50), (64, 4, 7), (192, 16, 33), (64, 21, 9)])
def test_grouped_operands_match_three_jax_linear_calls(D, r, M, bias, restore_flags):  # noqa: F811
    _force(restore_flags)
    rng = np.random.default_rng(D + r)
    p, lora = _attn(rng, D, (r, r, r, r), bias)
    x = rng.normal(size=(M, D)).astype(np.float32)
    ref = [np.asarray(J.linear(to_jax(p[n]), jnp.asarray(x), to_jax(lora[n]), 2.0)) for n in QKV]
    group = T.group_qkv(to_torch(p), to_torch(lora))
    assert group["kernel"].shape == (D, 3 * D) and group["a"].shape == (D, 3 * r)
    assert group["a"].t().is_contiguous()  # the kernel's A^T layout, no copy at launch
    assert group["b"].shape == (3 * r, 3 * D)
    assert (group["bias"] is None) == (not bias)
    for i in range(3):  # blockdiag: every off-diagonal block is zero
        for j in range(3):
            blk = group["b"][i * r:(i + 1) * r, j * D:(j + 1) * D]
            assert (i == j) or not blk.any()
    y = L.lora_matmul_plain(torch.from_numpy(x), group["kernel"], group["a"], group["b"], 2.0, groups=3)
    assert y.shape == (3, M, D) and y.is_contiguous()
    if bias:
        y = y + group["bias"]
    for i in range(3):
        np.testing.assert_allclose(y[i].numpy(), ref[i], atol=1e-5)


@pytest.mark.parametrize("ranks", [(8, 8, 4, 8), (8, 0, 8, 8), (0, 0, 0, 8), (22, 22, 22, 22), (32, 32, 32, 32)],
                         ids=["mixed_ranks", "no_k_adapter", "out_proj_only", "r22_past_r_max", "r32_past_r_max"])
def test_layer_without_one_rank_takes_the_per_projection_path(ranks, restore_flags, monkeypatch):  # noqa: F811
    _force(restore_flags)
    rng = np.random.default_rng(sum(ranks))
    D, H = 128, 2
    p, lora = _attn(rng, D, ranks)
    assert T.group_qkv(to_torch(p), to_torch(lora)) is None  # 3 x 22 > R_MAX = 64
    calls = []
    real = L.lora_matmul
    monkeypatch.setattr(L, "lora_matmul", lambda *a, **k: calls.append(k.get("groups", 1)) or real(*a, **k))
    x = rng.normal(size=(2, 50, D)).astype(np.float32)
    ref = J.attention(to_jax(p), jnp.asarray(x), H, lora=to_jax(lora), lora_scaling=2.0)
    got = T.attention(to_torch(p), torch.from_numpy(x), H, lora=to_torch(lora), lora_scaling=2.0)
    assert calls == [1] * sum(1 for r in ranks if r)  # one launch per adapted projection
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_attention_takes_the_grouped_launch_like_jax(restore_flags, monkeypatch):  # noqa: F811
    _force(restore_flags)
    rng = np.random.default_rng(21)
    D, H = 128, 2
    p, lora = _attn(rng, D, (8, 8, 8, 8))
    tl = to_torch(lora)
    tl["qkv"] = T.group_qkv(to_torch(p), tl)
    calls = []
    real = L.lora_matmul
    monkeypatch.setattr(L, "lora_matmul", lambda *a, **k: calls.append(k.get("groups", 1)) or real(*a, **k))
    x = rng.normal(size=(2, 50, D)).astype(np.float32)
    ref = J.attention(to_jax(p), jnp.asarray(x), H, lora=to_jax(lora), lora_scaling=2.0)
    got = T.attention(to_torch(p), torch.from_numpy(x), H, lora=tl, lora_scaling=2.0)
    assert calls == [3, 1]  # q/k/v in one launch, then out_proj
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    # with fused_lora off the plain path reads the grouped W and still agrees
    T.set_kernel_flags(fused_lora=False)
    J.set_kernel_flags(fused_lora=False)
    got = T.attention(to_torch(p), torch.from_numpy(x), H, lora=tl, lora_scaling=2.0)
    ref = J.attention(to_jax(p), jnp.asarray(x), H, lora=to_jax(lora), lora_scaling=2.0)
    assert calls == [3, 1]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def _encoders(targets=("q_proj", "k_proj", "v_proj", "out_proj"), r=8):
    params = jclip.init_params(jax.random.PRNGKey(0), J_SMALL)
    lcfg = JLoraConfig(r=r, target_modules=targets)
    lora = to_jax(random_like_tree(j_init_lora(jax.random.PRNGKey(1), J_SMALL, lcfg)))
    jenc = JEncoder(params, arch=J_SMALL, config=JConfig(arch=J_SMALL), lora=lora, lora_scaling=2.0)
    tenc = TEncoder(params_from_numpy(j_flatten(params), device="cpu"), arch=T_SMALL,
                    config=TConfig(arch=T_SMALL), device="cpu")
    tenc.attach_lora(params_from_numpy(j_flatten(lora), device="cpu"), 2.0)
    return jenc, tenc


@pytest.mark.parametrize("targets,r", [(QKV + ("out_proj",), 8), (("q_proj", "v_proj"), 8), (QKV + ("out_proj",), 32)],
                         ids=["qkv_out", "q_v_only", "qkv_out_r32"])
def test_tiny_model_through_the_grouped_layers_matches_jax(targets, r, restore_flags, monkeypatch):  # noqa: F811
    jenc, tenc = _encoders(targets, r)
    J.set_kernel_flags(fused_lora=True, small_attention=True, interpret=True)
    T.set_kernel_flags(fused_lora=True, small_attention=True)
    calls = []
    real = L.lora_matmul
    monkeypatch.setattr(L, "lora_matmul", lambda *a, **k: calls.append(k.get("groups", 1)) or real(*a, **k))
    rng = np.random.default_rng(22)
    pix = rng.normal(size=(3, 64, 64, 3)).astype(np.float32)
    texts = ["tas pink di kantin", "payung hitam", "kunci motor"]
    got_img, got_txt = tenc.encode_image_batch(pix), tenc.encode_text(texts)
    layers = J_SMALL.vision_layers + J_SMALL.text_layers
    grouped = len(targets) == 4 and 3 * r <= L.R_MAX
    if grouped:  # every attention layer: one grouped launch + out_proj
        assert sorted(calls) == [1] * layers + [3] * layers
    else:  # one launch per adapted projection: k_proj has no adapter, or 3r > R_MAX
        assert calls == [1] * len(targets) * layers
    _, serving_lora = tenc._serving_state()
    assert all(("qkv" in lb["attn"]) == grouped
               for tower in ("visual", "text") for lb in serving_lora[tower]["blocks"])
    ref_img, ref_txt = jenc.encode_image_batch(pix), jenc.encode_text(texts)
    assert np.abs(got_img - ref_img).max() <= 1e-4
    assert np.abs(got_txt - ref_txt).max() <= 1e-4


def test_serving_copy_holds_one_grouped_w_in_place_of_three():
    _, tenc = _encoders()
    params, lora = tenc._serving_state()
    for tower in ("visual", "text"):
        for pb, lb in zip(params[tower]["blocks"], lora[tower]["blocks"]):
            w = lb["attn"]["qkv"]["kernel"]
            D = w.shape[0]
            for i, n in enumerate(QKV):  # q/k/v kernels are views into the grouped W
                kern = pb["attn"][n]["kernel"]
                assert kern.data_ptr() == w[:, i * D:].data_ptr() and kern.shape == (D, D)
            assert lb["attn"]["out_proj"]["a"].t().is_contiguous()
    # the master weights are untouched
    assert tenc.params["visual"]["blocks"]["attn"]["q_proj"]["kernel"].is_contiguous()


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

# (K, N, groups) of every projection the main paths launch: per projection
# (out_proj, and q/k/v where they cannot group) and grouped
WIDTHS = {"B32_image": (768, 768, 1), "B32_text": (512, 512, 1), "L14_image": (1024, 1024, 1),
          "L14_text": (768, 768, 1), "B32_image_qkv": (768, 2304, 3), "B32_text_qkv": (512, 1536, 3),
          "L14_image_qkv": (1024, 3072, 3), "L14_text_qkv": (768, 2304, 3)}


@pytest.mark.parametrize("sms", [132, 114, 78])
@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("M", [1, 50, 64, 577, 4_800, 16_384, 18_464])
def test_lora_plan_covers_each_k_step_once(M, width, sms):
    # K is not split: each block runs the whole K loop of its output tile,
    # the largest tile whose grid reaches 7/8 of the SMs, else the smallest
    K, N, G = WIDTHS[width]
    r = 8 * G
    p = L.plan(M, N, K, r, torch.bfloat16, True, sms, G)
    assert p.body == "wgmma" and p._fields == ("body", "bm", "bn")
    reach = [t for t in L._TILES if 8 * -(-M // t[0]) * -(-N // t[1]) >= 7 * sms]
    assert (p.bm, p.bn) == (reach[0] if reach else L._TILES[-1])


@pytest.mark.parametrize(
    "M,K,N,G,want",
    [(50, 768, 768, 1, (64, 64)), (64, 512, 512, 1, (64, 64)), (577, 1024, 1024, 1, (64, 64)),
     (64, 768, 768, 1, (64, 64)), (50, 768, 2304, 3, (64, 64)), (64, 512, 1536, 3, (64, 64)),
     (577, 1024, 3072, 3, (128, 128)), (64, 768, 2304, 3, (64, 64)),
     (4_800, 768, 768, 1, (128, 128)), (16_384, 512, 512, 1, (128, 128)),
     (4_800, 768, 2304, 3, (128, 128)), (18_464, 1024, 3072, 3, (128, 128))],
    ids=["B32_image", "B32_text", "L14_image", "L14_text", "B32_image_qkv", "B32_text_qkv",
         "L14_image_qkv", "L14_text_qkv", "B32_image_batch", "B32_text_batch", "B32_image_batch_qkv",
         "L14_image_batch_qkv"],
)
def test_lora_plan_at_the_main_path_shapes(M, K, N, G, want):
    # request rows take the smallest tile (the most blocks); from M = 577 on
    # the tiles fill 132 SMs
    assert L.plan(M, N, K, 8 * G, torch.bfloat16, True, 132, G) == L.Plan("wgmma", *want)


@pytest.mark.parametrize(
    "K,N,G,r,aligned,body",
    [(768, 2304, 3, 24, True, "wgmma"), (768, 2304, 3, 24, False, "wmma"), (130, 768, 1, 8, True, "wmma"),
     (768, 70, 1, 8, True, "wmma"), (768, 12, 3, 8, True, "wmma"), (96, 80, 1, 20, True, "wgmma"),
     (1024, 1024, 1, 64, True, "wgmma"), (1, 1, 1, 1, True, "wmma")],
    ids=["grouped", "unaligned", "K_off_8", "N_off_8", "group_width_off_8", "small", "r_max", "one"],
)
def test_lora_plan_picks_the_body(K, N, G, r, aligned, body):
    assert L.plan(50, N, K, r, torch.bfloat16, aligned, 132, G).body == body
    assert L.plan(50, N, K, r, torch.float32, aligned, 132, G) == L.Plan("fp32", 64, 64)


def test_lora_wrapper_on_the_cpu_runs_the_plain_version():
    rng = np.random.default_rng(23)
    x, w, a, b = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                  for s in ((5, 32), (32, 48), (32, 6), (6, 48)))
    before = L.lora_matmul.launches
    got = L.lora_matmul(x, w, a, b, 2.0, groups=3)
    assert L.lora_matmul.launches == before and got.shape == (3, 5, 16)
    torch.testing.assert_close(got, L.lora_matmul_plain(x, w, a, b, 2.0, groups=3), rtol=0, atol=0)
    flat = L.lora_matmul_plain(x, w, a, b, 2.0)
    torch.testing.assert_close(got, flat.view(5, 3, 16).transpose(0, 1), rtol=0, atol=0)
