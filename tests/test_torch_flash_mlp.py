"""The port's flash attention and fused MLP against the JAX package on the CPU:
the kernels' plain versions against the Pallas kernels in interpret mode,
the layer dispatch under the forced flags, and a tiny model whose image tower
(S = 145, head_dim 64) takes flash and whose MLPs take the fused kernel, in
both packages. fp32 tolerances: flash atol 2e-5 / rtol 1e-4 (online vs
one-pass softmax, other summation order), MLP atol 1e-5; bf16: 2e-2 / 3e-2
(one bf16 step of the output, or of the rounded hidden)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_lora_match_tpu.core.config import ClipArchConfig as JArch
from clip_lora_match_tpu.core.config import ClipConfig as JConfig
from clip_lora_match_tpu.core.config import LoraConfig as JLoraConfig
from clip_lora_match_tpu.lora.adapter import init_lora as j_init_lora
from clip_lora_match_tpu.models import clip as jclip
from clip_lora_match_tpu.models.encoder import ClipEncoder as JEncoder
from clip_lora_match_tpu.models.io import flatten_params as j_flatten
from clip_lora_match_tpu.nn import layers as J
from clip_lora_match_tpu.ops.flash_attention import attention_reference as j_attention_reference
from clip_lora_match_tpu.ops.flash_attention import flash_attention as j_flash
from clip_lora_match_tpu.ops.mlp_fused import mlp_fused as j_mlp_fused
from clip_lora_match_tpu_torch.core.config import ClipArchConfig as TArch
from clip_lora_match_tpu_torch.core.config import ClipConfig as TConfig
from clip_lora_match_tpu_torch.models.encoder import ClipEncoder as TEncoder
from clip_lora_match_tpu_torch.models.io import params_from_numpy
from clip_lora_match_tpu_torch.nn import layers as T
from clip_lora_match_tpu_torch.ops import flash_attention as F
from clip_lora_match_tpu_torch.ops import mlp_fused as MF
from tests._torch_helpers import random_like_tree, restore_flags, to_jax, to_torch  # noqa: F401

NEG = float(np.finfo(np.float32).min)


def _qkv(rng, B, S, H, d=64, dtype=np.float32):
    return [rng.normal(size=(B, S, H, d)).astype(dtype) for _ in range(3)]


def _mask(rng, kind, B, S):
    if kind == "none":
        return None
    if kind == "causal":
        return np.triu(np.full((S, S), NEG, np.float32), 1)[None, None]
    # per-batch: row 1 keeps only its first third of the keys, row 0 a
    # random sparse pattern (every row keeps key 0)
    m = np.where(rng.random((B, 1, S, S)) < 0.3, NEG, 0.0).astype(np.float32)
    m[..., 0] = 0.0
    m[1, :, :, S // 3:] = NEG
    return m


def _bhsd(x):
    return jnp.asarray(np.ascontiguousarray(x.transpose(0, 2, 1, 3)))


@pytest.mark.parametrize("mask_kind", ["none", "causal", "per_batch"])
@pytest.mark.parametrize("S", [65, 145, 300])
def test_flash_plain_matches_jax_kernel(S, mask_kind):
    rng = np.random.default_rng(S)
    B, H = 2, 2
    q, k, v = _qkv(rng, B, S, H)
    m = _mask(rng, mask_kind, B, S)
    ref = j_flash(_bhsd(q), _bhsd(k), _bhsd(v), mask=None if m is None else jnp.asarray(m),
                  block_q=128, block_kv=128, interpret=True)
    got = F.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                  mask=None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref).transpose(0, 2, 1, 3),
                               atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("S,mask_kind", [(145, "none"), (77, "causal")])
def test_flash_plain_bf16_matches_jax_kernel(S, mask_kind):
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, 2, S, 3)
    m = _mask(rng, mask_kind, 2, S)
    qb, kb, vb = (torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v))
    jb = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16).transpose(0, 2, 1, 3) for t in (qb, kb, vb)]
    ref = j_flash(*jb, mask=None if m is None else jnp.asarray(m), interpret=True)
    got = F.flash_attention_plain(qb, kb, vb, mask=None if m is None else torch.from_numpy(m))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)).transpose(0, 2, 1, 3), atol=2e-2)


def test_attention_reference_matches_jax():
    rng = np.random.default_rng(8)
    q, k, v = (x.transpose(0, 2, 1, 3).copy() for x in _qkv(rng, 2, 50, 2))
    m = _mask(rng, "per_batch", 2, 50)
    ref = j_attention_reference(*map(jnp.asarray, (q, k, v)), mask=jnp.asarray(m))
    got = F.attention_reference(*map(torch.from_numpy, (q, k, v)), mask=torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)


def test_flash_wrapper_takes_the_layout_and_refuses_other_head_dims():
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(t) for t in _qkv(rng, 1, 20, 2))
    out = F.flash_attention(q, k, v)  # CPU tensors: the plain version, no launch
    assert out.shape == q.shape and F.flash_attention.launches == 0
    torch.testing.assert_close(out, F.flash_attention_plain(q, k, v), rtol=0, atol=0)
    with pytest.raises(ValueError, match="head_dim"):
        F.flash_attention(q[..., :32], k[..., :32], v[..., :32])


@pytest.mark.parametrize(
    "M,K,H,N",
    [(37, 64, 256, 64), (1, 128, 512, 96), (50, 64, 200, 64)],
    ids=["rows", "one_row", "ragged_H"],
)
def test_mlp_plain_matches_jax_kernel_fp32(M, K, H, N):
    rng = np.random.default_rng(M + H)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w1 = rng.normal(0, K ** -0.5, (K, H)).astype(np.float32)
    b1 = rng.normal(0, 0.1, (H,)).astype(np.float32)
    w2 = rng.normal(0, H ** -0.5, (H, N)).astype(np.float32)
    b2 = rng.normal(0, 0.1, (N,)).astype(np.float32)
    ref = j_mlp_fused(*map(jnp.asarray, (x, w1, b1, w2, b2)), interpret=True)
    got = MF.mlp_fused_plain(*map(torch.from_numpy, (x, w1, b1, w2, b2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("H", [256, 200], ids=["even_H", "ragged_H"])
def test_mlp_plain_matches_jax_kernel_bf16(H):
    rng = np.random.default_rng(H)
    M, K, N = 40, 64, 64
    arrs = [rng.normal(size=(M, K)), rng.normal(0, K ** -0.5, (K, H)), rng.normal(0, 0.1, (H,)),
            rng.normal(0, H ** -0.5, (H, N)), rng.normal(0, 0.1, (N,))]
    x, w1, b1, w2, b2 = (torch.from_numpy(a.astype(np.float32)) for a in arrs)
    x, w1, w2 = (t.to(torch.bfloat16) for t in (x, w1, w2))
    jx, jw1, jw2 = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (x, w1, w2))
    ref = j_mlp_fused(jx, jw1, jnp.asarray(b1.numpy()), jw2, jnp.asarray(b2.numpy()), interpret=True)
    got = MF.mlp_fused_plain(x, w1, b1, w2, b2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)), atol=3e-2)


# ---------------------------------------------------------------------------
# dispatch in nn/layers under the forced flags
# ---------------------------------------------------------------------------


def _lin(rng, d_in, d_out):
    return {"kernel": rng.normal(0, d_in ** -0.5, (d_in, d_out)).astype(np.float32),
            "bias": rng.normal(0, 0.1, (d_out,)).astype(np.float32)}


def _force(flash: bool, fused_mlp: bool):
    J.set_kernel_flags(flash_attention=flash, fused_mlp=fused_mlp, small_attention=False,
                       fused_lora=False, interpret=True)
    T.set_kernel_flags(flash_attention=flash, fused_mlp=fused_mlp, small_attention=False,
                       fused_lora=False)


@pytest.mark.parametrize("tower", ["image", "text"])
def test_attention_layer_takes_flash_like_jax(tower, restore_flags, monkeypatch):  # noqa: F811
    _force(flash=True, fused_mlp=False)
    calls = []
    real = F.flash_attention
    monkeypatch.setattr(F, "flash_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(10)
    D, H = 128, 2
    p = {n: _lin(rng, D, D) for n in ("q_proj", "k_proj", "v_proj", "out_proj")}
    S = 145 if tower == "image" else 77
    x = rng.normal(size=(2, S, D)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if tower == "text":
        m = _mask(rng, "causal", 2, S)
        kw_j, kw_t = dict(mask=jnp.asarray(m), causal=True), dict(mask=torch.from_numpy(m), causal=True)
    ref = J.attention(to_jax(p), jnp.asarray(x), H, **kw_j)
    got = T.attention(to_torch(p), torch.from_numpy(x), H, **kw_t)
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("compute", ["fp32", "bf16"])
def test_mlp_layer_takes_the_fused_kernel_like_jax(compute, restore_flags, monkeypatch):  # noqa: F811
    _force(flash=False, fused_mlp=True)
    calls = []
    real = MF.mlp_fused
    monkeypatch.setattr(MF, "mlp_fused", lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(11)
    p = {"fc1": _lin(rng, 64, 256), "fc2": _lin(rng, 256, 64)}
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    jdt, tdt = (None, None) if compute == "fp32" else (jnp.bfloat16, torch.bfloat16)
    ref = J.mlp(to_jax(p), jnp.asarray(x), compute_dtype=jdt)
    tp = to_torch(p)
    if tdt is not None:  # the encoder's serving copy holds the kernels in bf16
        tp = {n: {"kernel": t["kernel"].to(tdt), "bias": t["bias"]} for n, t in tp.items()}
    got = T.mlp(tp, torch.from_numpy(x), compute_dtype=tdt)
    assert calls == [1] and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5 if jdt is None else 3e-2)


def test_mlp_with_an_adapter_takes_the_plain_path_exactly(restore_flags, monkeypatch):  # noqa: F811
    rng = np.random.default_rng(12)
    p = to_torch({"fc1": _lin(rng, 64, 256), "fc2": _lin(rng, 256, 64)})
    lora = to_torch({"fc1": {"a": rng.normal(0, 0.1, (64, 4)).astype(np.float32),
                             "b": rng.normal(0, 0.1, (4, 256)).astype(np.float32)}})
    x = torch.from_numpy(rng.normal(size=(2, 5, 64)).astype(np.float32))
    T.set_kernel_flags(fused_mlp=False)
    plain = T.mlp(p, x, lora=lora, lora_scaling=2.0)
    monkeypatch.setattr(MF, "mlp_fused", lambda *a, **k: pytest.fail("mlp_fused was called"))
    T.set_kernel_flags(fused_mlp=True)
    got = T.mlp(p, x, lora=lora, lora_scaling=2.0)
    assert torch.equal(got, plain)
    # a bias-free MLP keeps the plain path too (the kernel's signature has both biases)
    del p["fc2"]["bias"]
    T.set_kernel_flags(fused_mlp=False)
    plain = T.mlp(p, x)
    T.set_kernel_flags(fused_mlp=True)
    assert torch.equal(T.mlp(p, x), plain)


def test_flash_gate_follows_flag_device_and_sentinel(restore_flags):  # noqa: F811
    x = torch.zeros(1, 577, 8)
    for flag, want in ((True, True), (False, False), ("auto", False)):
        T.set_kernel_flags(flash_attention=flag)
        assert T._use_flash(x) is want  # "auto": CPU tensors never take it
    assert T.FLASH_MIN_SEQ == J.FLASH_MIN_SEQ == 1 << 30


# ---------------------------------------------------------------------------
# the slice as a whole: a tiny model at head_dim 64 whose image tower runs S=145
# ---------------------------------------------------------------------------

TINY_KW = dict(
    image_size=96, patch_size=8, vision_width=128, vision_layers=2, vision_heads=2,
    vision_mlp_dim=512, text_width=128, text_layers=2, text_heads=2, text_mlp_dim=512,
    vocab_size=514, projection_dim=64,
)


def test_tiny_model_through_flash_and_fused_mlp_matches_jax(restore_flags):  # noqa: F811
    jarch, tarch = JArch(**TINY_KW), TArch(**TINY_KW)
    assert tarch.vision_seq_len == 145
    params = jclip.init_params(jax.random.PRNGKey(0), jarch)
    lora = to_jax(random_like_tree(j_init_lora(jax.random.PRNGKey(1), jarch, JLoraConfig())))
    jenc = JEncoder(params, arch=jarch, config=JConfig(arch=jarch), lora=lora, lora_scaling=2.0)
    tenc = TEncoder(params_from_numpy(j_flatten(params), device="cpu"), arch=tarch,
                    config=TConfig(arch=tarch), device="cpu")
    tenc.attach_lora(params_from_numpy(j_flatten(lora), device="cpu"), 2.0)
    # every kernel branch on in both packages (JAX kernels interpreted): the
    # image tower takes flash, the text tower small attention, every MLP the
    # fused kernel, every adapted projection lora_matmul
    J.set_kernel_flags(flash_attention=True, fused_mlp=True, small_attention=True,
                       fused_lora=True, interpret=True)
    T.set_kernel_flags(flash_attention=True, fused_mlp=True, small_attention=True, fused_lora=True)
    rng = np.random.default_rng(13)
    pix = rng.normal(size=(3, 96, 96, 3)).astype(np.float32)
    texts = ["tas pink di kantin", "payung hitam", "kunci motor"]
    calls = {"flash": 0, "mlp": 0}
    real_flash, real_mlp = F.flash_attention, MF.mlp_fused
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(F, "flash_attention",
                   lambda *a, **k: calls.__setitem__("flash", calls["flash"] + 1) or real_flash(*a, **k))
        mp.setattr(MF, "mlp_fused",
                   lambda *a, **k: calls.__setitem__("mlp", calls["mlp"] + 1) or real_mlp(*a, **k))
        got_img, got_txt = tenc.encode_image_batch(pix), tenc.encode_text(texts)
    assert calls == {"flash": 2, "mlp": 4}  # flash per image layer; fused MLP per layer of both towers
    ref_img, ref_txt = jenc.encode_image_batch(pix), jenc.encode_text(texts)
    assert np.abs(got_img - ref_img).max() <= 1e-4
    assert np.abs(got_txt - ref_txt).max() <= 1e-4


# ---------------------------------------------------------------------------
# the fused MLP's launch plan (pure Python: the card runs what it says)
# ---------------------------------------------------------------------------

CLIP_MLPS = {"B32_text": (512, 2048, 512), "L14_text": (768, 3072, 768), "L14_vision": (1024, 4096, 1024)}


@pytest.mark.parametrize("sms", [132, 114, 78])
@pytest.mark.parametrize("width", sorted(CLIP_MLPS))
@pytest.mark.parametrize("M", [1, 63, 64, 65, 577, 18_464])
def test_mlp_plan_covers_each_hidden_chunk_once(M, width, sms):
    K, H, N = CLIP_MLPS[width]
    p = MF.plan(M, K, H, N, torch.bfloat16, True, sms)
    assert p.body == "wgmma" and p.cluster == N // 256 and p.chunk == 64 * p.cluster
    n_chunks = -(-H // p.chunk)
    cps = -(-n_chunks // p.splits)  # chunks per split, as the kernel's entry point derives it
    covered = [c for z in range(p.splits) for c in range(z * cps, min(n_chunks, (z + 1) * cps))]
    assert covered == list(range(n_chunks))  # in order, each once
    assert all(z * cps < n_chunks for z in range(p.splits))  # no empty split
    ctas = -(-M // 64) * p.cluster * p.splits
    if p.splits > 1:
        assert ctas <= sms
    else:  # a split would not fit: the tiles alone fill (or pass) the SMs, or nothing to split
        assert -(-M // 64) * p.cluster * 2 > sms or n_chunks == 1


@pytest.mark.parametrize(
    "M,K,H,N,aligned,body",
    [(577, 1024, 4096, 1024, True, "wgmma"), (64, 768, 3072, 768, True, "wgmma"),
     (50, 512, 2048, 512, True, "wgmma"), (577, 1024, 4096, 1024, False, "wmma"),
     (33, 100, 200, 300, True, "wmma"), (70, 1024, 4100, 1000, True, "wmma"),
     (50, 768, 3000, 768, True, "wgmma"), (8, 256, 1024, 256, True, "wmma"),
     (8, 1088, 4096, 1024, True, "wmma"), (8, 1024, 4096, 1280, True, "wmma"),
     (8, 768, 3004, 768, True, "wmma")],
    ids=["L14_vision", "L14_text", "B32_text", "unaligned", "ragged_K_N", "ragged_all",
         "ragged_H_even", "one_cta_cluster", "K_past_resident_x", "cluster_past_4", "H_stride_off_16B"],
)
def test_mlp_plan_picks_the_body(M, K, H, N, aligned, body):
    p = MF.plan(M, K, H, N, torch.bfloat16, aligned, 132)
    assert p.body == body
    assert (p.cluster, p.chunk) == ((N // 256, 64 * (N // 256)) if body == "wgmma" else (1, 64))
    assert MF.plan(M, K, H, N, torch.float32, aligned, 132) == MF.Plan("fp32", 1, 32, 1)


def test_mlp_plan_at_one_l14_image():
    # 10 row tiles x 4 CTAs = 40: three splits of the 16 chunks give 120 CTAs
    assert MF.plan(577, 1024, 4096, 1024, torch.bfloat16, True, 132) == MF.Plan("wgmma", 4, 256, 3)
    assert MF.plan(18_464, 1024, 4096, 1024, torch.bfloat16, True, 132) == MF.Plan("wgmma", 4, 256, 1)
    assert MF.plan(64, 768, 3072, 768, torch.bfloat16, True, 132) == MF.Plan("wgmma", 3, 192, 16)


@pytest.mark.parametrize(
    "B,S,H,dtype,want",
    [(1, 50, 12, torch.bfloat16, (4, 4)), (1, 77, 8, torch.bfloat16, (4, 4)),
     (96, 50, 12, torch.bfloat16, (4, 1)), (256, 77, 8, torch.bfloat16, (5, 1)),
     (256, 64, 8, torch.bfloat16, (4, 1)), (20, 128, 8, torch.bfloat16, (8, 1)),
     (1, 50, 12, torch.float32, (8, 2)), (96, 50, 12, torch.float32, (8, 4)),
     (8, 77, 8, torch.float32, (8, 2))],
)
def test_attention_small_launch_shape(B, S, H, dtype, want):
    from clip_lora_match_tpu_torch.ops import attention_small as A

    assert A.launch_shape(B, S, H, dtype, 132) == want
