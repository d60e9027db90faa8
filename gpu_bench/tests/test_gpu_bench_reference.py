"""The plain reference against the port on a tiny architecture, on the CPU
in fp32, and the blocked exact top-k against a brute-force one."""

import numpy as np
import pytest
import torch

from gpu_bench.harness import traffic, weights
from gpu_bench.reference import clip as ref_clip
from gpu_bench.reference import train as ref_train
from gpu_bench.reference.tokenizer import ByteTokenizer
from gpu_bench.reference.topk import exact_topk
from gpu_bench.tests.tiny import TINY_WIDTHS

LORA = {"r": 4, "alpha": 8, "dropout": 0.0, "target_modules": ["q_proj", "k_proj", "v_proj", "out_proj"],
        "b_std": 0.05}
CPU = torch.device("cpu")


def _port_encoder(seed):
    from clip_lora_match_tpu_torch.core.config import ClipArchConfig, ClipConfig
    from clip_lora_match_tpu_torch.models.encoder import ClipEncoder

    arch = ClipArchConfig(**TINY_WIDTHS)
    params = weights.clip_weights(TINY_WIDTHS, seed, CPU)
    lora = weights.lora_weights(TINY_WIDTHS, LORA, seed, CPU)
    return ClipEncoder(params, arch=arch, config=ClipConfig(model_name="tiny", arch=arch), lora=lora,
                       lora_scaling=2.0, device=CPU), params, lora


def test_weights_repeat_for_a_seed():
    a = weights.clip_weights(TINY_WIDTHS, 5, CPU)
    b = weights.clip_weights(TINY_WIDTHS, 5, CPU)
    c = weights.clip_weights(TINY_WIDTHS, 6, CPU)
    ka, kb, kc = (t["text"]["blocks"]["attn"]["q_proj"]["kernel"] for t in (a, b, c))
    assert torch.equal(ka, kb) and not torch.equal(ka, kc)
    la = weights.lora_weights(TINY_WIDTHS, LORA, 5, CPU)["visual"]["blocks"]["attn"]["k_proj"]["a"]
    assert la.abs().max() <= TINY_WIDTHS["vision_width"] ** -0.5


def test_text_tower_matches_the_port():
    enc, params, lora = _port_encoder(11)
    texts = ["dompet kulit coklat", "tas ransel hitam ada stiker, ditemukan di aula rektorat.", "x"]
    got = torch.as_tensor(enc.encode_text(texts))
    tok = ByteTokenizer()
    with torch.no_grad():
        ref = ref_clip.unit(ref_clip.text_features(params, lora, torch.as_tensor(tok(texts)), TINY_WIDTHS,
                                                   tok.eot, 2.0))
    assert (got - ref).norm(dim=1).max() < 2e-6


def test_image_tower_matches_the_port():
    enc, params, lora = _port_encoder(12)
    pix = traffic.clip_normalize(traffic.pixels_u8(3, 32, 12, CPU, "p"))
    got = torch.as_tensor(enc.encode_image_batch(pix.numpy()))
    with torch.no_grad():
        ref = ref_clip.unit(ref_clip.image_features(params, lora, pix, TINY_WIDTHS, 2.0))
    assert (got - ref).norm(dim=1).max() < 2e-6


def test_training_steps_match_the_port():
    from clip_lora_match_tpu_torch.core.config import ClipArchConfig, LoraConfig, TrainingConfig
    from clip_lora_match_tpu_torch.nn.layers import kernel_flags
    from clip_lora_match_tpu_torch.train.step import init_train_state, make_optimizer, make_train_step

    arch = ClipArchConfig(**TINY_WIDTHS)
    params = weights.clip_weights(TINY_WIDTHS, 13, CPU)
    lora = weights.lora_weights(TINY_WIDTHS, LORA, 13, CPU)
    opt = {"learning_rate": 0.05, "weight_decay": 0.01, "warmup_ratio": 0.2, "max_grad_norm": 0.5,
           "temperature": 0.07, "total_steps": 10, "scaling": 2.0}
    cfg = TrainingConfig(batch_size=6, learning_rate=0.05, weight_decay=0.01, warmup_ratio=0.2,
                         max_grad_norm=0.5, temperature=0.07)
    tx, _ = make_optimizer(cfg, 10)
    tok = ByteTokenizer()
    caps = [traffic.texts({"items": ["dompet"], "colors": ["biru"], "details": ["kecil"], "places": ["aula"],
                           "fashion_items": ["kaos"], "genders": ["pria"], "categories": ["a/b"]},
                          np.array([8, 20, 30, 12, 9, 40]), j, "c") for j in range(3)]
    pix = [traffic.pixels_u8(6, 32, 13, CPU, f"p{j}") for j in range(3)]
    ids = [torch.as_tensor(tok(c)) for c in caps]
    with kernel_flags(fused_lora=False, flash_attention=False, small_attention=False):
        step = make_train_step(params, arch, LoraConfig(r=4, alpha=8, dropout=0.0), cfg, tx, eot_id=tok.eot)
        state = init_train_state(lora, tx)
        losses = []
        for j in range(3):
            mask = (np.arange(77)[None] < np.array([len(tok.ids(c)) for c in caps[j]])[:, None]).astype(np.int32)
            state, m = step(state, {"pixel_values": pix[j].numpy(), "input_ids": ids[j].numpy(),
                                    "attention_mask": mask})
            losses.append(float(m["loss"]))
    ref = ref_train.steps(params, lora, list(zip(pix, ids)), TINY_WIDTHS, opt, tok.eot)
    assert np.allclose(losses, ref["losses"], rtol=1e-5)
    got, start = dict(ref_train.leaves(state.lora)), dict(ref_train.leaves(lora))
    for path, t in ref["lora"]:
        # fp32 in another order of summation: within 1e-4 of each leaf's change
        assert (got[path] - t).abs().max() <= 1e-4 * (t - start[path]).abs().max(), path


def test_blocked_exact_topk_matches_brute_force():
    g = torch.Generator().manual_seed(3)
    rows = torch.nn.functional.normalize(torch.randn(1000, 16, generator=g), dim=1)
    rows[700] = rows[20]  # a tie: the lower id ranks first
    q = torch.nn.functional.normalize(torch.randn(4, 16, generator=g), dim=1)
    q[0] = rows[20]
    blocks = ((s, rows[s:s + 128]) for s in range(0, 1000, 128))
    ids = torch.tensor([[20, 700, 5], [1, 2, 3], [999, 0, 500], [7, 7, 7]])
    best_s, best_i, own = exact_topk(q, blocks, 5, ids=ids)
    full = q @ rows.t()
    s, i = torch.sort(full, dim=1, descending=True, stable=True)
    assert torch.equal(best_i, i[:, :5]) and torch.allclose(best_s, s[:, :5])
    assert best_i[0, 0] == 20 and best_i[0, 1] == 700
    assert torch.allclose(own, full.gather(1, ids))


@pytest.mark.parametrize("tf32", [False])
def test_precision_context_restores(tf32):
    before = torch.backends.cuda.matmul.allow_tf32
    with ref_clip.precision(tf32=True):
        assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32 == before
