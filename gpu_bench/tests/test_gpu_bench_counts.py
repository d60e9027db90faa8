"""The FLOP and byte counters against shapes worked by hand."""

from gpu_bench.counts import clip_flops, kernels
from gpu_bench.harness.peaks import bound_s

W = {"image_size": 4, "patch_size": 2, "vision_width": 2, "vision_layers": 1, "vision_heads": 1,
     "vision_mlp_dim": 4, "text_width": 2, "text_layers": 1, "text_heads": 1, "text_mlp_dim": 4,
     "projection_dim": 3, "max_text_length": 77}


def test_text_tower_by_hand():
    # L=3 tokens, width 2, MLP 4, r=1, one layer:
    # q,k,v,out: 4 * 2*3*2*2 = 96; MLP: 2 * 2*3*2*4 = 96; LoRA: 4 * (2*3*2*1 + 2*3*1*2) = 96;
    # attention over the 6 causal pairs: q.k 2*6*2 = 24, p.v 24; projection 2*2*3 = 12
    assert clip_flops.text_tower(W, 3, r=1) == 96 + 96 + 96 + 48 + 12


def test_image_tower_by_hand():
    # 4x4 image, patch 2: 4 patches + class = 5 tokens, width 2, MLP 4, r=1, one layer
    # patch embedding 2*4*12*2 = 192; q,k,v,out 4 * 2*5*2*2 = 160; MLP 2 * 2*5*2*4 = 160;
    # LoRA 4 * 4*5*2*1 = 160; attention over all 25 pairs 2 * 2*25*2 = 200; projection 2*2*3 = 12
    assert clip_flops.image_tokens(W) == 5
    assert clip_flops.image_tower(W, r=1) == 192 + 160 + 160 + 160 + 200 + 12


def test_train_step_by_hand():
    # one pair, caption of 3 tokens: both towers forward, then backward:
    # image: frozen products' input gradients 160 + 160 (less the first layer's q/k/v: 3 * 2*5*2*2 = 120),
    #   attention twice forward 400, LoRA 4 * 8*5*2*1 = 320 (less the first layer's q/k/v dx: 3 * 2*5*2*1 = 60),
    #   projection 12
    # text: 96 + 96 - 3 * 2*3*2*2 (72) + 96 (2 * 48) + 4 * 8*3*2*1 (192) - 3 * 2*3*2*1 (36) + 12
    # loss: 3 * 2*1*1*3 = 18
    fwd = clip_flops.image_tower(W, r=1) + clip_flops.text_tower(W, 3, r=1)
    img_bwd = 160 + 160 - 120 + 400 + 320 - 60 + 12
    txt_bwd = 96 + 96 - 72 + 96 + 192 - 36 + 12
    assert clip_flops.train_step(W, [3], batch=1, r=1) == fwd + img_bwd + txt_bwd + 18


def test_b32_and_l14_totals():
    b32 = {"image_size": 224, "patch_size": 32, "vision_width": 768, "vision_layers": 12,
           "vision_mlp_dim": 3072, "projection_dim": 512}
    l14 = {"image_size": 336, "patch_size": 14, "vision_width": 1024, "vision_layers": 24,
           "vision_mlp_dim": 4096, "projection_dim": 768}
    # L/14-336: 577 tokens; 24 * (8*577*1024^2 + 4*577*1024*4096 + 16*577*1024*8 + 4*577^2*1024)
    # + 2*576*588*1024 + 2*1024*768
    per_layer = 8 * 577 * 1024 ** 2 + 4 * 577 * 1024 * 4096 + 16 * 577 * 1024 * 8 + 4 * 577 ** 2 * 1024
    assert clip_flops.image_tower(l14, r=8) == 24 * per_layer + 2 * 576 * 588 * 1024 + 2 * 1024 * 768
    assert 380e9 < clip_flops.image_tower(l14, r=8) < 390e9
    assert 8.8e9 < clip_flops.image_tower(b32, r=8) < 9.0e9  # 4.4 G multiply-adds


def test_tilemax_sup_bytes():
    # 32 rows of 4 fp32, tile 16 -> 2 tiles, group 16 -> 1 group
    nbytes, ops = kernels.tilemax_sup(1, 32, 4, elem=4, tile=16, group=16)
    assert nbytes == 32 * 4 * 4 + 4 * 4 + 4 * (2 + 1)
    assert ops == 2 * 32 * 4
    # 4,194,304 x 512 fp32 is bound by its bytes: 8.59 GB at 3.35 TB/s
    t = kernels.tilemax_sup_bound_s(1, 4_194_304, 512)
    assert abs(t - (4_194_304 * 512 * 4) / 3.35e12) / t < 1e-3


def test_lora_linear_bytes_and_ops():
    nbytes, ops = kernels.lora_linear(2, 3, 4, 1)
    assert nbytes == (2 * 3 + 3 * 4 + 3 * 1 + 1 * 4 + 2 * 4) * 2
    assert ops == 2 * 2 * 3 * 4 + 2 * 2 * 3 * 1 + 2 * 2 * 1 * 4
    g_bytes, g_ops = kernels.lora_linear(2, 3, 4, 1, groups=3)
    assert g_bytes == (2 * 3 + 3 * (3 * 4 + 3 + 4 + 8)) * 2 and g_ops == 3 * ops
    qkv = bound_s(*kernels.lora_linear(10, 3, 3, 1, groups=3), "bf16")[0]
    out = bound_s(*kernels.lora_linear(10, 3, 3, 1), "bf16")[0]
    assert kernels.lora_tower_bound_s(M=10, width=3, layers=2, r=1) == 2 * (qkv + out)
