"""The port's serving entry points against the JAX package on the CPU: the
config entry point (a YAML that names ViT-L/14-336, and one with a tiny
``model.arch:`` block and weights written by the JAX package), the HF weight
converter on a random tiny ``transformers.CLIPModel``, the batch queue and
the service graph. Embedding bar: atol 1e-4 (fp32, as the tower tests)."""

import dataclasses
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import jax

from clip_lora_match_tpu.core.config import VIT_L14_336 as J_L14_336
from clip_lora_match_tpu.core.config import LoraConfig as JLoraConfig
from clip_lora_match_tpu.core.config import load_clip_config as j_load_clip_config
from clip_lora_match_tpu.lora.adapter import init_lora as j_init_lora
from clip_lora_match_tpu.lora.adapter import save_lora as j_save_lora
from clip_lora_match_tpu.models import clip as jclip
from clip_lora_match_tpu.models.convert_hf import convert_hf_clip_model as j_convert_model
from clip_lora_match_tpu.models.convert_hf import convert_hf_clip_state_dict as j_convert_sd
from clip_lora_match_tpu.models.convert_hf import infer_arch_from_state_dict as j_infer_arch
from clip_lora_match_tpu.models.encoder import ClipEncoder as JEncoder
from clip_lora_match_tpu.models.io import flatten_params as j_flatten
from clip_lora_match_tpu.models.io import save_params as j_save_params
from clip_lora_match_tpu_torch.api import ServiceGraph, build_services
from clip_lora_match_tpu_torch.core.config import ClipConfig as TConfig
from clip_lora_match_tpu_torch.core.config import load_clip_config
from clip_lora_match_tpu_torch.db.store import SqliteStore
from clip_lora_match_tpu_torch.models import convert_hf as C
from clip_lora_match_tpu_torch.models.encoder import ClipEncoder as TEncoder
from clip_lora_match_tpu_torch.models.encoder import load_clip_model
from clip_lora_match_tpu_torch.models.io import params_from_numpy
from clip_lora_match_tpu_torch.nn import layers as tlayers
from clip_lora_match_tpu_torch.ops import flash_attention as F
from clip_lora_match_tpu_torch.ops import mlp_fused as MF
from clip_lora_match_tpu_torch.services import QueuedEncoder
from tests._torch_helpers import SMALL_KW, J_SMALL, T_SMALL, random_like_tree, restore_flags, to_jax  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGES = os.path.join(REPO, "data", "custom", "images")
TEXTS = ["tas pink di kantin", "payung hitam", "kunci motor honda", "botol minum biru"]


def _yaml(tmp_path, model: dict) -> str:
    path = str(tmp_path / "clip_config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({"model": model}, f)
    return path


def _images():
    return [Image.open(os.path.join(IMAGES, n)).convert("RGB") for n in sorted(os.listdir(IMAGES))[:2]]


@pytest.fixture(scope="module")
def tiny_encoder():
    params = jclip.init_params(jax.random.PRNGKey(0), J_SMALL)
    enc = TEncoder(params_from_numpy(j_flatten(params), device="cpu"), arch=T_SMALL,
                   config=TConfig(arch=T_SMALL), device="cpu")
    return enc


# ---------------------------------------------------------------------------
# the config entry point
# ---------------------------------------------------------------------------


def test_yaml_naming_l14_336_gives_the_jax_arch(tmp_path):
    path = _yaml(tmp_path, {"name": "openai/clip-vit-large-patch14-336"})
    cfg, jcfg = load_clip_config(path), j_load_clip_config(path)
    assert dataclasses.asdict(cfg.arch) == dataclasses.asdict(J_L14_336) == dataclasses.asdict(jcfg.arch)
    assert cfg.arch.image_size == cfg.preprocess.image_size == jcfg.preprocess.image_size == 336
    assert cfg.arch.vision_seq_len == 577 and cfg.arch.vision_width // cfg.arch.vision_heads == 64


@pytest.mark.parametrize("entry", ["from_config", "load_clip_model"])
def test_config_entry_point_matches_jax(entry, tmp_path, restore_flags):  # noqa: F811
    params = jclip.init_params(jax.random.PRNGKey(0), J_SMALL)
    lora = to_jax(random_like_tree(j_init_lora(jax.random.PRNGKey(1), J_SMALL, JLoraConfig())))
    weights, lora_dir = str(tmp_path / "clip.npz"), str(tmp_path / "lora")
    j_save_params(weights, params)
    j_save_lora(lora_dir, lora, JLoraConfig())
    arch_block = {k: v for k, v in SMALL_KW.items()}
    path = _yaml(tmp_path, {"name": "openai/clip-vit-base-patch32", "arch": arch_block})
    jenc = JEncoder.from_config(path, weights_path=weights, lora_path=lora_dir)
    if entry == "from_config":
        tenc = TEncoder.from_config(path, weights_path=weights, lora_path=lora_dir, device="cpu")
    else:
        tenc = load_clip_model(path, lora_path=lora_dir, weights_path=weights, device="cpu")
    assert dataclasses.asdict(tenc.arch) == dataclasses.asdict(jenc.arch)
    assert tenc.lora_scaling == jenc.lora_scaling == 2.0 and tenc.device.type == "cpu"
    np.testing.assert_allclose(tenc.encode_text(TEXTS), jenc.encode_text(TEXTS), atol=1e-4)
    np.testing.assert_allclose(tenc.encode_image(_images()), jenc.encode_image(_images()), atol=1e-4)


def test_config_entry_point_warns_on_missing_files(tmp_path, restore_flags):  # noqa: F811
    path = _yaml(tmp_path, {"arch": dict(SMALL_KW)})
    with pytest.warns(UserWarning) as rec:
        enc = TEncoder.from_config(path, weights_path=str(tmp_path / "none.npz"),
                                   lora_path=str(tmp_path / "no_lora"), seed=3, device="cpu")
    messages = " ".join(str(w.message) for w in rec)
    assert "random init" in messages and "LoRA weights not found" in messages
    assert enc.lora is None and enc.arch == T_SMALL
    before = tlayers.get_kernel_flags()
    with pytest.warns(UserWarning, match="random initialization"):
        TEncoder.from_config(path, device="cpu")
    assert tlayers.get_kernel_flags() == before  # building an encoder sets no flag
    assert enc.encode_text("tas").shape == (T_SMALL.projection_dim,)


def test_plain_config_turns_every_kernel_off(tiny_encoder, monkeypatch, restore_flags):  # noqa: F811
    calls = []
    for mod, name in ((F, "flash_attention"), (MF, "mlp_fused")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k: calls.append(_n) or _r(*a, **k))
    tlayers.set_kernel_flags(flash_attention=True, fused_mlp=True)
    forced = tlayers.get_kernel_flags()
    tiny_encoder.encode_text("tas pink")
    # small attention is "auto" (off for CPU tensors), so the forced flash takes the text tower
    assert set(calls) == {"flash_attention", "mlp_fused"}
    calls.clear()
    plain = TEncoder(tiny_encoder.params, arch=T_SMALL,
                     config=TConfig(arch=T_SMALL, use_pallas_kernels=False), device="cpu")
    plain.encode_text("tas pink")
    plain.encode_image(_images()[:1])
    assert calls == [] and tlayers.get_kernel_flags() == forced


# ---------------------------------------------------------------------------
# the HF converter
# ---------------------------------------------------------------------------


def _hf_model():
    from transformers import CLIPConfig, CLIPModel, CLIPTextConfig, CLIPVisionConfig

    a = J_SMALL
    torch.manual_seed(0)
    cfg = CLIPConfig(
        vision_config=CLIPVisionConfig(
            image_size=a.image_size, patch_size=a.patch_size, hidden_size=a.vision_width,
            num_hidden_layers=a.vision_layers, num_attention_heads=a.vision_heads,
            intermediate_size=a.vision_mlp_dim, hidden_act="quick_gelu",
        ).to_dict(),
        text_config=CLIPTextConfig(
            vocab_size=a.vocab_size, max_position_embeddings=a.max_text_length,
            hidden_size=a.text_width, num_hidden_layers=a.text_layers,
            num_attention_heads=a.text_heads, intermediate_size=a.text_mlp_dim,
            hidden_act="quick_gelu", eos_token_id=a.vocab_size - 1,
        ).to_dict(),
        projection_dim=a.projection_dim,
    )
    return CLIPModel(cfg).eval()


def _assert_trees_equal(port, ref):
    flat_ref = j_flatten(ref)
    flat_port = {}

    def walk(node, prefix):
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, key)
            else:
                flat_port[key] = v
    walk(port, "")
    assert sorted(flat_port) == sorted(flat_ref)
    for key, value in flat_ref.items():
        assert flat_port[key].dtype == torch.float32
        np.testing.assert_array_equal(flat_port[key].numpy(), np.asarray(value), err_msg=key)


def test_convert_hf_matches_jax_converter():
    hf = _hf_model()
    _assert_trees_equal(C.convert_hf_clip_model(hf), j_convert_model(hf))
    # a state dict of numpy arrays, heads by the 64-dim convention
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    with pytest.warns(UserWarning, match="64-dim-per-head"):
        arch = C.infer_arch_from_state_dict(sd)
    with pytest.warns(UserWarning):
        assert dataclasses.asdict(arch) == dataclasses.asdict(j_infer_arch(sd))
    assert dataclasses.asdict(arch) == dataclasses.asdict(T_SMALL)
    _assert_trees_equal(C.convert_hf_clip_state_dict(hf.state_dict(), arch), j_convert_sd(sd, J_SMALL))


def test_converted_weights_serve(restore_flags):  # noqa: F811
    hf = _hf_model()
    params = C.convert_hf_clip_model(hf)
    enc = TEncoder(params, arch=T_SMALL, config=TConfig(arch=T_SMALL), device="cpu")
    with torch.no_grad():
        ref = hf.get_image_features(
            pixel_values=torch.from_numpy(enc.preprocessor.preprocess_images(_images())).permute(0, 3, 1, 2)
        )
    ref = torch.nn.functional.normalize(ref, dim=-1).numpy()
    np.testing.assert_allclose(enc.encode_image(_images()), ref, atol=1e-4)


# ---------------------------------------------------------------------------
# the batch queue and the service graph
# ---------------------------------------------------------------------------


def test_queued_encoder_matches_and_coalesces(tiny_encoder):
    sizes = []
    real_text, real_image = tiny_encoder.encode_text, tiny_encoder.encode_image

    class Counting:
        """The encoder, recording the size of every batch the queue sends."""

        def __getattr__(self, name):
            return getattr(tiny_encoder, name)

        def encode_text(self, texts, normalize=True):
            sizes.append(("text", len(texts)))
            return real_text(texts, normalize)

        def encode_image(self, images, normalize=True):
            sizes.append(("image", len(images)))
            return real_image(images, normalize)

    texts = [f"{TEXTS[i % 4]} nomor {i}" for i in range(8)]
    want = tiny_encoder.encode_text(texts)
    queued = QueuedEncoder(Counting(), linger_ms=500.0)
    start = threading.Barrier(8)
    try:
        def one(t):
            start.wait(timeout=30)
            return queued.encode_text(t)

        with ThreadPoolExecutor(8) as pool:
            futures = [pool.submit(one, t) for t in texts]
            got = np.stack([f.result(timeout=60) for f in futures])
        np.testing.assert_allclose(got, want, atol=1e-6)
        assert sum(n for _, n in sizes) == 8 and len(sizes) < 8  # fewer tower passes than requests
        image = _images()[0]
        np.testing.assert_allclose(queued.encode_image(image), tiny_encoder.encode_image(image), atol=1e-6)
        assert sizes[-1] == ("image", 1)
        # lists and unnormalized calls bypass the queue
        np.testing.assert_allclose(queued.encode_text(texts[:2]), want[:2], atol=1e-6)
        assert queued.arch == tiny_encoder.arch and queued.device == tiny_encoder.device
    finally:
        queued.close()
    assert not queued.queue._worker.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        queued.encode_text("tas")


def test_build_services_on_cpu(tiny_encoder, tmp_path):
    data_dir = str(tmp_path / "data")
    store = SqliteStore(str(tmp_path / "found_items.sqlite"))
    graph = build_services(tiny_encoder, store=store, data_dir=data_dir)
    try:
        assert isinstance(graph, ServiceGraph) and graph.store is store and graph.data_dir == data_dir
        assert isinstance(graph.seeker.encoder, QueuedEncoder) and graph.seeker.encoder is graph.finder.encoder
        assert graph.seeker.index is graph.finder.index and graph.finder.index.dim == T_SMALL.projection_dim
        assert graph.finder.cfg.index_path == os.path.join(data_dir, "index", "items_index.npz")
        image = os.path.join(IMAGES, sorted(os.listdir(IMAGES))[0])
        rep = graph.finder.report_item(image, "payung lipat hitam", location="halte")
        assert rep.index_row == 0 and os.path.exists(graph.finder.cfg.index_path)
        assert rep.stored_image_path.startswith(os.path.join(data_dir, "reported", "images"))
        top = graph.seeker.search_items(description=rep.indexed_text)[0]
        assert top.index == rep.index_row and top.score > 0.999 and top.text == rep.indexed_text
        assert [it.description for it in store.all_items()] == [rep.indexed_text]
    finally:
        graph.seeker.encoder.close()
    unqueued = build_services(tiny_encoder, store=store, data_dir=data_dir, use_batch_queue=False)
    assert unqueued.seeker.encoder is tiny_encoder and len(unqueued.seeker.index) == 1
