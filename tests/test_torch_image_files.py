"""The image-file encode path of the port against the JAX package, on the CPU:
``prefetch``, ``ClipPreprocessor``'s native routing and its single-image and
pair methods, and ``ClipEncoder.encode_image_files`` (the uint8 feed,
normalized where the tower runs) over five JPEGs in batches of two (a ragged
last batch and bucket padding), with and without LoRA, in fp32 and bf16."""

import os
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from clip_lora_match_tpu.core.config import ClipArchConfig as JArch
from clip_lora_match_tpu.core.config import ClipConfig as JConfig
from clip_lora_match_tpu.core.config import LoraConfig as JLoraConfig
from clip_lora_match_tpu.core.config import PreprocessConfig as JPre
from clip_lora_match_tpu.data.dataset import prefetch as j_prefetch
from clip_lora_match_tpu.lora.adapter import init_lora as j_init_lora
from clip_lora_match_tpu.models import clip as jclip
from clip_lora_match_tpu.models.encoder import ClipEncoder as JEncoder
from clip_lora_match_tpu.models.io import flatten_params as j_flatten
from clip_lora_match_tpu.nn import layers as jlayers
from clip_lora_match_tpu.preprocess.pipeline import ClipPreprocessor as JPreprocessor
from clip_lora_match_tpu_torch.core.config import ClipArchConfig as TArch
from clip_lora_match_tpu_torch.core.config import ClipConfig as TConfig
from clip_lora_match_tpu_torch.core.config import PreprocessConfig as TPre
from clip_lora_match_tpu_torch.data import prefetch
from clip_lora_match_tpu_torch.data import native_loader as TL
from clip_lora_match_tpu_torch.models.encoder import ClipEncoder as TEncoder
from clip_lora_match_tpu_torch.models.io import params_from_numpy
from clip_lora_match_tpu_torch.preprocess.pipeline import ClipPreprocessor as TPreprocessor
from tests._torch_helpers import cosine_rows, random_like_tree, to_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGES = os.path.join(REPO, "data", "custom", "images")
TINY_KW = dict(
    image_size=32, patch_size=16, vision_width=64, vision_layers=2, vision_heads=4,
    vision_mlp_dim=128, vocab_size=600, max_text_length=77, text_width=32, text_layers=2,
    text_heads=4, text_mlp_dim=64, projection_dim=16,
)


# -- prefetch ---------------------------------------------------------------------


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "prefetch"]


def test_prefetch_keeps_the_order():
    items = [{"i": np.full(3, i)} for i in range(25)]
    got = list(prefetch(iter(items), depth=2))
    assert [int(x["i"][0]) for x in got] == list(range(25))
    assert [int(x["i"][0]) for x in j_prefetch(iter(items), depth=2)] == list(range(25))


def test_prefetch_reraises_a_worker_exception_after_the_items_before_it():
    def items():
        yield 1
        yield 2
        raise KeyError("boom")

    seen = []
    with pytest.raises(KeyError, match="boom"):
        for x in prefetch(items()):
            seen.append(x)
    assert seen == [1, 2]


@pytest.mark.parametrize("source", ["endless", "paced"])
def test_prefetch_frees_its_worker_when_the_consumer_breaks(source):
    """An abandoned generator stops its worker within 1 s, whether the worker
    waits on a full queue (endless) or is between items (paced)."""
    def endless():
        i = 0
        while True:
            yield i
            i += 1

    def paced():
        for i in range(1000):
            time.sleep(0.01)
            yield i

    before = set(_prefetch_threads())
    for x in prefetch(endless() if source == "endless" else paced(), depth=2):
        if x == 3:
            (worker,) = set(_prefetch_threads()) - before
            break
    worker.join(timeout=1.0)
    assert not worker.is_alive()


# -- ClipPreprocessor ------------------------------------------------------------


@pytest.fixture(scope="module")
def preprocessors():
    return JPreprocessor(config=JConfig()), TPreprocessor(config=TConfig())


def _custom_paths():
    return [os.path.join(IMAGES, n) for n in sorted(os.listdir(IMAGES))]


def test_preprocess_images_over_paths_equals_jax(preprocessors):
    jp, tp = preprocessors
    paths = _custom_paths()
    got = tp.preprocess_images(paths)
    assert got.shape == (len(paths), 224, 224, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jp.preprocess_images(paths))
    if TL.native_available():  # a batch of paths took the native loader
        np.testing.assert_array_equal(got, TL.preprocess_image_batch_native(paths, tp.pre))


def test_preprocess_images_mixed_batch_takes_pil_as_jax(preprocessors):
    jp, tp = preprocessors
    paths = _custom_paths()[:2]
    items = [paths[0], Image.open(paths[1]).convert("RGB")]
    np.testing.assert_array_equal(tp.preprocess_images(items), jp.preprocess_images(items))
    assert tp.preprocess_images([]).shape == jp.preprocess_images([]).shape == (0, 224, 224, 3)


def test_preprocess_image_and_pair_equal_jax(preprocessors):
    jp, tp = preprocessors
    path = _custom_paths()[0]
    img = tp.preprocess_image(path)
    assert img.shape == (1, 224, 224, 3)
    np.testing.assert_array_equal(img, jp.preprocess_image(path))
    got, ref = tp.preprocess_pair(path, "kacamata pink"), jp.preprocess_pair(path, "kacamata pink")
    assert sorted(got) == sorted(ref) == ["attention_mask", "input_ids", "pixel_values"]
    for key in ref:
        assert got[key].shape == ref[key].shape
        np.testing.assert_array_equal(got[key], ref[key])


# -- encode_image_files ----------------------------------------------------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("files")
    rng = np.random.default_rng(41)
    paths = []
    for i in range(5):
        p = d / f"f{i}.jpg"
        Image.fromarray(rng.integers(0, 255, (60 + 3 * i, 50, 3), dtype=np.uint8), "RGB").save(p, quality=95)
        paths.append(str(p))
    return paths


@pytest.fixture(scope="module")
def encoders():
    """JAX and port encoders of one tiny arch with the same weights: a
    factory over (LoRA or not, compute dtype)."""
    jarch, tarch = JArch(**TINY_KW), TArch(**TINY_KW)
    jcfg = JConfig(arch=jarch, preprocess=JPre(image_size=32))
    tcfg = TConfig(arch=tarch, preprocess=TPre(image_size=32))
    params = jclip.init_params(jax.random.PRNGKey(0), jarch)
    lora = to_jax(random_like_tree(j_init_lora(jax.random.PRNGKey(1), jarch, JLoraConfig())))

    def make(with_lora: bool, dtype: str):
        jflags = dict(jlayers._KERNEL_FLAGS)  # the JAX encoder sets them process-wide
        jenc = JEncoder(params, arch=jarch, config=jcfg, compute_dtype=dtype)
        jlayers._KERNEL_FLAGS.update(jflags)
        tenc = TEncoder(params_from_numpy(j_flatten(params), device="cpu"), arch=tarch,
                        config=tcfg, compute_dtype=dtype, device="cpu")
        if with_lora:
            jenc.attach_lora(lora, 2.0)
            tenc.attach_lora(params_from_numpy(j_flatten(lora), device="cpu"), 2.0)
        return jenc, tenc

    return make


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_lora", [False, True])
def test_encode_image_files_matches_jax(encoders, files, with_lora, dtype):
    jenc, tenc = encoders(with_lora, dtype)
    ref = jenc.encode_image_files(files, batch_size=2, dct_scale=False)
    got = tenc.encode_image_files(files, batch_size=2, dct_scale=False)
    assert got.shape == ref.shape == (5, 16) and got.dtype == np.float32
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    else:
        assert cosine_rows(got, ref).min() >= 0.999
        assert tenc.compute_dtype == torch.bfloat16


@pytest.mark.parametrize("batch_size", [1, 2, 4, 96])
def test_encode_image_files_equals_encode_image_at_every_batch_size(encoders, files, batch_size):
    _, tenc = encoders(True, "float32")
    got = tenc.encode_image_files(files, batch_size=batch_size, dct_scale=False)
    ref = tenc.encode_image(files)
    assert cosine_rows(got, ref).min() > 0.9999
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_encode_image_files_unnormalized_and_dct_scaled(encoders, files):
    jenc, tenc = encoders(False, "float32")
    raw = tenc.encode_image_files(files, batch_size=2, normalize=False, dct_scale=False)
    np.testing.assert_allclose(raw, jenc.encode_image_files(files, batch_size=2, normalize=False,
                                                            dct_scale=False), atol=1e-5, rtol=0)
    assert not np.allclose(np.linalg.norm(raw, axis=1), 1.0)
    # the scaled decode is on by default in both packages, with the same pixels
    dct = tenc.encode_image_files(files, batch_size=2)
    np.testing.assert_array_equal(dct, tenc.encode_image_files(files, batch_size=2, dct_scale=True))
    np.testing.assert_allclose(dct, jenc.encode_image_files(files, batch_size=2), atol=1e-5, rtol=0)


def test_encode_image_files_of_no_paths(encoders):
    jenc, tenc = encoders(False, "float32")
    got = tenc.encode_image_files([])
    assert got.shape == jenc.encode_image_files([]).shape == (0, 16) and got.dtype == np.float32


def test_encode_image_files_refuses_an_unknown_staging(encoders, files):
    _, tenc = encoders(False, "float32")
    tenc.host_staging = "mapped"
    with pytest.raises(ValueError, match="host_staging"):
        tenc.encode_image_files(files)


def test_the_encoder_wants_cuda_unless_the_caller_asks_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    from clip_lora_match_tpu_torch.models.clip import init_params

    tarch = TArch(**TINY_KW)
    with pytest.raises(RuntimeError, match="CUDA"):
        TEncoder(init_params(0, tarch, device="cpu"), arch=tarch, config=TConfig(arch=tarch))
