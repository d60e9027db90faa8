"""The port's two host libraries against the JAX package's, on the CPU.

- The JPEG loader (``data/native_loader.py``): its uint8 and fp32 outputs
  equal the JAX loader's bit for bit with the DCT-scaled decode on and off
  (both compile ``native/clm_native.cpp``); a PNG and a file no decoder takes
  go the JAX package's way (the PIL row, PIL's error); without the library
  every row is a PIL row, on a thread pool, equal to one at a time; the uint8 feed
  normalized as the device does it equals the float pipeline; an empty list
  gives an empty batch; the library builds into ``build/torch_native/``.
- The BPE merge core (``tokenizer/native_bpe.py``): with it, the port's ids
  equal the JAX package's Python merge loop on a seeded corpus with learned
  merges and on text that holds a literal special token.

Tests that need ``g++`` and libjpeg skip where the library cannot be built;
the PIL-row tests run either way.
"""

import os

import numpy as np
import pytest
from PIL import Image

from clip_lora_match_tpu.core.config import PreprocessConfig as JPre
from clip_lora_match_tpu.data import native_loader as JL
from clip_lora_match_tpu.tokenizer.bpe import ClipTokenizer as JTok
from clip_lora_match_tpu.tokenizer.learn import learn_bpe
from clip_lora_match_tpu_torch.core import native
from clip_lora_match_tpu_torch.core.config import PreprocessConfig
from clip_lora_match_tpu_torch.data import native_loader as TL
from clip_lora_match_tpu_torch.preprocess.image import (
    load_resized_cropped_u8,
    nchw_to_nhwc,
    nhwc_to_nchw,
    preprocess_image,
)
from clip_lora_match_tpu_torch.tokenizer import native_bpe
from clip_lora_match_tpu_torch.tokenizer.bpe import ClipTokenizer as TTok

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOADERS = {
    "u8": (TL.preprocess_image_batch_native_u8, JL.preprocess_image_batch_native_u8),
    "fp32": (TL.preprocess_image_batch_native, JL.preprocess_image_batch_native),
}


@pytest.fixture
def native_lib():
    if not TL.native_available():
        pytest.skip("native loader unavailable (no g++/libjpeg)")


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """Seeded JPEGs: landscape, portrait, exact, small, and a photo-size
    1200x1600 (the DCT-scaled decode's case)."""
    d = tmp_path_factory.mktemp("jpg")
    rng = np.random.default_rng(21)
    paths = []
    for i, (w, h) in enumerate([(640, 480), (300, 500), (224, 224), (100, 80), (1200, 1600)]):
        p = d / f"img{i}.jpg"
        # smooth content plus noise, so the DCT lowpass has something to keep
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([(xx * (i + 1)) % 256, (yy * 2) % 256, (xx + yy) % 256], -1)
        noise = rng.integers(0, 40, (h, w, 3))
        Image.fromarray(np.clip(base + noise, 0, 255).astype(np.uint8), "RGB").save(p, quality=92)
        paths.append(str(p))
    return paths


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    """A PNG, and a PNG saved under a .jpg name: neither is a JPEG."""
    d = tmp_path_factory.mktemp("png")
    rng = np.random.default_rng(22)
    paths = []
    for name, fmt in (("real.png", "PNG"), ("renamed.jpg", "PNG")):
        p = d / name
        Image.fromarray(rng.integers(0, 255, (90, 130, 3), dtype=np.uint8), "RGB").save(p, format=fmt)
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("dct_scale", [False, True])
@pytest.mark.parametrize("kind", ["u8", "fp32"])
def test_loader_equals_the_jax_loader_bit_for_bit(native_lib, jpegs, kind, dct_scale):
    port, jax_ = LOADERS[kind]
    got = port(jpegs, PreprocessConfig(), dct_scale=dct_scale)
    ref = jax_(jpegs, JPre(), dct_scale=dct_scale)
    assert got.dtype == ref.dtype == (np.uint8 if kind == "u8" else np.float32)
    assert got.shape == ref.shape == (5, 224, 224, 3)
    np.testing.assert_array_equal(got, ref)


def test_a_truncated_jpeg_decodes_as_jax(native_lib, tmp_path, jpegs):
    """libjpeg reads half a JPEG (the missing rows grey) in both packages."""
    data = open(jpegs[0], "rb").read()
    cut = tmp_path / "half.jpg"
    cut.write_bytes(data[: len(data) // 2])
    got = TL.preprocess_image_batch_native_u8([str(cut), jpegs[1]])
    np.testing.assert_array_equal(got, JL.preprocess_image_batch_native_u8([str(cut), jpegs[1]]))


def test_dct_scale_changes_only_the_photo(native_lib, jpegs):
    full = TL.preprocess_image_batch_native_u8(jpegs, dct_scale=False)
    fast = TL.preprocess_image_batch_native_u8(jpegs, dct_scale=True)
    np.testing.assert_array_equal(full[2:4], fast[2:4])  # at or below 224: decoded at 8/8
    assert (full[4] != fast[4]).any()
    assert np.abs(full.astype(np.float32) - fast).mean() < 8


@pytest.mark.parametrize("env,want", [(None, False), ("0", False), ("false", False), ("1", True)])
def test_dct_scale_default_follows_the_environment_as_jax(monkeypatch, env, want):
    if env is None:
        monkeypatch.delenv("CLM_NATIVE_DCT_SCALE", raising=False)
    else:
        monkeypatch.setenv("CLM_NATIVE_DCT_SCALE", env)
    assert TL._dct_scale_default() == JL._dct_scale_default() == want


@pytest.mark.parametrize("kind", ["u8", "fp32"])
def test_non_jpeg_rows_take_the_pil_path_as_jax(jpegs, pngs, kind):
    port, jax_ = LOADERS[kind]
    paths = [jpegs[1], pngs[0], jpegs[3], pngs[1]]
    got = port(paths, PreprocessConfig())
    np.testing.assert_array_equal(got, jax_(paths, JPre()))
    pil = load_resized_cropped_u8 if kind == "u8" else preprocess_image
    for row in (1, 3):
        np.testing.assert_array_equal(got[row], pil(paths[row], PreprocessConfig()))


@pytest.mark.parametrize("kind", ["u8", "fp32"])
def test_without_the_library_every_row_is_a_pil_row_on_threads(monkeypatch, jpegs, pngs, kind):
    """A host without libjpeg's headers: every row through PIL, on a thread
    pool, the same rows as one at a time and as the PIL pipeline."""
    monkeypatch.setattr(TL, "get_lib", lambda: None)
    port, _ = LOADERS[kind]
    paths = jpegs + pngs + jpegs[:2]
    pooled = port(paths, PreprocessConfig(), num_threads=4)
    np.testing.assert_array_equal(pooled, port(paths, PreprocessConfig(), num_threads=1))
    pil = load_resized_cropped_u8 if kind == "u8" else preprocess_image
    for row, path in enumerate(paths):
        np.testing.assert_array_equal(pooled[row], pil(path, PreprocessConfig()))


def test_the_first_failing_pil_row_raises_from_the_pool(monkeypatch, tmp_path, jpegs):
    monkeypatch.setattr(TL, "get_lib", lambda: None)
    bad = tmp_path / "corrupt.jpg"
    bad.write_bytes(b"not a jpeg at all")
    with pytest.raises(Exception) as pooled:
        TL.preprocess_image_batch_native_u8([jpegs[0], str(bad), jpegs[1]], num_threads=3)
    with pytest.raises(Exception) as serial:
        TL.preprocess_image_batch_native_u8([jpegs[0], str(bad), jpegs[1]], num_threads=1)
    assert type(pooled.value) is type(serial.value)


@pytest.mark.parametrize("kind", ["u8", "fp32"])
def test_a_file_no_decoder_takes_raises_as_jax(tmp_path, kind):
    bad = tmp_path / "corrupt.jpg"
    bad.write_bytes(b"not a jpeg at all")
    port, jax_ = LOADERS[kind]
    with pytest.raises(Exception) as jerr:
        jax_([str(bad)], JPre())
    with pytest.raises(Exception) as terr:
        port([str(bad)], PreprocessConfig())
    assert type(terr.value) is type(jerr.value)


def test_u8_feed_normalized_equals_the_float_pipeline(jpegs, pngs):
    cfg = PreprocessConfig()
    paths = jpegs + pngs
    u8 = TL.preprocess_image_batch_native_u8(paths, cfg, dct_scale=False)
    f32 = TL.preprocess_image_batch_native(paths, cfg, dct_scale=False)
    mean, std = np.asarray(cfg.mean, np.float32), np.asarray(cfg.std, np.float32)
    np.testing.assert_allclose((u8.astype(np.float32) / 255.0 - mean) / std, f32, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", ["u8", "fp32"])
def test_an_empty_list_gives_an_empty_batch(kind):
    port, jax_ = LOADERS[kind]
    got = port([], PreprocessConfig(image_size=32))
    assert got.shape == jax_([], JPre(image_size=32)).shape == (0, 32, 32, 3)
    assert got.dtype == (np.uint8 if kind == "u8" else np.float32)


def test_layout_helpers_as_jax():
    from clip_lora_match_tpu.preprocess.image import nchw_to_nhwc as j_to_nhwc
    from clip_lora_match_tpu.preprocess.image import nhwc_to_nchw as j_to_nchw

    x = np.random.default_rng(23).normal(size=(2, 5, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(nhwc_to_nchw(x), j_to_nchw(x))
    assert nhwc_to_nchw(x).shape == (2, 3, 5, 7)
    np.testing.assert_array_equal(nchw_to_nhwc(nhwc_to_nchw(x)), x)
    np.testing.assert_array_equal(nchw_to_nhwc(nhwc_to_nchw(x)), j_to_nhwc(j_to_nchw(x)))


@pytest.mark.parametrize("name", ["clm_native", "clm_bpe"])
def test_libraries_build_under_build_and_not_into_native(native_lib, name):
    before = sorted(os.listdir(os.path.join(REPO, "native")))
    path = native.build(name)
    assert path.parent == native.BUILD_DIR and path.parent.parts[-2:] == ("build", "torch_native")
    assert path.name.startswith(f"{name}-") and path.suffix == ".so" and path.exists()
    assert native.build(name) == path == native.target(name)  # cached: no rebuild
    assert sorted(os.listdir(os.path.join(REPO, "native"))) == before
    assert not list(native.BUILD_DIR.glob(f"{name}-*.tmp"))


# -- the BPE merge core ----------------------------------------------------------


CORPUS_WORDS = ["tas", "pink", "hitam", "kacamata", "dompet", "kunci", "sepatu", "biru", "merah",
                "jam", "tangan", "botol", "minum", "payung", "earphone", "laptop", "charger"]


def _corpus(seed: int, n: int) -> list[str]:
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(CORPUS_WORDS, size=rng.integers(2, 7)))
            + (f" no.{rng.integers(0, 99)}" if rng.random() < 0.3 else "") for _ in range(n)]


@pytest.fixture(scope="module")
def learned():
    """A merge table learned from a seeded corpus (the JAX package's learner)."""
    return learn_bpe(_corpus(31, 400), num_merges=300)


@pytest.fixture
def native_bpe_lib():
    if not native_bpe.native_bpe_available():
        pytest.skip("native BPE unavailable (no g++)")


def _jax_python_path(vocab, merges):
    tok = JTok(vocab, merges) if vocab is not None else JTok.from_dir(None)
    tok._native_tried, tok._native = True, None  # pin the JAX side to its Python loop
    return tok


@pytest.mark.parametrize("table", ["learned", "fallback"])
def test_native_bpe_ids_equal_the_jax_python_path(native_bpe_lib, learned, table):
    vocab, merges = learned if table == "learned" else (None, None)
    ours = TTok(vocab, merges) if vocab is not None else TTok.from_dir(None)
    ref = _jax_python_path(vocab, merges)
    texts = _corpus(32, 200) + ["<|startoftext|> hi", "tas <|endoftext|> pink", "Kacamata’s café 2x!"]
    for t in texts:
        assert ours.encode(t) == ref.encode(t), t
    assert ours._native is not None  # the C++ core took the words
    np.testing.assert_array_equal(ours(texts)["input_ids"], ref(texts)["input_ids"])


def test_a_literal_special_token_keeps_the_python_ids(native_bpe_lib):
    ours = TTok.from_dir(None)
    assert ours.encode("<|startoftext|> hi") == [512, 512, 104, 361, 513]
    assert ours._native is not None
    assert ours._native.encode_word("<|startoftext|>") != [512]  # the C++ core alone would split it


def test_the_python_merge_loop_alone_equals_jax(learned):
    vocab, merges = learned
    ours = TTok(vocab, merges)
    ours._native_tried, ours._native = True, None
    ref = _jax_python_path(vocab, merges)
    for t in _corpus(33, 100) + ["<|startoftext|> hi"]:
        assert ours.encode(t) == ref.encode(t), t
