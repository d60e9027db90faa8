"""The device crop stage of the port against the JAX package on the CPU:
``crop_resize_batch`` / ``crop_resize_normalize`` against
``jax.image.scale_and_translate`` (boxes that up- and downsample, fractional
edges, a box on the border), the fused search's letterbox against
``jax.image.resize``, ``crop_embed_pipeline`` and ``make_fused_search`` on a
tiny CLIP with the committed detector, the seeker with ``use_yolo_crop`` on
disk and on the device against the JAX seeker (ids tie-aware), and the
finder's ``crop_used``.

Resampling tolerance: a sample position is a difference of fp32 products,
which XLA fuses differently from PyTorch's one-op-at-a-time evaluation; the
two weight matrices lie within ~1e-5 of each other and each within 8e-6 of a
float64 evaluation, so pixels in [0, 1] are held to 5e-5 and normalized
pixels (divided by std ~0.27) to 2e-4."""

import os
import random
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from clip_lora_match_tpu.core.config import ClipConfig as JConfig
from clip_lora_match_tpu.core.config import LoraConfig as JLoraConfig
from clip_lora_match_tpu.core.config import YoloConfig as JYoloConfig
from clip_lora_match_tpu.index.store import EmbeddingIndex as JIndex
from clip_lora_match_tpu.lora.adapter import init_lora as j_init_lora
from clip_lora_match_tpu.models import clip as jclip
from clip_lora_match_tpu.models.encoder import ClipEncoder as JEncoder
from clip_lora_match_tpu.models.io import flatten_params as j_flatten
from clip_lora_match_tpu.models.yolo import cropper as jcrop
from clip_lora_match_tpu.models.yolo import device_crop as JD
from clip_lora_match_tpu.models.yolo import yolov8 as JY
from clip_lora_match_tpu.nn import layers as jlayers
from clip_lora_match_tpu.services.finder import FinderConfig as JFinderConfig
from clip_lora_match_tpu.services.finder import FinderService as JFinder
from clip_lora_match_tpu.services.seeker import SeekerConfig as JSeekerConfig
from clip_lora_match_tpu.services.seeker import SeekerService as JSeeker
from clip_lora_match_tpu_torch.core.config import ClipConfig as TConfig
from clip_lora_match_tpu_torch.core.config import YoloConfig
from clip_lora_match_tpu_torch.index.store import EmbeddingIndex as TIndex
from clip_lora_match_tpu_torch.models.encoder import ClipEncoder as TEncoder
from clip_lora_match_tpu_torch.models.io import params_from_numpy
from clip_lora_match_tpu_torch.models.yolo import cropper as tcrop
from clip_lora_match_tpu_torch.models.yolo import device_crop as TD
from clip_lora_match_tpu_torch.models.yolo import yolov8 as TY
from clip_lora_match_tpu_torch.services.finder import FinderConfig, FinderService
from clip_lora_match_tpu_torch.services.seeker import SeekerConfig, SeekerService
from tests._torch_helpers import J_SMALL, T_SMALL, random_like_tree, to_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = os.path.join(REPO, "models", "yolo_synth", "yolov8n_synth.npz")
DIM = J_SMALL.projection_dim

_IMAGES = np.random.default_rng(0).random((5, 97, 131, 3)).astype(np.float32)
_BOXES = {
    "upsample": [50.5, 40.25, 60.75, 47.5],       # 10x7 px → out
    "downsample": [3.0, 2.0, 128.0, 95.0],        # most of the image
    "fractional": [10.3, 5.7, 120.9, 90.2],
    "border": [100.0, 80.0, 131.0, 97.0],         # touches the right and bottom edges
    "full": [0.0, 0.0, 131.0, 97.0],
}


@pytest.mark.parametrize("out_size", [224, 32])
@pytest.mark.parametrize("case", sorted(_BOXES))
def test_crop_resize_matches_jax(case, out_size):
    boxes = np.asarray([_BOXES[case], _BOXES["fractional"]], np.float32)
    imgs = _IMAGES[:2]
    want = np.asarray(JD.crop_resize_batch(jnp.asarray(imgs), jnp.asarray(boxes), out_size=out_size))
    got = TD.crop_resize_batch(torch.from_numpy(imgs), torch.from_numpy(boxes), out_size=out_size)
    assert got.shape == (2, out_size, out_size, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)
    want_n = np.asarray(JD.crop_resize_normalize(jnp.asarray(imgs), jnp.asarray(boxes), out_size=out_size))
    got_n = TD.crop_resize_normalize(torch.from_numpy(imgs), torch.from_numpy(boxes), out_size=out_size)
    np.testing.assert_allclose(got_n.numpy(), want_n, atol=2e-4)


def test_crop_resize_without_antialias_matches_jax():
    boxes = np.asarray([_BOXES["downsample"]], np.float32)
    want = np.asarray(JD.crop_resize_batch(jnp.asarray(_IMAGES[:1]), jnp.asarray(boxes), 24, antialias=False))
    got = TD.crop_resize_batch(torch.from_numpy(_IMAGES[:1]), torch.from_numpy(boxes), 24, antialias=False)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)


@pytest.mark.parametrize("shape", [(73, 99), (97, 60), (200, 131), (320, 241), (97, 131)])
def test_letterbox_resize_matches_jax_image_resize(shape):
    img = _IMAGES[2]
    want = np.asarray(jax.image.resize(jnp.asarray(img), shape + (3,), "bilinear"))
    got = TD.resize_bilinear(torch.from_numpy(img), *shape)
    assert got.shape == shape + (3,)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.fixture(scope="module")
def encoders():
    """(JAX encoder, port encoder): the tiny architecture, the same weights
    and LoRA."""
    params = jclip.init_params(jax.random.PRNGKey(0), J_SMALL)
    lora = to_jax(random_like_tree(j_init_lora(jax.random.PRNGKey(1), J_SMALL, JLoraConfig())))
    jflags = dict(jlayers._KERNEL_FLAGS)  # the JAX encoder sets them process-wide
    jenc = JEncoder(params, arch=J_SMALL, config=JConfig(arch=J_SMALL), lora=lora, lora_scaling=2.0)
    jlayers._KERNEL_FLAGS.update(jflags)
    tenc = TEncoder(params_from_numpy(j_flatten(params), device="cpu"), arch=T_SMALL,
                    config=TConfig(arch=T_SMALL), device="cpu")
    tenc.attach_lora(params_from_numpy(j_flatten(lora), device="cpu"), 2.0)
    return jenc, tenc


@pytest.fixture(scope="module")
def detectors():
    return JY.load_detector(SYNTH, JYoloConfig()), TY.load_detector(SYNTH, device="cpu")


@pytest.fixture(scope="module")
def renders():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import generate_fashion_corpus as gen

    rng = random.Random(999)
    return [gen.render_detect_image(rng, 320, max_objects=1) for _ in range(2)]


class _TwoBoxes:
    def __init__(self, module):
        self.dets = [module.Detection((5.5, 3.0, 70.2, 60.7), 0.9, 1),
                     module.Detection((40.0, 20.0, 119.0, 79.0), 0.8, 2)]

    def detect(self, image, conf, iou, max_det, classes=None, agnostic=False):
        return self.dets[:max_det]


def test_crop_embed_pipeline_matches_jax(encoders):
    jenc, tenc = encoders
    image = Image.fromarray(np.random.default_rng(2).integers(0, 255, (80, 120, 3), dtype=np.uint8), "RGB")
    jemb, jdets = JD.crop_embed_pipeline(_TwoBoxes(jcrop), jenc, image, k_best=2)
    temb, tdets = TD.crop_embed_pipeline(_TwoBoxes(tcrop), tenc, image, k_best=2)
    assert temb.shape == (2, DIM) and [d.box for d in tdets] == [d.box for d in jdets]
    np.testing.assert_allclose(temb, np.asarray(jemb), atol=1e-4)
    jemb, jdets = JD.crop_embed_pipeline(jcrop.NullDetector(), jenc, image)
    temb, tdets = TD.crop_embed_pipeline(tcrop.NullDetector(), tenc, image)  # full-image fallback
    assert tdets == jdets == [] and temb.shape == (1, DIM)
    np.testing.assert_allclose(temb, np.asarray(jemb), atol=1e-4)


def _index_rows(seed: int, n: int) -> np.ndarray:
    rows = np.random.default_rng(seed).normal(size=(n, DIM)).astype(np.float32)
    return rows / np.linalg.norm(rows, axis=1, keepdims=True)


def test_fused_search_matches_jax_and_the_staged_path(encoders, detectors, renders):
    jenc, tenc = encoders
    jdet, tdet = detectors
    index = _index_rows(3, 200)
    jsearch = JD.make_fused_search(jdet, jenc, jnp.asarray(index), k=5)
    tsearch = TD.make_fused_search(tdet, tenc, torch.from_numpy(index), k=5)
    blank = np.full((320, 320, 3), 210, np.uint8)  # nothing to detect
    for img in [np.asarray(r[0], np.uint8) for r in renders] + [blank]:
        js, ji, jb, jdet_ = jsearch(img)
        ts, ti, tb, tdet_ = tsearch(img)
        assert tdet_ == jdet_ and ts.shape == ti.shape == (5,)
        np.testing.assert_allclose(tb, jb, atol=0.5)
        np.testing.assert_allclose(ts, js, atol=1e-4)
        assert list(ti) == list(np.asarray(ji))
    assert not tdet_
    np.testing.assert_array_equal(tb, [0.0, 0.0, 320.0, 320.0])
    # the staged path (host detect → device crop → embed → search) agrees
    img = renders[0][0]
    emb, dets = TD.crop_embed_pipeline(tdet, tenc, img)
    ts, ti, tb, detected = tsearch(np.asarray(img, np.uint8))
    assert detected and len(dets) == 1
    staged = index @ emb[0]
    assert int(ti[0]) == int(np.argmax(staged))


def _services(tmp_path, encoders, detectors, use_device_crop, jdetector=None, tdetector=None):
    jenc, tenc = encoders
    rows = _index_rows(4, 300)
    paths, texts = [f"p{i}.jpg" for i in range(300)], [f"t{i}" for i in range(300)]
    jcropper = jcrop.YoloCropper(jdetector or detectors[0], JYoloConfig(crop_save_dir=str(tmp_path / "jc")))
    tcropper = tcrop.YoloCropper(tdetector or detectors[1], YoloConfig(crop_save_dir=str(tmp_path / "tc")))
    jcfg = JSeekerConfig(index_path=str(tmp_path / "none.npz"), use_yolo_crop=True,
                         use_device_crop=use_device_crop)
    tcfg = SeekerConfig(index_path=str(tmp_path / "none.npz"), use_yolo_crop=True,
                        use_device_crop=use_device_crop)
    jseek = JSeeker(jenc, jcfg, cropper=jcropper, index=JIndex(rows, paths, texts))
    tseek = SeekerService(tenc, tcfg, cropper=tcropper, index=TIndex(rows, paths, texts, device="cpu"))
    return jseek, tseek


def _assert_same_results(tres, jres):
    assert len(tres) == len(jres) == 5
    js = [r.score for r in jres]
    np.testing.assert_allclose([r.score for r in tres], js, atol=1e-4)
    start = 0  # ids tie-aware: equal as sets within runs of near-equal scores
    for p in range(1, 6):
        if p == 5 or js[p - 1] - js[p] > 1e-3:
            assert {r.index for r in tres[start:p]} == {r.index for r in jres[start:p]}
            start = p


@pytest.mark.parametrize("mode", ["disk", "device"])
def test_seeker_crop_matches_jax(tmp_path, encoders, detectors, renders, mode):
    jseek, tseek = _services(tmp_path, encoders, detectors, use_device_crop=mode == "device")
    for i, (img, _) in enumerate(renders):
        src = str(tmp_path / f"query_{i}.jpg")
        img.save(src)
        _assert_same_results(tseek.search_items(image_path=src), jseek.search_items(image_path=src))
        _assert_same_results(tseek.search_items(description="tas pink", image_path=src),
                             jseek.search_items(description="tas pink", image_path=src))
    if mode == "disk":  # crop 0 of each query written beside the JAX seeker's
        assert sorted(os.listdir(tmp_path / "tc")) == sorted(os.listdir(tmp_path / "jc")) == [
            "query_0_crop_0.jpg", "query_1_crop_0.jpg"]
    assert tseek.device_crops == (4 if mode == "device" else 0)
    # the device path embeds the crop, not the whole image
    whole = tseek.encoder.encode_image(src)
    assert not np.allclose(tseek._build_query_embedding(None, src), whole, atol=1e-3)


def test_seeker_device_crop_falls_back_as_jax(tmp_path, encoders, detectors, renders):
    """No live detector: the device path gives way to the disk path (a
    full-image crop file); a failing detector: the device path gives way, the
    disk crop fails too, and the original image is embedded."""
    img = renders[0][0]
    src = str(tmp_path / "q.jpg")
    img.save(src)
    jseek, tseek = _services(tmp_path, encoders, detectors, True, jcrop.NullDetector(), tcrop.NullDetector())
    _assert_same_results(tseek.search_items(image_path=src), jseek.search_items(image_path=src))
    assert tseek.device_crops == 0 and os.listdir(tmp_path / "tc") == ["q_crop_0.jpg"]

    class Broken:
        def detect(self, *a, **k):
            raise RuntimeError("detector down")

    jseek, tseek = _services(tmp_path, encoders, detectors, True, Broken(), Broken())
    _assert_same_results(tseek.search_items(image_path=src), jseek.search_items(image_path=src))
    assert tseek.device_crops == 0
    np.testing.assert_allclose(tseek._build_query_embedding(None, src), tseek.encoder.encode_image(src),
                               atol=1e-6)
    # without use_yolo_crop the cropper is ignored, as in the JAX seeker
    plain = SeekerService(encoders[1], SeekerConfig(index_path=str(tmp_path / "none.npz")),
                          cropper=tcrop.YoloCropper(detectors[1]), index=TIndex(_index_rows(4, 300), device="cpu"))
    assert plain.cropper is None


def test_finder_crop_used_matches_jax(tmp_path, encoders, detectors, renders):
    jenc, tenc = encoders
    src = str(tmp_path / "found.jpg")
    renders[1][0].save(src)
    results = []
    for name, cfg_cls, finder_cls, cropper, index in (
        ("jax", JFinderConfig, JFinder, jcrop.YoloCropper(detectors[0], JYoloConfig(crop_save_dir=str(tmp_path / "jc"))),
         JIndex(dim=DIM)),
        ("port", FinderConfig, FinderService,
         tcrop.YoloCropper(detectors[1], YoloConfig(crop_save_dir=str(tmp_path / "tc"))), TIndex(dim=DIM, device="cpu")),
    ):
        cfg = cfg_cls(index_path=str(tmp_path / name / "index.npz"),
                      reported_images_dir=str(tmp_path / name / "reported"), k_dim=DIM, use_yolo_crop=True)
        results.append(finder_cls(jenc if name == "jax" else tenc, cfg, cropper=cropper, index=index)
                       .report_item(src, "tas pink", location="kantin"))
    j, t = results
    assert t.crop_used is True and j.crop_used is True
    assert (t.index_row, t.indexed_text) == (j.index_row, j.indexed_text)
    assert os.listdir(tmp_path / "tc") == os.listdir(tmp_path / "jc") == ["found_crop_0.jpg"]

    class Broken:
        cfg = YoloConfig()

        def crop_image(self, path):
            raise OSError("disk full")

    cfg = FinderConfig(index_path=str(tmp_path / "b" / "index.npz"),
                       reported_images_dir=str(tmp_path / "b" / "reported"), k_dim=DIM, use_yolo_crop=True)
    res = FinderService(tenc, cfg, cropper=Broken(), index=TIndex(dim=DIM, device="cpu")).report_item(src, "x")
    assert res.crop_used is False and res.index_row == 0
