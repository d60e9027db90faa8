"""The YOLOv8 crop stage of the port against the JAX package on the CPU: the
blocks and the whole forward + decode at the -n widths (fp32, atol 1e-4),
the committed synthetic-corpus detector at 320² on held-out renders (boxes
within 0.5 px, the same classes and valid slots), ``nms_fixed`` bit for bit,
the letterbox, the ultralytics converter, ``load_detector`` with its
``meta.json``, and the cropper's file pattern, clamp, fallback and
``min_box_frac``. The weights cross between the packages as numpy trees in
the JAX file layout."""

import dataclasses
import json
import os
import random
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from clip_lora_match_tpu.core.config import YoloConfig as JYoloConfig
from clip_lora_match_tpu.core.config import load_yolo_config as j_load_yolo_config
from clip_lora_match_tpu.models.io import flatten_params as j_flatten
from clip_lora_match_tpu.models.yolo import cropper as jcrop
from clip_lora_match_tpu.models.yolo import postprocess as jpost
from clip_lora_match_tpu.models.yolo import yolov8 as J
from clip_lora_match_tpu_torch.core.config import YoloConfig, load_yolo_config
from clip_lora_match_tpu_torch.models.yolo import cropper as tcrop
from clip_lora_match_tpu_torch.models.yolo import postprocess as tpost
from clip_lora_match_tpu_torch.models.yolo import yolov8 as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = os.path.join(REPO, "models", "yolo_synth", "yolov8n_synth.npz")


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def _scaled_tree(seed: int = 3, num_classes: int = 10):
    """The -n tree's shapes with weights that keep activations O(1) through
    the whole net (He-like kernels, nonzero biases), numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda key: J.init_params(key, widths=J.WIDTHS_N, num_classes=num_classes), jax.random.PRNGKey(0)
    )

    def walk(node):
        if isinstance(node, dict):
            if "kernel" in node:
                kh, kw, cin, cout = node["kernel"].shape
                return {
                    "kernel": rng.normal(0, 1.6 / np.sqrt(kh * kw * cin), (kh, kw, cin, cout)).astype(np.float32),
                    "bias": rng.normal(0, 0.1, (cout,)).astype(np.float32),
                }
            return {k: walk(v) for k, v in node.items()}
        return [walk(v) for v in node]

    return walk(shapes)


@pytest.fixture(scope="module")
def trees():
    tree = _scaled_tree()
    return jax.tree.map(jnp.asarray, tree), T.params_from_jax(tree, "cpu")


@pytest.fixture(scope="module")
def held_out():
    """Renders from a seed outside every training split, as
    tests/test_yolo_trained.py draws them."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import generate_fashion_corpus as gen

    rng = random.Random(999)
    out = []
    for _ in range(3):
        img, boxes = gen.render_detect_image(rng, 320, max_objects=1)
        out.append((img, boxes))
    return out


def test_yolo_config_loads_as_jax(tmp_path):
    path = os.path.join(REPO, "config", "yolo_config.yaml")
    assert dataclasses.asdict(load_yolo_config(path)) == dataclasses.asdict(j_load_yolo_config(path))
    assert load_yolo_config(path).device == "tpu"  # read and kept; the detector's device is the caller's
    assert dataclasses.asdict(load_yolo_config(None)) == dataclasses.asdict(j_load_yolo_config(None))
    custom = tmp_path / "y.yaml"
    custom.write_text("model:\n  imgsz: 320\ninference:\n  max_det: 2\n  classes: [1, 3]\n"
                      "crop:\n  save_dir: out\n")
    assert dataclasses.asdict(load_yolo_config(str(custom))) == dataclasses.asdict(j_load_yolo_config(str(custom)))


@pytest.mark.parametrize("block", ["conv", "bottleneck", "c2f", "sppf", "upsample", "head"])
def test_block_matches_jax(trees, block):
    jp, tp = trees
    rng = np.random.default_rng(11)
    if block == "head":
        feats = [rng.normal(0, 1, (2, s, s, c)).astype(np.float32) for s, c in ((8, 64), (4, 128), (2, 256))]
        jo = J.detect_head(jp["head"], [jnp.asarray(f) for f in feats])
        to = T.detect_head(tp["head"], [_nchw(f) for f in feats])
        for (jr, jc), (tr, tc) in zip(jo, to):
            np.testing.assert_allclose(_nhwc(tr), np.asarray(jr), atol=1e-4)
            np.testing.assert_allclose(_nhwc(tc), np.asarray(jc), atol=1e-4)
        return
    b = ("backbone",)
    cases = {
        "conv": (b + ("1",), 16, lambda m, p, x: m.conv(p, x, 2)),
        "bottleneck": (b + ("2", "m", 0), 16, lambda m, p, x: m.bottleneck(p, x, True)),
        "c2f": (b + ("4",), 64, lambda m, p, x: m.c2f(p, x, True)),
        "sppf": (b + ("9",), 256, lambda m, p, x: m.sppf(p, x)),
        "upsample": ((), 8, lambda m, p, x: m.upsample2x(x)),
    }
    path, cin, fn = cases[block]
    pj, pt = jp, tp
    for key in path:
        pj, pt = pj[key], pt[key]
    x = rng.normal(0, 1, (2, 16, 16, cin)).astype(np.float32)
    want = np.asarray(fn(J, pj, jnp.asarray(x)))
    got = _nhwc(fn(T, pt, _nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_forward_and_decode_match_jax(trees):
    jp, tp = trees
    x = np.random.default_rng(12).random((2, 64, 64, 3)).astype(np.float32)
    jo = J.forward(jp, jnp.asarray(x))
    to = T.forward(tp, _nchw(x))
    assert [tuple(r.shape) for r, _ in to] == [(2, 64, 8, 8), (2, 64, 4, 4), (2, 64, 2, 2)]
    for (jr, jc), (tr, tc) in zip(jo, to):
        np.testing.assert_allclose(_nhwc(tr), np.asarray(jr), atol=1e-4)
        np.testing.assert_allclose(_nhwc(tc), np.asarray(jc), atol=1e-4)
    jb, jprob = J.decode_predictions(jo)
    tb, tprob = T.decode_predictions(to)
    assert tb.shape == (2, 84, 4) and tprob.shape == (2, 84, 10)
    # pixels: stride (up to 32) times a 16-bin softmax expectation over logits
    # of tens, so a 1e-5 logit difference moves a box edge by ~1e-3 px
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tprob.numpy(), np.asarray(jprob), atol=1e-5)


def test_committed_detector_matches_jax(held_out):
    jdet = J.load_detector(SYNTH, JYoloConfig())
    tdet = T.load_detector(SYNTH, device="cpu")
    assert tdet.cfg.imgsz == jdet.cfg.imgsz == 320 and tdet.compute_dtype == torch.float32
    for img, _ in held_out:
        arr, _, _ = J.letterbox(img, 320)
        jout = jdet._infer(jdet._params_c, jnp.asarray(arr[None]), 0.25, 0.45, 5, False)
        tout = tdet.infer(_nchw(arr[None]), 0.25, 0.45, 5)
        jb, js, jc, jv = (np.asarray(o) for o in jout)
        tb, ts, tc, tv = (o.numpy() for o in tout)
        assert tv.any()
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_allclose(tb, jb, atol=0.5)
        np.testing.assert_allclose(ts, js, atol=1e-4)
        jd = jdet.detect(img, 0.25, 0.45, 5)
        td = tdet.detect(img, 0.25, 0.45, 5)
        assert [d.class_id for d in td] == [d.class_id for d in jd]
        np.testing.assert_allclose([d.box for d in td], [d.box for d in jd], atol=0.5)


def test_detector_compute_dtype_rule(held_out):
    """fp32 on the CPU unless given; an explicit bf16 keeps the boxes (the
    card's rule is held there with an IoU tolerance)."""
    tdet = T.load_detector(SYNTH, device="cpu")
    bf = T.YoloV8Detector(tdet.params, tdet.cfg, compute_dtype="bfloat16", device="cpu")
    assert bf.compute_dtype == torch.bfloat16 and bf._params_c["backbone"]["0"]["kernel"].dtype == torch.bfloat16
    img = held_out[0][0]
    a, b = tdet.detect(img, 0.25, 0.45, 5), bf.detect(img, 0.25, 0.45, 5)
    assert a and b and a[0].class_id == b[0].class_id
    iou = tpost.box_iou(torch.tensor([a[0].box]), torch.tensor([b[0].box]))[0, 0]
    assert iou >= 0.9


def _nms_case(name):
    rng = np.random.default_rng(21)
    n = 40
    xy = rng.uniform(0, 60, (n, 2)).astype(np.float32)
    wh = rng.uniform(5, 30, (n, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], 1)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    classes = rng.integers(0, 3, n).astype(np.int32)
    if name == "ties":  # equal scores, overlapping and apart: first index wins
        scores[[3, 7, 19]] = scores.max() + 0.01
        boxes[7] = boxes[3] + 0.5
    if name == "below_conf":
        scores *= 0.2
    return boxes, scores, classes


@pytest.mark.parametrize("case", ["class_aware", "agnostic", "ties", "below_conf"])
def test_nms_fixed_matches_jax(case):
    boxes, scores, classes = _nms_case(case)
    agnostic = case == "agnostic"
    jout = jpost.nms_fixed(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes), 0.25, 0.45,
                           max_det=7, agnostic=agnostic)
    tout = tpost.nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(classes),
                           0.25, 0.45, max_det=7, agnostic=agnostic)
    for j, t in zip(jout, tout):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert tout[2].dtype == torch.int32 and tout[3].dtype == torch.bool
    if case == "below_conf":
        assert not tout[3].any() and (tout[2] == -1).all() and not tout[0].any()
    # a batch runs each row as alone
    tb = tpost.nms_fixed(torch.from_numpy(np.stack([boxes, boxes[::-1].copy()])),
                         torch.from_numpy(np.stack([scores, scores[::-1].copy()])),
                         torch.from_numpy(np.stack([classes, classes[::-1].copy()])),
                         0.25, 0.45, max_det=7, agnostic=agnostic)
    for full, one in zip(tb, tout):
        assert torch.equal(full[0], one)


def test_box_helpers_match_jax():
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 50, (5, 4)).astype(np.float32)
    a[:, 2:] += a[:, :2]
    b = rng.uniform(0, 50, (3, 4)).astype(np.float32)
    np.testing.assert_allclose(tpost.box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jpost.box_iou(jnp.asarray(a), jnp.asarray(b))), atol=1e-6)
    np.testing.assert_allclose(tpost.decode_boxes(torch.from_numpy(a)).numpy(),
                               np.asarray(jpost.decode_boxes(jnp.asarray(a))), atol=1e-6)
    np.testing.assert_array_equal(tpost.clamp_boxes(torch.from_numpy(a), 40, 30).numpy(),
                                  np.asarray(jpost.clamp_boxes(jnp.asarray(a), 40, 30)))


@pytest.mark.parametrize("wh", [(320, 320), (123, 77), (50, 400)])
def test_letterbox_matches_jax(wh):
    rng = np.random.default_rng(5)
    img = Image.fromarray(rng.integers(0, 255, (wh[1], wh[0], 3), dtype=np.uint8), "RGB")
    ta, ts, tp = T.letterbox(img, 96)
    ja, js, jp = J.letterbox(img, 96)
    np.testing.assert_array_equal(ta, ja)
    assert (ts, tp) == (js, jp)


def _ultralytics_keys():
    fused, plain = [f"model.{i}" for i in (0, 1, 3, 5, 7, 16, 19)], []
    for i, n in ((2, 1), (4, 2), (6, 2), (8, 1), (12, 1), (15, 1), (18, 1), (21, 1)):
        fused += [f"model.{i}.cv1", f"model.{i}.cv2"]
        fused += [f"model.{i}.m.{j}.cv{c}" for j in range(n) for c in (1, 2)]
    fused += ["model.9.cv1", "model.9.cv2"]
    for lv in range(3):
        for head in ("cv2", "cv3"):
            fused += [f"model.22.{head}.{lv}.0", f"model.22.{head}.{lv}.1"]
            plain.append(f"model.22.{head}.{lv}.2")
    return fused, plain


def test_convert_ultralytics_state_dict_matches_jax():
    rng = np.random.default_rng(6)
    fused, plain = _ultralytics_keys()
    sd = {}
    for i, prefix in enumerate(fused):
        key = prefix.replace("model.", "model.model.", 1) if i % 3 == 0 else prefix  # both spellings
        cout, cin, k = 4 + i % 3, 3 + i % 2, 1 + 2 * (i % 2)
        sd[f"{key}.conv.weight"] = rng.normal(size=(cout, cin, k, k)).astype(np.float32)
        for stat in ("weight", "bias", "running_mean"):
            sd[f"{key}.bn.{stat}"] = rng.normal(size=cout).astype(np.float32)
        sd[f"{key}.bn.running_var"] = rng.uniform(0.5, 2, cout).astype(np.float32)
    for i, prefix in enumerate(plain):
        sd[f"{prefix}.weight"] = rng.normal(size=(5, 4, 1, 1)).astype(np.float32)
        if i % 2:
            sd[f"{prefix}.bias"] = rng.normal(size=5).astype(np.float32)
    got = j_flatten(T.convert_ultralytics_state_dict(sd))
    want = j_flatten(J.convert_ultralytics_state_dict(sd))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7)


def test_load_detector_reads_the_tree_and_meta_json(tmp_path, trees):
    jp, _ = trees
    flat = {k: v.astype(np.float16) for k, v in j_flatten(jax.tree.map(np.asarray, jp)).items()}
    path = tmp_path / "w" / "det.npz"
    path.parent.mkdir()
    np.savez(path, **flat)
    cfg = JYoloConfig(imgsz=640)
    assert T.load_detector(str(path), YoloConfig(imgsz=640), device="cpu").cfg.imgsz == 640
    (path.parent / "meta.json").write_text(json.dumps({"imgsz": 96}))
    tdet = T.load_detector(str(path), YoloConfig(imgsz=640), device="cpu")
    jdet = J.load_detector(str(path), cfg)
    assert tdet.cfg.imgsz == jdet.cfg.imgsz == 96
    assert tdet.params["backbone"]["0"]["kernel"].dtype == torch.float32
    x = np.random.default_rng(7).random((2, 64, 64, 3)).astype(np.float32)
    jb, _ = J.decode_predictions(J.forward(jdet.params, jnp.asarray(x)))
    tb, _ = T.decode_predictions(T.forward(tdet.params, _nchw(x)))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-3)


def test_init_params_geometry():
    p = T.init_params(0, device="cpu")  # the published -s plan, 80 classes
    assert tuple(p["backbone"]["0"]["kernel"].shape) == (32, 3, 3, 3)
    assert tuple(p["head"]["levels"][0]["cv3"][2]["kernel"].shape) == (80, 128, 1, 1)
    out = T.forward(p, torch.zeros(1, 3, 64, 64))
    assert [tuple(c.shape) for _, c in out] == [(1, 80, 8, 8), (1, 80, 4, 4), (1, 80, 2, 2)]
    n = T.init_params(1, widths=T.WIDTHS_N, num_classes=10, device="cpu")
    assert tuple(n["head"]["levels"][2]["cv2"][0]["kernel"].shape) == (64, 256, 3, 3)


def test_detector_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.load_detector(SYNTH)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcrop.load_yolo_cropper()


class _Boxes:
    """A detector that returns fixed boxes (out of bounds, fractional, tiny)."""

    def __init__(self, module, boxes):
        self.dets = [module.Detection(b, 0.9 - 0.1 * i, i) for i, b in enumerate(boxes)]

    def detect(self, image, conf, iou, max_det, classes=None, agnostic=False):
        return list(self.dets)


@pytest.mark.parametrize("case", ["boxes", "fallback", "min_box_frac"])
def test_cropper_matches_jax(tmp_path, case):
    rng = np.random.default_rng(8)
    src = tmp_path / "tas_pink.png"
    Image.fromarray(rng.integers(0, 255, (60, 90, 3), dtype=np.uint8), "RGB").save(src)
    boxes = [(-5.5, 3.7, 40.2, 50.9), (30.0, 10.0, 200.0, 70.0), (10.0, 10.0, 12.5, 11.9), (50, 50, 50, 55)]
    if case == "fallback":
        boxes = []
    frac = 0.01 if case == "min_box_frac" else 0.0
    got = tcrop.YoloCropper(_Boxes(tcrop, boxes), YoloConfig(crop_save_dir=str(tmp_path / "t"),
                                                             min_box_frac=frac))
    want = jcrop.YoloCropper(_Boxes(jcrop, boxes), JYoloConfig(crop_save_dir=str(tmp_path / "j"),
                                                               min_box_frac=frac))
    tp, jp = got.crop_image(str(src)), want.crop_image(str(src))
    assert [os.path.basename(p) for p in tp] == [os.path.basename(p) for p in jp]
    names = {"boxes": ["tas_pink_crop_0.jpg", "tas_pink_crop_1.jpg", "tas_pink_crop_2.jpg"],
             "fallback": ["tas_pink_crop_0.jpg"], "min_box_frac": ["tas_pink_crop_0.jpg", "tas_pink_crop_1.jpg"]}
    assert [os.path.basename(p) for p in tp] == names[case]
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))
    if case == "boxes":  # clamped to the image as integers
        assert Image.open(tp[1]).size == (60, 50) and Image.open(tp[0]).size == (40, 47)
    if case == "fallback":
        assert Image.open(tp[0]).size == (90, 60)
    folder = got.crop_folder(str(tmp_path), save_dir=str(tmp_path / "f"))
    assert list(folder) == [str(src)] and len(folder[str(src)]) == len(tp)


def test_load_yolo_cropper_finds_the_committed_weights(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # not the repository root
    cropper = tcrop.load_yolo_cropper(device="cpu")
    assert isinstance(cropper.detector, T.YoloV8Detector)
    assert cropper.detector.cfg.imgsz == 320 and cropper.cfg.imgsz == 640
    none = tcrop.load_yolo_cropper(weights_path=str(tmp_path / "missing.npz"), device="cpu")
    assert isinstance(none.detector, T.YoloV8Detector)  # the committed fallback
    assert os.path.isabs(tcrop._repo_relative("models/yolo_synth/yolov8n_synth.npz"))
