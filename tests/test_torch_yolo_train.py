"""The detector's training of the port (``models/yolo/train.py``,
``models/yolo/cli.py``) against the JAX package's ``models/yolo/train.py``
and ``scripts/{train,eval}_yolo.py`` on the CPU.

A narrow YOLOv8 (the JAX ``init_params`` widths argument: P1-P5 = 8, 16,
16, 32, 32; full depth; 10 classes) at 64², B=2, over a detection corpus
rendered by ``scripts/generate_fashion_corpus.py --detect`` at 64². The
weights are drawn with numpy (He-like kernels, nonzero biases) so that the
predictions differ from anchor to anchor: at the prior-bias init every box
of a level has one size, the IoUs of anchors placed symmetrically about a
GT are equal in exact arithmetic, and float rounding alone would pick the
top 10. Tolerances: the loss and its parts rel 1e-5 (optax's BCE form and
the port's agree to fp32 rounding), gradients and updated parameters
normwise rel 1e-5 per leaf, the assignment exact on inputs given to both.
"""

import argparse
import functools
import json
import os
import sys

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_lora_match_tpu.core.config import YoloConfig as JYoloConfig
from clip_lora_match_tpu.models.io import load_params as j_load_params
from clip_lora_match_tpu.models.io import save_params as j_save_params
from clip_lora_match_tpu.models.yolo import train as JT
from clip_lora_match_tpu.models.yolo import yolov8 as J
from clip_lora_match_tpu_torch.core.config import YoloConfig
from clip_lora_match_tpu_torch.models.io import save_params, tree_leaves
from clip_lora_match_tpu_torch.models.yolo import cli
from clip_lora_match_tpu_torch.models.yolo import train as TT
from clip_lora_match_tpu_torch.models.yolo import yolov8 as T
from clip_lora_match_tpu_torch.train.step import AdamW, Chain, ClipByGlobalNorm, warmup_cosine_decay_schedule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = os.path.join(REPO, "models", "yolo_synth", "yolov8n_synth.npz")
WIDTHS = {"P1": 8, "P2": 16, "P3": 16, "P4": 32, "P5": 32}
S, B, NC = 64, 2, 10
LR, WD = 1e-3, 5e-4


def _gen():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import generate_fashion_corpus

    return generate_fashion_corpus


def _corpus(root, imgsz, n_train, n_val):
    _gen().generate_detect(argparse.Namespace(out=str(root), seed=42, imgsz=imgsz, max_objects=2,
                                              n_train=n_train, n_val=n_val))
    return str(root)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _corpus(tmp_path_factory.mktemp("detect64"), S, 6, 4)


def _scaled_tree(seed: int = 3):
    """The narrow tree's shapes (JAX ``init_params``), numpy weights."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: J.init_params(k, widths=WIDTHS, num_classes=NC), jax.random.PRNGKey(0))

    def walk(node):
        if isinstance(node, dict):
            if "kernel" in node:
                kh, kw, cin, cout = node["kernel"].shape
                return {"kernel": rng.normal(0, 1.2 / np.sqrt(kh * kw * cin), (kh, kw, cin, cout)).astype(np.float32),
                        "bias": rng.normal(0, 0.1, (cout,)).astype(np.float32)}
            return {k: walk(v) for k, v in node.items()}
        return [walk(v) for v in node]

    return walk(shapes)


def _normrel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _leaves_np(tree):
    """(path, numpy) of a port tree, JAX's leaf order."""
    return [(p, t.detach().numpy()) for p, t in tree_leaves(tree)]


def _jax_as_port(tree):
    return _leaves_np(T.params_from_jax(jax.tree.map(np.asarray, tree), "cpu"))


# -- geometry ------------------------------------------------------------------


@pytest.mark.parametrize("imgsz", [64, 320])
def test_make_anchors_matches_jax(imgsz):
    ja, js = JT.make_anchors(imgsz)
    ta, ts = TT.make_anchors(imgsz, device="cpu")
    assert ta.dtype == ts.dtype == torch.float32
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _pred_boxes(rng, anchors, n_img):
    c = anchors[None] + rng.normal(0, 4, (n_img,) + anchors.shape)
    wh = rng.uniform(6, 40, (n_img, anchors.shape[0], 2))
    return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)


def test_plain_iou_matches_jax():
    rng = np.random.default_rng(0)
    anchors = np.asarray(JT.make_anchors(S)[0])
    pred = _pred_boxes(rng, anchors, 1)[0]
    gt = np.array([[5, 6, 40, 50], [30, 10, 60, 30], [0, 0, 0, 0]], np.float32)
    want = np.asarray(JT.plain_iou(jnp.asarray(pred), jnp.asarray(gt)))
    got = TT.plain_iou(torch.from_numpy(pred), torch.from_numpy(gt)).numpy()
    assert got.shape == (3, 84)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# -- task-aligned assignment ---------------------------------------------------------

_TAL_CASES = {
    # image 0: one GT and three padded slots; image 1: two GTs and two padded slots
    "padded": [[[4, 4, 44, 50, 3]], [[8, 30, 60, 62, 1], [2, 2, 30, 20, 7]]],
    # a 10-px GT holds at most two anchor centres: fewer than 10 candidates
    "few_candidates": [[[26, 26, 36, 36, 5], [0, 0, 60, 60, 2]], [[41, 9, 52, 22, 0]]],
    # two overlapping GTs share their centre anchors
    "two_gts": [[[4, 4, 52, 52, 1], [12, 12, 60, 60, 4]], [[10, 10, 50, 40, 2], [14, 6, 54, 44, 2]]],
}


def _tal_inputs(case: str):
    rng = np.random.default_rng(7)
    anchors = np.asarray(JT.make_anchors(S)[0])
    pred = _pred_boxes(rng, anchors, B)
    scores = rng.uniform(0.05, 0.95, (B, anchors.shape[0], NC)).astype(np.float32)
    M = 4
    boxes = np.zeros((B, M, 4), np.float32)
    cls = np.zeros((B, M), np.int32)
    valid = np.zeros((B, M), bool)
    for b, gts in enumerate(_TAL_CASES[case]):
        for m, (x1, y1, x2, y2, c) in enumerate(gts):
            boxes[b, m], cls[b, m], valid[b, m] = (x1, y1, x2, y2), c, True
    return pred, scores, anchors, boxes, cls, valid


@pytest.mark.parametrize("case", sorted(_TAL_CASES))
def test_assign_tal_matches_jax(case):
    pred, scores, anchors, boxes, cls, valid = _tal_inputs(case)
    want = jax.jit(jax.vmap(functools.partial(JT.assign_tal, anchors=jnp.asarray(anchors))))(
        jnp.asarray(pred), jnp.asarray(scores), gt_boxes=jnp.asarray(boxes), gt_cls=jnp.asarray(cls),
        gt_valid=jnp.asarray(valid),
    )
    got = TT.assign_tal(*(torch.tensor(a) for a in (pred, scores, anchors, boxes, cls, valid)))
    fg, gt_idx, t_score, a_iou = (np.asarray(w) for w in want)
    tfg, tidx, tscore, tiou = (g.numpy() for g in got)
    np.testing.assert_array_equal(tfg, fg)
    np.testing.assert_array_equal(tidx, gt_idx)
    np.testing.assert_allclose(tscore, t_score, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tiou, a_iou, rtol=1e-6, atol=1e-7)
    assert fg.any()
    if case == "padded":
        assert not np.isin(gt_idx[fg], [2, 3]).any()  # no anchor goes to a padded slot
    if case == "few_candidates":
        n = (fg[0] & (gt_idx[0] == 0)).sum()
        assert 0 < n < TT.TAL_TOPK
    if case == "two_gts":
        # an anchor inside both boxes that both GTs rank in their top 10:
        # the higher IoU takes it, as jnp.argmax picks
        ax, ay = anchors[:, 0], anchors[:, 1]
        inside = [(ax > b[0]) & (ax < b[2]) & (ay > b[1]) & (ay < b[3]) for b in boxes[0, :2]]
        assert (inside[0] & inside[1] & fg[0]).any()
        assert set(gt_idx[0][fg[0]]) == {0, 1}


# -- losses ------------------------------------------------------------------------


def test_diag_ciou_and_its_gradient_match_jax():
    rng = np.random.default_rng(3)
    anchors = np.asarray(JT.make_anchors(S)[0])
    pred = _pred_boxes(rng, anchors, B)
    gt = _pred_boxes(rng, anchors, B)
    w = rng.uniform(0, 1, (B, anchors.shape[0])).astype(np.float32)
    jval, jgrad = jax.jit(jax.value_and_grad(lambda p: jnp.sum(JT._diag_ciou(p, jnp.asarray(gt)) * w)))(
        jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    ciou = TT._diag_ciou(p, torch.from_numpy(gt))
    np.testing.assert_allclose(ciou.detach().numpy(), np.asarray(JT._diag_ciou(jnp.asarray(pred), jnp.asarray(gt))),
                               rtol=1e-5, atol=1e-6)
    (ciou * torch.from_numpy(w)).sum().backward()
    assert abs(float(jval) - float((ciou.detach() * torch.from_numpy(w)).sum())) <= 1e-5 * abs(float(jval))
    assert _normrel(p.grad.numpy(), jgrad) <= 1e-5


def test_init_detect_biases_matches_jax():
    tree = _scaled_tree()
    want = JT.init_detect_biases(jax.tree.map(jnp.asarray, tree), S)
    got = TT.init_detect_biases(T.params_from_jax(tree, "cpu"), S)
    for (path, a), (_, b) in zip(_leaves_np(got), _jax_as_port(want)):
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.fixture(scope="module")
def runs(corpus):
    """Three steps of JAX's ``make_yolo_train_step`` (a first transform in
    its chain keeps each step's raw gradients in the optimizer state) and of
    the port's, from the same weights over the same batches."""
    tree = _scaled_tree()
    jp = JT.init_detect_biases(jax.tree.map(jnp.asarray, tree), S)
    tp = TT.init_detect_biases(T.params_from_jax(tree, "cpu"), S)
    total, warmup = 4, 1
    capture = optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))
    jtx = optax.chain(capture, optax.clip_by_global_norm(10.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(0.0, LR, warmup, total, end_value=LR * 0.01), weight_decay=WD))
    ttx = Chain(ClipByGlobalNorm(10.0), AdamW(
        warmup_cosine_decay_schedule(0.0, LR, warmup, total, end_value=LR * 0.01), weight_decay=WD))
    jstep = JT.make_yolo_train_step(S, jtx)
    tstep = TT.make_yolo_train_step(S, ttx, device="cpu")
    jstate = JT.YoloTrainState(jp, jtx.init(jp), jnp.zeros((), jnp.int32))
    tstate = TT.YoloTrainState(tp, ttx.init(tp), 0)
    jds = JT.DetectDataset(os.path.join(corpus, "boxes_train.csv"), S)
    batches = list(jds.batches(B, np.random.default_rng(0)))
    out = []
    for batch in batches:
        tparams_before = tstate.params
        live = [t.detach().requires_grad_(True) for _, t in tree_leaves(tparams_before)]
        jstate, jaux = jstep(jstate, batch)
        tstate, taux = tstep(tstate, batch)
        out.append(dict(batch=batch, jaux={k: float(v) for k, v in jaux.items()},
                        taux={k: float(v) for k, v in taux.items()}, jgrads=_jax_as_port(jstate.opt_state[0]),
                        jparams=_jax_as_port(jstate.params), tparams=_leaves_np(tstate.params),
                        tparams_before=tparams_before, live=live))
    return out


def test_detection_loss_and_gradients_match_jax(runs):
    """``detection_loss`` and autograd at the first step's weights and batch
    against the gradients inside JAX's first step."""
    r = runs[0]
    b = r["batch"]
    anchors, spa = TT.make_anchors(S, device="cpu")
    images = (torch.from_numpy(b["images"]).float() / torch.tensor(255.0)).permute(0, 3, 1, 2).contiguous()
    params = TT._rebuild(r["tparams_before"], iter(r["live"]))
    loss, aux = TT.detection_loss(params, images, torch.from_numpy(b["boxes"]), torch.from_numpy(b["classes"]),
                                  torch.from_numpy(b["valid"]), anchors, spa)
    grads = torch.autograd.grad(loss, r["live"])
    aux = {k: float(v.detach()) for k, v in aux.items()}
    for k in ("loss", "box", "cls", "dfl"):
        assert abs(aux[k] - r["jaux"][k]) <= 1e-5 * abs(r["jaux"][k]), k
    assert aux["num_fg"] == r["jaux"]["num_fg"] > 0
    for (path, want), got in zip(r["jgrads"], grads):
        assert _normrel(got.numpy(), want) <= 1e-5, path


@pytest.mark.parametrize("i", [0, 1, 2])
def test_train_steps_match_jax(runs, i):
    r = runs[i]
    for k in ("loss", "box", "cls", "dfl", "grad_norm"):
        assert abs(r["taux"][k] - r["jaux"][k]) <= 1e-5 * abs(r["jaux"][k]), k
    assert r["taux"]["num_fg"] == r["jaux"]["num_fg"]
    for (path, want), (_, got) in zip(r["jparams"], r["tparams"]):
        assert _normrel(got, want) <= 1e-5, path
    if i == 0:  # the schedule starts at 0: the first step leaves the weights as they are
        for (_, a), (_, b) in zip(r["tparams"], _leaves_np(r["tparams_before"])):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("warmup,total", [(1, 2), (3, 10), (7, 75), (225, 3000)])
def test_warmup_cosine_schedule_matches_optax(warmup, total):
    ref = optax.warmup_cosine_decay_schedule(0.0, LR, warmup, total, end_value=LR * 0.01)
    got = warmup_cosine_decay_schedule(0.0, LR, warmup, total, end_value=LR * 0.01)
    counts = range(total + 3)
    # 1 + cos(x) cancels near the end of the decay: an ulp of cos there is
    # ~1e-5 of the rate, so the bound is absolute, 1e-6 of the peak
    np.testing.assert_allclose([got(c) for c in counts], np.asarray(ref(jnp.arange(total + 3))),
                               rtol=0, atol=1e-6 * LR)
    assert got(0) == 0.0


# -- data ------------------------------------------------------------------------------


def test_load_detect_csv_matches_jax(corpus):
    path = os.path.join(corpus, "boxes_val.csv")
    want, got = JT.load_detect_csv(path), TT.load_detect_csv(path)
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 5])
def test_detect_dataset_batches_bit_equal(corpus, seed):
    path = os.path.join(corpus, "boxes_train.csv")
    jds, tds = JT.DetectDataset(path, S), TT.DetectDataset(path, S)
    np.testing.assert_array_equal(tds.images, jds.images)
    want = list(jds.batches(B, np.random.default_rng(seed)))
    got = list(tds.batches(B, np.random.default_rng(seed)))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


# -- weights, evaluation and the entry points ---------------------------------------------


def test_params_to_jax_inverts_params_from_jax():
    tree = _scaled_tree()
    back = T.params_to_jax(T.params_from_jax(tree, "cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)


def test_a_port_saved_detector_loads_in_jax(tmp_path, corpus):
    """The port's fp16 save, as the trainer writes it, is the file JAX's
    trainer writes for the same weights, and JAX's ``load_detector`` detects
    from it what the port's does."""
    tree = _scaled_tree(seed=9)
    tparams = T.params_from_jax(tree, "cpu")
    port_file, jax_file = str(tmp_path / "port" / "w.npz"), str(tmp_path / "jax" / "w.npz")
    save_params(port_file, T.params_to_jax(tparams, np.float16))
    j_save_params(jax_file, jax.tree.map(lambda x: np.asarray(x, np.float16), tree))
    with np.load(port_file) as a, np.load(jax_file) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == np.float16
            np.testing.assert_array_equal(a[k], b[k])
    with open(os.path.join(os.path.dirname(port_file), "meta.json"), "w") as f:
        json.dump({"imgsz": S}, f)
    jdet = J.load_detector(port_file, JYoloConfig())
    tdet = T.load_detector(port_file, device="cpu")
    assert jdet.cfg.imgsz == tdet.cfg.imgsz == S
    from PIL import Image

    paths = TT.load_detect_csv(os.path.join(corpus, "boxes_val.csv"))[0]
    n = 0
    for p in paths:
        img = Image.open(p).convert("RGB")
        jd, td = jdet.detect(img, 0.01, 0.45, 5), tdet.detect(img, 0.01, 0.45, 5)
        assert [d.class_id for d in td] == [d.class_id for d in jd]
        np.testing.assert_allclose([d.box for d in td], [d.box for d in jd], atol=0.05)
        n += len(td)
    assert n > 0


def test_evaluate_matches_eval_yolo(tmp_path):
    """The port's ``evaluate`` with the port's detector against
    scripts/eval_yolo.py's with JAX's, on a 4-image 160² corpus and the
    committed synthetic-corpus detector."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import eval_yolo

    data = _corpus(tmp_path / "detect160", 160, 1, 4)
    csv_path = os.path.join(data, "boxes_val.csv")
    jdet = J.load_detector(SYNTH, JYoloConfig())
    tdet = T.load_detector(SYNTH, YoloConfig(), device="cpu")
    want = eval_yolo.evaluate(jdet, csv_path, jdet.cfg)
    got = cli.evaluate(tdet, csv_path, tdet.cfg)
    assert got.keys() == want.keys() and got["num_gt"] > 0
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-4), k
    boxes = ((0, 0, 10, 10), (5, 5, 15, 15)), ((0, 0, 1, 1), (2, 2, 3, 3))
    for a, b in boxes:
        assert cli.box_iou_np(a, b) == eval_yolo.box_iou_np(a, b)


def test_cli_train_and_eval_on_the_cpu(tmp_path, corpus, capsys):
    """One tiny epoch of ``train`` from the committed detector's leaves
    (same 10 classes: every leaf grafted), then ``eval`` of its weights;
    JAX's ``load_params`` reads them."""
    out = str(tmp_path / "out")
    res = cli.run(["train", "--data", corpus, "--out", out, "--imgsz", str(S), "--epochs", "1",
                   "--batch-size", str(B), "--log-every", "1", "--init-weights", SYNTH, "--device", "cpu"])
    printed = capsys.readouterr().out
    assert res["grafted"] == res["leaves"] == 126
    assert "126/126 leaves grafted" in printed
    assert res["steps"] == 3 and len(res["logged"]) == 3
    assert all(np.isfinite(a["loss"]) for a in res["logged"])
    assert res["weights"] == os.path.join(out, "yolov8n_synth.npz")
    with open(os.path.join(out, "meta.json")) as f:
        meta = json.load(f)
    assert meta == {"classes": _gen().ARTICLE_CLASSES, "imgsz": S, "width": "n", "epochs": 1, "train_images": 6}
    loaded = j_load_params(res["weights"])
    assert len(jax.tree_util.tree_leaves(loaded)) == 126
    m = cli.run(["eval", "--data", corpus, "--weights", res["weights"], "--device", "cpu", "--limit", "2",
                 "--out", str(tmp_path / "m.json")])
    assert m["num_images"] == 2
    with open(tmp_path / "m.json") as f:
        assert json.load(f) == m


def test_cli_entry_points_want_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.run(["eval", "--weights", SYNTH, "--data", "no/such/dir"])
