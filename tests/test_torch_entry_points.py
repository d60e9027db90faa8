"""The port's last entry points against the JAX package's scripts on the CPU:
``services.cli`` (the seven demos), ``lora.cli`` (export_lora.py),
``tokenizer.cli`` (learn_bpe.py), ``models.cli`` (test_clip_load.py,
test_lora_inference.py) and ``models.yolo.cli heldout``
(eval_real_detect_heldout.py).

Both sides run in this process on one tiny CLIP (the same weights as an
``.npz``, the same adapter) over the in-repo rows, from a temporary working
directory (the finder and the cropper write relative to it). The scripts'
printed results are parsed and compared: the same rows in the same order
where their scores are more than 2e-4 apart, and scores within 2e-4 (the
scripts print 4 decimals; the two packages' fp32 embeddings differ by about
1e-6).
"""

import csv
import importlib
import json
import os
import random
import re
import shutil
import sys

import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

import jax

from clip_lora_match_tpu.core.config import ClipArchConfig as JArch
from clip_lora_match_tpu.core.config import LoraConfig as JLoraConfig
from clip_lora_match_tpu.lora.adapter import init_lora as j_init_lora
from clip_lora_match_tpu.lora.adapter import load_lora as j_load_lora
from clip_lora_match_tpu.lora.adapter import merge_lora as j_merge_lora
from clip_lora_match_tpu.models import clip as jclip
from clip_lora_match_tpu.models.io import flatten_params as j_flatten
from clip_lora_match_tpu.models.io import load_params as j_load_params
from clip_lora_match_tpu.models.io import save_params as j_save_params
from clip_lora_match_tpu.nn import layers as jlayers
from clip_lora_match_tpu.retrieval.search import SearchIndex as JSearch
from clip_lora_match_tpu.tokenizer.learn import learn_bpe as j_learn_bpe
from clip_lora_match_tpu_torch.core.config import LoraConfig
from clip_lora_match_tpu_torch.index import cli as index_cli
from clip_lora_match_tpu_torch.lora import cli as lora_cli
from clip_lora_match_tpu_torch.lora.adapter import save_lora
from clip_lora_match_tpu_torch.lora.peft_io import read_safetensors
from clip_lora_match_tpu_torch.models import cli as models_cli
from clip_lora_match_tpu_torch.models.io import params_from_numpy
from clip_lora_match_tpu_torch.models.yolo import cli as yolo_cli
from clip_lora_match_tpu_torch.services import cli as services_cli
from clip_lora_match_tpu_torch.tokenizer import cli as tokenizer_cli
from tests._torch_helpers import random_like_tree, to_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
SYNTH = os.path.join(REPO, "models", "yolo_synth", "yolov8n_synth.npz")
TINY_KW = dict(
    image_size=32, patch_size=16, vision_width=64, vision_layers=2, vision_heads=4,
    vision_mlp_dim=128, vocab_size=600, max_text_length=77, text_width=32, text_layers=2,
    text_heads=4, text_mlp_dim=64, projection_dim=16,
)
RESULT = re.compile(r"^\s+(\d+)\. \[(-?\d+\.\d+)\] (.*)  \((.*)\)$")
TOL = 2e-4


def _abs_csv(src: str, dst) -> str:
    """The in-repo CSV with absolute image paths."""
    with open(os.path.join(REPO, src), newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    with open(dst, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["image_path", "text"])
        w.writerows([(os.path.join(REPO, r["image_path"]), r["text"]) for r in rows])
    return str(dst)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Tiny weights as an .npz, a clip config, a native adapter (r=8,
    alpha=16, random B), the custom and val CSVs with absolute paths, and the
    custom and text indexes built by the port's ``index.cli`` over them."""
    d = tmp_path_factory.mktemp("entry")
    params = jclip.init_params(jax.random.PRNGKey(0), JArch(**TINY_KW))
    weights = str(d / "base.npz")
    j_save_params(weights, params)
    lora = random_like_tree(j_init_lora(jax.random.PRNGKey(1), JArch(**TINY_KW), JLoraConfig()), seed=1,
                            scale=0.2)
    adapter = str(d / "adapter")
    save_lora(adapter, params_from_numpy(j_flatten(to_jax(lora)), device="cpu"), LoraConfig())
    arch_yaml = "\n".join(f"    {k}: {v}" for k, v in TINY_KW.items())
    clip_yaml = d / "clip.yaml"
    clip_yaml.write_text(f"model:\n  name: openai/clip-vit-base-patch32\n  arch:\n{arch_yaml}\n"
                         f"preprocess:\n  image_size: 32\n")
    enc = ["--clip-config", str(clip_yaml), "--weights", weights, "--lora", adapter]
    custom_csv = _abs_csv("data/custom/my_items.csv", d / "custom.csv")
    val_csv = _abs_csv("data/text/val_fashion.csv", d / "val.csv")
    custom = str(d / "custom_items_index.npz")
    text = str(d / "fashion_text_index.npz")
    index_cli.run(["build-custom", "--csv", custom_csv, "--out", custom, *enc, "--device", "cpu"])
    index_cli.run(["build-text", "--csv", val_csv, "--out", text, *enc, "--device", "cpu"])
    with open(custom_csv, newline="", encoding="utf-8") as f:
        custom_rows = list(csv.DictReader(f))
    return dict(dir=d, weights=weights, adapter=adapter, clip_yaml=str(clip_yaml), enc=enc,
                custom_csv=custom_csv, val_csv=val_csv, custom=custom, text=text, custom_rows=custom_rows)


def _script(name: str):
    if SCRIPTS not in sys.path:
        sys.path.insert(0, SCRIPTS)
    return importlib.import_module(name)


def _run_script(name, argv, monkeypatch, capsys, mod=None) -> str:
    """The JAX script's ``main`` with ``argv``; its printed lines. The JAX
    encoder sets its kernel flags process-wide: they are put back."""
    mod = mod or _script(name)
    flags = dict(jlayers._KERNEL_FLAGS)
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    try:
        mod.main()
    finally:
        jlayers._KERNEL_FLAGS.clear()
        jlayers._KERNEL_FLAGS.update(flags)
    return capsys.readouterr().out


def _run_port(cli, argv, capsys):
    capsys.readouterr()
    out = cli.run(argv)
    return out, capsys.readouterr().out


def _results(text: str) -> list:
    return [(int(m[1]), float(m[2]), m[3], m[4]) for m in map(RESULT.match, text.splitlines()) if m]


def _same_results(got: str, want: str) -> list:
    g, w = _results(got), _results(want)
    assert len(g) == len(w) > 0
    scores = np.array([r[1] for r in w])
    for i, (a, b) in enumerate(zip(g, w)):
        assert a[0] == b[0] and abs(a[1] - b[1]) <= TOL
        apart = all(abs(scores[i] - scores[j]) > TOL for j in (i - 1, i + 1) if 0 <= j < len(w))
        if apart:
            assert a[2:] == b[2:]
    return g


# -- services.cli: the demos --------------------------------------------------------------


def test_finder_report_then_search_text_custom(world, tmp_path, monkeypatch, capsys):
    """A report into a copy of the custom index in each package, then a
    one-shot text search over each copy: the same rows, the report first;
    with ``--db`` the report lands in the store too."""
    monkeypatch.chdir(tmp_path)
    copies = {}
    for side in ("jax", "port"):
        os.makedirs(side)
        copies[side] = os.path.join(side, "custom_items_index.npz")
        for ext in (".npz", ".json"):
            shutil.copy(world["custom"][:-4] + ext, copies[side][:-4] + ext)
    photo = os.path.join(REPO, "data", "custom", "images", "topi_merah_lapangan_basket.jpg")
    desc = "kacamata pink ditemukan di kantin"
    report = ["--image", photo, "--description", desc, "--location", "kantin"]
    want = _run_script("demo_finder_report", ["--index", copies["jax"], *report, *world["enc"]],
                       monkeypatch, capsys)
    rep, got = _run_port(services_cli, ["finder-report", "--index", copies["port"], *report, *world["enc"],
                                        "--device", "cpu"], capsys)
    n = len(world["custom_rows"])
    assert rep.index_row == n and f"row={n} id=None" in got and f"row={n} id=None" in want
    assert got.splitlines()[-1] == want.splitlines()[-1]  # the indexed text
    query = ["--query", desc, "--k", "3"]
    want = _run_script("demo_search_text_custom", ["--index", copies["jax"], *query, *world["enc"]],
                       monkeypatch, capsys)
    res, got = _run_port(services_cli, ["search-text-custom", "--index", copies["port"], *query,
                                        *world["enc"], "--device", "cpu"], capsys)
    _same_results(got, want)
    assert res[0].index == n and len(res) == 3
    # the JAX SearchIndex reads the port's updated copy
    jres = JSearch.from_file(copies["port"], None, dim=16)
    assert len(jres.index) == n + 1
    db = str(tmp_path / "found.sqlite")
    rep2, _ = _run_port(services_cli, ["finder-report", "--index", copies["port"], *report, "--db", db,
                                       *world["enc"], "--device", "cpu"], capsys)
    assert rep2.item_id == 1 and rep2.index_row == n + 1


def test_seeker_matches_jax(world, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    row = world["custom_rows"][1]
    args = ["--index", world["custom"], "--description", row["text"], "--image", row["image_path"], "--k", "4"]
    want = _run_script("demo_seeker", [*args, *world["enc"]], monkeypatch, capsys)
    res, got = _run_port(services_cli, ["seeker", *args, *world["enc"], "--device", "cpu"], capsys)
    _same_results(got, want)
    assert len(res) == 4


def test_seeker_loop(world, tmp_path, monkeypatch, capsys):
    """The REPL: a text-only then an image-only request, an unreadable image
    reported, then two empty answers end it."""
    monkeypatch.chdir(tmp_path)
    row = world["custom_rows"][0]
    answers = iter(["tas", "", "", row["image_path"], "", "missing.jpg", "", ""])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(answers))
    out, printed = _run_port(services_cli, ["seeker", "--index", world["custom"], *world["enc"],
                                            "--device", "cpu"], capsys)
    assert len(out) == 2 and all(len(r) == 5 for r in out)
    assert "error:" in printed


@pytest.mark.parametrize("cmd, script, index, arg", [
    ("search-text", "demo_search_text", "text", ["--query", "tas hijau"]),
    ("search-text-custom", "demo_search_text_custom", "custom", ["--query", "payung hitam"]),
    ("search-image", "demo_search_image", "text", ["--image", "IMG"]),
    ("search-image-custom", "demo_search_image_custom", "custom", ["--image", "IMG"]),
])
def test_one_shot_searches_match_jax(world, tmp_path, monkeypatch, capsys, cmd, script, index, arg):
    monkeypatch.chdir(tmp_path)
    arg = [world["custom_rows"][2]["image_path"] if a == "IMG" else a for a in arg]
    args = ["--index", world[index], "--k", "4", *arg, *world["enc"]]
    want = _run_script(script, args, monkeypatch, capsys)
    res, got = _run_port(services_cli, [cmd, *args, "--device", "cpu"], capsys)
    _same_results(got, want)
    assert got.splitlines()[0] == want.splitlines()[0]  # [demo] loaded N items from ...
    assert len(res) == 4


@pytest.mark.parametrize("cmd, script, index, answers", [
    ("search-text", "demo_search_text", "text", ["tas", "sepatu putih", "quit"]),
    ("search-image", "demo_search_image", "text", ["sample", "IMG", ""]),
    ("search-image-custom", "demo_search_image_custom", "custom", ["IMG", "exit"]),
])
def test_interactive_searches_match_jax(world, tmp_path, monkeypatch, capsys, cmd, script, index, answers):
    """The REPLs read ``input()`` as the scripts do; 'sample' draws the same
    val row from the same ``random`` state."""
    monkeypatch.chdir(tmp_path)
    img = world["custom_rows"][3]["image_path"]
    answers = [img if a == "IMG" else a for a in answers]
    args = ["--index", world[index], "--k", "3", *world["enc"]]
    if cmd == "search-image":
        args += ["--val-csv", world["val_csv"]]
    outs = []
    for run in ("jax", "port"):
        it = iter(answers)
        monkeypatch.setattr("builtins.input", lambda prompt="", it=it: next(it))
        random.seed(5)
        if run == "jax":
            outs.append(_run_script(script, args, monkeypatch, capsys))
        else:
            res, printed = _run_port(services_cli, [cmd, *args, "--device", "cpu"], capsys)
            outs.append(printed)
            assert len(res) == len(answers) - 1
    _same_results(outs[1], outs[0])
    if cmd == "search-image":
        assert [ln for ln in outs[1].splitlines() if ln.startswith("sampled:")] == [
            ln for ln in outs[0].splitlines() if ln.startswith("sampled:")] != []


@pytest.mark.parametrize("fused", [False, True])
def test_search_image_yolo_matches_jax(world, tmp_path, monkeypatch, capsys, fused):
    """Staged (crop file, then search) and ``--fused`` (detect, crop, embed,
    top-k in one call) with the committed synthetic detector."""
    monkeypatch.chdir(tmp_path)
    img = os.path.join(REPO, "data", "custom", "images", "topi_merah_lapangan_basket.jpg")
    args = ["--index", world["custom"], "--image", img, "--k", "3", "--yolo-weights", SYNTH,
            "--yolo-config", os.path.join(REPO, "config", "yolo_config.yaml"), *world["enc"]]
    args += ["--fused"] if fused else []
    want = _run_script("demo_search_image_yolo_custom", args, monkeypatch, capsys)
    res, got = _run_port(services_cli, ["search-image-yolo", *args, "--device", "cpu"], capsys)
    _same_results(got, want)
    if fused:
        scores, ids, box, detected = res
        line = [ln for ln in got.splitlines() if ln.startswith("[demo] fused:")][0]
        wline = [ln for ln in want.splitlines() if ln.startswith("[demo] fused:")][0]
        assert line.split(" box=")[0] == wline.split(" box=")[0]
        wbox = json.loads(wline.split(" box=")[1])
        np.testing.assert_allclose(box, wbox, atol=0.11)  # printed to 0.1
        assert len(ids) == 3
    else:
        crop = [ln for ln in got.splitlines() if ln.startswith("[demo] query crop:")]
        assert crop == [ln for ln in want.splitlines() if ln.startswith("[demo] query crop:")]
        assert len(res) == 3


def test_search_image_yolo_fused_refuses_a_null_detector(world, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    cfg = tmp_path / "yolo.yaml"
    cfg.write_text("model:\n  weights_path: none.npz\n")
    monkeypatch.setattr("clip_lora_match_tpu_torch.models.yolo.cropper.DEFAULT_WEIGHT_PATHS", ())
    with pytest.raises(SystemExit, match="trained detector"):
        services_cli.run(["search-image-yolo", "--index", world["custom"], "--image", "x.jpg", "--fused",
                          "--yolo-config", str(cfg), *world["enc"], "--device", "cpu"])


# -- lora.cli: export_lora ------------------------------------------------------------------


def test_export_merge_matches_jax(world, tmp_path, monkeypatch, capsys):
    """Merged leaves within 1e-6 (the fp32 A@B is summed in another order)."""
    monkeypatch.chdir(tmp_path)
    args = ["--adapter", world["adapter"], *world["enc"]]
    _run_script("export_lora", ["merge", "--out", "jax.npz", *args], monkeypatch, capsys)
    merged, printed = _run_port(lora_cli, ["merge", "--out", "port.npz", *args, "--device", "cpu"], capsys)
    assert printed.strip() == "[export_lora] merged weights -> port.npz"
    with np.load("jax.npz") as j, np.load("port.npz") as t:
        assert sorted(j.files) == sorted(t.files)
        for k in j.files:
            np.testing.assert_allclose(t[k], j[k], atol=1e-6, rtol=0, err_msg=k)
    lora, scaling = j_load_lora(world["adapter"])
    ref = jax.tree_util.tree_leaves(j_merge_lora(j_load_params(world["weights"]), lora, scaling))
    assert len(ref) == len(j_flatten(merged))


@pytest.mark.parametrize("r, alpha", [(8, 16), (6, 16)])
def test_export_peft_and_native_are_bit_equal_to_jax(world, tmp_path, monkeypatch, capsys, r, alpha):
    """native → peft → native in both packages: the same tensors, bit for
    bit, and the same configs. Both write ``LoraConfig(r=8,
    alpha=round(8 * scaling))`` whatever the rank: an r=6, alpha=16 adapter
    (scaling 8/3) comes back at alpha 21 (scaling 2.625) in both."""
    monkeypatch.chdir(tmp_path)
    src = world["adapter"]
    if r != 8:
        rng = np.random.default_rng(r)
        tree = {t: {"blocks": {"attn": {p: {"a": rng.standard_normal((2, w, r)).astype(np.float32),
                                             "b": rng.standard_normal((2, r, w)).astype(np.float32)}
                                         for p in ("q_proj", "v_proj")}}}
                for t, w in (("visual", 64), ("text", 32))}
        src = str(tmp_path / "r6")
        save_lora(src, params_from_numpy(j_flatten(tree), device="cpu"), LoraConfig(r=r, alpha=alpha))
    for side, run in (("jax", None), ("port", lora_cli)):
        for mode, a, out in (("peft", src, f"{side}_peft"), ("native", f"{side}_peft", f"{side}_native")):
            argv = [mode, "--adapter", a, "--out", out]
            if run is None:
                _run_script("export_lora", argv, monkeypatch, capsys)
            else:
                _run_port(run, [*argv, "--device", "cpu"], capsys)
    tj, tp = read_safetensors("jax_peft/adapter_model.safetensors"), read_safetensors(
        "port_peft/adapter_model.safetensors")
    assert tj.keys() == tp.keys() and all(np.array_equal(tj[k], tp[k]) for k in tj)
    for f in ("jax_peft/adapter_config.json", "jax_native/lora_config.json"):
        with open(f) as a, open(f.replace("jax", "port")) as b:
            assert json.load(a) == json.load(b)
    with np.load("jax_native/lora_weights.npz") as j, np.load("port_native/lora_weights.npz") as t:
        assert sorted(j.files) == sorted(t.files) and all(np.array_equal(j[k], t[k]) for k in j.files)
    with open("port_native/lora_config.json") as f:
        cfg = json.load(f)
    assert (cfg["r"], cfg["alpha"]) == (8, round(8 * alpha / r))


# -- tokenizer.cli: learn_bpe -----------------------------------------------------------------


def test_learn_bpe_matches_jax(world, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    for side in ("jax", "port"):
        argv = ["--csv", world["val_csv"], "--merges", "60", "--out", side]
        if side == "jax":
            _run_script("learn_bpe", argv, monkeypatch, capsys)
        else:
            (vocab, merges), printed = _run_port(tokenizer_cli, argv, capsys)
    for name in ("vocab.json", "merges.txt"):
        with open(os.path.join("jax", name), "rb") as a, open(os.path.join("port", name), "rb") as b:
            assert a.read() == b.read()
    with open(world["val_csv"], newline="", encoding="utf-8") as f:
        jv, jm = j_learn_bpe([r["text"] for r in csv.DictReader(f)], num_merges=60)
    assert vocab == jv and merges == jm and f"learned {len(jm)} merges" in printed
    assert "data/text/val_fashion.csv" in tokenizer_cli.__doc__


def test_learn_bpe_needs_out(tmp_path, monkeypatch, capsys):
    """No default --out: the script's default is the committed fixture that
    test_tokenizer_real.py reads, and the in-repo CSV would replace it."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit):
        tokenizer_cli.run(["--csv", os.path.join(REPO, "data", "text", "val_fashion.csv")])
    assert "--out" in capsys.readouterr().err and not os.listdir(tmp_path)


# -- models.cli: load and lora-inference ---------------------------------------------------------


def test_load_prints_what_the_script_prints(world, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    want = _run_script("test_clip_load", world["enc"], monkeypatch, capsys)
    out, got = _run_port(models_cli, ["load", *world["enc"], "--device", "cpu"], capsys)
    assert got.strip() == want.strip()
    assert out["dim"] == 16 and out["patch_size"] == 16


def test_lora_inference_prints_what_the_script_prints(world, tmp_path, monkeypatch, capsys):
    """The script's ``--seed`` (its sampling seed) collides with the encoder
    flags' ``--seed``, so the script does not start; it runs here with the
    encoder's ``--seed`` left out (``--weights`` makes it unused). The port
    names its sampling seed ``--sample-seed``."""
    monkeypatch.chdir(tmp_path)
    mod = _script("test_lora_inference")
    common = _script("_common")

    def add_encoder_args(p):
        p.add_argument("--clip-config", default=common.DEFAULT_CLIP_CONFIG)
        p.add_argument("--weights", default=None)
        p.add_argument("--lora", default=None)
        p.add_argument("--lora-epoch", type=int, default=None)

    monkeypatch.setattr(mod, "add_encoder_args", add_encoder_args)
    args = ["--csv", world["val_csv"], "--samples", "3", "--distractors", "4"]
    want = _run_script("test_lora_inference", [*args, *world["enc"]], monkeypatch, capsys, mod=mod)
    out, got = _run_port(models_cli, ["lora-inference", *args, *world["enc"], "--device", "cpu"], capsys)
    g, w = got.splitlines(), want.splitlines()
    assert len(g) == len(w) and out["cosine"] > 0.9999 and len(out["ranks"]) == 3
    num = re.compile(r"-?\d+\.\d{4,}")
    for a, b in zip(g, w):
        assert num.sub("#", a) == num.sub("#", b)
        for x, y in zip(num.findall(a), num.findall(b)):
            assert abs(float(x) - float(y)) <= TOL


# -- models.yolo.cli heldout ------------------------------------------------------------------------


def _labelled_photos(root) -> str:
    """Five rendered photos of three classes (one filed under two
    directories, as the committed labels file one photo twice) and their
    labels."""
    rng = np.random.default_rng(0)
    classes = ["bag", "glasses", "shoe"]
    entries = []
    for i, (cls, sub) in enumerate([("bag", "a"), ("glasses", "a"), ("shoe", "a"), ("bag", "b"),
                                    ("glasses", "b"), ("glasses", "a")]):
        name = f"photo{i if i < 5 else 1}.jpg"
        path = os.path.join("photos", sub, name)
        os.makedirs(os.path.join(root, "photos", sub), exist_ok=True)
        w, h = 120, 90
        img = Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
        box = [float(v) for v in (20 + 5 * i, 15, 80 + 3 * i, 70)]
        ImageDraw.Draw(img).rectangle(box, fill=(40 * classes.index(cls), 200, 90))
        if not os.path.exists(os.path.join(root, path)):
            img.save(os.path.join(root, path), quality=90)
        entries.append({"path": path, "width": w, "height": h, "boxes": [{"class": cls, "xyxy": box}]})
    labels = os.path.join(root, "labels.json")
    with open(labels, "w") as f:
        json.dump({"classes": classes, "images": entries}, f)
    return labels


def test_heldout_folds_equal_the_script(tmp_path):
    """``unique_photos``, ``make_folds`` and ``augment_one`` against the
    script's, over the committed labels file and the rendered one."""
    script = _script("eval_real_detect_heldout")
    corpus = _script("make_real_detect_corpus")
    for path in (os.path.join(REPO, "data", "real_labels", "real_boxes.json"), _labelled_photos(str(tmp_path))):
        with open(path) as f:
            labels = json.load(f)
        got, want = yolo_cli.unique_photos(labels), script.unique_photos(labels)
        assert got == want
        keys = [(k, es[0]["boxes"][0]["class"]) for k, es in got]
        for n, seed in ((2, 0), (3, 0), (3, 4)):
            assert yolo_cli.make_folds(keys, n, seed) == script.make_folds(keys, n, seed)
    img = Image.open(os.path.join(tmp_path, "photos", "a", "photo0.jpg")).convert("RGB")
    for seed in range(3):
        a, ba = yolo_cli.augment_one(img, [20, 15, 80, 70], random.Random(seed), 64)
        b, bb = corpus.augment_one(img, [20, 15, 80, 70], random.Random(seed), 64)
        assert ba == bb and np.array_equal(np.asarray(a), np.asarray(b))


def test_heldout_runs_in_process(tmp_path, capsys):
    """2 folds, 1 epoch, 2 variants a photo at 64²: every unique photo held
    out once, trained from the committed detector in this process."""
    labels = _labelled_photos(str(tmp_path))
    out = str(tmp_path / "heldout.json")
    pooled, printed = _run_port(yolo_cli, [
        "heldout", "--labels", labels, "--reference-root", str(tmp_path), "--init-weights", SYNTH,
        "--out", out, "--imgsz", "64", "--per-image", "2", "--epochs", "1", "--folds", "2",
        "--batch-size", "2", "--workdir", str(tmp_path / "work"), "--device", "cpu"], capsys)
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(pooled))
    assert pooled["num_unique_photos"] == 5 and pooled["num_images"] == pooled["num_gt"] == 5
    assert sorted(k for fold in pooled["folds"] for k in fold["holdout"]) == [f"photo{i}.jpg" for i in range(5)]
    for key in ("recall@0.5", "precision@0.5", "cls_accuracy", "mean_matched_iou"):
        assert 0.0 <= pooled[key] <= 1.0
    assert "[heldout] 5 unique photos (6 label entries)" in printed and "[heldout] pooled:" in printed
    for fi in range(2):
        assert os.path.exists(tmp_path / "work" / f"fold{fi}" / "weights" / f"yolov8n_heldout{fi}.npz")
    assert yolo_cli.REPO == REPO
    assert torch.get_default_dtype() == torch.float32
