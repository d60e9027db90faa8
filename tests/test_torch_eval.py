"""The evaluation job of the port (``eval/``, ``EvalConfig``, ``eval/cli.py``)
against the JAX package's ``eval/`` and ``core/config.py`` on the CPU.

The protocols take the same seeded embeddings in both packages (duplicate
rows, and queries with no relevant item) and must give the same numbers,
exactly. The evaluator and the comparator run a tiny CLIP (the same weights
in both packages) over the in-repo 60 rows, whose captions and images are
all distinct: the embeddings agree within 1e-5 (fp32) and the metrics
exactly. Every subcommand of ``eval/cli.py`` runs once with ``--device cpu``.
"""

import csv
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax

import clip_lora_match_tpu.eval as J
from clip_lora_match_tpu.core.config import ClipArchConfig as JArch
from clip_lora_match_tpu.core.config import ClipConfig as JConfig
from clip_lora_match_tpu.core.config import PreprocessConfig as JPre
from clip_lora_match_tpu.core.config import load_eval_config as j_load_eval_config
from clip_lora_match_tpu.lora.adapter import init_lora as j_init_lora
from clip_lora_match_tpu.core.config import LoraConfig as JLoraConfig
from clip_lora_match_tpu.models import clip as jclip
from clip_lora_match_tpu.models.encoder import ClipEncoder as JEncoder
from clip_lora_match_tpu.models.io import flatten_params as j_flatten
from clip_lora_match_tpu.models.io import save_params as j_save_params
from clip_lora_match_tpu.nn import layers as jlayers
import clip_lora_match_tpu_torch.eval as T
from clip_lora_match_tpu_torch.core.config import ClipArchConfig as TArch
from clip_lora_match_tpu_torch.core.config import ClipConfig as TConfig
from clip_lora_match_tpu_torch.core.config import LoraConfig
from clip_lora_match_tpu_torch.core.config import PreprocessConfig as TPre
from clip_lora_match_tpu_torch.core.config import load_eval_config
from clip_lora_match_tpu_torch.eval import cli
from clip_lora_match_tpu_torch.lora.adapter import save_lora
from clip_lora_match_tpu_torch.models.encoder import ClipEncoder as TEncoder
from clip_lora_match_tpu_torch.models.io import params_from_numpy
from tests._torch_helpers import random_like_tree, to_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGES = os.path.join(REPO, "data", "text", "images")
TINY_KW = dict(
    image_size=32, patch_size=16, vision_width=64, vision_layers=2, vision_heads=4,
    vision_mlp_dim=128, vocab_size=600, max_text_length=77, text_width=32, text_layers=2,
    text_heads=4, text_mlp_dim=64, projection_dim=16,
)


def _rows():
    rows = []
    for name in ("val_fashion.csv", "train_fashion.csv"):
        with open(os.path.join(REPO, "data", "text", name), newline="", encoding="utf-8") as f:
            rows += list(csv.DictReader(f))
    return rows


def _write_csv(path, header, rows):
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)
    return str(path)


@pytest.fixture(scope="module")
def csv60(tmp_path_factory):
    """The in-repo val + train rows (60), image paths as the repo lists them:
    they resolve against ``image_root`` by their basename."""
    d = tmp_path_factory.mktemp("csv")
    return _write_csv(d / "all.csv", ["image_path", "text"], [(r["image_path"], r["text"]) for r in _rows()])


# -- config --------------------------------------------------------------------


@pytest.mark.parametrize("path", ["config/evaluation_config.yaml", "no/such/file.yaml"])
def test_load_eval_config_matches_jax(path):
    path = os.path.join(REPO, path)
    got, want = load_eval_config(path), j_load_eval_config(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]


def test_load_eval_config_reads_every_block(tmp_path):
    p = tmp_path / "e.yaml"
    p.write_text("paths:\n  val_csv: v.csv\n  lora_dir: adapters\nmodels:\n  lora_epochs: [1, 2, 3]\n"
                 "evaluation:\n  recall_k_values: [1, 3]\n  embedding_viz_method: pca\n  skip_qualitative: true\n")
    got, want = load_eval_config(str(p)), j_load_eval_config(str(p))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.lora_epochs == (1, 2, 3) and got.recall_k_values == (1, 3) and got.skip_qualitative


# -- load_eval_csv --------------------------------------------------------------------


@pytest.mark.parametrize("cols", [("image_path", "text"), ("image", "caption"), ("img_path", "description"),
                                  ("filepath", "productDisplayName")])
def test_load_eval_csv_column_aliases_match_jax(tmp_path, cols):
    rows = [(r["image_path"], r["text"]) for r in _rows()[:8]]
    path = _write_csv(tmp_path / "a.csv", ["id", *cols], [(i, *r) for i, r in enumerate(rows)])
    got, want = T.load_eval_csv(path, IMAGES), J.load_eval_csv(path, IMAGES)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert len(got.texts) == 8 and got.skipped == 0


def test_load_eval_csv_path_resolutions_match_jax(tmp_path):
    """As given, under the root, by basename under the root; a missing
    image is skipped (or kept as given without ``require_images``);
    ``max_rows`` stops early."""
    first = sorted(os.listdir(IMAGES))[:3]
    rows = [
        (os.path.join(IMAGES, first[0]), "as given"),
        (first[1], "under the root"),
        (os.path.join("elsewhere", "deep", first[2]), "by basename"),
        ("missing.jpg", "no such image"),
        (first[0], "again"),
    ]
    path = _write_csv(tmp_path / "p.csv", ["image_path", "text"], rows)
    for kw in ({}, {"require_images": False}, {"max_rows": 2}, {"max_rows": 4, "require_images": False}):
        got, want = T.load_eval_csv(path, IMAGES, **kw), J.load_eval_csv(path, IMAGES, **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), kw
    got = T.load_eval_csv(path, IMAGES)
    assert got.skipped == 1 and got.texts == ["as given", "under the root", "by basename", "again"]
    assert all(os.path.exists(p) for p in got.image_paths)


def test_load_eval_csv_refuses_unknown_columns(tmp_path):
    path = _write_csv(tmp_path / "x.csv", ["picture", "words"], [("a.jpg", "b")])
    with pytest.raises(ValueError, match="could not detect"):
        T.load_eval_csv(path)


# -- protocols ----------------------------------------------------------------------------


def _embeds(case: str):
    """(images, texts) unit rows: clustered so that the 0.7 threshold holds
    for some pairs and not others."""
    rng = np.random.default_rng({"random": 1, "duplicates": 2, "no_relevant": 3}[case])
    n, d = 40, 16
    centres = rng.normal(size=(6, d))
    lab = rng.integers(0, 6, n)
    img = centres[lab] + 0.6 * rng.normal(size=(n, d))
    txt = img + 0.4 * rng.normal(size=(n, d))
    if case == "duplicates":  # repeated captions and images: exact ties
        txt[[5, 6, 7]] = txt[4]
        img[[12, 13]] = img[11]
        txt[20] = txt[30]
    if case == "no_relevant":  # queries far from everything
        txt[:4] = 3.0 * rng.normal(size=(4, d))
    return img.astype(np.float32), txt.astype(np.float32)


CASES = ["random", "duplicates", "no_relevant"]


@pytest.mark.parametrize("case", CASES)
def test_similarity_matrix_matches_jax(case):
    img, txt = _embeds(case)
    got, want = T.similarity_matrix(img, txt), J.similarity_matrix(img, txt)
    assert got.dtype == np.float32 and got.shape == (40, 40)
    # one fp32 product each, summed in another order: an ulp apart
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(T.similarity_matrix(torch.from_numpy(img), torch.from_numpy(txt)), got,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", CASES)
def test_diagonal_metrics_match_jax(case):
    img, txt = _embeds(case)
    assert T.diagonal_metrics(img, txt) == J.diagonal_metrics(img, txt)
    assert T.diagonal_metrics(img, txt, ks=(1, 2, 3)) == J.diagonal_metrics(img, txt, ks=(1, 2, 3))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("exclude_self", [False, True])
def test_threshold_metrics_match_jax(case, exclude_self):
    img, txt = _embeds(case)
    for q, idx in ((txt, txt), (txt, img)):
        got = T.threshold_metrics(q, idx, exclude_self=exclude_self, measure_latency=False)
        want = J.threshold_metrics(q, idx, exclude_self=exclude_self, measure_latency=False)
        assert got == want
    got = T.threshold_metrics(txt, img, exclude_self=exclude_self)
    assert got["avg_query_time_ms"] >= 0
    if case == "no_relevant":  # the far captions have no image at 0.7
        assert 0 < got["num_queries_with_relevant"] < got["num_queries"]


@pytest.mark.parametrize("case", CASES)
def test_find_failure_cases_match_jax(case):
    img, txt = _embeds(case)
    texts = [f"caption {i}" for i in range(40)]
    got = T.find_failure_cases(img, txt, texts, num_cases=8, k=5)
    want = J.find_failure_cases(img, txt, texts, num_cases=8, k=5)
    assert [dataclasses.asdict(c) for c in got] == [dataclasses.asdict(c) for c in want]


def test_relative_improvement_and_summaries_match_jax():
    base = {"recall@1": 0.2, "mrr": 0.0, "num": 3, "name": "x"}
    res = {J.BASE_NAME: base, J.epoch_name(1): {"recall@1": 0.3, "mrr": 0.1, "num": 4},
           J.epoch_name(2): {"recall@1": 0.25, "mrr": 0.2, "num": 4}}
    assert T.relative_improvement(base, res[J.epoch_name(1)]) == J.relative_improvement(base, res[J.epoch_name(1)])
    assert T.ModelComparator.summary(res) == J.ModelComparator.summary(res)
    assert T.ModelComparator.epoch_over_epoch(res) == J.ModelComparator.epoch_over_epoch(res)
    assert T.BASE_NAME == J.BASE_NAME and T.epoch_name(3) == J.epoch_name(3)
    assert T.__all__ == J.__all__


# -- report ----------------------------------------------------------------------------------


def _report_cases():
    e1 = {"recall@1": 0.5, "recall@5": 0.8, "recall@10": 0.9, "mrr": 0.6, "map": 0.6, "matching_accuracy": 0.5}
    base = {k: v / 2 for k, v in e1.items()}
    chance = {k: 0.001 for k in e1}
    worse = {k: v / 4 for k, v in e1.items()}
    return {
        "lift": {J.BASE_NAME: base, J.epoch_name(1): e1},
        "chance_base": {J.BASE_NAME: chance, J.epoch_name(1): e1, J.epoch_name(2): base},
        "no_lift": {J.BASE_NAME: e1, J.epoch_name(1): worse},
        "base_only": {J.BASE_NAME: base},
    }


@pytest.mark.parametrize("case", sorted(_report_cases()))
def test_report_text_matches_jax(tmp_path, case):
    results = _report_cases()[case]
    imp = J.ModelComparator.epoch_over_epoch(results)
    t = T.create_evaluation_report(results, str(tmp_path / "t" / "r.md"), imp, "Improvement (epoch over epoch)")
    j = J.create_evaluation_report(results, str(tmp_path / "j" / "r.md"), imp, "Improvement (epoch over epoch)")

    def body(path):
        with open(path) as f:
            return [ln for ln in f.read().splitlines() if not ln.startswith("**Generated:**")]

    assert body(t) == body(j) and len(body(t)) > 10


def test_plots_are_skipped_without_matplotlib(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    case = T.FailureCase(0, "q", 2, 0.5, 1.5, [1, 0], [0.9, 0.5])
    img, txt = _embeds("random")
    assert T.plot_failure_grids([case], [], str(tmp_path / "q"), k=2) == []
    assert T.plot_embedding_space(img, txt, str(tmp_path / "e.png")) is None
    assert T.ModelComparator.plot_all({J.BASE_NAME: {"recall@1": 1.0}}, str(tmp_path / "p")) == []
    assert not os.path.exists(tmp_path / "p")


# -- the evaluator and the comparator at a tiny arch ------------------------------------------


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """JAX and port encoders over one tiny arch and the same weights, the
    weights as an .npz, a clip config for the CLI, and two adapters saved by
    the port (epochs 1 and 2) beside a missing epoch 3."""
    d = tmp_path_factory.mktemp("tiny")
    jarch, tarch = JArch(**TINY_KW), TArch(**TINY_KW)
    params = jclip.init_params(jax.random.PRNGKey(0), jarch)
    flags = dict(jlayers._KERNEL_FLAGS)  # the JAX encoder sets them process-wide
    jenc = JEncoder(params, arch=jarch, config=JConfig(arch=jarch, preprocess=JPre(image_size=32)),
                    compute_dtype="float32")
    jlayers._KERNEL_FLAGS.update(flags)
    tenc = TEncoder(params_from_numpy(j_flatten(params), device="cpu"), arch=tarch,
                    config=TConfig(arch=tarch, preprocess=TPre(image_size=32)), compute_dtype="float32",
                    device="cpu")
    weights = str(d / "base.npz")
    j_save_params(weights, params)
    lora_dir = d / "adapters"
    for k in (1, 2):
        lora = random_like_tree(j_init_lora(jax.random.PRNGKey(k), jarch, JLoraConfig()), seed=k, scale=0.2)
        save_lora(str(lora_dir / f"epoch_{k}"), params_from_numpy(j_flatten(to_jax(lora)), device="cpu"),
                  LoraConfig())
    arch_yaml = "\n".join(f"    {k}: {v}" for k, v in TINY_KW.items())
    clip_yaml = d / "clip.yaml"
    clip_yaml.write_text(f"model:\n  name: openai/clip-vit-base-patch32\n  arch:\n{arch_yaml}\n"
                         f"preprocess:\n  image_size: 32\n")
    return dict(jenc=jenc, tenc=tenc, weights=weights, lora_dir=str(lora_dir), clip_yaml=str(clip_yaml), dir=d)


def test_clip_evaluator_matches_jax(tiny, csv60):
    data = T.load_eval_csv(csv60, IMAGES)
    assert len(data.texts) == 60 and len(set(data.texts)) == 60
    tev, jev = T.CLIPEvaluator(tiny["tenc"]), J.CLIPEvaluator(tiny["jenc"])
    timg, ttxt = tev.encode_dataset(data)
    jimg, jtxt = jev.encode_dataset(J.EvalData(data.image_paths, data.texts))
    assert timg.shape == ttxt.shape == (60, 16) and timg.dtype == np.float32
    np.testing.assert_allclose(timg, jimg, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ttxt, jtxt, atol=1e-5, rtol=0)
    got, want = tev.evaluate(data), jev.evaluate(J.EvalData(data.image_paths, data.texts))
    for g in (got, want):
        g["threshold"].pop("avg_query_time_ms")
    assert got == want
    assert tev.evaluation_results_artifact(data) == jev.evaluation_results_artifact(
        J.EvalData(data.image_paths, data.texts))


def test_model_comparator_matches_jax(tiny, csv60):
    """Base, two adapters written by the port's ``save_lora`` (JAX's
    ``load_lora`` reads them) and a missing epoch, skipped; the encoder's
    own adapter is put back."""
    data = T.load_eval_csv(csv60, IMAGES)
    tenc, jenc = tiny["tenc"], tiny["jenc"]
    own = {"visual": {"blocks": {}}, "text": {"blocks": {}}}
    tenc.attach_lora(own, 0.5)
    got = T.ModelComparator(tenc, tiny["lora_dir"], epochs=[1, 2, 3]).compare(data)
    assert tenc.lora is not None and tenc.lora_scaling == 0.5 and tenc.lora["visual"] == {"blocks": {}}
    tenc.attach_lora(None, 1.0)
    want = J.ModelComparator(jenc, tiny["lora_dir"], epochs=[1, 2, 3]).compare(
        J.EvalData(data.image_paths, data.texts))
    assert list(got) == [T.BASE_NAME, T.epoch_name(1), T.epoch_name(2)]
    assert got == want
    assert got[T.epoch_name(1)] != got[T.BASE_NAME]


# -- the entry points ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def eval_yaml(tiny, tmp_path_factory):
    d = tmp_path_factory.mktemp("evalrun")
    val = _write_csv(d / "val.csv", ["image_path", "text"], [(r["image_path"], r["text"]) for r in _rows()[:12]])
    out = d / "results"
    p = d / "eval.yaml"
    p.write_text(
        f"paths:\n  val_csv: {val}\n  image_root: {IMAGES}\n  lora_dir: {tiny['lora_dir']}\n"
        f"  results_dir: {out}\n  plots_dir: {out / 'plots'}\n  qualitative_dir: {out / 'qualitative'}\n"
        "models:\n  lora_epochs: [1, 2, 3]\nevaluation:\n  recall_k_values: [1, 5, 10]\n"
        "  num_failure_cases: 3\n  num_top_k_visualize: 3\n  embedding_viz_method: pca\n"
    )
    return str(p), out


def _cli(tiny, eval_yaml, *args):
    return cli.run([*args, "--eval-config", eval_yaml[0], "--clip-config", tiny["clip_yaml"],
                    "--weights", tiny["weights"], "--device", "cpu"])


SUBCOMMANDS = ["evaluate", "evaluate-model", "compare", "qualitative", "run-all", "similarity"]


@pytest.mark.parametrize("command", SUBCOMMANDS)
def test_eval_cli_subcommand_on_the_cpu(tiny, eval_yaml, command, tmp_path):
    import json

    out = eval_yaml[1]
    if command == "evaluate":
        res = _cli(tiny, eval_yaml, command)
        assert list(res) == ["base", "epoch_1", "epoch_2"]
        with open(out / "evaluation_results_threshold.json") as f:
            assert json.load(f) == res
        assert res["base"]["num_queries"] == 12
    elif command == "evaluate-model":
        res = _cli(tiny, eval_yaml, command, "--out", str(tmp_path / "a.json"))
        assert set(res) == {"retrieval", "matching_accuracy"} and "recall@10" in res["retrieval"]
        ev = T.CLIPEvaluator(tiny["tenc"])
        assert res == ev.evaluation_results_artifact(T.load_eval_csv(_val(eval_yaml), IMAGES))
    elif command == "compare":
        res = _cli(tiny, eval_yaml, command, "--out", str(tmp_path / "c.json"))
        assert list(res) == [T.BASE_NAME, T.epoch_name(1), T.epoch_name(2)]
        assert sorted(os.listdir(out / "plots")) >= ["metrics_heatmap.png", "radar_comparison.png",
                                                     "recall_comparison.png"]
    elif command == "qualitative":
        res = _cli(tiny, eval_yaml, command)
        assert len(res["cases"]) == 3 and len(res["grids"]) == 3 and res["embedding_plot"].endswith(".png")
    elif command == "run-all":
        res = _cli(tiny, eval_yaml, command)
        for name in ("evaluation_results.json", "model_comparison.json", "evaluation_report.md"):
            assert os.path.exists(out / name)
        with open(out / "model_comparison.json") as f:
            assert json.load(f) == res["comparison"]
        with open(res["report"]) as f:
            assert "## 1. Model Comparison" in f.read()
    else:
        from clip_lora_match_tpu_torch.index import EmbeddingIndex

        rng = np.random.default_rng(4)
        path = str(tmp_path / "index.npz")
        EmbeddingIndex(rng.normal(size=(300, 16)).astype(np.float32), device="cpu").save(path)
        res = cli.run([command, "--index", path, "--queries", "8", "--k", "5", "--iters", "2", "--device", "cpu"])
        assert res["ids"].shape == (8, 5) and res["rows"] == 300 and res["queries_per_s"] > 0
        from clip_lora_match_tpu.retrieval import top_k_similar as j_top_k

        _, want = j_top_k(res["queries"], np.asarray(EmbeddingIndex.load(path, device="cpu").embeddings),
                          5, assume_normalized=True)
        np.testing.assert_array_equal(res["ids"], np.asarray(want))


def _val(eval_yaml):
    return load_eval_config(eval_yaml[0]).val_csv


def test_eval_cli_wants_cuda_unless_asked(tiny, eval_yaml):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.run(["evaluate-model", "--eval-config", eval_yaml[0], "--clip-config", tiny["clip_yaml"]])
