"""Faults of the port against the JAX package, each held on the CPU:

- an empty ``image_path`` is no image (the JAX seeker tests ``not image_path``);
- a ``.pt`` index path reads and writes the reference's legacy torch dict, in
  both directions between the packages;
- ``k`` past the streaming kernel's ``K_MAX`` takes the exact mid-band route
  below ``TWOPASS_MIN_N`` instead of the kernel's refusal;
- ``model.quantize`` and ``model.compilation_cache_dir`` are read as the JAX
  loader reads them, and ``quantize: int8`` builds the W8A8 encoder the JAX
  package builds;
- ``k == 0`` gives an empty result and ``k < 0`` raises, on every top-k route
  and through ``SearchIndex`` and ``top_k_similar``;
- ``SearchIndex.search_batch`` takes a (D,) query as one query;
- a corrupt detector checkpoint is logged and the next candidate loads.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from clip_lora_match_tpu.core.config import ClipConfig as JConfig
from clip_lora_match_tpu.core.config import LoraConfig as JLoraConfig
from clip_lora_match_tpu.core.config import load_clip_config as j_load_clip_config
from clip_lora_match_tpu.index.store import EmbeddingIndex as JIndex
from clip_lora_match_tpu.lora.adapter import init_lora as j_init_lora
from clip_lora_match_tpu.models import clip as jclip
from clip_lora_match_tpu.models.encoder import ClipEncoder as JEncoder
from clip_lora_match_tpu.models.io import flatten_params as j_flatten
from clip_lora_match_tpu.models.yolo.cropper import load_yolo_cropper as j_load_yolo_cropper
from clip_lora_match_tpu.nn import layers as jlayers
from clip_lora_match_tpu.retrieval.search import SearchIndex as JSearchIndex
from clip_lora_match_tpu.retrieval.similarity import top_k_similar as j_top_k_similar
from clip_lora_match_tpu.services.seeker import SeekerConfig as JSeekerConfig
from clip_lora_match_tpu.services.seeker import SeekerService as JSeeker
from clip_lora_match_tpu_torch.core.config import ClipConfig as TConfig
from clip_lora_match_tpu_torch.core.config import load_clip_config
from clip_lora_match_tpu_torch.index.store import EmbeddingIndex as TIndex
from clip_lora_match_tpu_torch.models.encoder import ClipEncoder as TEncoder
from clip_lora_match_tpu_torch.models.io import params_from_numpy
from clip_lora_match_tpu_torch.models.yolo.cropper import load_yolo_cropper
from clip_lora_match_tpu_torch.models.yolo.yolov8 import YoloV8Detector
from clip_lora_match_tpu_torch.ops import retrieval_topk as R
from clip_lora_match_tpu_torch.retrieval.search import SearchIndex as TSearchIndex
from clip_lora_match_tpu_torch.retrieval.similarity import top_k_similar
from clip_lora_match_tpu_torch.services.seeker import SeekerConfig as TSeekerConfig
from clip_lora_match_tpu_torch.services.seeker import SeekerService as TSeeker
from tests._torch_helpers import J_SMALL, T_SMALL, random_like_tree, to_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGES = os.path.join(REPO, "data", "custom", "images")
DIM = J_SMALL.projection_dim


def _unit_rows(seed, n, d=DIM):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _assert_ids_tie_aware(ids, ref_ids, ref_scores, tol):
    """Ids equal wherever the reference's scores are more than ``tol`` from a
    neighbour; inside a tie group the ids match as a set."""
    ids, ref_ids, ref_scores = (np.asarray(a) for a in (ids, ref_ids, ref_scores))
    start = 0
    for p in range(1, len(ref_ids) + 1):
        if p == len(ref_ids) or ref_scores[p - 1] - ref_scores[p] > tol:
            assert set(ids[start:p].tolist()) == set(ref_ids[start:p].tolist()), (start, p)
            start = p


# -- 1. an empty image_path ------------------------------------------------------


@pytest.fixture(scope="module")
def seekers():
    """(JAX seeker, port seeker) with the same weights, LoRA and index."""
    params = jclip.init_params(jax.random.PRNGKey(0), J_SMALL)
    lora = to_jax(random_like_tree(j_init_lora(jax.random.PRNGKey(1), J_SMALL, JLoraConfig())))
    jflags = dict(jlayers._KERNEL_FLAGS)  # the JAX encoder sets them process-wide
    jenc = JEncoder(params, arch=J_SMALL, config=JConfig(arch=J_SMALL), lora=lora, lora_scaling=2.0)
    jlayers._KERNEL_FLAGS.update(jflags)
    tenc = TEncoder(
        params_from_numpy(j_flatten(params), device="cpu"), arch=T_SMALL,
        config=TConfig(arch=T_SMALL), device="cpu",
    )
    tenc.attach_lora(params_from_numpy(j_flatten(lora), device="cpu"), 2.0)
    names = sorted(os.listdir(IMAGES))
    texts = [os.path.splitext(n)[0].replace("_", " ") for n in names]
    noise = _unit_rows(4, 190)
    meta = [f"item{i}" for i in range(len(texts) + 190)]
    j_rows = np.concatenate([jenc.encode_text(texts), noise])
    t_rows = np.concatenate([tenc.encode_text(texts), noise])
    jseek = JSeeker(jenc, JSeekerConfig(), index=JIndex(j_rows, meta, meta))
    tseek = TSeeker(tenc, TSeekerConfig(), index=TIndex(t_rows, meta, meta, device="cpu"))
    return jseek, tseek


@pytest.mark.parametrize("image_path", ["", None])
def test_seeker_empty_image_path_is_no_image(seekers, image_path):
    jseek, tseek = seekers
    jres = jseek.search_items(description="tas pink", image_path=image_path)
    tres = tseek.search_items(description="tas pink", image_path=image_path)
    js = [r.score for r in jres]
    assert len(tres) == len(jres) == 5
    np.testing.assert_allclose([r.score for r in tres], js, atol=1e-4)
    _assert_ids_tie_aware([r.index for r in tres], [r.index for r in jres], js, 1e-4)


def test_seeker_empty_image_path_alone_raises_as_jax(seekers):
    jseek, tseek = seekers
    with pytest.raises(ValueError) as jerr:
        jseek.search_items(image_path="")
    with pytest.raises(ValueError) as terr:
        tseek.search_items(image_path="")
    assert str(terr.value) == str(jerr.value)


def test_seeker_a_pil_image_stays_an_image(seekers):
    _, tseek = seekers
    img = Image.open(os.path.join(IMAGES, sorted(os.listdir(IMAGES))[0])).convert("RGB")
    both = tseek.search_items(description="tas pink", image_path=img)
    text = tseek.search_items(description="tas pink")
    assert [r.score for r in both] != [r.score for r in text]


# -- 2. the legacy .pt index -----------------------------------------------------


def test_pt_index_written_by_jax_loads_in_the_port(tmp_path):
    rows = _unit_rows(1, 4)
    path = str(tmp_path / "idx.pt")
    JIndex(rows, ["a.jpg", "b.jpg", "c.jpg", "d.jpg"], ["a", "b", "c", "d"]).save(path)
    got = TIndex.load(path, device="cpu")  # weights_only=True takes the JAX file
    assert len(got) == 4
    np.testing.assert_allclose(got.embeddings_np(), rows, atol=1e-6)
    assert got.image_paths == ["a.jpg", "b.jpg", "c.jpg", "d.jpg"]
    assert got.texts == ["a", "b", "c", "d"]


def test_pt_index_written_by_the_port_loads_in_jax(tmp_path):
    rows = _unit_rows(2, 5)
    paths, texts = [f"p{i}.jpg" for i in range(5)], [f"t{i}" for i in range(5)]
    index = TIndex(rows, paths, texts, capacity=64, device="cpu")
    path = str(tmp_path / "port.pt")
    index.save(path)
    assert sorted(os.listdir(tmp_path)) == ["port.pt"]  # no port.pt.npz, no .json
    data = torch.load(path, weights_only=True)
    assert data["embeddings"].dtype == torch.float32 and data["embeddings"].shape == (5, DIM)
    assert isinstance(data["image_paths"], list) and isinstance(data["texts"], list)
    got = JIndex.load(path)
    assert len(got) == 5
    np.testing.assert_allclose(np.asarray(got.embeddings), rows, atol=1e-6)
    assert got.image_paths == paths and got.texts == texts
    back = TIndex.load(path, device="cpu")
    np.testing.assert_array_equal(back.embeddings_np(), index.embeddings_np())


def test_pt_index_singular_keys_missing_and_unrecognized(tmp_path):
    rows = _unit_rows(3, 3)
    single = str(tmp_path / "single.pt")
    torch.save({"embeddings": torch.from_numpy(rows), "image_path": ["x", "y", "z"],
                "text": ["u", "v", "w"]}, single)
    got, jgot = TIndex.load(single, device="cpu"), JIndex.load(single)
    assert got.image_paths == jgot.image_paths == ["x", "y", "z"]
    assert got.texts == jgot.texts == ["u", "v", "w"]
    np.testing.assert_allclose(got.embeddings_np(), np.asarray(jgot.embeddings), atol=1e-6)
    missing = TIndex.load(str(tmp_path / "none.pt"), dim=DIM, device="cpu")
    assert len(missing) == 0 and missing.dim == DIM
    assert not (tmp_path / "none.pt.npz").exists()
    torch.save({"rows": torch.zeros(2, 4)}, str(tmp_path / "other.pt"))
    (tmp_path / "junk.pt").write_bytes(b"not a torch file")
    for name in ("other.pt", "junk.pt"):
        with pytest.raises(ValueError):
            TIndex.load(str(tmp_path / name), device="cpu")


# -- 3. k past the kernel's K_MAX ------------------------------------------------


def test_auto_takes_the_mid_band_route_past_k_max(monkeypatch):
    rows = _unit_rows(5, 1000)
    rows[700] = rows[3]  # a tie: the lower id first
    query = rows[3] * 3.0
    taken = []
    mid = R.topk_retrieve_midscale

    def midscale(*a, **kw):
        taken.append("midscale")
        return mid(*a, **kw)

    def kernel(*a, **kw):
        raise AssertionError("k > K_MAX reached the streaming kernel's wrapper")

    monkeypatch.setattr(R, "topk_retrieve_midscale", midscale)
    monkeypatch.setattr(R, "topk_retrieve", kernel)
    s, i = R.topk_retrieve_auto(torch.from_numpy(query[None]), torch.from_numpy(rows), 300)
    assert taken == ["midscale"] and s.shape == i.shape == (1, 300)
    js, ji = j_top_k_similar(jnp.asarray(query), jnp.asarray(rows), k=300)
    np.testing.assert_allclose(s[0].numpy(), np.asarray(js), atol=1e-5)
    _assert_ids_tie_aware(i[0].numpy(), ji, js, 1e-5)
    assert i[0, :2].tolist() == [3, 700]


def test_top_k_similar_past_k_max_matches_jax():
    rows = _unit_rows(7, 1000)
    queries = np.random.default_rng(8).normal(size=(3, DIM)).astype(np.float32)
    s, i = top_k_similar(queries, torch.from_numpy(rows), k=300)
    js, ji = j_top_k_similar(jnp.asarray(queries), jnp.asarray(rows), k=300)
    assert s.shape == i.shape == (3, 300)
    np.testing.assert_allclose(s, np.asarray(js), atol=1e-5)
    for q in range(3):
        _assert_ids_tie_aware(i[q], np.asarray(ji)[q], np.asarray(js)[q], 1e-5)


# -- 4. model.quantize and model.compilation_cache_dir ---------------------------


def _tiny_yaml(path, extra):
    arch = "\n".join(f"    {k}: {v}" for k, v in [
        ("image_size", 64), ("patch_size", 32), ("vision_width", 128), ("vision_layers", 1),
        ("vision_heads", 2), ("vision_mlp_dim", 256), ("text_width", 128), ("text_layers", 1),
        ("text_heads", 2), ("text_mlp_dim", 256), ("vocab_size", 514), ("projection_dim", 64),
    ])
    path.write_text(f"model:\n  name: openai/clip-vit-base-patch32\n{extra}  arch:\n{arch}\n")
    return str(path)


def test_quantize_int8_is_refused(tmp_path):
    """Since W8A8 is ported, ``quantize: int8`` is no longer refused: it
    builds an int8 encoder that matches the JAX package's int8 encoder on the
    same weights, and an unknown mode raises ValueError in both packages."""
    cfg = _tiny_yaml(tmp_path / "int8.yaml", "  quantize: int8\n")
    assert load_clip_config(cfg).quantize == j_load_clip_config(cfg).quantize == "int8"
    with pytest.warns(UserWarning):
        tenc = TEncoder.from_config(cfg, device="cpu")
    assert tenc.quantize == "int8"
    jcfg = j_load_clip_config(cfg)
    jparams = jclip.init_params(jax.random.PRNGKey(0), jcfg.arch)
    jenc = JEncoder(jparams, arch=jcfg.arch, config=dataclasses.replace(jcfg, use_pallas_kernels=False))
    assert jenc.quantize == "int8"
    tenc = TEncoder(params_from_numpy(j_flatten(jparams), device="cpu"), config=load_clip_config(cfg),
                    device="cpu")
    texts = ["tas pink di kantin", "payung hitam"]
    got, ref = tenc.encode_text(texts), jenc.encode_text(texts)
    cos = (got * ref).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(ref, axis=1))
    assert cos.min() >= 0.99999, cos
    bad = _tiny_yaml(tmp_path / "int4.yaml", "  quantize: int4\n")
    with pytest.raises(ValueError, match="int4"):
        TEncoder({}, config=load_clip_config(bad), device="cpu")
    with pytest.raises(ValueError):
        JEncoder(jparams, arch=jcfg.arch, config=j_load_clip_config(bad))


def test_quantize_none_and_the_cache_dir_load_as_jax(tmp_path):
    cfg = _tiny_yaml(tmp_path / "none.yaml",
                     "  quantize: none\n  compilation_cache_dir: .jax_cache\n")
    tcfg, jcfg = load_clip_config(cfg), j_load_clip_config(cfg)
    assert (tcfg.quantize, tcfg.compilation_cache_dir) == (jcfg.quantize, jcfg.compilation_cache_dir)
    assert (tcfg.quantize, tcfg.compilation_cache_dir) == ("none", ".jax_cache")
    with pytest.warns(UserWarning):
        enc = TEncoder.from_config(cfg, device="cpu")
    assert enc.cfg.compilation_cache_dir == ".jax_cache"
    assert np.isfinite(enc.encode_text("tas pink")).all()
    default = load_clip_config(_tiny_yaml(tmp_path / "plain.yaml", ""))
    assert (default.quantize, default.compilation_cache_dir) == ("none", None)


# -- 5. k == 0 and k < 0 below the seeker ----------------------------------------


def _search_indexes(quantize, n=300):
    rows = _unit_rows(11, n)
    meta = [f"item{i}" for i in range(n)]
    j = JSearchIndex(JIndex(rows, meta, meta), dim=DIM, quantize=quantize)
    t = TSearchIndex(TIndex(rows, meta, meta, device="cpu"), dim=DIM, quantize=quantize, device="cpu")
    return rows, j, t


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_search_index_k0_is_empty_and_negative_k_raises_as_jax(quantize):
    rows, j, t = _search_indexes(quantize)
    q = rows[17] * 2.0
    assert t.search_with_embedding(q, 0) == j.search_with_embedding(q, 0) == []
    assert t.search_batch(np.stack([q, rows[3]]), 0) == j.search_batch(np.stack([q, rows[3]]), 0) == [[], []]
    with pytest.raises(ValueError):
        j.search_with_embedding(q, -1)
    with pytest.raises(ValueError):
        t.search_with_embedding(q, -1)
    with pytest.raises(ValueError):
        t.search_batch(q[None], -1)


@pytest.mark.parametrize("single", [True, False])
def test_top_k_similar_k0_and_negative_k_as_jax(single):
    rows = _unit_rows(12, 300)
    q = np.random.default_rng(13).normal(size=(2, DIM)).astype(np.float32)
    q = q[0] if single else q
    s, i = top_k_similar(q, torch.from_numpy(rows), k=0)
    js, ji = j_top_k_similar(jnp.asarray(q), jnp.asarray(rows), k=0)
    assert s.shape == i.shape == np.shape(js) == np.shape(ji) == ((0,) if single else (2, 0))
    assert (s.dtype, i.dtype) == (np.float32, np.int32)
    with pytest.raises(ValueError):
        j_top_k_similar(jnp.asarray(q), jnp.asarray(rows), k=-1)
    with pytest.raises(ValueError):
        top_k_similar(q, torch.from_numpy(rows), k=-1)


def _route(name, q, rows, k):
    if name == "auto":
        return R.topk_retrieve_auto(q, rows, k)
    if name == "midscale":
        return R.topk_retrieve_midscale(q, rows, k)
    if name == "twopass":
        return R.topk_retrieve_twopass(q, rows, k, tile=16)
    return R.topk_retrieve_q8(q, *R.quantize_index_int8(rows), k, tile=16)


@pytest.mark.parametrize("n", [300, 70_000])  # below and at TWOPASS_MIN_N
@pytest.mark.parametrize("route", ["auto", "midscale", "twopass", "q8"])
def test_every_top_k_route_gives_k0_empty_and_refuses_negative_k(route, n):
    """``topk_retrieve_auto(q, E, 0)`` on CPU tensors is the call the CUDA
    branch of ``top_k_similar`` makes."""
    rows = torch.from_numpy(_unit_rows(14, n, 32))
    q = torch.from_numpy(np.random.default_rng(15).normal(size=(3, 32)).astype(np.float32))
    s, i = _route(route, q, rows, 0)
    assert s.shape == i.shape == (3, 0) and (s.dtype, i.dtype) == (torch.float32, torch.int32)
    with pytest.raises(ValueError):
        _route(route, q, rows, -1)
    s1, i1 = _route(route, q, rows, 1)  # k = 1 still answers
    assert s1.shape == i1.shape == (3, 1)


# -- 6. search_batch with a (D,) query --------------------------------------------


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_search_batch_takes_a_1d_query_as_one_query(quantize):
    """The JAX package's int8 ``search_batch`` fails on a (D,) query
    (``topk_retrieve_q8`` reads ``queries.shape[1]``), so there the port is
    held to its own (1, D) search, which the float route shows equal to
    JAX's."""
    rows, j, t = _search_indexes(quantize)
    q = rows[42] + 0.1 * rows[7]
    tres = t.search_batch(q, 5)
    jres = j.search_batch(q[None] if quantize == "int8" else q, 5)
    assert len(tres) == len(jres) == 1 and len(tres[0]) == 5
    assert [r.index for r in tres[0]] == [r.index for r in jres[0]]
    np.testing.assert_allclose([r.score for r in tres[0]], [r.score for r in jres[0]], atol=1e-5)
    assert tres[0] == t.search_with_embedding(q, 5)


# -- 7. a corrupt detector checkpoint ---------------------------------------------


def test_a_truncated_detector_checkpoint_falls_back_to_the_committed_one(tmp_path, caplog):
    synth = os.path.join(REPO, "models", "yolo_synth", "yolov8n_synth.npz")
    data = open(synth, "rb").read()
    half = tmp_path / "yolov8n_half.npz"
    half.write_bytes(data[: len(data) // 2])
    jc = j_load_yolo_cropper(weights_path=str(half))
    with caplog.at_level("WARNING"):
        tc = load_yolo_cropper(weights_path=str(half), device="cpu")
    assert type(jc.detector).__name__ == type(tc.detector).__name__ == "YoloV8Detector"
    assert any("yolov8n_half.npz" in r.getMessage() for r in caplog.records)
    # the committed synth detector, as loaded directly
    ref = load_yolo_cropper(weights_path=synth, device="cpu").detector
    assert isinstance(tc.detector, YoloV8Detector)
    assert tc.detector.cfg == ref.cfg
    a = torch.cat([x.flatten() for x in jax.tree_util.tree_leaves(tc.detector.params)])
    b = torch.cat([x.flatten() for x in jax.tree_util.tree_leaves(ref.params)])
    assert torch.equal(a, b)
