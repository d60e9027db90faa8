"""The port's write path and int8 serving against the JAX package on the CPU:
``SearchIndex(quantize="int8")`` across appends, the q8 artifact in both
directions, ``FinderService.report_item`` with a ``SqliteStore``, the DB
store, and ``SeekerService(index_quantize="int8")``, all with the tiny
architecture and the same weights through the bridge."""

import datetime as dt
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from clip_lora_match_tpu.core.config import ClipConfig as JConfig
from clip_lora_match_tpu.core.config import LoraConfig as JLoraConfig
from clip_lora_match_tpu.db.store import SqliteStore as JStore
from clip_lora_match_tpu.index.store import EmbeddingIndex as JIndex
from clip_lora_match_tpu.index.store import load_index_q8 as j_load_q8
from clip_lora_match_tpu.index.store import save_index_q8 as j_save_q8
from clip_lora_match_tpu.lora.adapter import init_lora as j_init_lora
from clip_lora_match_tpu.models import clip as jclip
from clip_lora_match_tpu.models.encoder import ClipEncoder as JEncoder
from clip_lora_match_tpu.models.io import flatten_params as j_flatten
from clip_lora_match_tpu.nn import layers as jlayers
from clip_lora_match_tpu.ops import retrieval_topk as J
from clip_lora_match_tpu.retrieval.search import SearchIndex as JSearch
from clip_lora_match_tpu.services.finder import FinderConfig as JFinderConfig
from clip_lora_match_tpu.services.finder import FinderService as JFinder
from clip_lora_match_tpu.services.seeker import SeekerConfig as JSeekerConfig
from clip_lora_match_tpu.services.seeker import SeekerService as JSeeker
from clip_lora_match_tpu_torch.core.config import ClipConfig as TConfig
from clip_lora_match_tpu_torch.core.config import load_db_config
from clip_lora_match_tpu_torch.db.store import FoundItem, SqliteStore, open_store
from clip_lora_match_tpu_torch.index.store import EmbeddingIndex as TIndex
from clip_lora_match_tpu_torch.index.store import load_index_q8, save_index_q8
from clip_lora_match_tpu_torch.models.encoder import ClipEncoder as TEncoder
from clip_lora_match_tpu_torch.models.io import params_from_numpy
from clip_lora_match_tpu_torch.ops import retrieval_topk as T
from clip_lora_match_tpu_torch.retrieval.search import SearchIndex as TSearch
from clip_lora_match_tpu_torch.services.finder import FinderConfig, FinderService
from clip_lora_match_tpu_torch.services.seeker import SeekerConfig, SeekerService
from tests._torch_helpers import J_SMALL, T_SMALL, random_like_tree, to_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGES = os.path.join(REPO, "data", "custom", "images")
DIM = J_SMALL.projection_dim


@pytest.fixture(scope="module")
def encoders():
    """(JAX encoder, port encoder) with the same weights and LoRA."""
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
    return jenc, tenc


@pytest.fixture
def jax_query_quantizer(monkeypatch):
    """One query quantizer for both packages (XLA's CPU rsqrt and torch's
    differ by an ulp, which can flip a rounded int8; tests/
    test_torch_retrieval.py checks the port's quantizer on its own)."""
    def quantize(queries):
        qq, s_q = J._quantize_queries(jnp.asarray(queries.numpy()))
        return torch.from_numpy(np.array(qq)), torch.from_numpy(np.array(s_q))

    monkeypatch.setattr(T, "_quantize_queries", quantize)


def _unit_rows(rng, n):
    x = rng.normal(size=(n, DIM)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_search_index_int8_follows_appends(jax_query_quantizer, monkeypatch):
    rng = np.random.default_rng(0)
    rows = _unit_rows(rng, 3000)
    extra = rng.normal(size=(7, DIM)).astype(np.float32)
    queries = np.concatenate([extra[:4] + 0.1 * rng.normal(size=(4, DIM)), rng.normal(size=(4, DIM))])
    queries = queries.astype(np.float32)
    tidx, jidx = TIndex(rows, device="cpu", capacity=3100), JIndex(rows, capacity=3100)
    tsearch, jsearch = TSearch(tidx, quantize="int8"), JSearch(jidx, quantize="int8")
    quantized = []
    real = T.quantize_index_int8
    monkeypatch.setattr(
        "clip_lora_match_tpu_torch.retrieval.search.quantize_index_int8",
        lambda x: quantized.append(x.shape[0]) or real(x),
    )
    for step in (0, 3, 7):  # appends between searches: 3 rows, then 4 more
        for i in range(len(tidx), 3000 + step):
            assert tidx.append(extra[i - 3000], f"p{i}", f"t{i}") == jidx.append(extra[i - 3000], f"p{i}", f"t{i}")
        tres, jres = tsearch.search_batch(queries, k=10), jsearch.search_batch(queries, k=10)
        fresh = TSearch(TIndex(tidx.embeddings_np(), device="cpu", normalize=False), quantize="int8")
        for t, j, f in zip(tres, jres, fresh.search_batch(queries, k=10)):
            assert [r.index for r in t] == [r.index for r in j] == [r.index for r in f]
            np.testing.assert_allclose([r.score for r in t], [r.score for r in j], rtol=1e-6)
            assert [r.score for r in t] == [r.score for r in f]
            assert [(r.image_path, r.text) for r in t] == [(r.image_path, r.text) for r in j]
        assert tsearch._q8[0] == 3000 + step
    # the served copy quantizes only the appended rows; each fresh one all
    assert quantized == [3000, 3000, 3, 3003, 4, 3007]
    full_v, full_s = real(tidx.embeddings)
    assert torch.equal(tsearch._q8[1], full_v) and torch.equal(tsearch._q8[2], full_s)
    assert tres[0][0].index == 3000 and tres[3][0].index == 3003


def test_search_index_front_end():
    rng = np.random.default_rng(1)
    idx = TIndex(_unit_rows(rng, 50), [f"p{i}" for i in range(50)], device="cpu")
    with pytest.raises(ValueError, match="quantize"):
        TSearch(idx, quantize="int4")
    approx = TSearch(idx, approximate=True, recall_target=0.9)  # accepted: ops.approx_topk
    assert approx.approximate and approx.recall_target == 0.9
    assert approx.search_with_embedding(idx.embeddings_np()[7], k=3)[0].index == 7
    with pytest.raises(RuntimeError, match="encoder"):
        TSearch(idx).search_by_text("tas")
    s = TSearch(idx)
    assert s.search_with_embedding(idx.embeddings_np()[7], k=3)[0].index == 7
    assert [r[0].index for r in s.search_batch(idx.embeddings_np()[:4], k=2)] == [0, 1, 2, 3]
    assert TSearch(TIndex(dim=DIM, device="cpu")).search_batch(np.ones((2, DIM)), 3) == [[], []]


def test_search_index_from_a_path(tmp_path, encoders):
    _, tenc = encoders
    rng = np.random.default_rng(2)
    rows = _unit_rows(rng, 20)
    rows[4] = tenc.encode_text("dompet coklat")
    TIndex(rows, [f"p{i}" for i in range(20)], device="cpu").save(str(tmp_path / "i.npz"))
    a = TSearch(str(tmp_path / "i.npz"), tenc, dim=DIM, device="cpu")
    b = TSearch.from_file(str(tmp_path / "i.npz"), tenc, dim=DIM, device="cpu")
    assert a.search_by_text("dompet coklat")[0].index == b.search_by_text("dompet coklat")[0].index == 4
    assert a.search_by_image(Image.new("RGB", (64, 64)), k=2)[0].image_path.startswith("p")


def test_q8_artifact_round_trip_both_ways(tmp_path):
    rng = np.random.default_rng(3)
    rows = _unit_rows(rng, 40)
    paths, texts = [f"p{i}.jpg" for i in range(40)], [f"teks {i}" for i in range(40)]
    tv, ts = T.quantize_index_int8(torch.from_numpy(rows))
    save_index_q8(str(tmp_path / "port.npz"), tv, ts, paths, texts)
    jv, js, jp, jt = j_load_q8(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    assert (jp, jt) == (paths, texts)
    j_save_q8(str(tmp_path / "jax"), *J.quantize_index_int8(jnp.asarray(rows)), paths[:3], texts[:3])
    v, s, p, t = load_index_q8(str(tmp_path / "jax"), device="cpu")
    assert v.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (40, 1)
    assert torch.equal(v, tv) and torch.equal(s, ts) and (p, t) == (paths[:3], texts[:3])
    with pytest.raises(ValueError, match="int8"):
        save_index_q8(str(tmp_path / "bad.npz"), tv.float(), ts)


def _finder_env(tmp_path, name, cfg_cls, store_cls):
    cfg = cfg_cls(
        index_path=str(tmp_path / name / "index.npz"),
        reported_images_dir=str(tmp_path / name / "reported"), k_dim=DIM,
    )
    return cfg, store_cls(str(tmp_path / name / "db.sqlite"))


def test_finder_report_item_matches_jax(tmp_path, encoders):
    jenc, tenc = encoders
    jcfg, jstore = _finder_env(tmp_path, "jax", JFinderConfig, JStore)
    tcfg, tstore = _finder_env(tmp_path, "port", FinderConfig, SqliteStore)
    jfind = JFinder(jenc, jcfg, store=jstore)
    tfind = FinderService(tenc, tcfg, store=tstore, index=TIndex(dim=DIM, device="cpu"))
    image = os.path.join(IMAGES, "dompet_coklat_kantin_teknik.jpg")
    when = dt.datetime(2026, 8, 1, 10, 0)
    for desc, loc in (("dompet coklat", "kantin teknik"), ("payung lipat hitam", None)):
        j = jfind.report_item(image, desc, location=loc, found_at=when, reporter="budi")
        t = tfind.report_item(image, desc, location=loc, found_at=when, reporter="budi")
        assert (t.item_id, t.index_row, t.indexed_text) == (j.item_id, j.index_row, j.indexed_text)
        assert os.path.basename(t.stored_image_path) == os.path.basename(j.stored_image_path)
        assert os.path.exists(t.stored_image_path)
    assert t.indexed_text == "payung lipat hitam" and j.indexed_text == "payung lipat hitam"
    # the indexed embedding is the TEXT's, held to the encoder tolerance
    np.testing.assert_allclose(tfind.index.embeddings_np(), jfind.index.embeddings_np(), atol=1e-5)
    np.testing.assert_allclose(
        tfind.index.embeddings_np()[0], tenc.encode_text("dompet coklat, ditemukan di kantin teknik"),
        atol=1e-6,
    )
    for tr, jr in zip(tstore.all_items(), jstore.all_items()):
        assert (tr.id, tr.description, tr.location, tr.found_at, tr.reporter) == (
            jr.id, jr.description, jr.location, jr.found_at, jr.reporter)
        assert os.path.basename(tr.image_path) == os.path.basename(jr.image_path)
    assert tstore.all_items()[0].description in (
        "dompet coklat, ditemukan di kantin teknik", "payung lipat hitam")
    # persisted on every insert, in a format the JAX package reads back
    back = JIndex.load(tcfg.index_path, dim=DIM)
    np.testing.assert_allclose(back.embeddings_np(), tfind.index.embeddings_np(), atol=1e-7)
    assert back.texts == tfind.index.texts


def test_finder_refuses_the_crop_stage(tmp_path, encoders):
    """The crop stage is ported: ``use_yolo_crop`` without a cropper reports
    as the JAX finder does (no crop), with one it crops the stored photo
    (tests/test_torch_device_crop.py holds that against the JAX finder)."""
    from clip_lora_match_tpu_torch.models.yolo.cropper import YoloCropper

    cfg = FinderConfig(index_path=str(tmp_path / "index.npz"), reported_images_dir=str(tmp_path / "r"),
                       k_dim=DIM, use_yolo_crop=True)
    jcfg = JFinderConfig(index_path=str(tmp_path / "j.npz"), reported_images_dir=str(tmp_path / "jr"),
                         k_dim=DIM, use_yolo_crop=True)
    image = os.path.join(IMAGES, "dompet_coklat_kantin_teknik.jpg")
    t = FinderService(encoders[1], cfg, index=TIndex(dim=DIM, device="cpu")).report_item(image, "dompet")
    j = JFinder(encoders[0], jcfg, index=JIndex(dim=DIM)).report_item(image, "dompet")
    assert t.crop_used is j.crop_used is False
    from clip_lora_match_tpu_torch.core.config import YoloConfig

    cropper = YoloCropper(config=YoloConfig(crop_save_dir=str(tmp_path / "c")))  # NullDetector: full image
    finder = FinderService(encoders[1], cfg, cropper=cropper, index=TIndex(dim=DIM, device="cpu"))
    assert finder.report_item(image, "dompet").crop_used is True
    assert os.listdir(tmp_path / "c") == ["dompet_coklat_kantin_teknik_crop_0.jpg"]


def test_db_store_matches_jax(tmp_path, monkeypatch):
    rows = [
        FoundItem(None, "a.jpg", "tas pink", "gk 1", dt.datetime(2026, 1, 2), "ani"),
        FoundItem(None, "b.jpg", "dompet", None, None, None),
        FoundItem(None, "c.jpg", "kunci", "kantin", dt.datetime(2026, 1, 3), None),
    ]
    t, j = SqliteStore(), JStore()
    assert [t.insert(r) for r in rows] == [j.insert(r) for r in rows] == [1, 2, 3]
    for order in (True, False):
        assert [vars(x) for x in t.all_items(order)] == [vars(x) for x in j.all_items(order)]
    monkeypatch.delenv("DATABASE_URL", raising=False)
    assert isinstance(open_store(f"sqlite:///{tmp_path}/x.db"), SqliteStore)
    assert isinstance(open_store(), SqliteStore)
    with pytest.raises(ValueError, match="scheme"):
        open_store("mysql://u@h/db")
    cfg = tmp_path / "db.yaml"
    cfg.write_text("postgres:\n  host: db.local\n  port: 6543\n  other: 1\n")
    assert load_db_config(str(cfg)).url == "postgresql://postgres:@db.local:6543/balikkin_db"


@pytest.fixture(scope="module")
def seekers(encoders):
    """(JAX seeker, port seeker) serving the int8 index: 5 text rows and 5
    image rows of the custom items, then seeded unit rows."""
    jenc, tenc = encoders
    names = sorted(os.listdir(IMAGES))
    images = [Image.open(os.path.join(IMAGES, n)).convert("RGB") for n in names]
    texts = [os.path.splitext(n)[0].replace("_", " ") for n in names]
    noise = _unit_rows(np.random.default_rng(4), 1990)
    meta = [f"item{i}" for i in range(2000)]
    j_rows = np.concatenate([jenc.encode_text(texts), jenc.encode_image(images), noise])
    t_rows = np.concatenate([tenc.encode_text(texts), tenc.encode_image(images), noise])
    jseek = JSeeker(jenc, JSeekerConfig(index_quantize="int8"), index=JIndex(j_rows, meta, meta))
    tseek = SeekerService(
        tenc, SeekerConfig(index_quantize="int8"), index=TIndex(t_rows, meta, meta, device="cpu")
    )
    return jseek, tseek, images, texts


@pytest.mark.parametrize("mode", ["text", "image", "both"])
def test_seeker_int8_matches_jax(seekers, mode):
    """Top-k ids equal wherever the scores are apart by more than the int8
    query rounding the two encoders' last-ulp differences can flip."""
    jseek, tseek, images, texts = seekers
    for i in range(len(texts)):
        kw = {}
        if mode in ("text", "both"):
            kw["description"] = texts[i]
        if mode in ("image", "both"):
            kw["image_path"] = images[i]
        tres, jres = tseek.search_items(**kw), jseek.search_items(**kw)
        js = [r.score for r in jres]
        np.testing.assert_allclose([r.score for r in tres], js, atol=1e-3)
        start = 0
        for p in range(1, 6):  # groups of scores within 1e-3: same ids as a set
            if p == 5 or js[p - 1] - js[p] > 1e-3:
                assert {r.index for r in tres[start:p]} == {r.index for r in jres[start:p]}
                start = p
        own = {i, i + 5} if mode == "both" else {i if mode == "text" else i + 5}
        assert own <= {r.index for r in tres}
    assert tseek._search._q8[0] == len(tseek.index) == 2000


def test_seeker_reloads_its_own_index_file(tmp_path, encoders):
    _, tenc = encoders
    path = str(tmp_path / "index.npz")
    rows = _unit_rows(np.random.default_rng(6), 30)
    TIndex(rows, [""] * 30, [""] * 30, device="cpu").save(path)
    cfg = SeekerConfig(index_path=path, index_quantize="int8")
    seek = SeekerService(tenc, cfg)
    assert len(seek.index) == 30 and seek.index.device.type == "cpu"
    finder = FinderService(
        tenc, FinderConfig(index_path=path, reported_images_dir=str(tmp_path / "r"), k_dim=DIM),
        index=TIndex.load(path, dim=DIM, device="cpu"),
    )
    r = finder.report_item(os.path.join(IMAGES, "topi_merah_lapangan_basket.jpg"), "topi merah")
    os.utime(path, (seek._mtime + 5, seek._mtime + 5))
    res = seek.search_items(description="topi merah")
    assert len(seek.index) == 31 and res[0].index == r.index_row == 30
    frozen = SeekerService(tenc, SeekerConfig(index_path=path, watch_index_file=False))
    finder.report_item(os.path.join(IMAGES, "topi_merah_lapangan_basket.jpg"), "topi biru")
    os.utime(path, (frozen._mtime + 5, frozen._mtime + 5))
    frozen.search_items(description="topi")
    assert len(frozen.index) == 31
    # the crop stage is ported: use_device_crop alone (no use_yolo_crop, no
    # cropper) builds and serves as the JAX seeker does, uncropped
    crop_cfg = SeekerService(tenc, SeekerConfig(index_path=path, use_device_crop=True))
    assert crop_cfg.cropper is None and len(crop_cfg.index) == 32
    assert crop_cfg.search_items(description="topi biru")[0].index == 31
