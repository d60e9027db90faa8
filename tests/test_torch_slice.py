"""The seeker read path as a whole on the CPU: the JAX package's ClipEncoder,
EmbeddingIndex and SeekerService against the port's, the same weights through
the bridge. Ids equal, scores within atol 1e-5. Also: the port imports no JAX
and nothing of the JAX package, and its entry points refuse to fall back to
the CPU when CUDA is missing."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from clip_lora_match_tpu.core.config import ClipConfig as JConfig
from clip_lora_match_tpu.core.config import LoraConfig as JLoraConfig
from clip_lora_match_tpu.index.build import build_index_from_csv as j_build
from clip_lora_match_tpu.index.store import EmbeddingIndex as JIndex
from clip_lora_match_tpu.lora.adapter import init_lora as j_init_lora
from clip_lora_match_tpu.models import clip as jclip
from clip_lora_match_tpu.models.encoder import ClipEncoder as JEncoder
from clip_lora_match_tpu.models.io import flatten_params as j_flatten
from clip_lora_match_tpu.nn import layers as jlayers
from clip_lora_match_tpu.services.seeker import SeekerConfig as JSeekerConfig
from clip_lora_match_tpu.services.seeker import SeekerService as JSeeker
from clip_lora_match_tpu_torch.core.config import ClipConfig as TConfig
from clip_lora_match_tpu_torch.index.build import build_index_from_csv as t_build
from clip_lora_match_tpu_torch.index.store import EmbeddingIndex as TIndex
from clip_lora_match_tpu_torch.models.encoder import ClipEncoder as TEncoder
from clip_lora_match_tpu_torch.models.io import params_from_numpy
from clip_lora_match_tpu_torch.services.seeker import SeekerConfig as TSeekerConfig
from clip_lora_match_tpu_torch.services.seeker import SeekerService as TSeeker
from tests._torch_helpers import J_SMALL, T_SMALL, random_like_tree, restore_flags, to_jax  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSV = os.path.join(REPO, "data", "custom", "my_items.csv")
N_ROWS = 2100


@pytest.fixture(scope="module")
def services():
    """(JAX seeker, port seeker, PIL images, texts) over one 2,100-row index:
    5 text rows and 5 image rows of the custom items, then seeded unit rows."""
    params = jclip.init_params(jax.random.PRNGKey(0), J_SMALL)
    lora = to_jax(random_like_tree(j_init_lora(jax.random.PRNGKey(1), J_SMALL, JLoraConfig())))
    jflags = dict(jlayers._KERNEL_FLAGS)  # the JAX encoder sets them process-wide
    jenc = JEncoder(params, arch=J_SMALL, config=JConfig(arch=J_SMALL), lora=lora, lora_scaling=2.0)
    tenc = TEncoder(
        params_from_numpy(j_flatten(params), device="cpu"), arch=T_SMALL,
        config=TConfig(arch=T_SMALL), device="cpu",
    )
    tenc.attach_lora(params_from_numpy(j_flatten(lora), device="cpu"), 2.0)
    jlayers._KERNEL_FLAGS.update(jflags)

    cwd = os.getcwd()
    os.chdir(REPO)  # the CSV's image paths are relative to the checkout
    try:
        jtext, ttext = j_build(CSV, jenc, custom_format=True), t_build(CSV, tenc, custom_format=True)
    finally:
        os.chdir(cwd)
    paths = [os.path.join(REPO, p) for p in jtext.image_paths]
    images = [Image.open(p).convert("RGB") for p in paths]
    rng = np.random.default_rng(3)
    noise = rng.normal(size=(N_ROWS - 10, J_SMALL.projection_dim)).astype(np.float32)
    meta_paths = list(jtext.image_paths) * 2 + [""] * len(noise)
    meta_texts = list(jtext.texts) * 2 + [""] * len(noise)
    j_rows = np.concatenate([jtext.embeddings_np(), jenc.encode_image(images), noise])
    t_rows = np.concatenate([ttext.embeddings_np(), tenc.encode_image(images), noise])
    jseek = JSeeker(jenc, JSeekerConfig(), index=JIndex(j_rows, meta_paths, meta_texts))
    tseek = TSeeker(tenc, TSeekerConfig(), index=TIndex(t_rows, meta_paths, meta_texts, device="cpu"))
    return jseek, tseek, images, list(jtext.texts)


def _tie_groups(scores, tol=1e-5):
    """Consecutive positions whose scores lie within ``tol`` of their
    neighbour form one group."""
    groups, start = [], 0
    for p in range(1, len(scores) + 1):
        if p == len(scores) or scores[p - 1] - scores[p] > tol:
            groups.append((start, p))
            start = p
    return groups


def _same_results(jres, tres):
    """Ids equal position by position, except inside a group of equal scores:
    a fused query is exactly as close to its item's text row as to its image
    row (cos(t+i, t) == cos(t+i, i) for unit t, i), so rounding alone orders
    that pair."""
    assert len(jres) == len(tres) == 5
    for a, b in _tie_groups([r.score for r in jres]):
        assert sorted(r.index for r in tres[a:b]) == sorted(r.index for r in jres[a:b])
        if b - a == 1:
            assert tres[a].index == jres[a].index
    np.testing.assert_allclose([r.score for r in tres], [r.score for r in jres], atol=1e-5)
    assert [(r.image_path, r.text) for r in tres] == [(r.image_path, r.text) for r in jres]


@pytest.mark.parametrize("mode", ["text", "image", "both"])
def test_search_items_matches_jax(services, mode, restore_flags):  # noqa: F811
    jseek, tseek, images, texts = services
    assert len(jseek.index) == len(tseek.index) == N_ROWS
    for i in range(len(texts)):
        kw = {}
        if mode in ("text", "both"):
            kw["description"] = texts[i]
        if mode in ("image", "both"):
            kw["image_path"] = images[i]
        tres = tseek.search_items(**kw)
        _same_results(jseek.search_items(**kw), tres)
        own = {i, i + 5} if mode == "both" else {i if mode == "text" else i + 5}
        assert own <= {r.index for r in tres}


def test_search_items_k_handling(services):
    _, tseek, _, texts = services
    assert tseek.search_items(texts[0], k=0) == []
    with pytest.raises(ValueError):
        tseek.search_items(texts[0], k=-1)
    with pytest.raises(ValueError):
        tseek.search_items()
    assert len(tseek.search_items(texts[0], k=3)) == 3


_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import clip_lora_match_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "clip_lora_match_tpu"))
print("BAD=" + ",".join(bad))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True, text=True,
        timeout=300, check=True,
    ).stdout
    assert "BAD=\n" in out, out


def test_chip_smoke_source_imports_neither():
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert names and not [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "clip_lora_match_tpu")]


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TIndex(np.ones((2, 4), np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TEncoder({}, arch=T_SMALL, config=TConfig(arch=T_SMALL))


def test_index_npz_round_trip_both_ways(tmp_path):
    rng = np.random.default_rng(8)
    emb = rng.normal(size=(7, 16)).astype(np.float32)
    paths, texts = [f"p{i}.jpg" for i in range(7)], [f"teks {i}" for i in range(7)]
    TIndex(emb, paths, texts, device="cpu").save(str(tmp_path / "port.npz"))
    j = JIndex.load(str(tmp_path / "port.npz"), dim=16)
    JIndex(emb, paths, texts).save(str(tmp_path / "jax.npz"))
    t = TIndex.load(str(tmp_path / "jax.npz"), dim=16, device="cpu")
    np.testing.assert_allclose(t.embeddings_np(), j.embeddings_np(), atol=1e-7)
    assert (t.image_paths, t.texts) == (j.image_paths, j.texts) == (paths, texts)
    assert len(TIndex.load(str(tmp_path / "missing.npz"), dim=16, device="cpu")) == 0


def test_index_append_grows_and_normalizes():
    rng = np.random.default_rng(9)
    rows = rng.normal(size=(11, 8)).astype(np.float32)
    t, j = TIndex(dim=8, device="cpu"), JIndex(dim=8)
    for i, r in enumerate(rows):
        assert t.append(r, f"p{i}", f"t{i}") == j.append(r, f"p{i}", f"t{i}") == i
    assert len(t) == 11 and t._arena.shape[0] >= 11
    np.testing.assert_allclose(t.embeddings_np(), j.embeddings_np(), atol=1e-7)
    np.testing.assert_allclose(np.linalg.norm(t.embeddings_np(), axis=1), 1.0, atol=1e-6)
    assert t.metadata(10) == ("p10", "t10") and t.metadata(11) == (None, None)
    bf = TIndex(rows, storage_dtype="bfloat16", device="cpu")
    assert bf.embeddings.dtype == torch.bfloat16


def test_read_pairs_csv_matches_jax(tmp_path):
    from clip_lora_match_tpu.index.build import read_pairs_csv as j_read
    from clip_lora_match_tpu_torch.index.build import read_pairs_csv as t_read

    path = tmp_path / "pairs.csv"
    path.write_text('image_path,text\na.jpg,"tas pink, kecil"\nb.jpg,dompet\n', encoding="utf-8")
    assert t_read(str(path)) == j_read(str(path)) == (["a.jpg", "b.jpg"], ["tas pink, kecil", "dompet"])
    bad = tmp_path / "bad.csv"
    bad.write_text("path,caption\na.jpg,x\n", encoding="utf-8")
    with pytest.raises(ValueError):
        t_read(str(bad))
