"""The port's persistence and small host pieces against the JAX package on
the CPU: the PEFT adapter format (its own ``.safetensors`` reader and writer
against the ``safetensors`` package in both directions, and with that package
hidden), ``save_lora`` / ``load_lora``, ``save_params`` / ``load_params`` and
``ClipEncoder.save``, ``load_clip_config`` with its ``paths:`` and
``inference:`` blocks (``to_dict``), ``cosine_similarity``, ``verify_index``
and the ``encode_fn`` hook, the tokenizer's ``vocab_size`` / ``tokenize`` /
``decode`` / ``save`` and ``learn_bpe``, and ``core/profiling.py``.

Bars: tensors and token ids bit-equal, configs equal as dicts, scores within
1e-6.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml
from safetensors.numpy import load_file as st_load
from safetensors.numpy import save_file as st_save

import jax
import jax.numpy as jnp

from clip_lora_match_tpu.core.config import ClipArchConfig as JArch
from clip_lora_match_tpu.core.config import LoraConfig as JLoraConfig
from clip_lora_match_tpu.core.config import load_clip_config as j_load_clip_config
from clip_lora_match_tpu.core.config import to_dict as j_to_dict
from clip_lora_match_tpu.index.build import build_text_index as j_build_text_index
from clip_lora_match_tpu.index.build import verify_index as j_verify_index
from clip_lora_match_tpu.index.store import EmbeddingIndex as JIndex
from clip_lora_match_tpu.lora.adapter import init_lora as j_init_lora
from clip_lora_match_tpu.lora.adapter import load_lora as j_load_lora
from clip_lora_match_tpu.lora.adapter import save_lora as j_save_lora
from clip_lora_match_tpu.lora.peft_io import load_peft_adapter as j_load_peft
from clip_lora_match_tpu.lora.peft_io import save_peft_adapter as j_save_peft
from clip_lora_match_tpu.models import clip as jclip
from clip_lora_match_tpu.models.io import flatten_params as j_flatten
from clip_lora_match_tpu.models.io import load_params as j_load_params
from clip_lora_match_tpu.models.io import save_params as j_save_params
from clip_lora_match_tpu.retrieval.similarity import cosine_similarity as j_cosine
from clip_lora_match_tpu.tokenizer.bpe import ClipTokenizer as JTokenizer
from clip_lora_match_tpu.tokenizer.learn import learn_bpe as j_learn_bpe
from clip_lora_match_tpu_torch.core import profiling as P
from clip_lora_match_tpu_torch.core.config import ClipArchConfig as TArch
from clip_lora_match_tpu_torch.core.config import ClipConfig as TConfig
from clip_lora_match_tpu_torch.core.config import LoraConfig as TLoraConfig
from clip_lora_match_tpu_torch.core.config import load_clip_config, to_dict
from clip_lora_match_tpu_torch.index.build import build_index_from_csv, build_text_index, verify_index
from clip_lora_match_tpu_torch.index.store import EmbeddingIndex as TIndex
from clip_lora_match_tpu_torch.lora import load_lora, load_peft_adapter, save_lora, save_peft_adapter
from clip_lora_match_tpu_torch.lora.peft_io import read_safetensors, write_safetensors
from clip_lora_match_tpu_torch.models.encoder import ClipEncoder as TEncoder
from clip_lora_match_tpu_torch.models.io import flatten_params, load_params, params_from_numpy, save_params
from clip_lora_match_tpu_torch.retrieval import cosine_similarity
from clip_lora_match_tpu_torch.tokenizer.bpe import ClipTokenizer as TTokenizer
from clip_lora_match_tpu_torch.tokenizer.learn import learn_bpe, save_bpe
from tests._torch_helpers import J_SMALL, SMALL_KW, T_SMALL, random_like_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "fashion_bpe")
CORPUS = [os.path.join(REPO, "data", "text", f"{n}_fashion.csv") for n in ("train", "val")]
TEXTS = [
    "tas pink di kantin", "Payung HITAM, lipat!", "kunci motor honda 2023",
    "botol minum biru (tupperware)", "dompet kulit coklat — isi KTP", "jaket denim's sleeve",
    "headset bluetooth  putih", "<|startoftext|> hi", "",
]


def _lora_tree(arch=J_SMALL, r=4, seed=9):
    lora = j_init_lora(jax.random.PRNGKey(3), arch, JLoraConfig(r=r, alpha=2 * r))
    return random_like_tree(lora, seed=seed, scale=0.05)


def _assert_trees_bit_equal(got, ref):
    g, r = flatten_params(got), j_flatten(ref)
    assert sorted(g) == sorted(r)
    for k in r:
        rk = np.asarray(r[k])
        assert g[k].dtype == rk.dtype and g[k].shape == rk.shape and np.array_equal(g[k], rk), k


# ---------------------------------------------------------------------------
# the .safetensors format, read and written with numpy
# ---------------------------------------------------------------------------


def _tensors(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w.f32": rng.normal(size=(3, 5)).astype(np.float32),
        "a.f16": rng.normal(size=(7,)).astype(np.float16),
        "q.i8": rng.integers(-128, 128, (4, 4), dtype=np.int8),
        "n.i64": rng.integers(-9, 9, (2, 1, 3), dtype=np.int64),
        "s.f64": np.array(3.5),
        "e.f32": np.zeros((0, 4), np.float32),
        "m.bool": rng.random((5,)) > 0.5,
    }


def test_safetensors_writer_is_read_by_the_safetensors_package(tmp_path):
    src = _tensors(1)
    path = str(tmp_path / "x.safetensors")
    write_safetensors(path, src)
    got = st_load(path)
    assert sorted(got) == sorted(src)
    for k, v in src.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape and np.array_equal(got[k], v), k
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    assert n % 8 == 0 and "__metadata__" not in header


@pytest.mark.parametrize("metadata", [None, {"format": "pt"}])
def test_safetensors_reader_reads_the_safetensors_package(tmp_path, metadata):
    src = _tensors(2)
    path = str(tmp_path / "y.safetensors")
    st_save(src, path, metadata=metadata)
    got = read_safetensors(path)
    assert sorted(got) == sorted(src)
    for k, v in src.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape and np.array_equal(got[k], v), k
        assert got[k].flags.writeable


def test_safetensors_reader_takes_bf16_as_float32(tmp_path):
    vals = torch.tensor([[1.5, -2.25], [3.0e-3, 65504.0]], dtype=torch.bfloat16)
    path = str(tmp_path / "bf16.safetensors")
    raw = vals.view(torch.int16).numpy().tobytes()
    head = json.dumps({"b": {"dtype": "BF16", "shape": [2, 2], "data_offsets": [0, len(raw)]}}).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little") + head + raw)
    got = read_safetensors(path)["b"]
    assert got.dtype == np.float32 and np.array_equal(got, vals.float().numpy())


# ---------------------------------------------------------------------------
# PEFT adapter directories
# ---------------------------------------------------------------------------


def test_peft_written_by_the_port_is_read_by_jax(tmp_path):
    lora = _lora_tree()
    cfg_t = TLoraConfig(r=4, alpha=8, dropout=0.05, base_model_name="openai/clip-vit-base-patch16")
    cfg_j = JLoraConfig(r=4, alpha=8, dropout=0.05, base_model_name="openai/clip-vit-base-patch16")
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    save_peft_adapter(port_dir, params_from_numpy(j_flatten(lora), device="cpu"), cfg_t)
    j_save_peft(jax_dir, lora, cfg_j)
    jtree, jscale = j_load_peft(port_dir, arch=J_SMALL)
    assert jscale == 2.0
    _assert_trees_bit_equal(params_from_numpy(j_flatten(jtree), device="cpu"), lora)
    # the safetensors package reads the same tensors as from JAX's file
    ours = st_load(os.path.join(port_dir, "adapter_model.safetensors"))
    theirs = st_load(os.path.join(jax_dir, "adapter_model.safetensors"))
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        assert ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k]), k
    with open(os.path.join(port_dir, "adapter_config.json")) as f, \
            open(os.path.join(jax_dir, "adapter_config.json")) as g:
        assert json.load(f) == json.load(g)


def test_peft_written_by_jax_is_read_by_the_port(tmp_path):
    lora = _lora_tree(seed=11)
    j_save_peft(str(tmp_path), lora, JLoraConfig(r=4, alpha=16))
    tree, scale = load_peft_adapter(str(tmp_path), arch=T_SMALL, device="cpu")
    jtree, jscale = j_load_peft(str(tmp_path), arch=J_SMALL)
    assert scale == jscale == 4.0
    _assert_trees_bit_equal(tree, lora)
    _assert_trees_bit_equal(tree, jtree)
    assert tree["visual"]["blocks"]["attn"]["q_proj"]["a"].device.type == "cpu"


def test_peft_file_from_the_safetensors_package_with_partial_layers(tmp_path):
    """A PEFT file as PEFT writes it (``__metadata__``, a layer missing, one
    tower only, keys without the ``base_model.model.`` prefix, an unrelated
    key): the port stacks it as JAX does, the missing layer zero."""
    rng = np.random.default_rng(4)
    flat = {"text_projection.weight": rng.normal(size=(4, 4)).astype(np.float32)}
    for i in (0, 2):
        base = f"text_model.encoder.layers.{i}.self_attn.v_proj"
        flat[f"{base}.lora_A.weight"] = rng.normal(size=(2, 128)).astype(np.float32)
        flat[f"{base}.lora_B.weight"] = rng.normal(size=(128, 2)).astype(np.float32)
    st_save(flat, str(tmp_path / "adapter_model.safetensors"), metadata={"format": "pt"})
    with open(tmp_path / "adapter_config.json", "w") as f:
        json.dump({"r": 2, "lora_alpha": 5}, f)
    arch_j, arch_t = JArch(**dict(SMALL_KW, text_layers=3)), TArch(**dict(SMALL_KW, text_layers=3))
    tree, scale = load_peft_adapter(str(tmp_path), arch=arch_t, device="cpu")
    jtree, jscale = j_load_peft(str(tmp_path), arch=arch_j)
    assert scale == jscale == 2.5 and list(tree) == ["text"]
    _assert_trees_bit_equal(tree, jtree)
    assert not tree["text"]["blocks"]["attn"]["v_proj"]["a"][1].any()


def test_load_lora_reads_native_then_peft_then_raises(tmp_path):
    lora = _lora_tree(seed=12)
    j_save_peft(str(tmp_path / "peft"), lora, JLoraConfig(r=4, alpha=8))
    tree, scale = load_lora(str(tmp_path / "peft"), device="cpu", arch=T_SMALL)
    assert scale == 2.0
    _assert_trees_bit_equal(tree, j_load_peft(str(tmp_path / "peft"), arch=J_SMALL)[0])
    # a dir holding both formats: the native one wins, as in JAX
    other = _lora_tree(seed=13)
    j_save_lora(str(tmp_path / "peft"), other, JLoraConfig(r=4, alpha=4))
    tree, scale = load_lora(str(tmp_path / "peft"), device="cpu")
    assert scale == j_load_lora(str(tmp_path / "peft"))[1] == 1.0
    _assert_trees_bit_equal(tree, other)
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        load_lora(str(tmp_path / "empty"), device="cpu")
    with pytest.raises(FileNotFoundError):
        j_load_lora(str(tmp_path / "empty"))


def test_peft_load_at_the_default_arch_equals_jax(tmp_path):
    """Every call the JAX package answers (its PEFT branch stacks by the
    default ViT-B/32 arch) gives the same tree in the port."""
    arch = JArch()
    lora = _lora_tree(arch=arch, r=2, seed=14)
    j_save_peft(str(tmp_path), lora, JLoraConfig(r=2, alpha=4))
    tree, scale = load_lora(str(tmp_path), device="cpu")
    jtree, jscale = j_load_lora(str(tmp_path))
    assert scale == jscale
    _assert_trees_bit_equal(tree, jtree)


def test_peft_adapter_is_stacked_to_the_encoders_arch(tmp_path):
    """``from_config`` passes its own arch, so an adapter for a model of
    another depth than ViT-B/32 loads (the JAX package stacks by B/32)."""
    lora = _lora_tree(seed=15)
    save_peft_adapter(str(tmp_path / "peft"), params_from_numpy(j_flatten(lora), device="cpu"),
                      TLoraConfig(r=4, alpha=8))
    cfg = str(tmp_path / "clip.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump({"model": {"arch": dict(SMALL_KW)}}, f)
    with pytest.warns(UserWarning):
        enc = TEncoder.from_config(cfg, lora_path=str(tmp_path / "peft"), device="cpu")
    assert enc.lora_scaling == 2.0
    _assert_trees_bit_equal(enc.lora, lora)
    assert np.isfinite(enc.encode_text("tas pink")).all()


_NO_SAFETENSORS = r"""
import sys
sys.modules["safetensors"] = None
sys.modules["safetensors.numpy"] = None
import numpy as np
from clip_lora_match_tpu_torch.core.config import ClipArchConfig, LoraConfig
from clip_lora_match_tpu_torch.lora import init_lora, load_lora, save_peft_adapter
arch = ClipArchConfig(vision_layers=2, text_layers=2, vision_width=64, text_width=64,
                      vision_heads=2, text_heads=2, vision_mlp_dim=128, text_mlp_dim=128)
lora = init_lora(0, arch, LoraConfig(r=2, alpha=4), device="cpu")
save_peft_adapter(sys.argv[1], lora, LoraConfig(r=2, alpha=4))
tree, scale = load_lora(sys.argv[1], device="cpu", arch=arch)
a, b = lora["text"]["blocks"]["attn"]["k_proj"]["a"], tree["text"]["blocks"]["attn"]["k_proj"]["a"]
assert scale == 2.0 and bool((a == b).all())
try:
    import safetensors  # noqa: F401
except ImportError:
    print("no safetensors; round trip ok")
"""


def test_peft_round_trip_without_the_safetensors_package(tmp_path):
    out = subprocess.run([sys.executable, "-c", _NO_SAFETENSORS, str(tmp_path / "peft")],
                         capture_output=True, text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "no safetensors; round trip ok" in out.stdout
    assert st_load(str(tmp_path / "peft" / "adapter_model.safetensors"))


# ---------------------------------------------------------------------------
# native adapter dirs and weight files
# ---------------------------------------------------------------------------


def test_save_lora_and_jax_load_lora_both_ways(tmp_path):
    lora = _lora_tree(seed=16)
    cfg_t = TLoraConfig(r=4, alpha=12, dropout=0.2)
    save_lora(str(tmp_path / "port"), params_from_numpy(j_flatten(lora), device="cpu"), cfg_t)
    jtree, jscale = j_load_lora(str(tmp_path / "port"))
    assert jscale == 3.0
    _assert_trees_bit_equal(params_from_numpy(j_flatten(jtree), device="cpu"), lora)
    j_save_lora(str(tmp_path / "jax"), lora, JLoraConfig(r=4, alpha=12, dropout=0.2))
    tree, scale = load_lora(str(tmp_path / "jax"), device="cpu")
    assert scale == 3.0
    _assert_trees_bit_equal(tree, lora)
    for name in ("port", "jax"):
        with open(tmp_path / name / "lora_config.json") as f:
            meta = json.load(f)
        assert meta == {"r": 4, "alpha": 12, "dropout": 0.2,
                        "target_modules": ["q_proj", "k_proj", "v_proj", "out_proj"],
                        "base_model_name": "openai/clip-vit-base-patch32"}


def test_save_params_and_jax_load_params_both_ways(tmp_path):
    params = jclip.init_params(jax.random.PRNGKey(0), J_SMALL)
    tparams = params_from_numpy(j_flatten(params), device="cpu")
    save_params(str(tmp_path / "port" / "w.npz"), tparams)
    _assert_trees_bit_equal(params_from_numpy(j_flatten(j_load_params(str(tmp_path / "port" / "w.npz"))),
                                              device="cpu"), params)
    j_save_params(str(tmp_path / "jax.npz"), params)
    _assert_trees_bit_equal(load_params(str(tmp_path / "jax.npz"), device="cpu"), params)
    # lists under numbered keys, as the JAX flattener writes them
    tree = {"m": [torch.ones(2), torch.zeros(3, dtype=torch.int32)]}
    save_params(str(tmp_path / "list.npz"), tree)
    assert sorted(j_load_params(str(tmp_path / "list.npz"))["m"]) == ["0", "1"]


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_encoder_save_writes_the_fp32_master(tmp_path, quantize):
    params = jclip.init_params(jax.random.PRNGKey(1), J_SMALL)
    enc = TEncoder(params_from_numpy(j_flatten(params), device="cpu"), arch=T_SMALL,
                   config=TConfig(arch=T_SMALL), compute_dtype="bfloat16", quantize=quantize, device="cpu")
    enc.encode_text("tas pink")  # the bf16 (and int8) serving copy exists
    enc.save(str(tmp_path / "enc.npz"))
    back = j_load_params(str(tmp_path / "enc.npz"))
    _assert_trees_bit_equal(params_from_numpy(j_flatten(back), device="cpu"), params)
    assert all(np.asarray(v).dtype == np.float32 for v in j_flatten(back).values())
    _assert_trees_bit_equal(load_params(str(tmp_path / "enc.npz"), device="cpu"), params)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


def test_load_clip_config_equals_jax_field_for_field(tmp_path):
    shipped = os.path.join(REPO, "config", "clip_config.yaml")
    assert to_dict(load_clip_config(shipped)) == j_to_dict(j_load_clip_config(shipped))
    assert to_dict(load_clip_config(None)) == j_to_dict(j_load_clip_config(None))
    path = str(tmp_path / "c.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({
            "model": {"name": "openai/clip-vit-base-patch16", "pretrained": False, "device": "cuda"},
            "paths": {"lora_weights_dir": "w/lora", "checkpoints_dir": "w/ck", "logs_dir": "w/logs"},
            "inference": {"batch_size": 64, "num_workers": 2},
        }, f)
    got, ref = to_dict(load_clip_config(path)), j_to_dict(j_load_clip_config(path))
    assert got == ref
    assert (got["lora_weights_dir"], got["batch_size"], got["num_workers"], got["pretrained"]) == \
        ("w/lora", 64, 2, False)
    assert to_dict(TLoraConfig()) == j_to_dict(JLoraConfig())


def test_config_device_does_not_move_the_encoder(tmp_path):
    """``model.device: "tpu"`` is read and kept; the entry point's explicit
    ``device`` decides where the port runs, and its default stays CUDA."""
    path = str(tmp_path / "tpu.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({"model": {"device": "tpu", "arch": dict(SMALL_KW)}}, f)
    cfg = load_clip_config(path)
    assert cfg.device == j_load_clip_config(path).device == "tpu"
    with pytest.warns(UserWarning):
        enc = TEncoder.from_config(path, device="cpu")
    assert enc.device.type == "cpu" and enc.cfg.device == "tpu"
    assert enc.params["text"]["proj"]["kernel"].device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TEncoder.from_config(path)


# ---------------------------------------------------------------------------
# retrieval and index helpers
# ---------------------------------------------------------------------------


def test_cosine_similarity_matches_jax():
    rng = np.random.default_rng(20)
    q = rng.normal(size=(3, 48)).astype(np.float32)
    c = rng.normal(size=(50, 48)).astype(np.float32) * 3.0
    for query in (q, q[0]):
        got = cosine_similarity(query, torch.from_numpy(c))
        ref = np.asarray(j_cosine(jnp.asarray(query), jnp.asarray(c)))
        assert got.shape == ref.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
    assert cosine_similarity(q, c).shape == (3, 50)


def _index_pair(emb, paths, texts, normalize=True):
    return (TIndex(emb, paths, texts, normalize=normalize, device="cpu"),
            JIndex(emb, paths, texts, normalize=normalize))


def test_verify_index_gives_jax_answers():
    rng = np.random.default_rng(21)
    emb = rng.normal(size=(6, 16)).astype(np.float32)
    paths, texts = [f"p{i}.jpg" for i in range(6)], [f"t{i}" for i in range(6)]
    cases = {
        "good": _index_pair(emb, paths, texts),
        "not unit": _index_pair(emb * 2.0, paths, texts, normalize=False),
        "empty": _index_pair(np.zeros((0, 16), np.float32), [], []),
    }
    with pytest.warns(UserWarning):
        cases["short metadata"] = _index_pair(emb, paths[:4], texts)
    got = {name: verify_index(t) for name, (t, _) in cases.items()}
    ref = {name: j_verify_index(j) for name, (_, j) in cases.items()}
    assert got == ref == {"good": True, "not unit": False, "short metadata": False, "empty": True}


def test_build_text_index_encode_fn_hook_matches_jax(tmp_path):
    rng = np.random.default_rng(22)
    texts = [f"barang {i}" for i in range(7)]
    table = {t: rng.normal(size=(16,)).astype(np.float32) for t in texts}
    chunks = []

    def encode_fn(chunk):
        chunks.append(list(chunk))
        return np.stack([table[t] for t in chunk])

    class _Enc:
        arch = TArch(projection_dim=16)
        device = torch.device("cpu")

        def encode_text(self, chunk):
            raise AssertionError("encode_fn replaces encode_text")

    tidx = build_text_index(texts, [f"{t}.jpg" for t in texts], _Enc(), batch_size=3, encode_fn=encode_fn)
    jidx = j_build_text_index(texts, [f"{t}.jpg" for t in texts], _Enc(), batch_size=3, encode_fn=encode_fn)
    assert [len(c) for c in chunks] == [3, 3, 1] * 2
    np.testing.assert_array_equal(tidx.embeddings_np(), jidx.embeddings_np())
    assert tidx.texts == jidx.texts and verify_index(tidx) and j_verify_index(jidx)
    csv = tmp_path / "items.csv"
    csv.write_text("image_path,text\n" + "".join(f"{t}.jpg,{t}\n" for t in texts))
    chunks.clear()
    cidx = build_index_from_csv(str(csv), _Enc(), batch_size=4, encode_fn=encode_fn)
    assert [len(c) for c in chunks] == [4, 3] and np.array_equal(cidx.embeddings_np(), tidx.embeddings_np())


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tokenizers():
    jt = JTokenizer.from_dir(FIXTURE)
    jt._native_tried, jt._native = True, None  # the JAX Python merge path
    return TTokenizer.from_dir(FIXTURE), jt


def test_tokenizer_vocab_tokenize_decode_match_jax(tokenizers):
    ours, theirs = tokenizers
    assert ours.vocab_size == theirs.vocab_size == len(theirs.encoder)
    fallback = TTokenizer.from_dir(None)
    assert fallback.vocab_size == JTokenizer.from_dir(None).vocab_size == 514
    for text in TEXTS:
        assert ours.tokenize(text) == theirs.tokenize(text), text
        ids = theirs.encode(text)
        assert ours.encode(text) == ids, text
        for skip in (True, False):
            assert ours.decode(ids, skip_specials=skip) == theirs.decode(ids, skip_specials=skip), text
        assert ours.decode(np.asarray(ids)) == theirs.decode(np.asarray(ids))
    assert ours.decode([10 ** 6]) == theirs.decode([10 ** 6]) == ""


def test_tokenizer_save_matches_jax(tokenizers, tmp_path):
    ours, theirs = tokenizers
    ours.save(str(tmp_path / "port"))
    theirs.save(str(tmp_path / "jax"))
    for name in ("vocab.json", "merges.txt"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    again = TTokenizer.from_dir(str(tmp_path / "port"))
    assert again.encode(TEXTS[1]) == ours.encode(TEXTS[1])


def test_learn_bpe_matches_jax_on_the_fashion_captions(tmp_path):
    import csv

    texts = []
    for path in CORPUS:
        with open(path, newline="", encoding="utf-8") as f:
            texts += [row["text"] for row in csv.DictReader(f)]
    vocab, merges = learn_bpe(texts, num_merges=80)
    jvocab, jmerges = j_learn_bpe(texts, num_merges=80)
    assert merges == jmerges and vocab == jvocab and len(merges) == 80
    assert learn_bpe(texts, num_merges=1000) == j_learn_bpe(texts, num_merges=1000)  # to min_pair_count
    small = learn_bpe(["abab abab ab", "abc ab"], num_merges=4)
    assert small == j_learn_bpe(["abab abab ab", "abc ab"], num_merges=4)
    save_bpe(vocab, merges, str(tmp_path))
    tok = TTokenizer.from_dir(str(tmp_path))
    assert tok.vocab_size == len(vocab) and tok.eot_id == len(vocab) - 1
    jtok = JTokenizer.from_dir(str(tmp_path))
    jtok._native_tried, jtok._native = True, None
    assert tok.encode(texts[0]) == jtok.encode(texts[0])
    assert tok.decode(tok.encode(texts[0])) == jtok.decode(jtok.encode(texts[0]))


# ---------------------------------------------------------------------------
# core/profiling.py
# ---------------------------------------------------------------------------


def test_trace_and_annotate_write_a_chrome_trace_on_the_cpu(tmp_path):
    with P.trace(str(tmp_path / "logs")):
        with P.annotate("clip_encode"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path / "logs")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "logs" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "clip_encode" for e in events)
    with P.annotate("outside a trace"):
        pass

