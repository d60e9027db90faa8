"""The port's data axis (``parallel/``) and its index entry points
(``index/cli.py``) against the JAX package on the CPU.

One gloo world of 2 ranks (``tests/_torch_dist.py``, module fixture) runs the
mesh helpers (``shard_batch``, ``global_batch_from_local``, ``replicated``'s
check, the collectives and ``gather_rows``' backward, the refusals), the
sharded encoder over weights and an adapter the JAX package drew, and
``index.cli build-text`` over the ranks. In this process: ``pad_to_multiple``
and the rows of ``shard_batch`` against the JAX package's; the JAX
``ShardedEncoder`` on its 8 virtual devices (fp32 tolerance, empty batches
included); ``initialize_distributed``'s no-op, its reading of ``torchrun``'s
environment and of explicit arguments, and its refusals; an import that
starts no group; the three index subcommands against
``scripts/build_custom_index.py``, ``build_text_index.py`` and
``rebuild_index.py`` (embeddings within 1e-5, the ``.json`` sidecar and the
printed lines equal).
"""

import os
import runpy
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from clip_lora_match_tpu.core.config import LoraConfig as JLora
from clip_lora_match_tpu.lora.adapter import init_lora as j_init_lora
from clip_lora_match_tpu.lora.adapter import save_lora as j_save_lora
from clip_lora_match_tpu.models import clip as jclip
from clip_lora_match_tpu.models.io import save_params as j_save_params
from clip_lora_match_tpu.parallel import mesh as JM
from clip_lora_match_tpu.parallel.sharded_encode import ShardedEncoder as JShardedEncoder
from clip_lora_match_tpu_torch import parallel as P
from clip_lora_match_tpu_torch.index import cli as index_cli
from clip_lora_match_tpu_torch.parallel import distributed as D
from tests._torch_dist import EOT, LORA_KW, REPO, start_worlds, tiny_clip_yaml
from tests._torch_helpers import J_SMALL

TOL = 1e-5


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Weights, an adapter (B drawn too) and encoder inputs from the JAX
    package, the tiny clip config, under one directory."""
    d = tmp_path_factory.mktemp("parallel") / "w2"
    d.mkdir()
    params = jclip.init_params(jax.random.PRNGKey(0), J_SMALL)
    j_save_params(str(d / "params.npz"), params)
    lora = jax.tree_util.tree_map(np.asarray, j_init_lora(jax.random.PRNGKey(1), J_SMALL, JLora(**LORA_KW)))
    rng = np.random.default_rng(10)
    for tower in lora.values():
        for proj in tower["blocks"]["attn"].values():
            proj["b"] = rng.normal(0, 0.05, proj["b"].shape).astype(np.float32)
    j_save_lora(str(d / "lora"), lora, JLora(**LORA_KW))
    lens = rng.integers(4, 20, 7)
    ids = np.full((7, 77), EOT, np.int32)
    mask = np.zeros((7, 77), np.int32)
    for i, n in enumerate(lens):
        ids[i, :n - 1] = rng.integers(1, 500, n - 1)
        mask[i, :n] = 1
    np.savez(d / "encode_inputs.npz", ids=ids, mask=mask,
             pixels=rng.normal(size=(5, 64, 64, 3)).astype(np.float32))
    tiny_clip_yaml(d / "clip.yaml")
    return d, params, lora


@pytest.fixture(scope="module", autouse=True)
def launched(weights):
    """The 2-rank world, started before the module's first test: the tests
    that need no world come first in the module and run while its ranks
    work."""
    w = start_worlds({"w2": 2}, "parallel", weights[0].parent)
    yield w
    w.stop()


@pytest.fixture(scope="module")
def world(launched):
    return launched["w2"]


# -- initialize_distributed ---------------------------------------------------------


_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture
def no_env(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def test_import_starts_no_group_and_one_process_is_a_no_op(no_env):
    assert not dist.is_initialized()
    assert P.initialize_distributed(device="cpu") is False
    assert not dist.is_initialized()
    assert (P.process_count(), P.process_index(), P.is_primary()) == (1, 0, True)
    mesh = P.make_mesh(device="cpu")
    assert (mesh.n_data, mesh.rank, mesh.device, mesh.backend) == (1, 0, torch.device("cpu"), None)
    batch = {"x": np.arange(6).reshape(3, 2)}
    assert torch.equal(P.shard_batch(mesh, batch)["x"], torch.arange(6).reshape(3, 2))


def _spy(monkeypatch):
    calls = []
    monkeypatch.setattr(D.dist, "init_process_group", lambda *a, **k: calls.append((a, k)))
    return calls


def test_reads_torchruns_environment(no_env):
    calls = _spy(no_env)
    for k, v in dict(RANK="3", WORLD_SIZE="4", LOCAL_RANK="1", MASTER_ADDR="localhost", MASTER_PORT="29500").items():
        no_env.setenv(k, v)
    assert P.initialize_distributed(device="cpu", timeout=5) is True
    (args, kw), = calls
    assert args == ("gloo",) and kw["init_method"] == "env://" and (kw["world_size"], kw["rank"]) == (4, 3)
    assert kw["timeout"].total_seconds() == 5


def test_explicit_arguments_override(no_env):
    calls = _spy(no_env)
    assert P.initialize_distributed("localhost:1234", 2, 1, backend="gloo", device="cpu") is True
    assert P.initialize_distributed("file:///tmp/store", 2, 0, device="cpu") is True
    assert [c[1]["init_method"] for c in calls] == ["tcp://localhost:1234", "file:///tmp/store"]
    assert [(c[1]["world_size"], c[1]["rank"]) for c in calls] == [(2, 1), (2, 0)]


def test_explicit_intent_that_fails_raises(no_env, tmp_path):
    with pytest.raises(ValueError, match="together"):
        P.initialize_distributed("file:///tmp/x", 2, device="cpu")
    with pytest.raises(ValueError, match="gloo"):
        P.initialize_distributed(f"file://{tmp_path}/s", 2, 0, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        P.initialize_distributed(f"file://{tmp_path}/s", 2, 0, backend="mpi", device="cpu")

    def refuse(*a, **k):
        raise RuntimeError("store unreachable")

    no_env.setattr(D.dist, "init_process_group", refuse)
    with pytest.raises(RuntimeError, match="unreachable"):
        P.initialize_distributed(f"file://{tmp_path}/s", 2, 0, device="cpu")
    no_env.setenv("RANK", "0")
    no_env.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="unreachable"):
        P.initialize_distributed(device="cpu")
    assert not dist.is_initialized()


def test_nccl_on_a_second_host_from_explicit_arguments(no_env):
    """Two hosts of 4 cards, 8 ranks, started with explicit arguments: a rank
    of the second host joins on its own card; only a known local count or
    a local rank past the cards refuses nccl."""
    calls = _spy(no_env)
    cards = []
    no_env.setattr(D, "resolve_device", torch.device)
    no_env.setattr(D.torch.cuda, "device_count", lambda: 4)
    no_env.setattr(D.torch.cuda, "set_device", cards.append)
    assert P.initialize_distributed("host0:1234", 8, 5, backend="nccl", local_rank=1) is True
    no_env.setenv("LOCAL_RANK", "3")
    no_env.setenv("LOCAL_WORLD_SIZE", "4")
    assert P.initialize_distributed("host0:1234", 8, 7, backend="nccl") is True
    assert [(c[1]["world_size"], c[1]["rank"]) for c in calls] == [(8, 5), (8, 7)]
    assert cards == [torch.device("cuda", 1), torch.device("cuda", 3)]
    no_env.setenv("LOCAL_WORLD_SIZE", "5")
    with pytest.raises(ValueError, match="5 ranks on this host share 4 card.*gloo"):
        P.initialize_distributed("host0:1234", 10, 7, backend="nccl")
    for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        no_env.delenv(k)
    with pytest.raises(ValueError, match="local rank 5 .*local_rank.*gloo"):
        P.initialize_distributed("host0:1234", 8, 5, backend="nccl")
    assert len(calls) == 2


def test_a_card_is_required_where_asked(no_env):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        P.initialize_distributed("file:///tmp/store", 2, 0)


# -- index entry points against the JAX package's scripts -------------------------------


def _run_script(name, argv, capsys):
    """A JAX package script in this process, its printed lines returned."""
    saved = sys.argv, list(sys.path)
    sys.argv = [name, *argv]
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        runpy.run_path(str(REPO / "scripts" / name), run_name="__main__")
    finally:
        sys.argv, sys.path[:] = saved[0], saved[1]
    return capsys.readouterr().out


def _port(argv, capsys):
    index_cli.main(argv)
    return capsys.readouterr().out


def _same_output(tmp, got_out, ref_out, got_lines, ref_lines):
    g, r = np.load(got_out), np.load(ref_out)
    assert g.files == r.files == ["embeddings"]
    np.testing.assert_allclose(g["embeddings"], r["embeddings"], atol=TOL)
    side = lambda p: open(str(p)[:-4] + ".json", "rb").read()  # noqa: E731
    assert side(got_out) == side(ref_out)
    assert got_lines.replace(str(got_out), "OUT") == ref_lines.replace(str(ref_out), "OUT")


def test_build_custom_matches_the_jax_script(weights, tmp_path, capsys):
    d = weights[0]
    common = ["--clip-config", str(d / "clip.yaml"), "--weights", str(d / "params.npz"), "--lora", str(d / "lora")]
    ref_lines = _run_script("build_custom_index.py", ["--out", str(tmp_path / "jax.npz"), *common], capsys)
    got_lines = _port(["build-custom", "--out", str(tmp_path / "port.npz"), "--device", "cpu", *common], capsys)
    assert "verify=ok" in got_lines and "5 items" in got_lines
    _same_output(tmp_path, tmp_path / "port.npz", tmp_path / "jax.npz", got_lines, ref_lines)


def test_rebuild_matches_the_jax_script(weights, tmp_path, capsys):
    from clip_lora_match_tpu_torch.db.store import FoundItem, SqliteStore

    d = weights[0]
    db = str(tmp_path / "found.sqlite")
    store = SqliteStore(db)
    for desc, loc in (("tas pink", "kantin"), ("payung hitam", None), ("botol biru", "perpustakaan")):
        store.insert(FoundItem(id=None, image_path=f"images/{desc}.jpg", description=desc, location=loc))
    store.close()
    common = ["--db", db, "--db-config", str(tmp_path / "none.yaml"), "--clip-config", str(d / "clip.yaml"),
              "--weights", str(d / "params.npz")]
    ref_lines = _run_script("rebuild_index.py", ["--out", str(tmp_path / "jax.npz"), *common], capsys)
    got_lines = _port(["rebuild", "--out", str(tmp_path / "port.npz"), "--device", "cpu", *common], capsys)
    assert "3 DB rows -> 3 index rows" in got_lines
    _same_output(tmp_path, tmp_path / "port.npz", tmp_path / "jax.npz", got_lines, ref_lines)


def test_build_text_matches_the_jax_script_and_the_ranks(weights, world, tmp_path, capsys):
    """One process here against the JAX script (sharded over its 8 devices)
    and against the 2-rank build, where only rank 0 wrote the index."""
    d = weights[0]
    common = ["--csv", str(REPO / "data/text/train_fashion.csv"), "--clip-config", str(d / "clip.yaml"),
              "--weights", str(d / "params.npz"), "--lora", str(d / "lora"), "--batch-size", "16"]
    ref_lines = _run_script("build_text_index.py", ["--out", str(tmp_path / "jax.npz"), *common], capsys)
    got_lines = _port(["build-text", "--out", str(tmp_path / "port.npz"), "--device", "cpu", *common], capsys)
    assert "sharding over 8 devices" in ref_lines and "sharding" not in got_lines
    _same_output(tmp_path, tmp_path / "port.npz", tmp_path / "jax.npz", got_lines,
                 ref_lines.replace("[build_text_index] sharding over 8 devices\n", ""))
    built = d / "built"
    assert sorted(os.listdir(built)) == ["text_index_rank0.json", "text_index_rank0.npz"]
    one = np.load(tmp_path / "port.npz")["embeddings"]
    np.testing.assert_allclose(np.load(built / "text_index_rank0.npz")["embeddings"], one, atol=TOL)
    for res in world:
        np.testing.assert_allclose(res["build_text"], one, atol=TOL)
    assert open(built / "text_index_rank0.json", "rb").read() == open(tmp_path / "port.json", "rb").read()


# -- mesh helpers ---------------------------------------------------------------


@pytest.mark.parametrize("n,multiple,axis", [(10, 4, 0), (8, 4, 0), (7, 3, 1), (0, 2, 0)])
def test_pad_to_multiple_matches_jax(n, multiple, axis):
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    x = x.T.copy() if axis else x
    got, got_n = P.pad_to_multiple(x, multiple, axis)
    ref, ref_n = JM.pad_to_multiple(x, multiple, axis)
    assert got_n == ref_n and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_shard_batch_rows_match_jax(world):
    rng = np.random.default_rng(0)
    batch = {"x": rng.normal(size=(8, 3)).astype(np.float32), "ids": np.arange(16, dtype=np.int32).reshape(8, 2)}
    mesh = JM.make_mesh(n_data=2, devices=jax.devices()[:2])
    placed = JM.shard_batch(mesh, batch)
    for rank, res in enumerate(world):
        for k, v in placed.items():
            shard = next(s for s in v.addressable_shards if s.device == mesh.devices[rank, 0])
            np.testing.assert_array_equal(res["shard_batch"][k], np.asarray(shard.data))
            np.testing.assert_array_equal(res["from_local"][k], np.asarray(shard.data))


def test_mesh_refuses_what_it_cannot_place(world):
    for res in world:
        assert res["shard_batch_ragged"].startswith("ValueError") and "pad_to_multiple" in res["shard_batch_ragged"]
        # a model axis of 3 does not divide a world of 2 ranks
        assert res["model_axis"].startswith("ValueError") and "model axis" in res["model_axis"]
        assert res["n_data_mismatch"].startswith("ValueError")
        assert res["unequal_locals"].startswith("ValueError")


def test_model_axis_mesh_places_each_rank_as_jax_does(world):
    """``make_mesh(n_model=2)`` in the world of 2 is the (data, model) =
    (1, 2) mesh: rank r at JAX device r's coordinates."""
    mesh = JM.make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
    for rank, res in enumerate(world):
        names, sizes, coords = res["model_mesh"]
        assert names == mesh.axis_names and sizes == tuple(mesh.devices.shape)
        position = np.argwhere(mesh.devices == jax.devices()[rank])[0]
        assert coords == tuple(int(c) for c in position)


def test_world_reports_its_ranks(world):
    for rank, res in enumerate(world):
        assert (res["rank"], res["n_data"], res["count"], res["index"]) == (rank, 2, 2, rank)
        assert res["again"] is True and res["primary"] == (rank == 0)
        assert res["still_grouped"] == 2  # build-text leaves a group it did not start


def test_replicated_checks_every_rank(world):
    for res in world:
        assert torch.equal(res["replicated"], torch.arange(6.0).reshape(2, 3))
        assert "a/w" in res["replicated_differs"] and "seed" in res["replicated_differs"]


def test_collectives(world):
    for rank, res in enumerate(world):
        assert torch.equal(res["all_gather"], torch.cat([torch.full((2, 3), 1.0), torch.full((2, 3), 2.0)]))
        assert torch.equal(res["all_reduce"], torch.full((2, 3), 3.0))
        gathered, grad = res["gather_rows"]
        assert torch.equal(gathered, torch.cat([torch.arange(6.0).reshape(2, 3) + 10 * r for r in range(2)]))
        w = torch.arange(12.0).reshape(4, 3)
        assert torch.equal(grad, (w * 1 + w * 2)[2 * rank:2 * rank + 2])


# -- the sharded encoder ----------------------------------------------------------


def _jax_sharded_encoder(weights, n=8):
    _, params, lora = weights
    return JShardedEncoder(params, J_SMALL, eot_id=EOT, lora=jax.tree_util.tree_map(jnp.asarray, lora),
                           lora_scaling=2.0, mesh=JM.make_mesh(n_data=n, devices=jax.devices()[:n]))


@pytest.mark.parametrize("what", ["text", "image"])
def test_sharded_encode_matches_jax(weights, world, what):
    d = weights[0]
    inputs = np.load(d / "encode_inputs.npz")
    enc = _jax_sharded_encoder(weights)
    if what == "text":
        ref = enc.encode_text_batch(inputs["ids"], inputs["mask"])
    else:
        ref = enc.encode_image_batch(inputs["pixels"])
    for res in world:
        got = res[what]
        assert got.shape == ref.shape == (len(ref), 64) and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, atol=TOL)
        empty = res[f"{what}_empty"]
        assert empty.shape == (0, 64) and empty.dtype == np.float32
