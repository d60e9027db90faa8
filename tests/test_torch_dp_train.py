"""The port's data-parallel training against the JAX package's on the CPU.

One gloo world of 2 ranks (``tests/_torch_dist.py``, module fixture) runs:
three train steps at a global batch of 8 (4 a rank) and the eval step, over
weights and an adapter the JAX package drew; one step at dropout 0.1;
``train()`` over the in-repo CSVs for 2 epochs at batch 8 with the writers
spied on; the same run resumed from its epoch-1 checkpoint; and a batch of
5, which does not split over 2 ranks. In this process: the JAX step on a
2-device ``shard_batch`` (``tests/test_training.py:174``'s check held to the
port), the port's single-process step, and the JAX package's ``train()``,
data-parallel over its 8 virtual devices. Losses and grad norms within rel
1e-5, each LoRA leaf within rel 1e-5 of its norm; every rank holds the same
adapter bit for bit; only rank 0 writes.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_lora_match_tpu.core.config import ClipArchConfig as JArch
from clip_lora_match_tpu.core.config import LoraConfig as JLora
from clip_lora_match_tpu.core.config import TrainingConfig as JTrain
from clip_lora_match_tpu.lora.adapter import init_lora as j_init_lora
from clip_lora_match_tpu.lora.adapter import save_lora as j_save_lora
from clip_lora_match_tpu.models import clip as jclip
from clip_lora_match_tpu.models.io import save_params as j_save_params
from clip_lora_match_tpu.parallel.mesh import make_mesh as j_make_mesh
from clip_lora_match_tpu.parallel.mesh import shard_batch as j_shard_batch
from clip_lora_match_tpu.train import step as jstep
from clip_lora_match_tpu.train.trainer import train as j_train
from clip_lora_match_tpu_torch.core.config import ClipArchConfig, LoraConfig, TrainingConfig
from clip_lora_match_tpu_torch.models.io import tree_leaves
from clip_lora_match_tpu_torch.train import step as tstep
from tests._torch_dist import EOT, LORA_KW, REPO, TINY, seeded_batches, start_worlds, train_yaml
from tests._torch_helpers import J_SMALL, T_SMALL, to_torch

REL = 1e-5


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp_train") / "w2"
    d.mkdir()
    params = jax.tree_util.tree_map(np.asarray, jclip.init_params(jax.random.PRNGKey(0), J_SMALL))
    j_save_params(str(d / "params.npz"), params)
    lora = jax.tree_util.tree_map(np.asarray, j_init_lora(jax.random.PRNGKey(1), J_SMALL, JLora(**LORA_KW)))
    rng = np.random.default_rng(10)
    for tower in lora.values():
        for proj in tower["blocks"]["attn"].values():
            proj["b"] = rng.normal(0, 0.05, proj["b"].shape).astype(np.float32)
    j_save_lora(str(d / "lora"), lora, JLora(**LORA_KW))
    tiny = JArch(**TINY)
    tiny_params = jax.tree_util.tree_map(np.asarray, jclip.init_params(jax.random.PRNGKey(3), tiny))
    j_save_params(str(d / "tiny_params.npz"), tiny_params)
    tiny_lora = jax.tree_util.tree_map(
        np.asarray, j_init_lora(jax.random.PRNGKey(42), tiny, JLora(r=4, alpha=8, dropout=0.0)))
    j_save_lora(str(d / "tiny_lora"), tiny_lora, JLora(r=4, alpha=8, dropout=0.0))
    return d, params, lora, tiny_params, tiny_lora


@pytest.fixture(scope="module")
def world(inputs):
    """The 2-rank world's results, joined where a test first reads them:
    the JAX package's steps run here meanwhile."""
    launched = start_worlds({"w2": 2}, "dp_train", inputs[0].parent)
    yield launched["w2"]
    launched.stop()


def _rel_ok(got, ref):
    for g, r in zip(got, ref, strict=True):
        assert abs(g - r) <= REL * abs(r), (g, r)


def _assert_lora_close(got, ref):
    for (path, g), (_, r) in zip(tree_leaves(got), tree_leaves(ref), strict=True):
        err = (g.double() - r.double()).norm() / r.double().norm().clamp_min(1e-30)
        assert err <= REL, (path, err.item())


def _same_on_every_rank(world, key):
    first = world[0][key]
    for res in world[1:]:
        for (_, a), (_, b) in zip(tree_leaves(first), tree_leaves(res[key]), strict=True):
            assert torch.equal(a, b)
    return first


def _jax_steps(params, lora, batches, mesh=None):
    jt = JTrain(learning_rate=5e-3, warmup_ratio=0.1)
    tx, _ = jstep.make_optimizer(jt, len(batches))
    state = jstep.init_train_state(jax.tree_util.tree_map(jnp.asarray, lora), tx, seed=0)
    step = jstep.make_train_step(jax.tree_util.tree_map(jnp.asarray, params), J_SMALL,
                                 JLora(dropout=0.0, **LORA_KW), jt, tx, eot_id=EOT)
    losses, norms = [], []
    for b in batches:
        b = {k: jnp.asarray(v) for k, v in b.items()}
        state, m = step(state, j_shard_batch(mesh, b) if mesh is not None else b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, to_torch(jax.tree_util.tree_map(np.asarray, state.lora)), state


@pytest.fixture(scope="module")
def jax_dp_steps(inputs, world):
    """The JAX package's three steps on a 2-device ``shard_batch`` (computed
    while the ranks run)."""
    _, params, lora, _, _ = inputs
    mesh = j_make_mesh(n_data=2, devices=jax.devices()[:2])
    return _jax_steps(params, lora, seeded_batches(3, 8, 11), mesh)


def test_dp_step_matches_jax_on_a_two_device_mesh(jax_dp_steps, world):
    jl, jn, jlora, _ = jax_dp_steps
    for res in world:
        losses, norms, _ = res["steps"]
        _rel_ok(losses + norms, jl + jn)
    _assert_lora_close(_same_on_every_rank([{"lora": r["steps"][2]} for r in world], "lora"), jlora)


def test_dp_step_matches_the_single_process_step(inputs, world):
    """The 2-rank step at the global batch against the port's own step over
    the whole batch in one process."""
    _, params, lora, _, _ = inputs
    tcfg = TrainingConfig(learning_rate=5e-3, warmup_ratio=0.1)
    batches = seeded_batches(3, 8, 11)
    tx, _ = tstep.make_optimizer(tcfg, len(batches))
    state = tstep.init_train_state(to_torch(lora), tx, seed=0)
    step = tstep.make_train_step(to_torch(params), T_SMALL, LoraConfig(dropout=0.0, **LORA_KW), tcfg, tx,
                                 eot_id=EOT)
    losses, norms = [], []
    for b in batches:
        state, m = step(state, b)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    for res in world:
        got_l, got_n, got_lora = res["steps"]
        _rel_ok(got_l + got_n, losses + norms)
        _assert_lora_close(got_lora, state.lora)


def test_dp_eval_step_matches_jax(inputs, jax_dp_steps, world):
    _, params, _, _, _ = inputs
    *_, state = jax_dp_steps
    b = {k: jnp.asarray(v) for k, v in seeded_batches(3, 8, 11)[0].items()}
    ref = float(jstep.make_eval_step(jax.tree_util.tree_map(jnp.asarray, params), J_SMALL,
                                     JLora(dropout=0.0, **LORA_KW), JTrain(), eot_id=EOT)(state.lora, b))
    for res in world:
        _rel_ok([res["eval"]], [ref])


def test_dp_dropout_shares_one_generator(world):
    """At dropout 0.1 every rank logs the same global loss and keeps the same
    generator state (its masks come from its own pair of the drawn seeds)."""
    (l0, g0), (l1, g1) = world[0]["dropout"], world[1]["dropout"]
    assert l0 == l1 and np.isfinite(l0)
    assert torch.equal(g0, g1)
    fresh = torch.Generator().manual_seed(0)
    torch.randint(0, 2 ** 62, (4,), generator=fresh)  # 2 ranks x 2 towers
    assert torch.equal(g0, fresh.get_state())


def test_train_matches_jax_train_over_two_epochs(inputs, world, tmp_path):
    """train() at 2 ranks against the JAX package's train() over its 8
    virtual devices: batch 8, 2 epochs of 6 steps, validation over 6
    batches, from the same base and initial adapter."""
    _, _, _, tiny_params, tiny_lora = inputs
    import clip_lora_match_tpu.train.trainer as jtrainer

    real = jtrainer.init_lora
    jtrainer.init_lora = lambda *a, **k: jax.tree_util.tree_map(jnp.asarray, tiny_lora)
    try:
        ref = j_train(str(train_yaml(tmp_path / "jax.yaml", tmp_path / "jax", 2, 8,
                                     str(REPO / "data/text/train_fashion.csv"))),
                      arch=JArch(**TINY), params=jax.tree_util.tree_map(jnp.asarray, tiny_params))
    finally:
        jtrainer.init_lora = real
    assert ref.steps == 12 and len(ref.val_losses) == 2
    for res in world:
        steps, epochs, train_losses, val_losses, final, _ = res["train"]
        assert (steps, epochs, len(train_losses)) == (12, 2, 12)
        _rel_ok(train_losses + val_losses, ref.train_losses + ref.val_losses)
        _assert_lora_close(final, to_torch(jax.tree_util.tree_map(np.asarray, ref.final_lora)))


def test_only_rank0_writes(inputs, world):
    run = inputs[0] / "run"
    assert world[0]["train"][5] == ["save_lora", "save_peft_adapter", "checkpoint"] * 2
    assert world[1]["train"][5] == []
    assert world[0]["metrics_exists"] and world[1]["metrics_exists"]  # the primary's file, seen by both
    assert sorted(os.listdir(run)) == ["checkpoints", "epoch_1", "epoch_2", "training_metrics.jsonl"]
    assert sorted(os.listdir(run / "checkpoints")) == ["12.pt", "6.pt"]
    lines = (run / "training_metrics.jsonl").read_text().splitlines()
    assert sum('"event": "val"' in ln for ln in lines) == 2


def test_every_rank_resumes_to_the_uninterrupted_run(world):
    for res in world:
        steps, train_losses, val_losses, final = res["resumed"]
        full = res["train"]
        assert steps == 6 and train_losses == full[2][-6:] and val_losses == full[3][-1:]
        for (_, a), (_, b) in zip(tree_leaves(final), tree_leaves(full[4]), strict=True):
            assert torch.equal(a, b)


def test_a_batch_that_does_not_split_runs_the_single_process_step(inputs, world, tmp_path, monkeypatch):
    import clip_lora_match_tpu_torch.train.trainer as trainer

    _, _, _, tiny_params, tiny_lora = inputs
    monkeypatch.setattr(trainer, "init_lora", lambda *a, **k: to_torch(tiny_lora))
    ref = trainer.train(str(train_yaml(tmp_path / "odd.yaml", tmp_path / "odd", 1, 5, "")),
                        arch=ClipArchConfig(**TINY), params=to_torch(tiny_params), max_steps_per_epoch=2,
                        device="cpu")
    for res in world:
        losses, final = res["odd"]
        assert len(losses) == 2
        _rel_ok(losses, ref.train_losses)
        _assert_lora_close(final, ref.final_lora)
