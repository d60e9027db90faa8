"""The port's pipeline parallelism (``parallel/pp.py``) against the JAX
package's on the CPU.

Two gloo worlds (``tests/_torch_dist.py``, one module fixture) of 2 and 4
ranks. Each runs the GPipe executor over a 4-layer stack with a batch mask
and LoRA at (stage, M) = (2, 4) and (4, 2), output and LoRA gradients (the
backward through the tick loop: a rank that ran its collectives out of
order would hang its world past the join timeout), the world of 4 the
pp×sp executor at S = 16 and 13 with the text tower's causal + row-pad
mask, then the train steps pp2 (M = 4, world 2) and pp2×sp2 (M = 2, world
4). In this process: the executors against JAX's
``make_pipeline_transformer`` on the same mesh (rtol 1e-6, atol 1e-5; the
port's own single-process stack rtol 1e-6, atol 1e-6, with the ring SP's
tolerance; gradients of a sum
of squares rtol 1e-3, atol 1e-5 of each leaf's largest), the steps
against JAX's single-device ``make_train_step``, each rank's stage of the
tree against the JAX ``NamedSharding`` shard. Refusals: dropout,
indivisible layers or microbatches, a mesh the world cannot fill.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_lora_match_tpu.parallel import pp as JPP
from clip_lora_match_tpu_torch import parallel as P
from clip_lora_match_tpu_torch.core.config import ClipArchConfig, LoraConfig, TrainingConfig
from clip_lora_match_tpu_torch.models.io import tree_leaves, tree_map
from tests._torch_dist import EXEC, SMALL_KW, numpy_blocks, numpy_lora_blocks, pp_inputs, start_worlds
from tests._torch_helpers import assert_step_matches, jax_step_reference, model_axes_inputs

WORLDS = {"w2": 2, "w4": 4}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pp")
    return d, *model_axes_inputs(d)


@pytest.fixture(scope="module")
def worlds(inputs):
    launched = start_worlds(WORLDS, "pp", inputs[0])
    yield launched
    launched.stop()


@pytest.fixture(scope="module")
def reference(inputs, worlds):
    return jax_step_reference()


def _jax_pipeline(mesh, M, x, mask):
    """JAX's pipeline over the test's 4-layer stack: the output and the
    LoRA gradients of its sum of squares."""
    pipe = JPP.make_pipeline_transformer(mesh, M)
    blocks = jax.tree_util.tree_map(jnp.asarray, numpy_blocks(3, 4, EXEC["width"], EXEC["mlp"]))
    lora = jax.tree_util.tree_map(jnp.asarray, numpy_lora_blocks(4, 4, EXEC["width"]))

    def run(lb):
        return pipe(blocks, jnp.asarray(x), EXEC["heads"], mask=jnp.asarray(mask), lora_blocks=lb,
                    lora_scaling=2.0)

    with mesh:
        out = np.asarray(jax.jit(run)(lora))
        grads = jax.jit(jax.grad(lambda lb: jnp.sum(jnp.square(run(lb)))))(lora)
    return out, dict(tree_leaves(jax.tree_util.tree_map(np.asarray, grads)))


def _plain(x, mask):
    """The port's own single-process ``transformer`` over the same inputs:
    the pipeline is a re-schedule of it."""
    from clip_lora_match_tpu_torch.nn.layers import transformer

    return transformer(tree_map(torch.from_numpy, numpy_blocks(3, 4, EXEC["width"], EXEC["mlp"])),
                       torch.from_numpy(x), EXEC["heads"], mask=torch.from_numpy(mask),
                       lora_blocks=tree_map(torch.from_numpy, numpy_lora_blocks(4, 4, EXEC["width"])),
                       lora_scaling=2.0).numpy()


def _hold(got, grads, ref, ref_grads, plain, ring=False):
    """rtol 1e-6 against the port's own stack in one process (with the ring,
    SP's rtol 2e-5, atol 2e-6: the online softmax reassociates); against
    JAX's pipeline rtol 1e-6 with atol 1e-5 (XLA's and torch's fp32 products
    sum in other orders: ~3e-6 apart at values of ~4 after 4 layers)."""
    np.testing.assert_allclose(got.numpy(), plain, rtol=2e-5 if ring else 1e-6, atol=2e-6 if ring else 1e-6)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-5)
    for path, g in tree_leaves(grads):
        r = ref_grads[path]
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-3, atol=1e-5 * np.abs(r).max(), err_msg=path)


@pytest.mark.parametrize("world", list(WORLDS))
def test_pipeline_matches_the_jax_pipeline(worlds, world):
    n = WORLDS[world]
    M = 4 if n == 2 else 2
    x, mask = pp_inputs()["batch8"]
    ref, ref_grads = _jax_pipeline(JPP.make_pp_mesh(n_stage=n, n_data=1, devices=jax.devices()[:n]), M, x, mask)
    for rank, res in enumerate(worlds[world]):
        got, grads, coords = res["exec"][f"pp{n}"]
        assert coords == (0, rank)
        _hold(got, grads, ref, ref_grads, _plain(x, mask))


@pytest.mark.parametrize("case", ["causal16", "causal13"])
def test_pp_sp_pipeline_matches_jax(worlds, case):
    """dp1×pp2×sp2: every stage's attention on the KV ring; each rank's
    gradient is its stage's, partial over its tokens: the seq ranks' sum,
    stacked by stage, is the whole."""
    x, mask = pp_inputs()[case]
    mesh = JPP.make_pp_mesh(n_stage=2, n_data=1, n_seq=2, devices=jax.devices()[:4])
    ref, ref_grads = _jax_pipeline(mesh, 2, x, mask)
    ranks = worlds["w4"]
    per_stage = []
    for s in range(2):
        pair = [r["exec"][f"ppsp/{case}"] for r in ranks[2 * s:2 * s + 2]]
        assert [p[2] for p in pair] == [(0, s, 0), (0, s, 1)]
        per_stage.append(tree_map(lambda a, b: a + b, pair[0][1], pair[1][1]))
    grads = tree_map(lambda *g: torch.cat(g), *per_stage)
    plain = _plain(x, mask)
    for res in ranks:
        _hold(res["exec"][f"ppsp/{case}"][0], grads, ref, ref_grads, plain, ring=True)


@pytest.mark.parametrize("key", ["w2/step/pp2", "w4/step/pp2xsp2"])
def test_pp_steps_match_the_single_device_step(reference, worlds, key):
    world, name = key.split("/", 1)
    for res in worlds[world]:
        assert_step_matches(res[name], reference)


def test_every_stage_holds_the_jax_shard(inputs):
    """``shard_clip_pp`` at stage s of 2 (the SMALL arch's 2 layers a
    tower) against the JAX shard on the device at (0, s): computed here with
    a mesh object per stage (the split is the rank's coordinate alone)."""
    _, params, lora = inputs
    jmesh = JPP.make_pp_mesh(n_stage=2, n_data=1, devices=jax.devices()[:2])
    for tree in (params, lora):
        placed = dict(tree_leaves(JPP.shard_clip_pp(tree, jmesh)))
        for s in range(2):
            mesh = P.Mesh(("data", "stage"), (1, 2), (0, s), torch.device("cpu"))
            dev = jmesh.devices[0, s]
            for path, t in tree_leaves(P.shard_clip_pp(tree, mesh)):
                ref = next(sh for sh in placed[path].addressable_shards if sh.device == dev).data
                np.testing.assert_array_equal(t.numpy(), np.asarray(ref), err_msg=path)


def test_pp_refuses_dropout_bad_geometry_and_missing_ranks():
    from clip_lora_match_tpu_torch.train import step as tstep

    mesh = P.make_pp_mesh(n_stage=1, device="cpu")
    blocks = tree_map(torch.from_numpy, numpy_blocks(1, 1, 32, 64))
    with pytest.raises(NotImplementedError, match="dropout"):
        P.make_pipeline_transformer(mesh, 2)(blocks, torch.zeros(4, 8, 32), 2, lora_dropout=0.1,
                                             generator=torch.Generator())
    with pytest.raises(ValueError, match="microbatches"):
        P.make_pipeline_transformer(mesh, 3)(blocks, torch.zeros(4, 8, 32), 2)
    tx, _ = tstep.make_optimizer(TrainingConfig(), 3)
    arch = ClipArchConfig(**SMALL_KW)
    with pytest.raises(ValueError, match="dropout"):
        P.make_pp_train_step({}, arch, LoraConfig(dropout=0.1), TrainingConfig(), tx, mesh, 2)
    with pytest.raises(ValueError, match="layers"):
        P.check_pp_divisibility(ClipArchConfig(**{**SMALL_KW, "text_layers": 3}), 2)
    four = P.Mesh(("data", "stage"), (1, 4), (0, 0), torch.device("cpu"))
    with pytest.raises(ValueError, match="layers"):
        P.make_pp_train_step({}, arch, LoraConfig(dropout=0.0), TrainingConfig(), tx, four, 2)
    with pytest.raises(ValueError, match="ranks"):
        P.make_pp_mesh(n_stage=4, device="cpu")
    with pytest.raises(ValueError, match="ranks"):
        P.make_pp_mesh(n_stage=1, n_seq=2, device="cpu")
    assert P.clip_pp_pspecs({"visual": {"blocks": {"w": 0}, "proj": 0}}) == {
        "visual": {"blocks": {"w": P.Split("stage", 0)}, "proj": None}}
