"""The port's tensor parallelism (``parallel/tp.py``) against the JAX
package's on the CPU.

Two gloo worlds (``tests/_torch_dist.py``, one module fixture): (data,
model) = (1, 2) in a world of 2 ranks and (2, 2) in a world of 4. Each rank
returns its Megatron shards of weights and an adapter the JAX package drew
(every bias drawn), the TP encode of both towers over its data rows, one
block whose kernels are all zero, and three train steps (TP executor in
both towers) with the gradients at the first batch. In this process: each
rank's shards against the JAX ``NamedSharding`` shard at the same mesh
coordinates, the encodes against the JAX package's GSPMD encode on the
same (data, model) mesh (atol 1e-5), and the steps against JAX's
single-device ``make_train_step`` (losses and grad norms rel 1e-5, gradients
rtol 1e-3 / atol 1e-5). The three traps: a row-parallel bias added once, the
replicated LoRA factors' full gradient on every model rank, ``grad_norm``
equal to the unsharded one. Refusals: int8 weights and dropout under TP,
indivisible heads or MLP.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_lora_match_tpu.models import clip as jclip
from clip_lora_match_tpu.parallel import mesh as JM
from clip_lora_match_tpu.parallel import tp as JTP
from clip_lora_match_tpu_torch import parallel as P
from clip_lora_match_tpu_torch.core.config import ClipArchConfig, LoraConfig, TrainingConfig
from clip_lora_match_tpu_torch.models.io import tree_leaves
from tests._torch_dist import EOT, SMALL_KW, numpy_blocks, seeded_batches, start_worlds
from tests._torch_helpers import J_SMALL, assert_step_matches, jax_step_reference, model_axes_inputs

WORLDS = {"w2": 2, "w4": 4}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    return d, *model_axes_inputs(d)


@pytest.fixture(scope="module")
def worlds(inputs):
    launched = start_worlds(WORLDS, "tp", inputs[0])
    yield launched
    launched.stop()


@pytest.fixture(scope="module")
def reference(inputs, worlds):
    """JAX's single-device steps, computed while the ranks run."""
    return jax_step_reference()


def _jax_mesh(n_data):
    return JM.make_mesh(n_data=n_data, n_model=2, devices=jax.devices()[:2 * n_data])


def _shard_at(arr, mesh, coords):
    dev = mesh.devices[coords]
    return np.asarray(next(s for s in arr.addressable_shards if s.device == dev).data)


@pytest.mark.parametrize("world", list(WORLDS))
def test_every_rank_holds_the_jax_shard_at_its_coordinates(inputs, worlds, world):
    _, params, lora = inputs
    mesh = _jax_mesh(WORLDS[world] // 2)
    jp, jl = JTP.shard_params_tp(params, mesh), JTP.shard_lora_tp(lora, mesh)
    for rank, res in enumerate(worlds[world]):
        assert res["coords"] == (rank // 2, rank % 2)
        assert res["shape"] == dict(mesh.shape)
        for got, ref in ((res["params"], jp), (res["lora"], jl)):
            flat = dict(tree_leaves(ref))
            for path, t in tree_leaves(got):
                np.testing.assert_array_equal(t.numpy(), _shard_at(flat[path], mesh, res["coords"]), err_msg=path)


def test_specs_mirror_the_jax_partition_specs(inputs):
    _, params, lora = inputs
    for port_specs, jax_specs in ((P.clip_tp_pspecs(params), JTP.clip_tp_pspecs(params)),
                                  (P.lora_tp_pspecs(lora), JTP.lora_tp_pspecs(lora))):
        jflat = dict(tree_leaves(jax_specs))
        for path, split in tree_leaves(port_specs):
            spec = tuple(jflat[path])
            if split is None:
                assert all(a is None for a in spec), (path, spec)
            else:
                assert spec[split.dim] == split.axis == "model", (path, spec, split)


@pytest.mark.parametrize("world", list(WORLDS))
def test_tp_encode_matches_the_jax_gspmd_encode(inputs, worlds, world):
    _, params, lora = inputs
    b = seeded_batches(1, 8, 5)[0]
    n_data = WORLDS[world] // 2
    mesh = _jax_mesh(n_data)
    jl = jax.tree_util.tree_map(jnp.asarray, lora)
    with mesh:
        sp, sl = JTP.shard_params_tp(params, mesh), JTP.shard_lora_tp(jl, mesh)
        pix = JM.shard_batch(mesh, {"p": b["pixel_values"].astype(np.float32) / 255.0})["p"]
        img = np.asarray(jax.jit(lambda p, lo, x: jclip.encode_image_features(
            p, x, J_SMALL, lora=lo, lora_scaling=2.0))(sp, sl, pix))
        tb = JM.shard_batch(mesh, {"ids": b["input_ids"], "mask": b["attention_mask"]})
        txt = np.asarray(jax.jit(lambda p, lo, ids, m: jclip.encode_text_features(
            p, ids, J_SMALL, attention_mask=m, eot_id=EOT, lora=lo, lora_scaling=2.0))(
                sp, sl, tb["ids"], tb["mask"]))
    for rank, res in enumerate(worlds[world]):
        rows = slice((rank // 2) * 8 // n_data, (rank // 2 + 1) * 8 // n_data)
        np.testing.assert_allclose(res["image"].numpy(), img[rows], atol=1e-5)
        np.testing.assert_allclose(res["text"].numpy(), txt[rows], atol=1e-5)


def test_row_parallel_bias_is_added_once(worlds):
    """A block whose kernels are all 0 gives x + out_proj's bias + fc2's
    bias: each added once, after the model ranks' sum, on every rank."""
    blk = numpy_blocks(7, 1, 128, 256)
    b_out, b_fc2 = blk["attn"]["out_proj"]["bias"][0], blk["mlp"]["fc2"]["bias"][0]
    for world in WORLDS:
        for res in worlds[world]:
            x, y = res["bias_block"]
            np.testing.assert_array_equal(y.numpy(), (x.numpy() + b_out) + b_fc2)


@pytest.mark.parametrize("world", list(WORLDS))
def test_tp_step_matches_the_single_device_step(reference, worlds, world):
    for res in worlds[world]:
        assert_step_matches(res["step"], reference)


def test_replicated_lora_factors_get_the_whole_gradient_on_every_model_rank(reference, worlds):
    """A column-parallel ``a`` and a row-parallel ``b`` are whole on every
    model rank; each rank's own partial gradient is summed over the model
    axis, so both ranks hold JAX's gradient and the same adapter."""
    for world in WORLDS:
        ranks = worlds[world]
        for path in ("visual/blocks/attn/q_proj/a", "text/blocks/attn/v_proj/a",
                     "visual/blocks/attn/out_proj/b", "text/blocks/attn/out_proj/b"):
            grads = [dict(tree_leaves(r["step"]["grads"]))[path] for r in ranks]
            ref = dict(tree_leaves(reference["grads"]))[path]
            for g in grads:
                np.testing.assert_allclose(g.numpy(), ref.numpy(), rtol=1e-3, atol=1e-5, err_msg=path)
            assert all(torch.equal(grads[0], g) for g in grads[1:])
            final = [dict(tree_leaves(r["step"]["lora"]))[path] for r in ranks]
            assert all(torch.equal(final[0], f) for f in final[1:])


def test_grad_norm_equals_the_unsharded_one(reference, worlds):
    for world in WORLDS:
        for res in worlds[world]:
            for g, r in zip(res["step"]["norms"], reference["norms"], strict=True):
                assert abs(g - r) <= 1e-5 * r, (g, r)


def test_tp_refuses_int8_weights_dropout_and_indivisible_splits(inputs):
    from clip_lora_match_tpu_torch.quant.int8 import quantize_linear_params

    mesh = P.make_mesh(device="cpu")
    q = quantize_linear_params({"kernel": torch.randn(2, 8, 4)})
    with pytest.raises(NotImplementedError, match="int8"):
        P.shard_params_tp({"visual": {"blocks": {"attn": {"q_proj": q}}}}, mesh)
    fn = P.make_tp_transformer(mesh)
    blocks = torch.zeros(1)
    with pytest.raises(NotImplementedError, match="dropout"):
        fn(blocks, torch.zeros(1, 2, 8), 2, lora_dropout=0.1, generator=torch.Generator())
    arch = ClipArchConfig(**{**SMALL_KW, "vision_heads": 3})
    with pytest.raises(ValueError, match="heads"):
        P.check_tp_divisibility(arch, 2)
    with pytest.raises(ValueError, match="mlp_dim"):
        P.check_tp_divisibility(ClipArchConfig(**{**SMALL_KW, "text_mlp_dim": 255}), 2)
    P.check_tp_divisibility(ClipArchConfig(**SMALL_KW), 2)
    with pytest.raises(ValueError, match="model axis"):
        P.make_mesh(n_model=2, device="cpu")  # one process: the model axis does not divide the world
    with pytest.raises(ValueError, match="init_tp_train_state"):
        from clip_lora_match_tpu_torch.train import step as tstep

        mesh2 = P.Mesh(("data", "model"), (1, 2), (0, 0), torch.device("cpu"))
        tx, _ = tstep.make_optimizer(TrainingConfig(), 3)
        state = tstep.init_train_state({"a": torch.zeros(2)}, tx)
        tstep.make_train_step({}, ClipArchConfig(**SMALL_KW), LoraConfig(), TrainingConfig(), tx,
                              mesh=mesh2)(state, {})


def test_global_put_and_data_sharded_place_a_block(inputs):
    """The JAX package's placement names: ``global_put`` gives this rank's
    block under a split (the whole array without one), ``data_sharded`` the
    split of a batch's leading axis."""
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    for coords in ((0, 0), (0, 1)):
        mesh = P.Mesh(("data", "model"), (1, 2), coords, torch.device("cpu"))
        got = P.global_put(mesh, x, P.Split("model", -1))
        assert got.is_contiguous() and torch.equal(got, torch.from_numpy(x[:, 3 * coords[1]:3 * coords[1] + 3]))
        assert torch.equal(P.global_put(mesh, x, None), torch.from_numpy(x))
        assert P.data_sharded(mesh, rank=2) == P.Split("data", 0)
