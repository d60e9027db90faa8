"""The port's sequence parallelism (``parallel/sp.py``,
``ops/ring_attention.py``) against the JAX package's on the CPU.

Two gloo worlds (``tests/_torch_dist.py``, one module fixture) of 2 and 4
ranks. Each runs ring attention at n_seq = its size (dense, causal, and a
batch mask with fully masked rows: each rank's output block and q/k/v
gradients), the SP executor over a 3-layer stack at S = 16, S = 10 (the pad
path), S = 13 with a causal + row-pad mask and LoRA (with the LoRA
gradients), and S = 13 with a broadcast key mask, on (data, seq) = (1, n)
and, in the world of 4, (2, 2); then the train steps: sp2 (world 2),
dp2×sp2 and dp1×tp2×sp2 (world 4). In this process: the ring against the
JAX ring inside ``shard_map`` on the same (1, n) mesh (rtol 2e-5, atol
2e-6; gradients rtol 1e-4, atol 1e-5), the executor against JAX's
``make_sp_transformer`` on a (2, 2) mesh (rtol 2e-5, atol 2e-6; gradients
of a sum of squares rtol 1e-3, atol 1e-5 of each leaf's largest), and the
steps against JAX's single-device ``make_train_step``. Refusals: dropout, underspecified masks, a mesh the
world cannot fill, indivisible heads under dp×tp×sp.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

from clip_lora_match_tpu.ops.ring_attention import ring_attention as j_ring
from clip_lora_match_tpu.parallel.mesh import compat_shard_map
from clip_lora_match_tpu.parallel.sp import make_sp_mesh as j_sp_mesh
from clip_lora_match_tpu.parallel.sp import make_sp_transformer as j_sp_transformer
from clip_lora_match_tpu_torch import parallel as P
from clip_lora_match_tpu_torch.core.config import ClipArchConfig, LoraConfig, TrainingConfig
from clip_lora_match_tpu_torch.models.io import tree_leaves, tree_map
from clip_lora_match_tpu_torch.ops.ring_attention import _MASK_FLOOR, ring_attention_oracle
from tests._torch_dist import EXEC, SMALL_KW, numpy_blocks, numpy_lora_blocks, ring_inputs, sp_inputs, start_worlds
from tests._torch_helpers import assert_step_matches, jax_step_reference, model_axes_inputs

WORLDS = {"w2": 2, "w4": 4}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sp")
    return d, *model_axes_inputs(d)


@pytest.fixture(scope="module")
def worlds(inputs):
    launched = start_worlds(WORLDS, "sp", inputs[0])
    yield launched
    launched.stop()


@pytest.fixture(scope="module")
def reference(inputs, worlds):
    return jax_step_reference()


def _jax_ring(n, q, k, v, mask):
    """The JAX ring inside shard_map on a (1, n) mesh, and its q/k/v
    gradients of the weighted sum the ranks take."""
    mesh = j_sp_mesh(n_seq=n, n_data=1, devices=jax.devices()[:n])
    seq = JP(None, "seq")
    opt, specs = {}, {}
    if mask is not None:
        opt["mask"] = jnp.asarray(mask)
        specs["mask"] = JP(None, None, "seq" if mask.shape[2] > 1 else None, None)
    fn = compat_shard_map(lambda q_, k_, v_, o: j_ring(q_, k_, v_, "seq", mask=o.get("mask")), mesh=mesh,
                          in_specs=(seq, seq, seq, specs), out_specs=seq, check_rep=False)
    w = jnp.asarray(np.random.default_rng(3).normal(size=q.shape).astype(np.float32))
    with mesh:
        out = jax.jit(fn)(q, k, v, opt)
        grads = jax.jit(jax.grad(lambda a, b, c: jnp.sum(fn(a, b, c, opt) * w), argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("case", ["dense", "causal", "masked_rows"])
def test_ring_attention_matches_the_jax_ring(worlds, world, case):
    n = WORLDS[world]
    q, k, v, mask = ring_inputs(n)[case]
    ref, ref_grads = _jax_ring(n, q, k, v, mask)
    ranks = worlds[world]
    got = [torch.cat([r["ring"][case][i] for r in ranks], dim=1).numpy() for i in range(4)]
    np.testing.assert_allclose(got[0], ref, rtol=2e-5, atol=2e-6)
    for g, r in zip(got[1:], ref_grads):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-5)
    if case == "masked_rows":
        assert not np.isnan(got[0]).any()
        np.testing.assert_array_equal(got[0][:, 12:], 0.0)


def test_ring_attention_oracle_matches_jax():
    from clip_lora_match_tpu.ops.ring_attention import ring_attention_oracle as j_oracle

    for case, (q, k, v, mask) in ring_inputs(2).items():
        got = ring_attention_oracle(*(torch.from_numpy(a) for a in (q, k, v)),
                                    mask=None if mask is None else torch.from_numpy(mask))
        ref = j_oracle(q, k, v, mask=None if mask is None else jnp.asarray(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-6, err_msg=case)
    assert _MASK_FLOOR == -3.4e38


@pytest.fixture(scope="module")
def jax_sp(worlds):
    """JAX's SP executor on a (data, seq) = (2, 2) mesh for every input; the
    LoRA gradients of the sum of squares for the LoRA input."""
    mesh = j_sp_mesh(n_seq=2, n_data=2, devices=jax.devices()[:4])
    sp = j_sp_transformer(mesh)
    blocks = jax.tree_util.tree_map(jnp.asarray, numpy_blocks(1, 3, EXEC["width"], EXEC["mlp"]))
    lora = jax.tree_util.tree_map(jnp.asarray, numpy_lora_blocks(2, 3, EXEC["width"]))
    out = {}
    with mesh:
        for name, (x, mask, with_lora) in sp_inputs().items():
            m = None if mask is None else jnp.asarray(mask)

            def run(lb, m=m, x=x):
                return sp(blocks, jnp.asarray(x), EXEC["heads"], mask=m, lora_blocks=lb, lora_scaling=2.0)

            lb = lora if with_lora else None
            grads = None
            if with_lora:
                grads = jax.jit(jax.grad(lambda lb: jnp.sum(jnp.square(run(lb)))))(lb)
                grads = dict(tree_leaves(jax.tree_util.tree_map(np.asarray, grads)))
            out[name] = (np.asarray(jax.jit(run)(lb)), grads)
    return out


@pytest.mark.parametrize("tag", ["w2/1x2", "w4/1x4", "w4/2x2"])
@pytest.mark.parametrize("case", list(sp_inputs()))
def test_sp_executor_matches_jax(worlds, jax_sp, tag, case):
    world, mesh = tag.split("/")
    ranks = worlds[world]
    n_data = int(mesh[0])
    ref, ref_grads = jax_sp[case]
    for rank, res in enumerate(ranks):
        d = rank // (len(ranks) // n_data)
        got, _ = res["exec"][f"{mesh}/{case}"]
        np.testing.assert_allclose(got.numpy(), ref[d * 8 // n_data:(d + 1) * 8 // n_data], rtol=2e-5, atol=2e-6)
    if ref_grads is not None:
        # each rank's gradient covers its rows and its tokens: their sum is
        # the whole's (a sum of squares: atol 1e-5 of each leaf's largest)
        total = tree_map(lambda *g: sum(g), *[r["exec"][f"{mesh}/{case}"][1] for r in ranks])
        for path, g in tree_leaves(total):
            r = ref_grads[path]
            np.testing.assert_allclose(g.numpy(), r, rtol=1e-3, atol=1e-5 * np.abs(r).max(), err_msg=path)


@pytest.mark.parametrize("key", ["w2/step/sp2", "w4/step/dp2xsp2", "w4/step/tp2xsp2"])
def test_sp_steps_match_the_single_device_step(reference, worlds, key):
    world, name = key.split("/", 1)
    for res in worlds[world]:
        assert_step_matches(res[name], reference)


def test_sp_refuses_dropout_masks_it_cannot_split_and_missing_ranks(inputs):
    from clip_lora_match_tpu_torch.train import step as tstep

    mesh = P.make_sp_mesh(n_seq=1, device="cpu")
    fn = P.make_sp_transformer(mesh)
    blocks = tree_map(torch.from_numpy, numpy_blocks(1, 1, 32, 64))
    x = torch.zeros(2, 16, 32)
    with pytest.raises(NotImplementedError, match="dropout"):
        fn(blocks, x, 2, lora_dropout=0.1, generator=torch.Generator())
    tx, _ = tstep.make_optimizer(TrainingConfig(), 3)
    arch = ClipArchConfig(**SMALL_KW)
    with pytest.raises(ValueError, match="dropout"):
        P.make_sp_train_step({}, arch, LoraConfig(dropout=0.1), TrainingConfig(), tx, mesh)
    neg = float(np.finfo(np.float32).min)
    with pytest.raises(ValueError, match="4-dim"):
        fn(blocks, x, 2, mask=torch.triu(torch.full((16, 16), neg), diagonal=1))
    with pytest.raises(ValueError, match="query-row"):
        fn(blocks, x, 2, mask=torch.zeros(2, 1, 4, 16))
    with pytest.raises(ValueError, match="ranks"):
        P.make_sp_mesh(n_seq=4, device="cpu")
    with pytest.raises(ValueError, match="ranks"):
        P.make_sp_mesh(n_seq=1, n_data=2, device="cpu")
    bad = ClipArchConfig(**{**SMALL_KW, "vision_heads": 3})
    three = P.Mesh(("data", "model", "seq"), (1, 2, 2), (0, 0, 0), torch.device("cpu"))
    with pytest.raises(ValueError, match="heads"):
        P.make_sp_train_step({}, bad, LoraConfig(dropout=0.0), TrainingConfig(), tx, three)


def test_pad_keeps_a_broadcast_row_mask_broadcast():
    x = torch.zeros(2, 13, 8)
    _, m, pad = P.sp.pad_seq_and_mask(x, torch.zeros(2, 1, 1, 13), 4)
    assert pad == 3 and m.shape == (2, 1, 1, 16) and bool((m[..., 13:] == _MASK_FLOOR).all())
    _, m, _ = P.sp.pad_seq_and_mask(x, torch.zeros(2, 1, 13, 13), 4)
    assert m.shape == (2, 1, 16, 16) and bool((m[:, :, 13:] == _MASK_FLOOR).all())
    _, m, _ = P.sp.pad_seq_and_mask(x, None, 4)
    assert m.shape == (1, 1, 1, 16) and float(m[..., :13].abs().max()) == 0.0
    assert P.sp.seq_mask_spec(torch.zeros(2, 1, 16, 16)) == P.Split("seq", 2)
    assert P.sp.seq_mask_spec(torch.zeros(2, 1, 1, 16)) is None


@pytest.mark.parametrize("module", ["clip_lora_match_tpu_torch.ops.ring_attention",
                                    "clip_lora_match_tpu_torch.parallel.sp",
                                    "clip_lora_match_tpu_torch.parallel"])
def test_each_module_imports_first_in_a_fresh_process(module):
    """ops/ring_attention.py imports parallel.mesh, whose package imports
    sp.py: no order of first import may meet a half-made module."""
    import subprocess
    import sys

    from tests._torch_dist import REPO

    done = subprocess.run([sys.executable, "-c", f"import {module}"], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert done.returncode == 0, done.stderr[-2000:]
