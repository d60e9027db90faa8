"""Shared fixtures for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are drawn with numpy from a seed and handed to both packages; the JAX
package runs on the CPU (its Pallas kernels in interpret mode where a test
switches them on), the port runs its plain versions with device="cpu".
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_lora_match_tpu.core.config import ClipArchConfig as JArch
from clip_lora_match_tpu.nn import layers as jlayers
from clip_lora_match_tpu_torch.core.config import ClipArchConfig as TArch
from clip_lora_match_tpu_torch.nn import layers as tlayers

# head_dim 64 in both towers, so the attention dispatch and the kernel modes
# are the ones the full model takes on the card (image S=5, text S<=77)
SMALL_KW = dict(
    image_size=64, patch_size=32, vision_width=128, vision_layers=2,
    vision_heads=2, vision_mlp_dim=256, text_width=128, text_layers=2,
    text_heads=2, text_mlp_dim=256, vocab_size=514, projection_dim=64,
)
J_SMALL = JArch(**SMALL_KW)
T_SMALL = TArch(**SMALL_KW)


def to_torch(tree):
    """JAX/numpy tree → CPU torch tree (float32 leaves stay float32)."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def to_jax(tree):
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    return jnp.asarray(np.asarray(tree))


def random_like_tree(tree, seed: int = 5, scale: float = 0.05):
    """Same structure, every leaf drawn N(0, scale) from ``seed`` (numpy)."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    leaves = [rng.normal(0, scale, np.shape(x)).astype(np.float32) for x in leaves]
    return jax.tree_util.tree_unflatten(treedef, leaves)


def cosine_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.fixture
def restore_flags():
    """Both packages' kernel-dispatch switches are module state: put them
    back after the test."""
    jprev = dict(jlayers._KERNEL_FLAGS)
    tprev = dict(tlayers._KERNEL_FLAGS)
    yield
    jlayers._KERNEL_FLAGS.update(jprev)
    tlayers._KERNEL_FLAGS.update(tprev)


def set_flags(kernels: bool) -> None:
    """Kernel branches on in both packages (JAX kernels interpreted) or off."""
    jlayers.set_kernel_flags(
        fused_lora=kernels, small_attention=kernels, flash_attention=False,
        interpret=True,
    )
    tlayers.set_kernel_flags(fused_lora=kernels, small_attention=kernels)


# -- the model axes' tests (tests/test_torch_{tp,sp,pp}.py) ------------------


@functools.cache
def _model_axes_trees() -> tuple:
    from clip_lora_match_tpu.core.config import LoraConfig as JLora
    from clip_lora_match_tpu.lora.adapter import init_lora as j_init_lora
    from clip_lora_match_tpu.models import clip as jclip
    from tests._torch_dist import LORA_KW

    params = jax.tree_util.tree_map(np.array, jclip.init_params(jax.random.PRNGKey(0), J_SMALL))
    rng = np.random.default_rng(10)
    for tower in ("visual", "text"):
        for tree in params[tower]["blocks"]["attn"], params[tower]["blocks"]["mlp"]:
            for proj in tree.values():
                proj["bias"] = rng.normal(0, 0.02, proj["bias"].shape).astype(np.float32)
    lora = jax.tree_util.tree_map(np.array, j_init_lora(jax.random.PRNGKey(1), J_SMALL, JLora(**LORA_KW)))
    for tower in lora.values():
        for proj in tower["blocks"]["attn"].values():
            proj["b"] = rng.normal(0, 0.05, proj["b"].shape).astype(np.float32)
    return params, lora


def model_axes_inputs(d) -> tuple:
    """Weights and an adapter the JAX package drew (every block bias and
    every LoRA ``b`` drawn too, so that a bias added twice or a partial
    gradient shows), saved under ``d`` for the ranks: (params, lora) as
    numpy trees, drawn once a process (the three model-axis files share
    them; treat them as read-only)."""
    from clip_lora_match_tpu.core.config import LoraConfig as JLora
    from clip_lora_match_tpu.lora.adapter import save_lora as j_save_lora
    from clip_lora_match_tpu.models.io import save_params as j_save_params
    from tests._torch_dist import LORA_KW

    params, lora = _model_axes_trees()
    j_save_params(str(d / "params.npz"), params)
    j_save_lora(str(d / "lora"), lora, JLora(**LORA_KW))
    return params, lora


@functools.cache
def jax_step_reference() -> dict:
    """The JAX package's single-device ``make_train_step`` over the ranks'
    three batches (``tests/_torch_dist.py::_axis_steps``) from
    ``model_axes_inputs``' trees: losses, grad norms and the final adapter,
    and the loss and LoRA gradients at the first batch (``jax.grad`` of the
    step's loss). Computed once a process."""
    from clip_lora_match_tpu.core.config import LoraConfig as JLora
    from clip_lora_match_tpu.core.config import TrainingConfig as JTrain
    from clip_lora_match_tpu.train import step as jstep
    from clip_lora_match_tpu.train.loss import clip_contrastive_loss as j_loss
    from tests._torch_dist import EOT, LORA_KW, seeded_batches

    params, lora = _model_axes_trees()
    jt = JTrain(learning_rate=5e-3, warmup_ratio=0.1)
    lcfg = JLora(dropout=0.0, **LORA_KW)
    batches = [{k: jnp.asarray(v) for k, v in b.items()} for b in seeded_batches(3, 8, 11)]
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jl = jax.tree_util.tree_map(jnp.asarray, lora)

    def loss(lo):
        img, txt = jstep._tower_features(jp, lo, batches[0], J_SMALL, lcfg, EOT, None, False)
        return j_loss(img, txt, jt.temperature)

    loss0, grads = jax.jit(jax.value_and_grad(loss))(jl)
    tx, _ = jstep.make_optimizer(jt, len(batches))
    state = jstep.init_train_state(jl, tx, seed=0)
    step = jstep.make_train_step(jp, J_SMALL, lcfg, jt, tx, eot_id=EOT)
    losses, norms = [], []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"loss0": float(loss0), "grads": to_torch(jax.tree_util.tree_map(np.asarray, grads)),
            "losses": losses, "norms": norms, "lora": to_torch(jax.tree_util.tree_map(np.asarray, state.lora))}


def assert_step_matches(got: dict, ref: dict) -> None:
    """One rank's ``_axis_steps`` against ``jax_step_reference``: the first
    loss and the 3-step losses within rel 1e-5, the grad norms within rel
    1e-5, the gradients within rtol 1e-3 / atol 1e-5 and the final adapter
    within rel 1e-5 of each leaf's norm."""
    from clip_lora_match_tpu_torch.models.io import tree_leaves

    for g, r in zip([got["loss0"]] + got["losses"] + got["norms"], [ref["loss0"]] + ref["losses"] + ref["norms"],
                    strict=True):
        assert abs(g - r) <= 1e-5 * abs(r), (g, r)
    for (path, g), (_, r) in zip(tree_leaves(got["grads"]), tree_leaves(ref["grads"]), strict=True):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-3, atol=1e-5, err_msg=path)
    for (path, g), (_, r) in zip(tree_leaves(got["lora"]), tree_leaves(ref["lora"]), strict=True):
        err = (g.double() - r.double()).norm() / r.double().norm().clamp_min(1e-30)
        assert err <= 1e-5, (path, err.item())
