"""Shared fixtures for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are drawn with numpy from a seed and handed to both packages; the JAX
package runs on the CPU (its Pallas kernels in interpret mode where a test
switches them on), the port runs its plain versions with device="cpu".
"""

from __future__ import annotations

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
