"""The port's training path against the JAX package's on the CPU.

- The three differentiable kernels (``lora_matmul``, including the grouped
  q/k/v launch; ``attention_small`` maskless, with an additive mask and
  causal + lengths; ``mlp_fused``): the port's autograd Functions' gradients
  against ``jax.grad`` of the JAX kernels run in interpret mode, fp32, rel
  1e-5 (each gradient's largest error over its largest value).
  ``flash_attention`` refuses a differentiable call.
- ``fast_ln`` and the shared-mask q/k/v delta against the JAX package's at
  rate 0 (rel 1e-5); at rate > 0: one mask for the three projections, a keep
  share within 3 sigma of 1 - rate, the backward equal to autograd through the
  redrawn mask; ``linear``'s dropout bypassing ``lora_matmul``.
- The loss (within 1e-6) and the schedule (within 1e-9 of optax's at every
  step).
- Three ``make_train_step`` steps at dropout 0 from the same base and the
  same initial LoRA (the JAX package's ``init_lora``, carried over as numpy):
  losses, grad norms and the final LoRA within rel 1e-5 of the JAX step's
  (the LoRA by each leaf's norm), with and without gradient accumulation;
  the chained step K=2 bit-equal to the port's single steps; the eval step.
- Port-only: ``remat`` True and "dots" give the loss and gradients of False
  at dropout 0.1; the base parameters stay bit for bit; resume equals an
  uninterrupted run bit for bit at dropout 0.1; ``train()`` follows the JAX
  package's ``train()`` over 2 epochs at dropout 0 (losses and final LoRA
  within rel 1e-5); ``train()``'s ``epoch_k``
  adapters, native and PEFT, read back by the JAX package's ``load_lora``
  equal to the run's LoRA.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_lora_match_tpu.core.config import LoraConfig as JLora
from clip_lora_match_tpu.core.config import TrainingConfig as JTrain
from clip_lora_match_tpu.lora.adapter import init_lora as j_init_lora
from clip_lora_match_tpu.lora.adapter import load_lora as j_load_lora
from clip_lora_match_tpu.models import clip as jclip
from clip_lora_match_tpu.nn import layers as J
from clip_lora_match_tpu.ops.attention_small import attention_small as j_attention_small
from clip_lora_match_tpu.ops.lora_matmul import lora_matmul as j_lora_matmul
from clip_lora_match_tpu.ops.mlp_fused import mlp_fused as j_mlp_fused
from clip_lora_match_tpu.train import loss as jloss
from clip_lora_match_tpu.train import step as jstep
from clip_lora_match_tpu_torch.core.config import LoraConfig as TLora
from clip_lora_match_tpu_torch.core.config import TrainingConfig as TTrain
from clip_lora_match_tpu_torch.nn import layers as T
from clip_lora_match_tpu_torch.ops import attention_small as A
from clip_lora_match_tpu_torch.ops import flash_attention as F
from clip_lora_match_tpu_torch.ops import lora_matmul as L
from clip_lora_match_tpu_torch.ops import mlp_fused as MF
from clip_lora_match_tpu_torch.models.io import tree_leaves, unflatten
from clip_lora_match_tpu_torch.train import loss as tloss
from clip_lora_match_tpu_torch.train import step as tstep
from tests._torch_helpers import J_SMALL, T_SMALL, restore_flags, to_torch  # noqa: F401

REL = 1e-5
NEG = float(np.finfo(np.float32).min)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _grads_torch(fn, inputs, cot):
    ts = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    out = fn(*ts)
    out.backward(torch.from_numpy(cot))
    return [t.grad.numpy() for t in ts]


def _grads_jax(fn, inputs, cot):
    def f(*xs):
        return jnp.sum(fn(*xs) * jnp.asarray(cot))

    return [np.asarray(g) for g in jax.grad(f, argnums=tuple(range(len(inputs))))(*map(jnp.asarray, inputs))]


# ---------------------------------------------------------------------------
# the three differentiable kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M,K,N,r", [(50, 128, 128, 8), (77, 64, 192, 24)])
def test_lora_matmul_grads_match_jax(M, K, N, r):
    rng = np.random.default_rng(0)
    x, w = rng.normal(size=(M, K)).astype(np.float32), rng.normal(size=(K, N)).astype(np.float32) * 0.1
    a, b = rng.normal(size=(K, r)).astype(np.float32) * 0.1, rng.normal(size=(r, N)).astype(np.float32) * 0.1
    cot = rng.normal(size=(M, N)).astype(np.float32)
    got = _grads_torch(lambda *t: L.lora_matmul(*t, scaling=2.0), (x, w, a, b), cot)
    ref = _grads_jax(lambda *t: j_lora_matmul(*t, scaling=2.0, interpret=True), (x, w, a, b), cot)
    for name, g, r_ in zip(("dx", "dW", "dA", "dB"), got, ref):
        assert _rel(g, r_) <= REL, name


def test_grouped_qkv_launch_gives_each_adapter_its_ungrouped_gradient():
    rng = np.random.default_rng(1)
    D, r, M = 128, 8, 40
    p = {n: {"kernel": torch.from_numpy(rng.normal(size=(D, D)).astype(np.float32) * 0.1),
             "bias": torch.zeros(D)} for n in T.QKV}
    leaves = {n: {"a": torch.from_numpy(rng.normal(size=(D, r)).astype(np.float32) * 0.1).requires_grad_(True),
                  "b": torch.from_numpy(rng.normal(size=(r, D)).astype(np.float32) * 0.1).requires_grad_(True)}
              for n in T.QKV}
    x = torch.from_numpy(rng.normal(size=(M, D)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(3, M, D)).astype(np.float32))
    g = T.group_qkv(p, leaves)
    (L.lora_matmul(x, g["kernel"], g["a"], g["b"], scaling=2.0, groups=3) * cot).sum().backward()
    grouped = {n: (leaves[n]["a"].grad.clone(), leaves[n]["b"].grad.clone()) for n in T.QKV}
    for i, n in enumerate(T.QKV):
        a = leaves[n]["a"].detach().requires_grad_(True)
        b = leaves[n]["b"].detach().requires_grad_(True)
        (L.lora_matmul(x, p[n]["kernel"], a, b, scaling=2.0) * cot[i]).sum().backward()
        ref = _grads_jax(lambda a_, b_, w=p[n]["kernel"].numpy(): j_lora_matmul(
            jnp.asarray(x.numpy()), jnp.asarray(w), a_, b_, scaling=2.0, interpret=True),
            (a.detach().numpy(), b.detach().numpy()), cot[i].numpy())
        assert _rel(grouped[n][0], a.grad) <= REL and _rel(grouped[n][1], b.grad) <= REL, n
        assert _rel(grouped[n][0], ref[0]) <= REL and _rel(grouped[n][1], ref[1]) <= REL, n


@pytest.mark.parametrize("mode", ["none", "mask", "causal_lengths"])
def test_attention_small_grads_match_jax(mode):
    rng = np.random.default_rng(2)
    B, S, H, d = 3, 50 if mode != "causal_lengths" else 77, 2, 64
    q, k, v = (rng.normal(size=(B, S, H, d)).astype(np.float32) for _ in range(3))
    cot = rng.normal(size=(B, S, H, d)).astype(np.float32)
    kw = {}
    if mode == "mask":
        m = np.where(rng.random((B, 1, S, S)) < 0.3, NEG, 0.0).astype(np.float32)
        m[..., 0] = 0.0
        tkw, jkw = dict(mask=torch.from_numpy(m)), dict(mask=jnp.asarray(m))
    elif mode == "causal_lengths":
        lens = np.array([S, 9, 30], np.int32)
        tkw = dict(causal=True, lengths=torch.from_numpy(lens))
        jkw = dict(causal=True, lengths=jnp.asarray(lens))
    else:
        tkw, jkw = kw, kw
    got = _grads_torch(lambda *t: A.attention_small(*t, **tkw), (q, k, v), cot)
    ref = _grads_jax(lambda *t: j_attention_small(*t, interpret=True, **jkw), (q, k, v), cot)
    for name, g, r_ in zip(("dq", "dk", "dv"), got, ref):
        assert _rel(g, r_) <= REL, name


def test_mlp_fused_grads_match_jax():
    rng = np.random.default_rng(3)
    M, K, H = 50, 128, 256
    ins = (rng.normal(size=(M, K)).astype(np.float32), rng.normal(size=(K, H)).astype(np.float32) * 0.1,
           rng.normal(size=(H,)).astype(np.float32) * 0.1, rng.normal(size=(H, K)).astype(np.float32) * 0.1,
           rng.normal(size=(K,)).astype(np.float32) * 0.1)
    cot = rng.normal(size=(M, K)).astype(np.float32)
    got = _grads_torch(MF.mlp_fused, ins, cot)
    ref = _grads_jax(lambda *t: j_mlp_fused(*t, interpret=True), ins, cot)
    for name, g, r_ in zip(("dx", "dW1", "db1", "dW2", "db2"), got, ref):
        assert _rel(g, r_) <= REL, name


def test_kernel_wrappers_without_grad_return_plain_tensors():
    x = torch.randn(4, 8)
    y = L.lora_matmul(x, torch.randn(8, 8), torch.randn(8, 2), torch.randn(2, 8))
    assert y.grad_fn is None
    with torch.no_grad():
        y = L.lora_matmul(x, torch.randn(8, 8, requires_grad=True), torch.randn(8, 2), torch.randn(2, 8))
    assert y.grad_fn is None


def test_flash_attention_refuses_a_differentiable_call():
    q, k, v = (torch.randn(2, 8, 1, 64) for _ in range(3))
    with pytest.raises(RuntimeError, match="no backward"):
        F.flash_attention(q.requires_grad_(True), k, v)
    with torch.no_grad():
        assert F.flash_attention(q, k, v).shape == q.shape
    F.flash_attention(q.detach(), k, v)


# ---------------------------------------------------------------------------
# fast_ln, the shared-mask q/k/v delta, dropout
# ---------------------------------------------------------------------------


def test_fast_ln_matches_jax(restore_flags):  # noqa: F811
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 7, 64)).astype(np.float32) * 2 + 0.5
    scale, bias = rng.normal(size=(64,)).astype(np.float32), rng.normal(size=(64,)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    T.set_kernel_flags(fast_ln=True)
    got = _grads_torch(lambda x_, s, b: T.layer_norm({"scale": s, "bias": b}, x_), (x, scale, bias), cot)
    ref = _grads_jax(lambda x_, s, b: J._ln_fast(x_, s, b, 1e-5), (x, scale, bias), cot)
    for name, g, r_ in zip(("dx", "dscale", "dbias"), got, ref):
        assert _rel(g, r_) <= REL, name
    t = [torch.from_numpy(v).requires_grad_(True) for v in (x, scale, bias)]
    y = T.layer_norm({"scale": t[1], "bias": t[2]}, t[0])
    assert type(y.grad_fn).__name__.startswith("_FastLayerNorm")
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(J._ln_plain(x, scale, bias, 1e-5)), rtol=0, atol=1e-6)


def _shared_inputs(seed=5, B=2, S=9, D=64, r=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    a_cat = rng.normal(size=(D, 3 * r)).astype(np.float32) * 0.2
    b_stk = rng.normal(size=(3, r, D)).astype(np.float32) * 0.2
    cot = rng.normal(size=(B, S, 3, D)).astype(np.float32)
    return x, a_cat, b_stk, cot


def test_shared_mask_qkv_delta_matches_jax_at_rate_0():
    x, a_cat, b_stk, cot = _shared_inputs()
    gen = torch.Generator().manual_seed(0)
    got_y = T._QkvLoraShared.apply(*map(torch.from_numpy, (x, a_cat, b_stk)), gen, 2.0, 0.0)
    ref_y = J._qkv_lora_shared(*map(jnp.asarray, (x, a_cat, b_stk)), jax.random.PRNGKey(0), 2.0, 0.0)
    assert _rel(got_y.numpy(), ref_y) <= REL
    got = _grads_torch(lambda *t: T._QkvLoraShared.apply(*t, torch.Generator().manual_seed(0), 2.0, 0.0),
                       (x, a_cat, b_stk), cot)
    ref = _grads_jax(lambda *t: J._qkv_lora_shared(*t, jax.random.PRNGKey(0), 2.0, 0.0), (x, a_cat, b_stk), cot)
    for name, g, r_ in zip(("dx", "da", "db"), got, ref):
        assert _rel(g, r_) <= REL, name


def test_shared_mask_qkv_delta_at_rate_01():
    rate, s = 0.1, 2.0
    x, a_cat, b_stk, cot = _shared_inputs(6, B=4, S=50, D=64, r=4)
    gen = torch.Generator().manual_seed(11)
    state = gen.get_state()
    ts = [torch.from_numpy(v).requires_grad_(True) for v in (x, a_cat, b_stk)]
    y = T._QkvLoraShared.apply(*ts, gen, s, rate)
    y.backward(torch.from_numpy(cot))
    # the mask, redrawn from the state the Function saw
    g2 = torch.Generator()
    g2.set_state(state)
    keep = torch.rand(x.shape, generator=g2) < 1.0 - rate
    share = keep.float().mean().item()
    n = keep.numel()
    assert abs(share - (1 - rate)) <= 3 * np.sqrt(rate * (1 - rate) / n), share
    ref_ts = [torch.from_numpy(v).requires_grad_(True) for v in (x, a_cat, b_stk)]
    xl = torch.where(keep, ref_ts[0] / (1 - rate), torch.zeros(()))
    r = b_stk.shape[1]
    deltas = torch.stack([s * ((xl @ ref_ts[1][:, i * r:(i + 1) * r]) @ ref_ts[2][i]) for i in range(3)], dim=2)
    # one mask for the three projections: each slab is that mask's delta
    assert _rel(y.detach().numpy(), deltas.detach().numpy()) <= REL
    deltas.backward(torch.from_numpy(cot))
    for name, t, rt in zip(("dx", "da", "db"), ts, ref_ts):
        assert _rel(t.grad.numpy(), rt.grad.numpy()) <= REL, name


def test_attention_takes_the_shared_mask_only_when_asked(restore_flags):  # noqa: F811
    rng = np.random.default_rng(7)
    D, r = 128, 4
    p = {n: {"kernel": torch.from_numpy(rng.normal(size=(D, D)).astype(np.float32) * 0.05),
             "bias": torch.zeros(D)} for n in (*T.QKV, "out_proj")}
    lora = {n: {"a": torch.from_numpy(rng.normal(size=(D, r)).astype(np.float32) * 0.1),
                "b": torch.from_numpy(rng.normal(size=(r, D)).astype(np.float32) * 0.1)} for n in p}
    x = torch.from_numpy(rng.normal(size=(2, 6, D)).astype(np.float32)).requires_grad_(True)
    T.set_kernel_flags(fused_lora=False, small_attention=False)
    outs = {}
    for shared in (False, True):
        T.set_kernel_flags(fused_lora_dropout=shared)
        y = T.attention(p, x, 2, lora=lora, lora_scaling=2.0, lora_dropout=0.1,
                        generator=torch.Generator().manual_seed(3))
        outs[shared] = y
    names = {type(n).__name__ for n in _graph_nodes(outs[True].grad_fn)}
    assert any(n.startswith("_QkvLoraShared") for n in names)
    assert not any(n.startswith("_QkvLoraShared") for n in {type(n).__name__ for n in _graph_nodes(outs[False].grad_fn)})
    assert not torch.equal(outs[True], outs[False])


def _graph_nodes(fn):
    seen, stack = [], [fn]
    while stack:
        f = stack.pop()
        if f is None or f in seen:
            continue
        seen.append(f)
        stack.extend(nf for nf, _ in f.next_functions)
    return seen


def test_linear_dropout_bypasses_lora_matmul(restore_flags):  # noqa: F811
    rng = np.random.default_rng(8)
    p = {"kernel": torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32)), "bias": torch.zeros(64)}
    lora = {"a": torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32)),
            "b": torch.from_numpy(rng.normal(size=(8, 64)).astype(np.float32))}
    x = torch.from_numpy(rng.normal(size=(5, 64)).astype(np.float32))
    ys = []
    for flag in (True, False):
        T.set_kernel_flags(fused_lora=flag)
        ys.append(T.linear(p, x, lora, 2.0, lora_dropout=0.1, generator=torch.Generator().manual_seed(1)))
    assert torch.equal(ys[0], ys[1])  # the same plain path under both flags
    T.set_kernel_flags(fused_lora=True)
    no_drop = T.linear(p, x, lora, 2.0)
    assert torch.equal(no_drop, L.lora_matmul_plain(x, p["kernel"], lora["a"], lora["b"], 2.0) + p["bias"])
    # dropout changes the adapter branch only
    base = T.linear(p, x)
    keep = torch.rand(x.shape, generator=torch.Generator().manual_seed(1)) < 0.9
    want = base + 2.0 * ((torch.where(keep, x / 0.9, torch.zeros(())) @ lora["a"]) @ lora["b"])
    assert _rel(ys[0].numpy(), want.numpy()) <= REL


# ---------------------------------------------------------------------------
# loss, schedule
# ---------------------------------------------------------------------------


def test_loss_matches_jax():
    rng = np.random.default_rng(9)
    img, txt = rng.normal(size=(6, 32)).astype(np.float32), rng.normal(size=(6, 32)).astype(np.float32)
    got = tloss.clip_contrastive_loss(torch.from_numpy(img), torch.from_numpy(txt), 0.07).item()
    ref = float(jloss.clip_contrastive_loss(jnp.asarray(img), jnp.asarray(txt), 0.07))
    assert abs(got - ref) <= 1e-6
    got = tloss.clip_contrastive_loss_learned_scale(torch.from_numpy(img), torch.from_numpy(txt),
                                                    torch.tensor(2.6592)).item()
    ref = float(jloss.clip_contrastive_loss_learned_scale(jnp.asarray(img), jnp.asarray(txt), jnp.float32(2.6592)))
    assert abs(got - ref) <= 1e-6


@pytest.mark.parametrize("lr,total,ratio", [(1e-4, 27, 0.1), (3e-3, 5, 0.1), (1e-4, 100, 0.25), (2e-4, 1, 0.1)])
def test_schedule_matches_optax_at_every_step(lr, total, ratio):
    got = tstep.warmup_linear_schedule(lr, total, ratio)
    ref = jstep.warmup_linear_schedule(lr, total, ratio)
    for c in range(total + 3):
        assert abs(float(got(c)) - float(ref(c))) <= 1e-9, c
    assert float(got(0)) == 0.0


# ---------------------------------------------------------------------------
# train and eval steps against the JAX package
# ---------------------------------------------------------------------------

LORA_KW = dict(r=4, alpha=8, target_modules=("q_proj", "k_proj", "v_proj", "out_proj"))
EOT = 513


@pytest.fixture(scope="module")
def setup():
    params_j = jclip.init_params(jax.random.PRNGKey(0), J_SMALL)
    params_np = jax.tree_util.tree_map(np.asarray, params_j)
    lora_np = jax.tree_util.tree_map(
        np.asarray, j_init_lora(jax.random.PRNGKey(1), J_SMALL, JLora(dropout=0.0, **LORA_KW)))
    # B drawn too, so every adapter has a gradient from the first step
    rng = np.random.default_rng(10)
    for tower in lora_np.values():
        for proj in tower["blocks"]["attn"].values():
            proj["b"] = rng.normal(0, 0.05, proj["b"].shape).astype(np.float32)
    return params_np, lora_np


def _batches(n, B=4, S=77, seed=11, u8=True):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lens = rng.integers(4, 20, B)
        ids = np.full((B, S), EOT, np.int32)
        mask = np.zeros((B, S), np.int32)
        for i, n_tok in enumerate(lens):
            ids[i, :n_tok - 1] = rng.integers(1, 500, n_tok - 1)
            mask[i, :n_tok] = 1
        pix = (rng.integers(0, 256, (B, 64, 64, 3), dtype=np.uint8) if u8
               else rng.normal(size=(B, 64, 64, 3)).astype(np.float32))
        out.append({"pixel_values": pix, "input_ids": ids, "attention_mask": mask})
    return out


def _cfgs(accum=1, dropout=0.0, lr=5e-3):
    kw = dict(learning_rate=lr, gradient_accumulation_steps=accum, warmup_ratio=0.1)
    return (JLora(dropout=dropout, **LORA_KW), JTrain(**kw), TLora(dropout=dropout, **LORA_KW), TTrain(**kw))


def _run_jax(params_np, lora_np, batches, accum=1):
    jl, jt, _, _ = _cfgs(accum)
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    tx, _ = jstep.make_optimizer(jt, len(batches))
    state = jstep.init_train_state(jax.tree_util.tree_map(jnp.asarray, lora_np), tx, seed=0)
    step = jstep.make_train_step(params, J_SMALL, jl, jt, tx, eot_id=EOT)
    losses, norms = [], []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, jax.tree_util.tree_map(np.asarray, state.lora), state


def _run_port(params, lora_np, batches, accum=1, dropout=0.0, remat=False, chain=0):
    _, _, tl, tt = _cfgs(accum, dropout)
    tx, _ = tstep.make_optimizer(tt, len(batches))
    state = tstep.init_train_state(to_torch(lora_np), tx, seed=0)
    if chain:
        step = tstep.make_chained_train_step(params, T_SMALL, tl, tt, tx, chain, eot_id=EOT, remat=remat)
        losses, norms = [], []
        for i in range(0, len(batches), chain):
            stacked = {k: np.stack([b[k] for b in batches[i:i + chain]]) for k in batches[0]}
            state, m = step(state, stacked)
            losses += m["losses"].tolist()
            norms += m["grad_norms"].tolist()
        return losses, norms, state
    step = tstep.make_train_step(params, T_SMALL, tl, tt, tx, eot_id=EOT, remat=remat)
    losses, norms = [], []
    for b in batches:
        state, m = step(state, b)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    return losses, norms, state


def _assert_lora_close(got, ref):
    for (path, g), (_, r) in zip(tree_leaves(got), tree_leaves(to_torch(ref))):
        err = (g.double() - r.double()).norm() / r.double().norm().clamp_min(1e-30)
        assert err <= REL, (path, err.item())


@pytest.mark.parametrize("accum,n_steps", [(1, 3), (2, 4)])
def test_train_steps_match_jax(setup, accum, n_steps):
    params_np, lora_np = setup
    batches = _batches(n_steps)
    jl, jn, jlora, _ = _run_jax(params_np, lora_np, batches, accum)
    params = to_torch(params_np)
    before = {k: v.clone() for k, v in tree_leaves(params)}
    tl_, tn, state = _run_port(params, lora_np, batches, accum)
    for g, r in zip(tl_ + tn, jl + jn):
        assert abs(g - r) <= REL * abs(r)
    _assert_lora_close(state.lora, jlora)
    assert state.step == n_steps
    # the frozen base: bit for bit, and no gradient kept on it
    for k, v in tree_leaves(params):
        assert torch.equal(v, before[k]) and v.grad is None and not v.requires_grad


@pytest.mark.parametrize("accum", [1, 2])
def test_chained_step_equals_single_steps_bit_for_bit(setup, accum):
    params_np, lora_np = setup
    params, batches = to_torch(params_np), _batches(4, seed=12)
    sl, sn, s_state = _run_port(params, lora_np, batches, accum, dropout=0.1)
    cl, cn, c_state = _run_port(params, lora_np, batches, accum, dropout=0.1, chain=2)
    assert sl == cl and sn == cn
    for (_, a), (_, b) in zip(tree_leaves(s_state.lora), tree_leaves(c_state.lora)):
        assert torch.equal(a, b)
    assert torch.equal(s_state.generator.get_state(), c_state.generator.get_state())


def test_chained_step_matches_jax(setup):
    params_np, lora_np = setup
    batches = _batches(4, seed=13)
    jl, jn, jlora, _ = _run_jax(params_np, lora_np, batches)
    cl, cn, state = _run_port(to_torch(params_np), lora_np, batches, chain=2)
    for g, r in zip(cl + cn, jl + jn):
        assert abs(g - r) <= REL * abs(r)
    _assert_lora_close(state.lora, jlora)


def test_eval_step_matches_jax(setup):
    params_np, lora_np = setup
    jl, jt, tl, tt = _cfgs()
    for b in _batches(2, seed=14, u8=False):
        ref = float(jstep.make_eval_step(jax.tree_util.tree_map(jnp.asarray, params_np), J_SMALL, jl, jt,
                                         eot_id=EOT)(jax.tree_util.tree_map(jnp.asarray, lora_np),
                                                     {k: jnp.asarray(v) for k, v in b.items()}))
        got = tstep.make_eval_step(to_torch(params_np), T_SMALL, tl, tt, eot_id=EOT)(to_torch(lora_np), b)
        assert got.grad_fn is None and abs(got.item() - ref) <= REL * abs(ref)


def test_optimizer_state_counters_match_optax(setup):
    params_np, lora_np = setup
    batches = _batches(4, seed=15)
    _, _, _, jstate = _run_jax(params_np, lora_np, batches, accum=2)
    _, _, state = _run_port(to_torch(params_np), lora_np, batches, accum=2)
    inner = jstate.opt_state.inner_opt_state
    assert int(jstate.opt_state.mini_step) == state.opt_state["mini_step"] == 0
    assert int(jstate.opt_state.gradient_step) == state.opt_state["gradient_step"] == 2
    adam = state.opt_state["inner"][1]
    assert int(inner[1][0].count) == adam["count"] == 2
    assert int(inner[1][2].count) == adam["schedule_count"] == 2
    mu_j = jax.tree_util.tree_map(np.asarray, inner[1][0].mu)
    for (_, g), (_, r) in zip(tree_leaves(adam["mu"]), tree_leaves(to_torch(mu_j))):
        assert _rel(g.numpy(), r.numpy()) <= REL


# ---------------------------------------------------------------------------
# port-only: remat, resume, train()
# ---------------------------------------------------------------------------


def _loss_and_grads(params, lora_np, batch, remat, dropout):
    _, _, tl, tt = _cfgs(dropout=dropout)
    live = {p: t.requires_grad_(True) for p, t in tree_leaves(to_torch(lora_np))}
    lora = unflatten(live)
    img, txt = tstep.tower_features(params, lora, tstep.batch_to_device(batch, torch.device("cpu")), T_SMALL, tl,
                                    EOT, None, remat, torch.Generator().manual_seed(4) if dropout else None)
    loss = tloss.clip_contrastive_loss(img, txt)
    return loss, torch.autograd.grad(loss, list(live.values()))


@pytest.mark.parametrize("remat", [True, "dots"])
def test_remat_gives_the_loss_and_gradients_of_no_remat(setup, remat):
    params_np, lora_np = setup
    params, batch = to_torch(params_np), _batches(1, seed=16)[0]
    ref_loss, ref_g = _loss_and_grads(params, lora_np, batch, False, 0.1)
    loss, g = _loss_and_grads(params, lora_np, batch, remat, 0.1)
    assert abs(loss.item() - ref_loss.item()) <= 1e-6 * abs(ref_loss.item())
    for a, b in zip(g, ref_g):
        assert _rel(a.numpy(), b.numpy()) <= REL


def test_remat_rejects_an_unknown_mode(setup):
    params_np, lora_np = setup
    with pytest.raises(ValueError, match="remat"):
        _loss_and_grads(to_torch(params_np), lora_np, _batches(1)[0], "everything", 0.0)


def _yaml(tmp_path, out, epochs, dropout=0.1, resume=True):
    path = tmp_path / f"cfg_{epochs}_{os.path.basename(out)}.yaml"
    path.write_text(
        "model:\n  target_modules: [q_proj, k_proj, v_proj, out_proj]\n"
        f"lora:\n  r: 4\n  alpha: 8\n  dropout: {dropout}\n"
        f"data:\n  train_csv: {REPO}/data/text/train_fashion.csv\n  val_csv: {REPO}/data/text/val_fashion.csv\n"
        f"  image_root_dir: {REPO}\n"
        f"training:\n  seed: 42\n  batch_size: 6\n  num_epochs: {epochs}\n  logging_steps: 2\n"
        f"  learning_rate: 1e-3\n  output_dir: {out}\n  resume: {str(resume).lower()}\n"
    )
    return str(path)


TINY = dict(image_size=32, patch_size=16, vision_width=64, vision_layers=2, vision_heads=1,
            vision_mlp_dim=128, vocab_size=600, max_text_length=32, text_width=64, text_layers=2,
            text_heads=1, text_mlp_dim=128, projection_dim=32)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """train() at dropout 0.1 for 3 epochs straight through; then a copy of
    its output without the epoch-3 checkpoint and adapters (an interruption
    after epoch 2), resumed for the third epoch."""
    import shutil

    from clip_lora_match_tpu_torch.core.config import ClipArchConfig
    from clip_lora_match_tpu_torch.train import train

    tmp = tmp_path_factory.mktemp("train")
    arch = ClipArchConfig(**TINY)
    kw = dict(arch=arch, max_steps_per_epoch=4, device="cpu")
    full = train(_yaml(tmp, tmp / "full", 3), **kw)
    shutil.copytree(tmp / "full", tmp / "resumed")
    os.remove(tmp / "resumed" / "checkpoints" / "12.pt")
    shutil.rmtree(tmp / "resumed" / "epoch_3")
    resumed = train(_yaml(tmp, tmp / "resumed", 3), **kw)
    return tmp, full, resumed


def test_resume_equals_an_uninterrupted_run_bit_for_bit(trained):
    tmp, full, resumed = trained
    assert full.epochs == 3 and resumed.epochs == 3 and resumed.steps == 4
    assert resumed.train_losses == full.train_losses[-4:]
    assert resumed.val_losses == full.val_losses[-1:]
    for (_, a), (_, b) in zip(tree_leaves(full.final_lora), tree_leaves(resumed.final_lora)):
        assert torch.equal(a, b)
    # the checkpoint kept the augmenter's stream where epoch 2 left it
    import json

    saved = [torch.load(tmp / d / "checkpoints" / "12.pt", weights_only=True)["augmenter"]
             for d in ("full", "resumed")]
    assert saved[0] == saved[1] and json.loads(saved[0])["bit_generator"] == "PCG64"


def test_train_writes_epoch_adapters_jax_reads_back(trained):
    tmp, full, _ = trained
    out = tmp / "full"
    assert sorted(os.listdir(out / "checkpoints")) == ["12.pt", "4.pt", "8.pt"]
    assert {f"epoch_{k}" for k in (1, 2, 3)} <= set(os.listdir(out))
    final = full.final_lora
    for name in ("lora_weights.npz", "adapter_model.safetensors"):
        d = out / "epoch_3"
        if name == "adapter_model.safetensors":  # the PEFT branch of JAX's load_lora: hide the native file
            d = tmp / "peft_only"
            d.mkdir(exist_ok=True)
            for f in ("adapter_model.safetensors", "adapter_config.json"):
                (d / f).write_bytes((out / "epoch_3" / f).read_bytes())
        tree, scaling = j_load_lora(str(d))
        assert scaling == 2.0
        if name == "adapter_model.safetensors":
            # JAX stacks PEFT layers to the default (B/32) depth: the first two are ours
            tree = jax.tree_util.tree_map(lambda t: np.asarray(t)[:2], tree)
        for (path, g), (_, r) in zip(tree_leaves(to_torch(jax.tree_util.tree_map(np.asarray, tree))),
                                     tree_leaves(final)):
            assert torch.equal(g, r), (name, path)
    lines = (out / "training_metrics.jsonl").read_text().splitlines()
    assert any('"event": "val"' in ln for ln in lines) and any('"event": "train_step"' in ln for ln in lines)


def test_train_matches_jax_train_over_two_epochs(tmp_path, monkeypatch):
    """train() against the JAX package's train() at dropout 0 on the in-repo
    CSVs: 2 whole epochs of 9 steps (batch 6), the augmenter's one stream
    across them, from the same base and the same initial LoRA (JAX's
    init_lora carried over as numpy). Train and val losses within rel 1e-5,
    the final LoRA within rel 1e-5 of each leaf's norm."""
    from clip_lora_match_tpu.core.config import ClipArchConfig as JArch
    from clip_lora_match_tpu.train.trainer import train as j_train
    from clip_lora_match_tpu_torch.core.config import ClipArchConfig
    import clip_lora_match_tpu_torch.train.trainer as trainer

    jarch = JArch(**TINY)
    params_np = jax.tree_util.tree_map(np.asarray, jclip.init_params(jax.random.PRNGKey(3), jarch))
    lora_np = jax.tree_util.tree_map(
        np.asarray, j_init_lora(jax.random.PRNGKey(42), jarch, JLora(r=4, alpha=8, dropout=0.0)))
    ref = j_train(_yaml(tmp_path, tmp_path / "jax", 2, dropout=0.0, resume=False), arch=jarch,
                  params=jax.tree_util.tree_map(jnp.asarray, params_np))
    monkeypatch.setattr(trainer, "init_lora", lambda *a, **k: to_torch(lora_np))
    got = trainer.train(_yaml(tmp_path, tmp_path / "port", 2, dropout=0.0, resume=False),
                        arch=ClipArchConfig(**TINY), params=to_torch(params_np), device="cpu")
    assert got.steps == ref.steps == 18 and got.epochs == ref.epochs == 2
    assert len(got.train_losses) == len(ref.train_losses) == 18 and len(got.val_losses) == 2
    for g, r in zip(got.train_losses + got.val_losses, ref.train_losses + ref.val_losses):
        assert abs(g - r) <= REL * abs(r), (g, r)
    _assert_lora_close(got.final_lora, jax.tree_util.tree_map(np.asarray, ref.final_lora))


def test_cli_runs_on_the_cpu(tmp_path):
    from clip_lora_match_tpu_torch.train import cli

    cfg = _yaml(tmp_path, tmp_path / "cli", 1, resume=False)
    assert cli.main(["--config", cfg, "--arch", "tiny", "--device", "cpu", "--max-steps-per-epoch", "2",
                     "--chain-steps", "2"]) == 0
    assert os.path.exists(tmp_path / "cli" / "epoch_1" / "adapter_model.safetensors")


def test_train_restores_the_kernel_flags(tmp_path, restore_flags):  # noqa: F811
    from clip_lora_match_tpu_torch.core.config import ClipArchConfig
    from clip_lora_match_tpu_torch.train import train

    T.set_kernel_flags(fused_lora=True, small_attention=True, fused_mlp=True)
    before = T.get_kernel_flags()
    seen = {}
    orig = tstep.make_train_step

    def spy(*a, **k):
        seen.update(dict(T._KERNEL_FLAGS))
        return orig(*a, **k)

    import clip_lora_match_tpu_torch.train.trainer as trainer
    trainer.make_train_step, saved = spy, trainer.make_train_step
    try:
        train(_yaml(tmp_path, tmp_path / "flags", 1, resume=False), arch=ClipArchConfig(**TINY),
              max_steps_per_epoch=1, device="cpu")
    finally:
        trainer.make_train_step = saved
    assert seen["fused_lora"] is False and seen["small_attention"] is False and seen["flash_attention"] is False
    assert seen["fused_mlp"] is True  # the JAX trainer leaves it as it is
    assert T.get_kernel_flags() == before


def test_train_config_fields_match_jax():
    from clip_lora_match_tpu.core.config import load_lora_config as j_load
    from clip_lora_match_tpu_torch.core.config import load_lora_config as t_load

    assert [f.name for f in dataclasses.fields(TTrain)] == [f.name for f in dataclasses.fields(JTrain)]
    for path in (os.path.join(REPO, "config/lora_config.yaml"), None):
        (jl, jt), (tl, tt) = j_load(path), t_load(path)
        assert dataclasses.asdict(jt) == dataclasses.asdict(tt)
        assert dataclasses.asdict(jl) == dataclasses.asdict(tl)
