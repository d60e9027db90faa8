"""Spawned gloo worlds for the port's distributed tests on the CPU.

``start_worlds({"w2": 2, "w4": 4}, "retrieval", tmp)`` starts every rank of
every world at once and returns at once, each rank a process
(``python tests/_torch_dist.py <case> <rank> <world> <world dir>``) that
joins its world through a ``file://`` store in the world's directory (no TCP
port: the suite runs several workers at once) with a gloo timeout, runs the
case's rank function and saves what it returns (``torch.save``). The caller
computes its references meanwhile, then waits for every rank under one join
timeout (``run_worlds`` starts and waits); a rank that fails or hangs
fails the caller with its output. The test process writes the inputs that
need the JAX package (weights, adapters) into the world directory first.

This module imports no JAX: the ranks run the port alone, and the test files
hold their results to the JAX package in their own process.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time
from collections.abc import Mapping, Sequence
from pathlib import Path
from typing import Optional

import numpy as np

REPO = Path(__file__).resolve().parents[1]
GLOO_TIMEOUT = 90  # seconds a collective may wait
JOIN_TIMEOUT = 150  # seconds for every rank of every world to finish

# the tiny arch of the parity tests (tests/_torch_helpers.py's SMALL_KW):
# head_dim 64 in both towers
SMALL_KW = dict(
    image_size=64, patch_size=32, vision_width=128, vision_layers=2,
    vision_heads=2, vision_mlp_dim=256, text_width=128, text_layers=2,
    text_heads=2, text_mlp_dim=256, vocab_size=514, projection_dim=64,
)
EOT = 513
LORA_KW = dict(r=4, alpha=8, target_modules=("q_proj", "k_proj", "v_proj", "out_proj"))
# train(): the trainer tests' miniature tower (tests/test_torch_train.py's TINY)
TINY = dict(image_size=32, patch_size=16, vision_width=64, vision_layers=2, vision_heads=1,
            vision_mlp_dim=128, vocab_size=600, max_text_length=32, text_width=64, text_layers=2,
            text_heads=1, text_mlp_dim=128, projection_dim=32)


# ---------------------------------------------------------------------------
# launching
# ---------------------------------------------------------------------------


class Worlds(Mapping):
    """The ranks ``start_worlds`` started. ``worlds[name]`` is that world's
    per-rank results, a sequence that joins every rank on first use, so the
    caller can compute its references while the ranks run. ``stop()`` kills
    whatever still runs."""

    def __init__(self, worlds: dict[str, int], tmp: Path, procs: list):
        self._worlds, self._tmp, self._procs = worlds, tmp, procs
        self._results: Optional[dict[str, list[dict]]] = None

    def __getitem__(self, name: str) -> "Ranks":
        if name not in self._worlds:
            raise KeyError(name)
        return Ranks(self, name)

    def __iter__(self):
        return iter(self._worlds)

    def __len__(self) -> int:
        return len(self._worlds)

    def join(self) -> dict[str, list[dict]]:
        """Every world's per-rank results; a rank that fails or outlasts
        ``JOIN_TIMEOUT`` (counted from the start) raises with its output."""
        if self._results is not None:
            return self._results
        import torch

        failed = []
        try:
            for name, r, _, p, deadline in self._procs:
                try:
                    p.wait(timeout=max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    failed.append((name, r, "timed out"))
                    continue
                if p.returncode != 0:
                    failed.append((name, r, f"exit {p.returncode}"))
        finally:
            self.stop()
        if failed:
            tails = "\n".join(
                f"--- {name} rank {r} ({why}):\n" + (self._tmp / name / f"rank{r}.log").read_text()[-3000:]
                for name, r, why in failed
            )
            raise RuntimeError(f"{len(failed)} rank(s) failed:\n{tails}")
        self._results = {name: [torch.load(self._tmp / name / f"rank{r}.pt", weights_only=False)
                                for r in range(n)] for name, n in self._worlds.items()}
        return self._results

    def stop(self) -> None:
        for _, _, log, p, _ in self._procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
            log.close()


class Ranks(Sequence):
    """One world's per-rank results, joined on first use."""

    def __init__(self, worlds: Worlds, name: str):
        self._worlds, self._name = worlds, name

    def __getitem__(self, i):
        return self._worlds.join()[self._name][i]

    def __len__(self) -> int:
        return len(self._worlds.join()[self._name])


def start_worlds(worlds: dict[str, int], case: str, tmp: Path, backend: str = "gloo",
                 device: str = "cpu") -> Worlds:
    """Start ``case`` in every world (name -> ranks) at once and return at
    once. The inputs a world reads are in ``tmp/<name>``. ``device="cuda"``:
    the ranks' devices are the card's (gloo lets ranks share one)."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    if device == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
    deadline = time.monotonic() + JOIN_TIMEOUT
    procs = []
    for name, n in worlds.items():
        d = tmp / name
        d.mkdir(parents=True, exist_ok=True)
        for r in range(n):
            log = open(d / f"rank{r}.log", "w")
            procs.append((name, r, log, subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), case, str(r), str(n), str(d), backend, device],
                cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT,
            ), deadline))
    return Worlds(worlds, tmp, procs)


def run_worlds(worlds: dict[str, int], case: str, tmp: Path, backend: str = "gloo",
               device: str = "cpu") -> dict[str, list[dict]]:
    """``start_worlds`` and wait: each world's per-rank results."""
    return start_worlds(worlds, case, tmp, backend, device).join()


def _rank_main(case: str, rank: int, world: int, d: Path, backend: str, device: str) -> None:
    import torch

    from clip_lora_match_tpu_torch.parallel import initialize_distributed, make_mesh

    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_distributed(coordinator_address=f"file://{d / 'store'}", num_processes=world,
                           process_id=rank, backend=backend, device=device, timeout=GLOO_TIMEOUT)
    try:
        out = CASES[case](make_mesh(device=device), d)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()
    torch.save(out, d / f"rank{rank}.pt")


# ---------------------------------------------------------------------------
# inputs, the same in the ranks and in the test process
# ---------------------------------------------------------------------------


def unit_rows(rng, n: int, d: int) -> np.ndarray:
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _all_negative(rng, n: int, d: int, q: np.ndarray) -> np.ndarray:
    """Rows anti-correlated with the queries: every score is below 0."""
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    idx = (-qn[rng.integers(0, q.shape[0], n)] + rng.normal(0, 0.3, (n, d))).astype(np.float32)
    return idx / np.linalg.norm(idx, axis=1, keepdims=True)


def retrieval_inputs(n_ranks: int) -> dict[str, dict]:
    """name -> {queries, index (fp32 rows), k}; each runs fp32, bf16 and int8."""
    out = {}
    rng = np.random.default_rng(1)  # tests/test_ops_retrieval.py's ragged N = 10_001 case
    index = unit_rows(rng, 10_001, 64)
    out["ragged"] = dict(index=index, queries=rng.normal(size=(7, 64)).astype(np.float32), k=10)
    rng = np.random.default_rng(4)  # its all-negative case (:519)
    q = rng.normal(size=(3, 32)).astype(np.float32)
    out["all_negative"] = dict(index=_all_negative(rng, 1001, 32, q), queries=q, k=10)
    # 1,001 rows that every query scores below 0, the 10 best of query 0
    # moved to the end: into the last shard, beside its zero pad rows
    rng = np.random.default_rng(6)
    q0 = rng.normal(size=32).astype(np.float32)
    q0 /= np.linalg.norm(q0)
    q = (q0 + rng.normal(0, 0.05, (3, 32))).astype(np.float32)
    idx = (-q0 + rng.normal(0, 0.2, (1001, 32))).astype(np.float32)
    idx /= np.linalg.norm(idx, axis=1, keepdims=True)
    assert (idx @ q.T < 0).all()
    best = np.argsort(-(idx @ q[0]), kind="stable")[:10]
    rest = np.setdiff1d(np.arange(1001), best)
    out["best_in_pad_shard"] = dict(index=np.concatenate([idx[rest], idx[best]]), queries=q, k=10)
    out["small_best_in_pad_shard"] = small_best_in_pad_shard()
    # every shard exactly k rows, the last one with a pad row
    rng = np.random.default_rng(9)
    out["exact_k"] = dict(index=unit_rows(rng, n_ranks * 5 - 1, 48),
                          queries=rng.normal(size=(4, 48)).astype(np.float32), k=5)
    return out


def small_best_in_pad_shard(n: int = 41, d: int = 32, k: int = 10) -> dict:
    """``n`` rows that every query scores below 0, the k best of query 0 at
    the end. Padded over 2 or 4 ranks, a shard has fewer 16-row tiles than
    the two-pass selection needs, so each shard's search takes its oracle
    route, and the last shard's zero pad rows sit beside the best rows."""
    rng = np.random.default_rng(12)
    q0 = rng.normal(size=d).astype(np.float32)
    q0 /= np.linalg.norm(q0)
    q = (q0 + rng.normal(0, 0.05, (3, d))).astype(np.float32)
    idx = (-q0 + rng.normal(0, 0.2, (n, d))).astype(np.float32)
    idx /= np.linalg.norm(idx, axis=1, keepdims=True)
    assert (idx @ q.T < 0).all()
    best = np.argsort(-(idx @ q[0]), kind="stable")[:k]
    rest = np.setdiff1d(np.arange(n), best)
    return dict(index=np.concatenate([idx[rest], idx[best]]), queries=q, k=k)


def seeded_batches(n: int, B: int, seed: int, image_size: int = 64, S: int = 77) -> list[dict]:
    """uint8 pixels and EOT-padded token ids (prefix masks)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lens = rng.integers(4, 20, B)
        ids = np.full((B, S), EOT, np.int32)
        mask = np.zeros((B, S), np.int32)
        for i, n_tok in enumerate(lens):
            ids[i, :n_tok - 1] = rng.integers(1, 500, n_tok - 1)
            mask[i, :n_tok] = 1
        out.append({"pixel_values": rng.integers(0, 256, (B, image_size, image_size, 3), dtype=np.uint8),
                    "input_ids": ids, "attention_mask": mask})
    return out


def tiny_clip_yaml(path: Path) -> Path:
    """A clip config at SMALL_KW with fp32 compute, for both packages."""
    arch = "".join(f"    {k}: {v}\n" for k, v in SMALL_KW.items())
    path.write_text(
        "model:\n  name: openai/clip-vit-base-patch32\n  dtype: float32\n  compute_dtype: float32\n"
        f"  arch:\n{arch}preprocess:\n  image_size: {SMALL_KW['image_size']}\n"
    )
    return path


def train_yaml(path: Path, out: Path, epochs: int, batch: int, val_csv: str) -> Path:
    path.write_text(
        "model:\n  target_modules: [q_proj, k_proj, v_proj, out_proj]\n"
        "lora:\n  r: 4\n  alpha: 8\n  dropout: 0.0\n"
        f"data:\n  train_csv: {REPO}/data/text/train_fashion.csv\n  val_csv: {val_csv}\n"
        f"  image_root_dir: {REPO}\n"
        f"training:\n  seed: 42\n  batch_size: {batch}\n  num_epochs: {epochs}\n  logging_steps: 2\n"
        f"  learning_rate: 1e-3\n  output_dir: {out}\n  resume: true\n"
    )
    return path


# ---------------------------------------------------------------------------
# rank functions (one world each)
# ---------------------------------------------------------------------------


def retrieval_rank(mesh, d: Path) -> dict:
    """Every retrieval input through the sharded routes: fp32 and bf16 plain
    and two-pass (the shard's own two-pass result beside it), int8."""
    import torch

    from clip_lora_match_tpu_torch.ops.retrieval_topk import quantize_index_int8, topk_retrieve_twopass
    from clip_lora_match_tpu_torch.parallel import pad_to_multiple
    from clip_lora_match_tpu_torch.retrieval.sharded import (
        shard_index,
        shard_index_q8,
        sharded_topk_retrieve,
        sharded_topk_retrieve_q8,
    )

    out = {}
    for name, case in retrieval_inputs(mesh.n_data).items():
        q, k = case["queries"], case["k"]
        padded, n_valid = pad_to_multiple(case["index"], mesh.n_data)
        for dtype in ("fp32", "bf16"):
            shard = shard_index(mesh, torch.from_numpy(padded))
            if dtype == "bf16":
                shard = shard.to(torch.bfloat16)
            out[f"{name}/{dtype}/plain"] = sharded_topk_retrieve(q, shard, k, mesh, n_valid=n_valid)
            out[f"{name}/{dtype}/twopass"] = sharded_topk_retrieve(
                q, shard, k, mesh, n_valid=n_valid, use_kernel=True, max_pad=padded.shape[0] - n_valid)
            local = min(max(n_valid - mesh.rank * shard.shape[0], 0), shard.shape[0])
            out[f"{name}/{dtype}/shard"] = (local, topk_retrieve_twopass(torch.from_numpy(q), shard, k,
                                                                         n_valid=local))
        values, scales = quantize_index_int8(torch.from_numpy(case["index"]))
        vp, _ = pad_to_multiple(values.numpy(), mesh.n_data)
        sp, _ = pad_to_multiple(scales.numpy(), mesh.n_data)
        vs, ss = shard_index_q8(mesh, vp, sp)
        out[f"{name}/int8"] = sharded_topk_retrieve_q8(q, vs, ss, k, mesh, n_valid=n_valid)
    return out


def parallel_rank(mesh, d: Path) -> dict:
    """The mesh helpers, the sharded encoder and the sharded index build."""
    import torch

    from clip_lora_match_tpu_torch import parallel as P
    from clip_lora_match_tpu_torch.index import cli as index_cli
    from clip_lora_match_tpu_torch.lora.adapter import load_lora
    from clip_lora_match_tpu_torch.core.config import ClipArchConfig
    from clip_lora_match_tpu_torch.models.io import load_params

    out = {"rank": mesh.rank, "n_data": mesh.n_data, "again": P.initialize_distributed(),
           "count": P.process_count(), "index": P.process_index(), "primary": P.is_primary()}
    rng = np.random.default_rng(0)
    batch = {"x": rng.normal(size=(8, 3)).astype(np.float32), "ids": np.arange(16, dtype=np.int32).reshape(8, 2)}
    out["shard_batch"] = {k: v.numpy() for k, v in P.shard_batch(mesh, batch).items()}
    local = {k: v[mesh.rank * 4:(mesh.rank + 1) * 4] for k, v in batch.items()}
    out["from_local"] = {k: v.numpy() for k, v in P.global_batch_from_local(mesh, local).items()}
    for what, fn in (("shard_batch_ragged", lambda: P.shard_batch(mesh, {"x": np.zeros((7, 2))})),
                     ("model_axis", lambda: P.make_mesh(n_model=3, device="cpu")),
                     ("n_data_mismatch", lambda: P.make_mesh(n_data=mesh.n_data + 1, device="cpu")),
                     ("unequal_locals", lambda: P.global_batch_from_local(
                         mesh, {"x": np.zeros((2 + mesh.rank, 3))}))):
        try:
            fn()
            out[what] = None
        except (ValueError, NotImplementedError) as e:
            out[what] = f"{type(e).__name__}: {e}"
    model = P.make_mesh(n_model=2, device="cpu")
    out["model_mesh"] = (model.axis_names, model.axis_sizes, model.coords)
    tree = {"a": {"w": torch.arange(6.0).reshape(2, 3)}, "b": [torch.ones(2, dtype=torch.int64)]}
    out["replicated"] = P.replicated(mesh, tree)["a"]["w"]
    try:
        P.replicated(mesh, {"a": {"w": torch.full((2,), float(mesh.rank))}})
        out["replicated_differs"] = None
    except ValueError as e:
        out["replicated_differs"] = str(e)
    x = torch.full((2, 3), float(mesh.rank + 1))
    out["all_gather"] = P.all_gather(mesh, x)
    out["all_reduce"] = P.all_reduce_sum(mesh, x)
    # gather_rows' backward: d/dx_r of sum_s <gather(x)_s, w_s> summed over
    # the ranks s is sum_s w_s[rows of r]
    xg = torch.arange(6.0).reshape(2, 3).add(10 * mesh.rank).requires_grad_(True)
    w = torch.arange(12.0).reshape(4, 3) * (mesh.rank + 1)
    (P.gather_rows(mesh, xg) * w).sum().backward()
    out["gather_rows"] = (P.gather_rows(mesh, xg).detach(), xg.grad)

    # the sharded encoder over the test process's weights and adapter
    arch = ClipArchConfig(**SMALL_KW)
    params = load_params(str(d / "params.npz"), device="cpu")
    lora, scaling = load_lora(str(d / "lora"), device="cpu")
    enc = P.ShardedEncoder(params, arch, eot_id=EOT, lora=lora, lora_scaling=scaling, mesh=mesh,
                           compute_dtype="float32")
    inputs = np.load(d / "encode_inputs.npz")
    out["text"] = enc.encode_text_batch(inputs["ids"], inputs["mask"])
    out["text_empty"] = enc.encode_text_batch(inputs["ids"][:0], inputs["mask"][:0])
    out["image"] = enc.encode_image_batch(inputs["pixels"])
    out["image_empty"] = enc.encode_image_batch(inputs["pixels"][:0])

    # index.cli build-text over the ranks: rank 0 saves and verifies
    index = index_cli.run(["build-text", "--csv", str(REPO / "data/text/train_fashion.csv"),
                           "--clip-config", str(d / "clip.yaml"), "--weights", str(d / "params.npz"),
                           "--lora", str(d / "lora"), "--device", "cpu", "--batch-size", "16",
                           "--out", str(d / "built" / f"text_index_rank{mesh.rank}.npz")])
    out["build_text"] = index.embeddings_np()
    out["still_grouped"] = P.process_count()
    return out


def dp_train_rank(mesh, d: Path) -> dict:
    """Three data-parallel steps and the eval step over the test process's
    weights and adapter; train() over 2 epochs with the writers spied on;
    the same run resumed from its epoch-1 checkpoint; a batch that does not
    split over the ranks."""
    import torch

    import clip_lora_match_tpu_torch.train.trainer as trainer
    from clip_lora_match_tpu_torch import parallel as P
    from clip_lora_match_tpu_torch.core.config import ClipArchConfig, LoraConfig, TrainingConfig
    from clip_lora_match_tpu_torch.lora.adapter import load_lora
    from clip_lora_match_tpu_torch.models.io import load_params, tree_map
    from clip_lora_match_tpu_torch.train import step as tstep

    out = {}
    arch = ClipArchConfig(**SMALL_KW)
    params = load_params(str(d / "params.npz"), device="cpu")
    lora, _ = load_lora(str(d / "lora"), device="cpu")
    lcfg = LoraConfig(dropout=0.0, **LORA_KW)
    tcfg = TrainingConfig(learning_rate=5e-3, warmup_ratio=0.1)
    batches = seeded_batches(3, 8, 11)
    tx, _ = tstep.make_optimizer(tcfg, len(batches))
    state = tstep.init_train_state(lora, tx, seed=0)
    step = tstep.make_train_step(params, arch, lcfg, tcfg, tx, eot_id=EOT, mesh=mesh)
    losses, norms = [], []
    for b in batches:
        state, m = step(state, P.shard_batch(mesh, b))
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    out["steps"] = (losses, norms, tree_map(lambda t: t.detach().clone(), state.lora))
    ev = tstep.make_eval_step(params, arch, lcfg, tcfg, eot_id=EOT, mesh=mesh)
    out["eval"] = ev(state.lora, P.shard_batch(mesh, batches[0])).item()
    # dropout 0.1: the ranks draw other masks from one shared generator
    lcfg_d = LoraConfig(dropout=0.1, **LORA_KW)
    st = tstep.init_train_state(lora, tx, seed=0)
    st, m = tstep.make_train_step(params, arch, lcfg_d, tcfg, tx, eot_id=EOT, mesh=mesh)(
        st, P.shard_batch(mesh, batches[0]))
    out["dropout"] = (m["loss"].item(), st.generator.get_state())

    # train() at batch 8 (4 a rank) over 2 epochs, the test process's
    # initial adapter; who writes what
    tiny = ClipArchConfig(**TINY)
    tiny_params = load_params(str(d / "tiny_params.npz"), device="cpu")
    tiny_lora, _ = load_lora(str(d / "tiny_lora"), device="cpu")
    trainer.init_lora = lambda *a, **k: tree_map(torch.clone, tiny_lora)
    writes = []
    for name in ("save_lora", "save_peft_adapter"):
        real = getattr(trainer, name)
        setattr(trainer, name, lambda *a, _real=real, _name=name, **k: writes.append(_name) or _real(*a, **k))
    real_ckpt = trainer.CheckpointManager.save
    trainer.CheckpointManager.save = lambda self, *a, **k: writes.append("checkpoint") or real_ckpt(self, *a, **k)
    val = str(REPO / "data/text/train_fashion.csv")
    run = d / "run"
    res = trainer.train(str(train_yaml(d / f"train{mesh.rank}.yaml", run, 2, 8, val)), arch=tiny,
                        params=tree_map(torch.clone, tiny_params), device="cpu")
    out["train"] = (res.steps, res.epochs, res.train_losses, res.val_losses, res.final_lora, list(writes))
    out["metrics_exists"] = (run / "training_metrics.jsonl").exists()
    # resume: a copy of the run without its epoch-2 checkpoint and adapters
    resumed = d / "resumed"
    if mesh.rank == 0:
        shutil.copytree(run, resumed)
        os.remove(resumed / "checkpoints" / f"{res.steps}.pt")
        shutil.rmtree(resumed / "epoch_2")
    P.barrier(mesh)
    again = trainer.train(str(train_yaml(d / f"resume{mesh.rank}.yaml", resumed, 2, 8, val)), arch=tiny,
                          params=tree_map(torch.clone, tiny_params), device="cpu")
    out["resumed"] = (again.steps, again.train_losses, again.val_losses, again.final_lora)
    # batch 5 does not split over 2 ranks: every rank runs the single-process step
    odd = trainer.train(str(train_yaml(d / f"odd{mesh.rank}.yaml", d / "odd", 1, 5, "")), arch=tiny,
                        params=tree_map(torch.clone, tiny_params), max_steps_per_epoch=2, device="cpu")
    out["odd"] = (odd.train_losses, odd.final_lora)
    return out


def cuda_retrieval_rank(mesh, d: Path) -> dict:
    """On the card: fp32, bf16 and int8 shards of one seeded index through the
    sharded search (pass 1 on the kernels), and rank 0's unsharded search of
    the whole index beside it; each rank's pass-1 launches."""
    import torch

    from clip_lora_match_tpu_torch import ops
    from clip_lora_match_tpu_torch.ops.retrieval_topk import (
        quantize_index_int8,
        topk_retrieve_q8,
        topk_retrieve_twopass,
    )
    from clip_lora_match_tpu_torch.parallel import pad_to_multiple
    from clip_lora_match_tpu_torch.retrieval.sharded import (
        shard_index,
        shard_index_q8,
        sharded_topk_retrieve,
        sharded_topk_retrieve_q8,
    )

    rng = np.random.default_rng(3)
    index = unit_rows(rng, 300_007, 128)
    padded, n_valid = pad_to_multiple(index, mesh.n_data)
    out = {}
    for Q in (1, 64):
        q = torch.from_numpy(rng.normal(size=(Q, 128)).astype(np.float32)).to(mesh.device)
        for dtype in (torch.float32, torch.bfloat16):
            shard = shard_index(mesh, padded).to(dtype)
            ops.reset_launch_counts()
            got = sharded_topk_retrieve(q, shard, 10, mesh, n_valid=n_valid)
            out[f"{Q}/{dtype}"] = (_cpu(got), ops.launch_counts())
            if mesh.rank == 0:
                whole = torch.from_numpy(index).to(mesh.device, dtype)
                out[f"{Q}/{dtype}/whole"] = _cpu(topk_retrieve_twopass(q, whole, 10))
        values, scales = quantize_index_int8(torch.from_numpy(index).to(mesh.device))
        vp, _ = pad_to_multiple(values.cpu().numpy(), mesh.n_data)
        sp, _ = pad_to_multiple(scales.cpu().numpy(), mesh.n_data)
        ops.reset_launch_counts()
        got = sharded_topk_retrieve_q8(q, *shard_index_q8(mesh, vp, sp), 10, mesh, n_valid=n_valid)
        out[f"{Q}/int8"] = (_cpu(got), ops.launch_counts())
        if mesh.rank == 0:
            out[f"{Q}/int8/whole"] = _cpu(topk_retrieve_q8(q, values, scales, 10))
    # 41 all-negative rows, the best beside the last shard's pad rows: each
    # shard's search takes its oracle route
    case = small_best_in_pad_shard()
    small, n_valid = pad_to_multiple(case["index"], mesh.n_data)
    q = torch.from_numpy(case["queries"]).to(mesh.device)
    whole = torch.from_numpy(case["index"]).to(mesh.device)
    for dtype in (torch.float32, torch.bfloat16):
        shard = shard_index(mesh, small).to(dtype)
        out[f"small/{dtype}"] = _cpu(sharded_topk_retrieve(q, shard, case["k"], mesh, n_valid=n_valid))
        out[f"small/{dtype}/whole"] = _cpu(topk_retrieve_twopass(q, whole.to(dtype), case["k"]))
    values, scales = quantize_index_int8(whole)
    vp, _ = pad_to_multiple(values.cpu().numpy(), mesh.n_data)
    sp, _ = pad_to_multiple(scales.cpu().numpy(), mesh.n_data)
    out["small/int8"] = _cpu(sharded_topk_retrieve_q8(q, *shard_index_q8(mesh, vp, sp), case["k"], mesh,
                                                      n_valid=n_valid))
    out["small/int8/whole"] = _cpu(topk_retrieve_q8(q, values, scales, case["k"]))
    return out


def _cpu(pair):
    return tuple(t.cpu() for t in pair)


def cuda_dp_step_rank(mesh, d: Path) -> dict:
    """On the card, fp32: three data-parallel steps at a global batch of 8
    over the port's seeded tiny weights and adapter; rank 0 also runs the
    single-process step over the whole batches."""
    import torch

    from clip_lora_match_tpu_torch import parallel as P
    from clip_lora_match_tpu_torch.core.config import ClipArchConfig, LoraConfig, TrainingConfig
    from clip_lora_match_tpu_torch.lora.adapter import init_lora
    from clip_lora_match_tpu_torch.models.clip import init_params
    from clip_lora_match_tpu_torch.models.io import tree_map
    from clip_lora_match_tpu_torch.train import step as tstep

    arch = ClipArchConfig(**SMALL_KW)
    lcfg = LoraConfig(dropout=0.0, **LORA_KW)
    tcfg = TrainingConfig(learning_rate=5e-3, warmup_ratio=0.1)
    params = init_params(0, arch, device=mesh.device)
    lora = init_lora(1, arch, lcfg, device=mesh.device)
    gen = torch.Generator().manual_seed(10)
    lora = tree_map(lambda t: torch.randn(t.shape, generator=gen).mul(0.05).to(t.device), lora)
    lora = P.replicated(mesh, lora)
    batches = seeded_batches(3, 8, 11)
    out = {}
    for name, m in (("dp", mesh), ("single", None)):
        if m is None and mesh.rank != 0:
            break
        tx, _ = tstep.make_optimizer(tcfg, len(batches))
        state = tstep.init_train_state(lora, tx, seed=0)
        step = tstep.make_train_step(params, arch, lcfg, tcfg, tx, eot_id=EOT, mesh=m)
        losses, norms = [], []
        for b in batches:
            state, met = step(state, P.shard_batch(m, b) if m is not None else b)
            losses.append(met["loss"].item())
            norms.append(met["grad_norm"].item())
        out[name] = (losses, norms, tree_map(lambda t: t.detach().cpu(), state.lora))
    out["device"] = str(mesh.device)
    return out


# ---------------------------------------------------------------------------
# the model axes: inputs drawn with numpy, the same in the ranks and in the
# test process
# ---------------------------------------------------------------------------

NEG = float(np.finfo(np.float32).min)


def numpy_blocks(seed: int, layers: int, width: int, mlp_dim: int) -> dict:
    """A stacked block tree (the JAX package's layout), every bias drawn
    too: a row-parallel bias added twice would show."""
    rng = np.random.default_rng(seed)

    def lin(d_in, d_out, std):
        return {"kernel": (rng.normal(size=(layers, d_in, d_out)) * std).astype(np.float32),
                "bias": (rng.normal(size=(layers, d_out)) * 0.02).astype(np.float32)}

    def ln():
        return {"scale": (1 + 0.1 * rng.normal(size=(layers, width))).astype(np.float32),
                "bias": (0.05 * rng.normal(size=(layers, width))).astype(np.float32)}

    w = width ** -0.5
    return {"ln_1": ln(), "attn": {n: lin(width, width, w) for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "ln_2": ln(), "mlp": {"fc1": lin(width, mlp_dim, (2 * width) ** -0.5),
                                  "fc2": lin(mlp_dim, width, mlp_dim ** -0.5)}}


def numpy_lora_blocks(seed: int, layers: int, width: int, r: int = 4) -> dict:
    rng = np.random.default_rng(seed)
    return {"attn": {n: {"a": (rng.normal(size=(layers, width, r)) * width ** -0.5).astype(np.float32),
                         "b": (rng.normal(size=(layers, r, width)) * 0.05).astype(np.float32)}
                     for n in ("q_proj", "k_proj", "v_proj", "out_proj")}}


def text_mask(B: int, S: int, cut: int) -> np.ndarray:
    """The text tower's additive causal mask with keys from ``cut`` on
    padded away, (B, 1, S, S) (-inf where both add, as in both packages)."""
    causal = np.triu(np.full((S, S), NEG, np.float32), k=1)[None, None]
    am = np.ones((B, S), np.float32)
    am[:, cut:] = 0
    with np.errstate(over="ignore"):
        return (causal + ((1.0 - am)[:, None, None, :] * NEG)).astype(np.float32)


def ring_inputs(n_seq: int) -> dict:
    """name -> (q, k, v, mask or None): dense, causal, and a batch mask with
    fully masked query rows (the JAX package's ring tests)."""
    rng = np.random.default_rng(20 + n_seq)
    B, S, H, hd = 2, 16, 2, 8
    q, k, v = (rng.normal(size=(B, S, H, hd)).astype(np.float32) for _ in range(3))
    floor = np.float32(-3.4e38)
    rows = np.zeros((B, 1, S, S), np.float32)
    rows[:, :, :, 12:] = floor
    rows[:, :, 12:, :] = floor
    causal = np.triu(np.full((S, S), NEG, np.float32), k=1)[None, None]
    return {"dense": (q, k, v, None), "causal": (q, k, v, causal), "masked_rows": (q, k, v, rows)}


# the executors' inputs: (width, heads, mlp) 64 / 4 / 128, batch 8
EXEC = dict(width=64, heads=4, mlp=128)


def sp_inputs() -> dict:
    """name -> (x, mask or None, with LoRA): S = 16 and the pad path S = 10
    dense; S = 13 with a causal + row-pad mask and LoRA; S = 13 with a
    broadcast (B, 1, 1, S) key mask."""
    rng = np.random.default_rng(30)
    x = {S: rng.normal(size=(8, S, EXEC["width"])).astype(np.float32) for S in (16, 10, 13)}
    keep = rng.random((8, 1, 1, 13)) < 0.8
    keep[..., 0] = True
    return {"dense16": (x[16], None, False), "dense10": (x[10], None, False),
            "causal13": (x[13], text_mask(8, 13, 9), True),
            "keymask13": (x[13], np.where(keep, 0.0, NEG).astype(np.float32), False)}


def pp_inputs() -> dict:
    """name -> (x, mask or None): S = 8 with a batch mask (pipeline alone);
    S = 16 and 13 with the causal + row-pad mask (pp×sp)."""
    rng = np.random.default_rng(40)
    x8 = rng.normal(size=(8, 8, EXEC["width"])).astype(np.float32)
    keep = rng.random((8, 1, 1, 8)) < 0.75
    keep[..., 0] = True
    return {"batch8": (x8, np.where(keep, 0.0, NEG).astype(np.float32)),
            "causal16": (rng.normal(size=(8, 16, EXEC["width"])).astype(np.float32), text_mask(8, 16, 11)),
            "causal13": (rng.normal(size=(8, 13, EXEC["width"])).astype(np.float32), text_mask(8, 13, 9))}


def _t(tree):
    import torch

    from clip_lora_match_tpu_torch.models.io import tree_map

    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)), tree)


def _executor_run(fn, blocks, x, mask, lora_blocks, heads, rows: slice) -> tuple:
    """The executor's output on this data rank's rows, and the LoRA blocks'
    gradients of the sum of its squares (this rank's share; the test sums
    or gathers them), the LoRA blocks as given (shards)."""
    import torch

    from clip_lora_match_tpu_torch.models.io import tree_leaves, unflatten

    live = None
    if lora_blocks is not None:
        pairs = tree_leaves(lora_blocks)
        live = [t.detach().clone().requires_grad_(True) for _, t in pairs]
        lora_blocks = unflatten({p: t for (p, _), t in zip(pairs, live)})
    xt = torch.from_numpy(x[rows])
    mt = None if mask is None else torch.from_numpy(mask[rows] if mask.shape[0] > 1 else mask)
    out = fn(blocks, xt, heads, mask=mt, lora_blocks=lora_blocks, lora_scaling=2.0)
    grads = None
    if live is not None:
        g = torch.autograd.grad(out.square().sum(), live)
        grads = unflatten({p: t for (p, _), t in zip(pairs, g)})
    return out.detach(), grads


def _rows_of(mesh, B: int) -> slice:
    b = B // mesh.n_data
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def _axis_steps(mesh, d: Path, kind: str, n_micro: int = 2) -> dict:
    """Three train steps (the dp_train case's: batch 8, dropout 0) on this
    rank's shards under ``kind`` ("tp", "sp" or "pp"), and the step's
    gradients at the first batch; the gradients and the final LoRA tree
    gathered whole."""
    from clip_lora_match_tpu_torch import parallel as P
    from clip_lora_match_tpu_torch.core.config import ClipArchConfig, LoraConfig, TrainingConfig
    from clip_lora_match_tpu_torch.lora.adapter import load_lora
    from clip_lora_match_tpu_torch.models.io import load_params
    from clip_lora_match_tpu_torch.train import step as tstep

    arch = ClipArchConfig(**SMALL_KW)
    params = load_params(str(d.parent / "params.npz"), device="cpu")
    lora, _ = load_lora(str(d.parent / "lora"), device="cpu")
    lcfg = LoraConfig(dropout=0.0, **LORA_KW)
    tcfg = TrainingConfig(learning_rate=5e-3, warmup_ratio=0.1)
    batches = seeded_batches(3, 8, 11)
    tx, _ = tstep.make_optimizer(tcfg, len(batches))
    model = mesh.size(P.MODEL_AXIS) > 1
    if kind == "tp":
        state = P.init_tp_train_state(P.shard_lora_tp(lora, mesh), tx, seed=0)
        step = tstep.make_train_step(P.shard_params_tp(params, mesh), arch, lcfg, tcfg, tx, eot_id=EOT,
                                     mesh=mesh, transformer_fn=P.make_tp_transformer(mesh))
    elif kind == "sp":
        place = (lambda t, lora=False: P.shard_clip_sp_tp(t, mesh, lora)) if model else (
            lambda t, lora=False: P.shard_clip_sp(t, mesh))
        init = P.init_tp_train_state if model else P.init_sp_train_state
        state = init(place(lora, lora=True), tx, seed=0)
        step = P.make_sp_train_step(place(params), arch, lcfg, tcfg, tx, mesh, eot_id=EOT)
    else:
        state = P.init_pp_train_state(P.shard_clip_pp(lora, mesh), tx, seed=0)
        step = P.make_pp_train_step(P.shard_clip_pp(params, mesh), arch, lcfg, tcfg, tx, mesh, n_micro,
                                    eot_id=EOT)
    loss0, grads = step.loss_and_grads(state.lora, P.shard_batch(mesh, batches[0]), state.specs)
    out = {"loss0": loss0.item(), "grads": P.gather_sharded(grads, state.specs, mesh)}
    losses, norms = [], []
    for b in batches:
        state, m = step(state, P.shard_batch(mesh, b))
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    out.update(losses=losses, norms=norms, lora=P.gather_sharded(state.lora, state.specs, mesh),
               coords=mesh.coords)
    return out


def tp_rank(mesh, d: Path) -> dict:
    """Tensor parallelism: (data, model) = (1, 2) in a world of 2 and
    (2, 2) in a world of 4. Each rank's shards, the TP encode of both towers
    over the world's batch, the TP block's biases alone, and the train
    steps."""
    import torch

    from clip_lora_match_tpu_torch import parallel as P
    from clip_lora_match_tpu_torch.core.config import ClipArchConfig
    from clip_lora_match_tpu_torch.lora.adapter import load_lora
    from clip_lora_match_tpu_torch.models import clip as C
    from clip_lora_match_tpu_torch.models.io import load_params
    from clip_lora_match_tpu_torch.parallel.tp import tp_block

    tp = P.make_mesh(n_model=2, device="cpu")
    out = {"coords": tp.coords, "shape": tp.shape}
    arch = ClipArchConfig(**SMALL_KW)
    params = load_params(str(d.parent / "params.npz"), device="cpu")
    lora, scaling = load_lora(str(d.parent / "lora"), device="cpu")
    sp_, sl = P.shard_params_tp(params, tp), P.shard_lora_tp(lora, tp)
    out["params"], out["lora"] = sp_, sl
    b = seeded_batches(1, 8, 5)[0]
    rows = _rows_of(tp, 8)
    fn = P.make_tp_transformer(tp)
    with torch.no_grad():
        pix = torch.from_numpy(b["pixel_values"][rows]).float() / 255.0
        out["image"] = C.encode_image_features(sp_, pix, arch, lora=sl, lora_scaling=scaling, transformer_fn=fn)
        out["text"] = C.encode_text_features(sp_, torch.from_numpy(b["input_ids"][rows]), arch,
                                             attention_mask=torch.from_numpy(b["attention_mask"][rows]),
                                             eot_id=EOT, lora=sl, lora_scaling=scaling, transformer_fn=fn)
        # a block whose kernels are all 0: the output is x + out_proj's bias
        # + fc2's bias, each added once
        blk = numpy_blocks(7, 1, 128, 256)
        for tree in (blk["attn"], blk["mlp"]):
            for proj in tree.values():
                proj["kernel"][:] = 0
        shard = P.shard_params_tp({"blocks": blk}, tp)["blocks"]
        x = torch.from_numpy(np.random.default_rng(8).normal(size=(2, 5, 128)).astype(np.float32))
        out["bias_block"] = (x, tp_block({k: v for k, v in _first_layer(shard).items()}, x, 2, tp))
    out["step"] = _axis_steps(tp, d, "tp")
    return out


def _first_layer(tree):
    return {k: _first_layer(v) for k, v in tree.items()} if isinstance(tree, dict) else tree[0]


def sp_rank(mesh, d: Path) -> dict:
    """Sequence parallelism: the ring at n_seq = world (its output block and
    the q/k/v gradients of a weighted sum), the SP executor over the
    ``sp_inputs`` on (data, seq) = (1, world) and, in a world of 4, (2, 2),
    the SP train steps: sp2 (world 2), dp2×sp2 and dp1×tp2×sp2 (world 4)."""
    import torch

    from clip_lora_match_tpu_torch import parallel as P
    from clip_lora_match_tpu_torch.ops.ring_attention import ring_attention

    n = mesh.world
    out = {"ring": {}, "exec": {}}
    seq = P.make_sp_mesh(n_seq=n, device="cpu")
    for name, (q, k, v, m) in ring_inputs(n).items():
        S_loc = q.shape[1] // n
        blk = slice(seq.index("seq") * S_loc, (seq.index("seq") + 1) * S_loc)
        qt, kt, vt = (torch.from_numpy(a[:, blk].copy()).requires_grad_(True) for a in (q, k, v))
        mt = None if m is None else torch.from_numpy(m if m.shape[2] == 1 else m[:, :, blk])
        o = ring_attention(qt, kt, vt, seq, "seq", mask=mt)
        w = torch.from_numpy(np.random.default_rng(3).normal(size=q.shape).astype(np.float32)[:, blk])
        gq, gk, gv = torch.autograd.grad((o * w).sum(), (qt, kt, vt))
        out["ring"][name] = (o.detach(), gq, gk, gv)
    blocks = _t(numpy_blocks(1, 3, EXEC["width"], EXEC["mlp"]))
    lora = _t(numpy_lora_blocks(2, 3, EXEC["width"]))
    meshes = {f"1x{n}": seq}
    if n == 4:
        meshes["2x2"] = P.make_sp_mesh(n_seq=2, n_data=2, device="cpu")
    for tag, m_ in meshes.items():
        fn = P.make_sp_transformer(m_)
        for name, (x, mask, with_lora) in sp_inputs().items():
            out["exec"][f"{tag}/{name}"] = _executor_run(fn, blocks, x, mask, lora if with_lora else None,
                                                         EXEC["heads"], _rows_of(m_, 8))
    if n == 2:
        out["step/sp2"] = _axis_steps(seq, d, "sp")
    else:
        out["step/dp2xsp2"] = _axis_steps(meshes["2x2"], d, "sp")
        out["step/tp2xsp2"] = _axis_steps(P.make_sp_mesh(n_seq=2, n_model=2, device="cpu"), d, "sp")
    return out


def pp_rank(mesh, d: Path) -> dict:
    """Pipeline parallelism: the pipeline executor at (stage, M) = (2, 4) in
    a world of 2 and (4, 2) in a world of 4 over 4 layers with a batch mask
    and LoRA (output and LoRA gradients: the backward through the tick
    loop), the pp×sp executor at S = 16 and 13 (world 4), and the train
    steps pp2 (M = 4, world 2) and pp2×sp2 (world 4)."""
    from clip_lora_match_tpu_torch import parallel as P

    n = mesh.world
    out = {"exec": {}}
    blocks = numpy_blocks(3, 4, EXEC["width"], EXEC["mlp"])
    lora = numpy_lora_blocks(4, 4, EXEC["width"])
    M = 4 if n == 2 else 2
    pp = P.make_pp_mesh(n_stage=n, device="cpu")
    x, mask = pp_inputs()["batch8"]
    fn = P.make_pipeline_transformer(pp, M)
    o, g = _executor_run(fn, P.shard_clip_pp({"blocks": blocks}, pp)["blocks"], x, mask,
                         P.shard_clip_pp({"blocks": lora}, pp)["blocks"], EXEC["heads"], slice(None))
    out["exec"][f"pp{n}"] = (o, P.gather_sharded(g, P.clip_pp_pspecs({"blocks": g})["blocks"], pp), pp.coords)
    if n == 2:
        out["step/pp2"] = _axis_steps(pp, d, "pp", n_micro=4)
    else:
        ppsp = P.make_pp_mesh(n_stage=2, n_seq=2, device="cpu")
        fn = P.make_pipeline_transformer(ppsp, 2)
        b_, l_ = (P.shard_clip_pp({"blocks": t}, ppsp)["blocks"] for t in (blocks, lora))
        for name in ("causal16", "causal13"):
            x, mask = pp_inputs()[name]
            o, g = _executor_run(fn, b_, x, mask, l_, EXEC["heads"], slice(None))
            out["exec"][f"ppsp/{name}"] = (o, g, ppsp.coords)
        out["step/pp2xsp2"] = _axis_steps(ppsp, d, "pp")
    return out


CASES = {"retrieval": retrieval_rank, "parallel": parallel_rank, "dp_train": dp_train_rank,
         "cuda_retrieval": cuda_retrieval_rank, "cuda_dp_step": cuda_dp_step_rank,
         "tp": tp_rank, "sp": sp_rank, "pp": pp_rank}


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]), sys.argv[5], sys.argv[6])
