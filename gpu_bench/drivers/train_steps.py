"""train_steps: contrastive LoRA steps back to back, the step ``train()``
builds.

Set-up repeats ``train()``'s calls (it inlines them and exposes no builder):
the kernel flags it sets, ``make_optimizer``, ``init_train_state`` and
``make_train_step``, and its ``slice_batch`` (trailing all-pad text columns
dropped down to ``text_seq_slice``). Each batch is seeded uint8 pixels and
seeded captions tokenized by the port's tokenizer, handed to the step as
host arrays (``batch_to_device`` uploads them through pinned memory). A pool
of distinct batches is made in set-up and cycled. Set-up drives the state
through its first three steps, on three distinct batches, and the window
goes on from that same state; losses are read at the trainer's logging
cadence. The mix sets no warm-up (``warmup_ratio`` 0: the schedule's one
step at rate 0, then its linear decay from the full rate), so the checked
steps 2-3 and the whole window run at the working rate, not at the
hundredths of it that the first steps of a 10% warm-up would take. ``train_pairs_per_s`` is every pair stepped over all the window's
time, the device's last step included.

The check replays the first three steps in the plain reference and
compares: ``loss_err``, each step's loss, relative; ``grad_err``, the
first step's gradient as the optimizer got it (clipped; read back from
AdamW's first moment after step 1), the worst leaf's gap of norms against
that leaf's reference norm or the median leaf's, whichever is larger;
``update_err``, each leaf's change over the three steps the same way,
leaving out leaves whose reference gradient is under a thousandth of the
median leaf's. Control: ``tf32``, the reference in TF32 in the program's
place; planted faults: ``half_batch`` (the reference's loss over half the
rows) and ``unchanged`` (the state after three steps equal to the first).
"""

from __future__ import annotations

import math
import time

import numpy as np

from gpu_bench.harness import program, seeds, traffic
from gpu_bench.reference import train as ref_train
from gpu_bench.reference.tokenizer import ByteTokenizer

FIRST_STEPS = 3


def _gap_err(got: dict, ref: dict, keep=None) -> float:
    """max over leaves of |‖got‖ - ‖ref‖| / max(‖ref‖, median ‖ref‖)."""
    norms = {p: float(t.double().norm()) for p, t in ref.items()}
    med = float(np.median(list(norms.values())))
    worst = 0.0
    for p, t in got.items():
        if keep is not None and p not in keep:
            continue
        worst = max(worst, abs(float(t.double().norm()) - norms[p]) / max(norms[p], med))
    return worst


class Driver:
    first_steps = FIRST_STEPS

    def __init__(self, ctx):
        self.ctx = ctx
        self.tr = {**ctx.traffic, **ctx.cell.get("load", {})}
        self.attempted = 0
        self.failed = 0

    def _batch_pixels(self, j: int):
        w = self.ctx.config["widths"]
        return traffic.pixels_u8(self.tr["batch"], w["image_size"], self.ctx.seed, self.ctx.device, f"pixels{j}")

    def setup(self) -> None:
        from clip_lora_match_tpu_torch.core.config import LoraConfig, TrainingConfig
        from clip_lora_match_tpu_torch.nn.layers import set_kernel_flags
        from clip_lora_match_tpu_torch.tokenizer.bpe import ClipTokenizer
        from clip_lora_match_tpu_torch.train.step import init_train_state, make_optimizer, make_train_step

        ctx, tr, cfg = self.ctx, self.tr, self.ctx.config
        arch, _ = program.arch_and_config(cfg)
        params, lora, _ = program.seeded_weights(ctx)
        lo = cfg["lora"]
        self.lora_cfg = LoraConfig(r=lo["r"], alpha=lo["alpha"], dropout=lo["dropout"],
                                   target_modules=tuple(lo["target_modules"]))
        o = tr["optimizer"]
        self.train_cfg = TrainingConfig(
            batch_size=tr["batch"], learning_rate=o["learning_rate"], weight_decay=o["weight_decay"],
            warmup_ratio=o["warmup_ratio"], max_grad_norm=o["max_grad_norm"], temperature=o["temperature"],
            text_seq_slice=tr["text_seq_slice"], seed=seeds.derive(ctx.seed, "train") % (2 ** 31))
        self.prev_flags = set_kernel_flags(fused_lora=False, flash_attention=False, small_attention=False)
        tx, _ = make_optimizer(self.train_cfg, o["total_steps"])
        tok = ClipTokenizer.from_dir(None, arch.max_text_length)
        self.eot = tok.eot_id
        step = make_train_step(params, arch, self.lora_cfg, self.train_cfg, tx, eot_id=tok.eot_id,
                               remat=self.train_cfg.remat, unroll=self.train_cfg.scan_unroll)
        words = ctx.bench.data_file(tr["words"])
        lo_len, hi_len = tr["token_lengths"]
        self.captions, self.batches, self.lengths = [], [], []
        for j in range(tr["pool_batches"]):
            lengths = traffic.token_lengths(tr["batch"], lo_len, hi_len, ctx.seed, f"lengths{j}")
            caps = traffic.texts(words, lengths, ctx.seed, f"captions{j}")
            enc = tok(caps, max_length=arch.max_text_length)
            self.captions.append(caps)
            self.lengths.append(lengths)
            self.batches.append(self._slice({"pixel_values": self._batch_pixels(j).cpu().numpy(),
                                             "input_ids": enc["input_ids"],
                                             "attention_mask": enc["attention_mask"]}))
        state = init_train_state(lora, tx, seed=self.train_cfg.seed)
        self.lora0 = state.lora
        self.first_losses = []
        for j in range(FIRST_STEPS):
            state, m = step(state, self.batches[j])
            self.first_losses.append(m["loss"])
            if j == 0:
                self.state1 = state
        self.first_losses = [float(x) for x in self.first_losses]
        self.state3 = state
        self.state, self.step = state, step

    def _slice(self, b: dict) -> dict:
        """``train()``'s ``slice_batch``."""
        n, ids, mask = self.train_cfg.text_seq_slice, b["input_ids"], b["attention_mask"]
        if (n and ids.shape[1] > n and not mask[:, n:].any()
                and (ids[:, :n] == self.eot).any(axis=1).all()):
            b = dict(b, input_ids=ids[:, :n], attention_mask=mask[:, :n])
        return b

    def window(self, seconds: float, sub) -> float:
        import torch

        self.losses: list[float] = []
        self.step_spans: list[tuple[float, float]] = []
        pending = []
        state, i = self.state, 0
        t0 = time.perf_counter()
        if sub is not None:
            sub.begin(t0)
        while time.perf_counter() - t0 < seconds:
            if sub is not None:
                sub.tick()
            s = time.perf_counter()
            state, m = self.step(state, self.batches[(FIRST_STEPS + i) % len(self.batches)])
            self.step_spans.append((s, time.perf_counter()))
            pending.append(m["loss"])
            i += 1
            if i % self.tr["logging_steps"] == 0:
                self.losses += torch.stack(pending).tolist()
                pending = []
        if pending:
            self.losses += torch.stack(pending).tolist()
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()
        self.t0, self.t_end = t0, time.perf_counter()
        self.state = state
        self.attempted = i
        self.failed = sum(1 for x in self.losses if not math.isfinite(x))
        self.window_s = self.t_end - t0
        return self.window_s

    def end_to_end(self) -> dict:
        return {"train_pairs_per_s": self.attempted * self.tr["batch"] / self.window_s}

    def free(self) -> None:
        from clip_lora_match_tpu_torch.nn.layers import set_kernel_flags

        set_kernel_flags(**self.prev_flags)
        self.state = self.step = None
        program.free_device(self.ctx.device)

    def _paths(self, tree) -> dict:
        return {p: t for p, t in ref_train.leaves(tree)}

    def check(self) -> dict:
        import torch

        ctx = self.ctx
        params, lora, scaling = program.seeded_weights(ctx)
        tok = ByteTokenizer(length=ctx.config["widths"]["max_text_length"])
        batches = [(self._batch_pixels(j), torch.as_tensor(tok(self.captions[j]), device=ctx.device))
                   for j in range(FIRST_STEPS)]
        o = self.tr["optimizer"]
        opt = {**o, "scaling": scaling}
        ref = ref_train.steps(params, lora, batches, ctx.config["widths"], opt, tok.eot)
        lora0 = self._paths(lora)
        ref_grad = dict(ref["first_grad"])
        ref_delta = {p: t - lora0[p] for p, t in ref["lora"]}

        if ctx.control in ("tf32", "half_batch"):
            got = ref_train.steps(params, lora, batches, ctx.config["widths"], opt, tok.eot,
                                  tf32=ctx.control == "tf32", half_batch=ctx.control == "half_batch")
            losses, got_grad = got["losses"], dict(got["first_grad"])
            got_delta = {p: t - lora0[p] for p, t in got["lora"]}
        else:
            losses = self.first_losses
            b1 = 0.9  # AdamW's first moment after one step is (1 - b1)·g
            adam = self.state1.opt_state[-1]
            got_grad = {p: t / (1 - b1) for p, t in self._paths(adam["mu"]).items()}
            start = self._paths(self.lora0)
            got_delta = {p: t - start[p] for p, t in self._paths(self.state3.lora).items()}
            if ctx.control == "unchanged":
                got_delta = {p: torch.zeros_like(t) for p, t in got_delta.items()}
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
        gnorm = {p: float(t.double().norm()) for p, t in ref_grad.items()}
        med = float(np.median(list(gnorm.values())))
        moved = {p for p, v in gnorm.items() if v >= 1e-3 * med}
        return {"loss_err": loss_err, "grad_err": _gap_err(got_grad, ref_grad),
                "update_err": _gap_err(got_delta, ref_delta, keep=moved)}
