"""Each cell's comparison comes out false when the timed path is broken
underneath, once for each fault the cell can have, and true when it is not.
The harness's look for a card is skipped: the tiny cells run on the CPU
through the same drivers, the port on its plain paths."""

import time

import numpy as np
import pytest
import torch

from gpu_bench.harness.manifest import Bench
from gpu_bench.harness.runner import run_cell
from gpu_bench.tests.tiny import make_root

SEED = 2 ** 33 + 99


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return Bench(make_root(tmp_path_factory.mktemp("faults")))


def _run(bench, cell):
    return run_cell(bench, cell, SEED, 0.5, False, torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("cell", ["tiny-seek", "tiny-embed", "tiny-train"])
def test_sound_runs_are_correct(bench, cell):
    out = _run(bench, cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"


def _seek_answer_altered(mp):
    from clip_lora_match_tpu_torch.retrieval.search import SearchIndex, SearchResult

    orig = SearchIndex._results

    def altered(self, scores, idx):
        out = orig(self, scores, idx)
        out[0] = SearchResult(out[0].index + 1, out[0].score, None, None)  # the top id, one off
        return out

    mp.setattr(SearchIndex, "_results", altered)
    return "search_err"


def _seek_row_repeated(mp):
    from clip_lora_match_tpu_torch.retrieval.search import SearchIndex

    orig = SearchIndex._results

    def repeated(self, scores, idx):
        out = orig(self, scores, idx)
        out[1] = out[0]  # the top row twice, the second row lost
        return out

    mp.setattr(SearchIndex, "_results", repeated)
    return "search_err"


def _seek_token_altered(mp):
    from clip_lora_match_tpu_torch.tokenizer.bpe import ClipTokenizer

    orig = ClipTokenizer.encode

    def altered(self, text, add_specials=True):
        ids = orig(self, text, add_specials)
        ids[1] = (ids[1] + 1) % 256  # the first token after the start token
        return ids

    mp.setattr(ClipTokenizer, "encode", altered)
    return "tower_err"


def _embed_answer_altered(mp):
    from clip_lora_match_tpu_torch.models.encoder import ClipEncoder

    orig = ClipEncoder.encode_image_batch

    def altered(self, pixels, normalize=True):
        out = orig(self, pixels, normalize).copy()
        out[:, 0] = -out[:, 0]
        return out

    mp.setattr(ClipEncoder, "encode_image_batch", altered)
    return "embed_err"


def _embed_half_batch(mp):
    from clip_lora_match_tpu_torch.models.encoder import ClipEncoder

    orig = ClipEncoder.encode_image_batch

    def half(self, pixels, normalize=True):
        n = pixels.shape[0]
        out = orig(self, pixels[: n // 2], normalize)
        return np.concatenate([out, out])[:n]  # the second half left out, the first's rows in its place

    mp.setattr(ClipEncoder, "encode_image_batch", half)
    return "embed_err"


def _train_state_unchanged(mp):
    import clip_lora_match_tpu_torch.train.step as step_mod

    orig = step_mod.make_train_step

    def make(*a, **k):
        real = orig(*a, **k)

        def step(state, batch):
            _, m = real(state, batch)
            return state, m

        return step

    mp.setattr(step_mod, "make_train_step", make)
    return "update_err"


def _train_half_batch(mp):
    import clip_lora_match_tpu_torch.train.step as step_mod

    orig = step_mod.clip_contrastive_loss

    def half(img, txt, temperature=0.07):
        n = img.shape[0] // 2
        return orig(img[:n], txt[:n], temperature)

    mp.setattr(step_mod, "clip_contrastive_loss", half)
    return "loss_err"


@pytest.mark.parametrize("cell,fault", [
    ("tiny-seek", _seek_answer_altered),
    ("tiny-seek", _seek_row_repeated),
    ("tiny-seek", _seek_token_altered),
    ("tiny-embed", _embed_answer_altered),
    ("tiny-embed", _embed_half_batch),
    ("tiny-train", _train_state_unchanged),
    ("tiny-train", _train_half_batch),
])
def test_faults_come_out_incorrect(bench, monkeypatch, cell, fault):
    key = fault(monkeypatch)
    out = _run(bench, cell)
    assert not out["correct"]
    assert out["checks"][key]["value"] > 10 * out["checks"][key]["limit"], out["checks"]
