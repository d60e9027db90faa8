"""The evaluation entry points of the port, one subcommand per script of
the JAX package (``scripts/evaluate.py``, ``evaluate_model.py``,
``compare_models.py``, ``qualitative_evaluation.py``,
``run_all_evaluations.py``, ``eval_similarity.py``):

    python -m clip_lora_match_tpu_torch.eval.cli evaluate        # threshold protocol per epoch
    python -m clip_lora_match_tpu_torch.eval.cli evaluate-model  # results/evaluation_results.json
    python -m clip_lora_match_tpu_torch.eval.cli compare         # results/model_comparison.json + plots
    python -m clip_lora_match_tpu_torch.eval.cli qualitative     # failure cases + embedding plot
    python -m clip_lora_match_tpu_torch.eval.cli run-all         # artifact → comparison → qualitative → report
    python -m clip_lora_match_tpu_torch.eval.cli similarity      # top-k queries/s over a built index

Each takes its script's flags and defaults (the encoder's from
``scripts/_common.py``) plus ``--device`` (``cuda`` by default, ``cpu`` for
the plain path). ``run(argv)`` returns what the subcommand computed.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from clip_lora_match_tpu_torch.train.cli import DEFAULT_LORA_CONFIG

DEFAULT_CLIP_CONFIG = "config/clip_config.yaml"
DEFAULT_EVAL_CONFIG = "config/evaluation_config.yaml"


def _encoder_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--clip-config", default=DEFAULT_CLIP_CONFIG)
    p.add_argument(
        "--weights", default=None,
        help="base CLIP weights (.npz); the adapters evaluated must have been trained over "
        "these weights (by the port's trainer or any other given the same --weights)",
    )
    p.add_argument("--lora", default=None,
                   help="LoRA adapter dir (native or PEFT); e.g. models/saved/clip-lora/epoch_1")
    p.add_argument("--lora-epoch", type=int, default=None,
                   help="shorthand: epoch number under the configured output dir")
    p.add_argument(
        "--seed", type=int, default=0,
        help="random-init seed when no --weights given; it gives the port's own weights, not "
        "the JAX package's, and MUST match the training seed (config training.seed) of a "
        "port-trained adapter to evaluate it",
    )
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def build_encoder(args):
    from clip_lora_match_tpu_torch.models.encoder import ClipEncoder

    lora_path = args.lora
    if lora_path is None and args.lora_epoch is not None:
        from clip_lora_match_tpu_torch.core.config import load_lora_config

        _, tcfg = load_lora_config(DEFAULT_LORA_CONFIG)
        lora_path = os.path.join(tcfg.output_dir, f"epoch_{args.lora_epoch}")
    return ClipEncoder.from_config(
        config_path=args.clip_config if os.path.exists(args.clip_config) else None,
        weights_path=args.weights, lora_path=lora_path, seed=args.seed, device=args.device,
    )


def _write_json(obj, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


# -- subcommands ----------------------------------------------------------------


def evaluate(args) -> dict:
    """Threshold relevance per adapter epoch, with query latency
    (ref:scripts/evaluate.py:24,141-168,231-266,305)."""
    from clip_lora_match_tpu_torch.core.config import load_eval_config, load_lora_config
    from clip_lora_match_tpu_torch.eval import CLIPEvaluator, load_eval_csv, threshold_metrics
    from clip_lora_match_tpu_torch.lora.adapter import load_lora

    cfg = load_eval_config(args.eval_config)
    encoder = build_encoder(args)
    data = load_eval_csv(args.csv or cfg.val_csv, cfg.image_root, max_rows=args.max_rows)
    epochs = args.epochs if args.epochs is not None else list(cfg.lora_epochs)
    _, tcfg = load_lora_config(DEFAULT_LORA_CONFIG)

    results = {}
    variants = [("base", None, 1.0)]
    for k in epochs:
        path = os.path.join(args.lora_dir or cfg.lora_dir or tcfg.output_dir, f"epoch_{k}")
        if os.path.exists(path):
            variants.append((f"epoch_{k}", *load_lora(path, device=encoder.device, arch=encoder.arch)))
    for name, lora, scaling in variants:
        encoder.attach_lora(lora, scaling)
        _, txt = CLIPEvaluator(encoder).encode_dataset(data)
        results[name] = threshold_metrics(
            txt, txt, ks=cfg.recall_k_values, threshold=args.threshold, exclude_self=True,
            device=encoder.device,
        )
        print(f"[evaluate] {name}: {json.dumps(results[name])}")
    out = args.out or os.path.join(cfg.results_dir, "evaluation_results_threshold.json")
    _write_json(results, out)
    print(f"[evaluate] wrote {out}")
    return results


def evaluate_model(args) -> dict:
    """Diagonal ground truth, written as results/evaluation_results.json
    (ref:scripts/evaluate_model.py:291-375)."""
    from clip_lora_match_tpu_torch.core.config import load_eval_config
    from clip_lora_match_tpu_torch.eval import CLIPEvaluator, load_eval_csv

    cfg = load_eval_config(args.eval_config)
    encoder = build_encoder(args)
    data = load_eval_csv(args.csv or cfg.val_csv, args.image_root or cfg.image_root, max_rows=args.max_rows)
    artifact = CLIPEvaluator(encoder).evaluation_results_artifact(data, ks=cfg.recall_k_values)
    out = args.out or os.path.join(cfg.results_dir, "evaluation_results.json")
    _write_json(artifact, out)
    print(f"[evaluate_model] {data.texts and len(data.texts)} samples -> {out}")
    print(json.dumps(artifact, indent=2))
    return artifact


def compare(args) -> dict:
    """Base against the LoRA epochs, with plots (ref:scripts/compare_models.py:305-350)."""
    from clip_lora_match_tpu_torch.core.config import load_eval_config
    from clip_lora_match_tpu_torch.eval import ModelComparator, load_eval_csv

    cfg = load_eval_config(args.eval_config)
    encoder = build_encoder(args)
    data = load_eval_csv(args.csv or cfg.val_csv, cfg.image_root, max_rows=args.max_rows)
    comp = ModelComparator(encoder, args.lora_dir or cfg.lora_dir, epochs=args.epochs or cfg.lora_epochs)
    results = comp.compare(data, ks=cfg.recall_k_values)
    out = args.out or os.path.join(cfg.results_dir, "model_comparison.json")
    comp.save_json(results, out)
    print(f"[compare_models] wrote {out}")
    for name, imp in comp.summary(results).items():
        print(f"  {name}: " + ", ".join(f"{k} {v:+.1f}%" for k, v in imp.items()))
    if not args.skip_plots:
        for path in comp.plot_all(results, cfg.plots_dir, ks=cfg.recall_k_values):
            print(f"  plot: {path}")
    return results


def qualitative(args) -> dict:
    """Failure-case grids and the embedding-space plot
    (ref:scripts/qualitative_evaluation.py:117-337)."""
    from clip_lora_match_tpu_torch.core.config import load_eval_config
    from clip_lora_match_tpu_torch.eval import (
        CLIPEvaluator,
        find_failure_cases,
        load_eval_csv,
        plot_embedding_space,
        plot_failure_grids,
    )

    cfg = load_eval_config(args.eval_config)
    encoder = build_encoder(args)
    data = load_eval_csv(args.csv or cfg.val_csv, cfg.image_root, max_rows=args.max_rows)
    img, txt = CLIPEvaluator(encoder).encode_dataset(data)
    cases = find_failure_cases(
        img, txt, data.texts, num_cases=args.num_cases or cfg.num_failure_cases,
        k=cfg.num_top_k_visualize, device=encoder.device,
    )
    print(f"[qualitative] {len(cases)} failure cases:")
    for c in cases:
        print(f"  rank {c.correct_rank:4d} score {c.correct_score:.3f}  {c.query_text[:60]}")
    grids = plot_failure_grids(cases, data.image_paths, cfg.qualitative_dir, k=cfg.num_top_k_visualize)
    viz = plot_embedding_space(
        img, txt, os.path.join(cfg.plots_dir, "embedding_space.png"), method=cfg.embedding_viz_method,
    )
    print(f"[qualitative] {len(grids)} grids -> {cfg.qualitative_dir}; viz={viz}")
    return {"cases": cases, "grids": grids, "embedding_plot": viz}


def run_all(args) -> dict:
    """Full evaluation → comparison → qualitative → markdown report
    (ref:scripts/run_all_evaluations.py:140-269)."""
    from clip_lora_match_tpu_torch.core.config import load_eval_config
    from clip_lora_match_tpu_torch.eval import (
        BASE_NAME,
        CLIPEvaluator,
        ModelComparator,
        create_evaluation_report,
        find_failure_cases,
        load_eval_csv,
        plot_embedding_space,
        plot_failure_grids,
    )

    cfg = load_eval_config(args.eval_config)
    encoder = build_encoder(args)
    data = load_eval_csv(args.csv or cfg.val_csv, cfg.image_root, max_rows=200 if args.quick else None)
    os.makedirs(cfg.results_dir, exist_ok=True)

    # 1. the full evaluation of the encoder as built (base or --lora)
    ev = CLIPEvaluator(encoder)
    artifact = ev.evaluation_results_artifact(data, ks=cfg.recall_k_values)
    _write_json(artifact, os.path.join(cfg.results_dir, "evaluation_results.json"))

    # 2. the comparison across base and epochs
    comp = ModelComparator(encoder, cfg.lora_dir, epochs=cfg.lora_epochs)
    results = comp.compare(data, ks=cfg.recall_k_values)
    if args.skip_base:
        results.pop(BASE_NAME, None)
    comp.save_json(results, os.path.join(cfg.results_dir, "model_comparison.json"))
    plots = comp.plot_all(results, cfg.plots_dir, ks=cfg.recall_k_values)

    # 3. qualitative
    grids, viz = [], None
    if not (args.skip_qualitative or cfg.skip_qualitative):
        img, txt = ev.encode_dataset(data)
        cases = find_failure_cases(
            img, txt, data.texts, num_cases=cfg.num_failure_cases, k=cfg.num_top_k_visualize,
            device=encoder.device,
        )
        grids = plot_failure_grids(cases, data.image_paths, cfg.qualitative_dir, k=cfg.num_top_k_visualize)
        viz = plot_embedding_space(
            img, txt, os.path.join(cfg.plots_dir, "embedding_space.png"), method=cfg.embedding_viz_method,
        )

    # 4. the report: the epoch-over-epoch lift, not the lift over a base
    # that scores chance when its weights are random
    report = create_evaluation_report(
        results,
        os.path.join(cfg.results_dir, "evaluation_report.md"),
        ModelComparator.epoch_over_epoch(results),
        improvements_title="Improvement (epoch over epoch)",
    )
    print(f"[run_all_evaluations] report: {report}")
    return {"artifact": artifact, "comparison": results, "report": report, "plots": plots,
            "grids": grids, "embedding_plot": viz}


def similarity(args) -> dict:
    """Top-k throughput over a built index (the JAX package's
    scripts/eval_similarity.py)."""
    from clip_lora_match_tpu_torch.core.device import resolve_device
    from clip_lora_match_tpu_torch.index import EmbeddingIndex
    from clip_lora_match_tpu_torch.retrieval import top_k_similar

    index = EmbeddingIndex.load(args.index, device=resolve_device(args.device))
    if len(index) == 0:
        print("[eval_similarity] empty index; run build_custom_index first")
        return {}
    rng = np.random.default_rng(0)
    q = rng.normal(size=(args.queries, index.dim)).astype(np.float32)
    top_k_similar(q, index.embeddings, args.k, assume_normalized=True)  # warm-up
    t0 = time.perf_counter()
    for _ in range(args.iters):
        scores, idx = top_k_similar(q, index.embeddings, args.k, assume_normalized=True)
    dt = (time.perf_counter() - t0) / args.iters
    print(
        f"[eval_similarity] N={len(index)} Q={args.queries} k={args.k}: "
        f"{dt * 1e3:.3f} ms/batch -> {args.queries / dt:,.0f} queries/sec"
    )
    return {"queries": q, "scores": scores, "ids": idx, "ms_per_batch": dt * 1e3,
            "queries_per_s": args.queries / dt, "rows": len(index)}


# -- argument parsing ---------------------------------------------------------


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate CLIP and its LoRA adapters (PyTorch)")
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser("evaluate", help="threshold-relevance evaluation per epoch")
    s.add_argument("--eval-config", default=DEFAULT_EVAL_CONFIG)
    s.add_argument("--csv", default=None)
    s.add_argument("--threshold", type=float, default=0.7)
    s.add_argument("--epochs", type=int, nargs="*", default=None)
    s.add_argument("--max-rows", type=int, default=None)
    s.add_argument("--out", default=None)
    s.add_argument("--lora-dir", default=None, help="adapter root (default: eval config / training output)")
    _encoder_args(s)
    s.set_defaults(fn=evaluate)

    s = sub.add_parser("evaluate-model", help="diagonal-GT retrieval evaluation")
    s.add_argument("--eval-config", default=DEFAULT_EVAL_CONFIG)
    s.add_argument("--csv", default=None)
    s.add_argument("--image-root", default=None)
    s.add_argument("--max-rows", type=int, default=None)
    s.add_argument("--out", default=None)
    _encoder_args(s)
    s.set_defaults(fn=evaluate_model)

    s = sub.add_parser("compare", help="compare base CLIP against LoRA epochs")
    s.add_argument("--eval-config", default=DEFAULT_EVAL_CONFIG)
    s.add_argument("--csv", default=None)
    s.add_argument("--max-rows", type=int, default=None)
    s.add_argument("--skip-plots", action="store_true")
    s.add_argument("--lora-dir", default=None, help="adapter root (default: eval config's lora_dir)")
    s.add_argument("--epochs", type=int, nargs="+", default=None)
    s.add_argument("--out", default=None,
                   help="output JSON path (default: results_dir/model_comparison.json)")
    _encoder_args(s)
    s.set_defaults(fn=compare)

    s = sub.add_parser("qualitative", help="qualitative failure analysis")
    s.add_argument("--eval-config", default=DEFAULT_EVAL_CONFIG)
    s.add_argument("--csv", default=None)
    s.add_argument("--max-rows", type=int, default=None)
    s.add_argument("--num-cases", type=int, default=None)
    _encoder_args(s)
    s.set_defaults(fn=qualitative)

    s = sub.add_parser("run-all", help="run the full evaluation pipeline")
    s.add_argument("--eval-config", default=DEFAULT_EVAL_CONFIG)
    s.add_argument("--csv", default=None)
    s.add_argument("--quick", action="store_true", help="subsample to 200 rows")
    s.add_argument("--skip-base", action="store_true")
    s.add_argument("--skip-qualitative", action="store_true")
    _encoder_args(s)
    s.set_defaults(fn=run_all)

    s = sub.add_parser("similarity", help="similarity / top-k throughput")
    s.add_argument("--index", default="data/index/custom_items_index.npz")
    s.add_argument("--queries", type=int, default=256)
    s.add_argument("--k", type=int, default=10)
    s.add_argument("--iters", type=int, default=20)
    _encoder_args(s)
    s.set_defaults(fn=similarity)
    return p


def run(argv=None):
    args = _parser().parse_args(argv)
    return args.fn(args)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
