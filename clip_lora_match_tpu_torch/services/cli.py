"""The demo entry points of the port, one subcommand per demo script of the
JAX package:

    python -m clip_lora_match_tpu_torch.services.cli finder-report --image IMG --description TEXT
    python -m clip_lora_match_tpu_torch.services.cli seeker              # scripts/demo_seeker.py
    python -m clip_lora_match_tpu_torch.services.cli search-text         # the fashion text index
    python -m clip_lora_match_tpu_torch.services.cli search-text-custom  # the custom items index
    python -m clip_lora_match_tpu_torch.services.cli search-image        # 'sample' draws a val row
    python -m clip_lora_match_tpu_torch.services.cli search-image-custom
    python -m clip_lora_match_tpu_torch.services.cli search-image-yolo --image IMG [--fused]

Each takes its script's flags and defaults (the encoder's from
``scripts/_common.py``) plus ``--device`` (``cuda`` by default, ``cpu`` for
the plain path). The interactive subcommands read ``input()`` as the scripts
do; a one-shot flag (``--query``, ``--image``, ``--description``) skips the
loop. ``run(argv)`` returns what the subcommand computed: the result list
of a one-shot search, the list of result lists of a loop, the finder's
``ReportResult``, or the fused search's (scores, ids, box, detected).
"""

from __future__ import annotations

import argparse
import datetime as dt
import random

from clip_lora_match_tpu_torch.eval.cli import _encoder_args, build_encoder

DEFAULT_YOLO_CONFIG = "config/yolo_config.yaml"
CUSTOM_INDEX = "data/index/custom_items_index.npz"
FASHION_INDEX = "data/index/fashion_text_index.npz"


def print_results(results, max_text: int = 70) -> None:
    for rank, r in enumerate(results, 1):
        text = (r.text or "")[:max_text]
        print(f"  {rank}. [{r.score:.4f}] {text}  ({r.image_path})")


def _search_index(args):
    from clip_lora_match_tpu_torch.retrieval.search import SearchIndex

    encoder = build_encoder(args)
    si = SearchIndex.from_file(args.index, encoder, device=encoder.device)
    print(f"[demo] loaded {len(si.index)} items from {args.index}")
    return si


def _loop(prompt: str, search, sample=None) -> list:
    """The scripts' REPL: one search a line until an empty line, q, quit,
    exit or end of input; ``sample`` maps the word 'sample' to a query."""
    out = []
    while True:
        try:
            q = input(prompt).strip()
        except (EOFError, KeyboardInterrupt):
            break
        if not q or q.lower() in ("q", "quit", "exit"):
            break
        if sample is not None and q == "sample":
            q = sample()
            if q is None:
                continue
        res = search(q)
        print_results(res)
        out.append(res)
    return out


def finder_report(args):
    """scripts/demo_finder_report.py: one report into the index (and the
    store, with ``--db``)."""
    from clip_lora_match_tpu_torch.db.store import open_store
    from clip_lora_match_tpu_torch.services.finder import FinderConfig, FinderService

    finder = FinderService(
        build_encoder(args), FinderConfig(index_path=args.index),
        store=open_store(args.db) if args.db else None,
    )
    r = finder.report_item(
        args.image, description=args.description, location=args.location,
        found_at=dt.datetime.now(), reporter=args.reporter,
    )
    print(f"[demo_finder_report] row={r.index_row} id={r.item_id} "
          f"stored={r.stored_image_path}\n  indexed text: {r.indexed_text}")
    return r


def seeker(args):
    """scripts/demo_seeker.py: fused text and/or image search."""
    from clip_lora_match_tpu_torch.services.seeker import SeekerConfig, SeekerService

    svc = SeekerService(build_encoder(args), SeekerConfig(index_path=args.index, top_k=args.k))
    if args.description or args.image:
        res = svc.search_items(description=args.description, image_path=args.image)
        print_results(res)
        return res
    out = []
    while True:
        try:
            desc = input("description (empty to skip)> ").strip() or None
            img = input("image path (empty to skip)> ").strip() or None
        except (EOFError, KeyboardInterrupt):
            break
        if desc is None and img is None:
            break
        try:
            res = svc.search_items(description=desc, image_path=img)
        except Exception as e:  # the script's REPL reports and goes on
            print(f"error: {e}")
            continue
        print_results(res)
        out.append(res)
    return out


def search_text(args):
    """scripts/demo_search_text.py and demo_search_text_custom.py."""
    si = _search_index(args)
    if args.query:
        res = si.search_by_text(args.query, args.k)
        print_results(res)
        return res
    return _loop("query> ", lambda q: si.search_by_text(q, args.k))


def search_image(args):
    """scripts/demo_search_image.py (with ``--val-csv``: the word 'sample'
    draws a random val image) and demo_search_image_custom.py."""
    si = _search_index(args)
    if args.image:
        res = si.search_by_image(args.image, args.k)
        print_results(res)
        return res
    sample = None
    if getattr(args, "val_csv", None):
        def sample():
            from clip_lora_match_tpu_torch.eval import load_eval_csv

            data = load_eval_csv(args.val_csv, require_images=True)
            if not data.image_paths:
                print("no val images available")
                return None
            q = random.choice(data.image_paths)
            print(f"sampled: {q}")
            return q
    return _loop("image path (or 'sample')> " if sample else "image path> ",
                 lambda q: si.search_by_image(q, args.k), sample)


def search_image_yolo(args):
    """scripts/demo_search_image_yolo_custom.py: crop with the detector, then
    search with the first crop; ``--fused`` runs detect → crop → embed →
    top-k on the card in one call (``make_fused_search``)."""
    from clip_lora_match_tpu_torch.models.yolo.cropper import NullDetector, load_yolo_cropper

    cropper = load_yolo_cropper(args.yolo_config, weights_path=args.yolo_weights, device=args.device)
    si = _search_index(args)
    print(f"[demo] original: {args.image}")
    if args.fused:
        import numpy as np
        from PIL import Image

        from clip_lora_match_tpu_torch.models.yolo.device_crop import make_fused_search

        if isinstance(cropper.detector, NullDetector):
            raise SystemExit("[demo] --fused needs trained detector weights")
        search = make_fused_search(
            cropper.detector, si.encoder, si.index.embeddings, k=args.k,
            conf=cropper.cfg.conf_threshold, iou=cropper.cfg.iou_threshold,
        )
        scores, ids, box, detected = search(np.asarray(Image.open(args.image).convert("RGB"), np.uint8))
        print(f"[demo] fused: detected={detected} box={box.round(1).tolist()}")
        for rank, (s, i) in enumerate(zip(scores, ids), 1):
            path, text = si.index.metadata(int(i))
            print(f"  {rank}. [{s:.4f}] {text}  ({path})")
        return scores, ids, box, detected
    try:
        crops = cropper.crop_image(args.image)
    except Exception as e:  # the script searches with the original image
        print(f"[demo] crop failed ({e}); using original image")
        crops = [args.image]
    query = crops[0] if crops else args.image
    print(f"[demo] query crop: {query}")
    res = si.search_by_image(query, args.k)
    print_results(res)
    return res


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="The demos of the finder and seeker services (PyTorch)")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("finder-report", help="one-shot finder report (scripts/demo_finder_report.py)")
    s.add_argument("--index", default=CUSTOM_INDEX)
    s.add_argument("--image", required=True)
    s.add_argument("--description", required=True)
    s.add_argument("--location", default=None)
    s.add_argument("--reporter", default="demo")
    s.add_argument("--db", default=None)
    s.set_defaults(fn=finder_report)

    s = sub.add_parser("seeker", help="multimodal seeker (scripts/demo_seeker.py)")
    s.add_argument("--index", default=CUSTOM_INDEX)
    s.add_argument("--k", type=int, default=5)
    s.add_argument("--description", default=None)
    s.add_argument("--image", default=None)
    s.set_defaults(fn=seeker)

    for name, index, what in (("search-text", FASHION_INDEX, "fashion"),
                              ("search-text-custom", CUSTOM_INDEX, "custom")):
        s = sub.add_parser(name, help=f"{what}-index text search (scripts/demo_{name.replace('-', '_')}.py)")
        s.add_argument("--index", default=index)
        s.add_argument("--k", type=int, default=5)
        s.add_argument("--query", default=None, help="one-shot query (skip REPL)")
        s.set_defaults(fn=search_text)

    s = sub.add_parser("search-image", help="image search, 'sample' draws a val row "
                                            "(scripts/demo_search_image.py)")
    s.add_argument("--index", default=FASHION_INDEX)
    s.add_argument("--val-csv", default="data/text/val_fashion.csv")
    s.add_argument("--k", type=int, default=5)
    s.add_argument("--image", default=None, help="one-shot image path")
    s.set_defaults(fn=search_image)

    s = sub.add_parser("search-image-custom", help="custom-index image search "
                                                   "(scripts/demo_search_image_custom.py)")
    s.add_argument("--index", default=CUSTOM_INDEX)
    s.add_argument("--k", type=int, default=5)
    s.add_argument("--image", default=None)
    s.set_defaults(fn=search_image)

    s = sub.add_parser("search-image-yolo", help="YOLO crop + CLIP image search "
                                                 "(scripts/demo_search_image_yolo_custom.py)")
    s.add_argument("--index", default=CUSTOM_INDEX)
    s.add_argument("--yolo-config", default=DEFAULT_YOLO_CONFIG)
    s.add_argument("--yolo-weights", default=None)
    s.add_argument("--k", type=int, default=5)
    s.add_argument("--image", required=True)
    s.add_argument("--fused", action="store_true",
                   help="detect → crop → embed → top-k on the device in one call (needs a live "
                        "detector) instead of the staged crop-file pipeline")
    s.set_defaults(fn=search_image_yolo)

    for s in sub.choices.values():
        _encoder_args(s)
    return p


def run(argv=None):
    args = _parser().parse_args(argv)
    return args.fn(args)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
