"""The detector's entry points of the port: training on the synthetic
detection corpus (``scripts/train_yolo.py``), evaluation against its
ground truth (``scripts/eval_yolo.py``) and the leave-photos-out evaluation
on the hand-labelled photos (``scripts/eval_real_detect_heldout.py``).

    python scripts/generate_fashion_corpus.py --detect --out data/detect_synth \\
        --n-train 2400 --n-val 600 --imgsz 320
    python -m clip_lora_match_tpu_torch.models.yolo.cli train --data data/detect_synth --epochs 30
    python -m clip_lora_match_tpu_torch.models.yolo.cli eval --data data/detect_synth --limit 150
    python -m clip_lora_match_tpu_torch.models.yolo.cli heldout --out results/real_detect_eval_heldout.json

The flags are the scripts' plus ``--device`` (``cuda`` by default, ``cpu``
for the plain path). ``train`` saves fp16 weights in the JAX package's file
layout (``yolov8{width}_{tag}.npz``, HWIO kernels) and a ``meta.json``
under ``--out``, so either package's ``load_detector`` reads them. Without
``--init-weights`` the weights start from the port's seeded init, which is
not the JAX package's (another generator). ``heldout`` trains each fold in
this process through ``train`` and scores it through ``evaluate``; its
``--reference-root`` (where the labels' photo paths resolve) defaults to
the repository root. ``run(argv)`` returns what the subcommand computed.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def _graft(dst, src) -> int:
    """Copy every ``src`` leaf whose shape matches the ``dst`` leaf at the
    same place (dicts by key, lists by index); the others keep their fresh
    init (the class-count-dependent head leaves). → the count grafted."""
    if isinstance(dst, dict) and isinstance(src, dict):
        items = [(k, k) for k in dst if k in src]
    elif isinstance(dst, list) and isinstance(src, list):
        items = [(i, i) for i in range(min(len(dst), len(src)))]
    else:
        return 0
    n = 0
    for dk, sk in items:
        v = dst[dk]
        if isinstance(v, (dict, list)):
            n += _graft(v, src[sk])
        elif src[sk].shape == v.shape:
            dst[dk] = src[sk].to(v.device, v.dtype)
            n += 1
    return n


def train(args) -> dict:
    """scripts/train_yolo.py: AdamW on a warmup-cosine schedule after a
    global-norm clip at 10, over ``DetectDataset`` batches."""
    import torch

    from clip_lora_match_tpu_torch.core.device import resolve_device
    from clip_lora_match_tpu_torch.models.io import save_params, tree_leaves
    from clip_lora_match_tpu_torch.models.yolo.train import (
        DetectDataset,
        YoloTrainState,
        init_detect_biases,
        make_yolo_train_step,
    )
    from clip_lora_match_tpu_torch.models.yolo.yolov8 import (
        WIDTHS,
        WIDTHS_N,
        init_params,
        params_from_jax,
        params_to_jax,
        read_detector,
    )
    from clip_lora_match_tpu_torch.train.step import AdamW, Chain, ClipByGlobalNorm, warmup_cosine_decay_schedule

    dev = resolve_device(args.device)
    with open(os.path.join(args.data, "classes.txt")) as f:
        classes = f.read().split()
    ds = DetectDataset(os.path.join(args.data, "boxes_train.csv"), args.imgsz)
    print(f"[train_yolo] {len(ds)} images, {len(classes)} classes, imgsz {args.imgsz}, width -{args.width}")

    params = init_params(args.seed, widths=WIDTHS_N if args.width == "n" else WIDTHS,
                         num_classes=len(classes), device=dev)
    params = init_detect_biases(params, args.imgsz)
    grafted = None
    if args.init_weights:
        grafted = _graft(params, params_from_jax(read_detector(args.init_weights)[0], dev))
        print(f"[train_yolo] warm-start from {args.init_weights}: "
              f"{grafted}/{len(tree_leaves(params))} leaves grafted")

    steps_per_epoch = len(ds) // args.batch_size
    total = max(2, steps_per_epoch * args.epochs)
    # warmup clamped below the horizon (smoke-scale runs have fewer steps than the warmup)
    warmup = min(int(steps_per_epoch * args.warmup_epochs), total - 1)
    sched = warmup_cosine_decay_schedule(0.0, args.lr, max(warmup, 1), total, end_value=args.lr * 0.01)
    tx = Chain(ClipByGlobalNorm(10.0), AdamW(sched, weight_decay=args.weight_decay))
    step = make_yolo_train_step(args.imgsz, tx, device=dev)
    state = YoloTrainState(params, tx.init(params), 0)

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    n_steps = 0
    logged = []
    for epoch in range(args.epochs):
        for batch in ds.batches(args.batch_size, rng):
            state, aux = step(state, batch)
            n_steps += 1
            if n_steps % args.log_every == 0:
                aux = {k: float(v) for k, v in aux.items()}
                logged.append(aux)
                print(
                    f"[train_yolo] epoch {epoch + 1} step {n_steps}/{total} "
                    f"loss {aux['loss']:.3f} (box {aux['box']:.3f} "
                    f"cls {aux['cls']:.3f} dfl {aux['dfl']:.3f}) "
                    f"fg {aux['num_fg']:.1f}",
                    flush=True,
                )
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.time() - t0
        print(f"[train_yolo] epoch {epoch + 1} done ({dt:.0f}s elapsed, "
              f"{n_steps * args.batch_size / dt:.0f} img/s)")
    seconds = time.time() - t0

    os.makedirs(args.out, exist_ok=True)
    wpath = os.path.join(args.out, f"yolov8{args.width}_{args.tag}.npz")
    save_params(wpath, params_to_jax(state.params, np.float16))
    with open(os.path.join(args.out, "meta.json"), "w") as f:
        json.dump({"classes": classes, "imgsz": args.imgsz, "width": args.width, "epochs": args.epochs,
                   "train_images": len(ds)}, f, indent=2)
    print(f"[train_yolo] saved {wpath}")
    return {"params": state.params, "logged": logged, "steps": n_steps, "seconds": seconds,
            "weights": wpath, "grafted": grafted, "leaves": len(tree_leaves(state.params))}


def box_iou_np(a, b) -> float:
    ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
    ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, ix2 - ix1) * max(0.0, iy2 - iy1)
    aa = max(0.0, a[2] - a[0]) * max(0.0, a[3] - a[1])
    bb = max(0.0, b[2] - b[0]) * max(0.0, b[3] - b[1])
    return inter / max(aa + bb - inter, 1e-9)


def evaluate(detector, csv_path: str, cfg, limit=None) -> dict:
    """Recall and precision at IoU 0.5, the mean matched IoU and the class
    accuracy of ``detector`` over a ``boxes_{split}.csv`` (greedy matching
    per GT, as scripts/eval_yolo.py)."""
    from PIL import Image

    from clip_lora_match_tpu_torch.models.yolo.train import load_detect_csv

    paths, boxes, cls, valid = load_detect_csv(csv_path)
    if limit:
        paths, boxes, cls, valid = paths[:limit], boxes[:limit], cls[:limit], valid[:limit]
    n_gt = n_matched = n_cls_ok = n_det = n_det_matched = 0
    iou_sum = 0.0
    for p, bs, cs, vs in zip(paths, boxes, cls, valid):
        img = Image.open(p).convert("RGB")
        dets = detector.detect(img, conf=cfg.conf_threshold, iou=cfg.iou_threshold, max_det=cfg.max_det)
        n_det += len(dets)
        used = set()
        for b, c, v in zip(bs, cs, vs):
            if not v:
                continue
            n_gt += 1
            best, best_iou = None, 0.0
            for i, d in enumerate(dets):
                if i in used:
                    continue
                iou = box_iou_np(b, d.box)
                if iou > best_iou:
                    best, best_iou = i, iou
            if best is not None and best_iou >= 0.5:
                used.add(best)
                n_matched += 1
                iou_sum += best_iou
                n_cls_ok += int(dets[best].class_id == int(c))
        n_det_matched += len(used)
    return {
        "num_images": len(paths),
        "num_gt": n_gt,
        "recall@0.5": float(n_matched / max(n_gt, 1)),
        "mean_matched_iou": float(iou_sum / max(n_matched, 1)),
        "cls_accuracy": float(n_cls_ok / max(n_matched, 1)),
        "precision@0.5": float(n_det_matched / max(n_det, 1)),
        "detections": n_det,
    }


def evaluate_cmd(args) -> dict:
    from clip_lora_match_tpu_torch.core.config import YoloConfig
    from clip_lora_match_tpu_torch.models.yolo.yolov8 import load_detector

    det = load_detector(args.weights, YoloConfig(), device=args.device)
    metrics = evaluate(det, os.path.join(args.data, f"boxes_{args.split}.csv"), det.cfg, limit=args.limit)
    print(json.dumps(metrics, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(metrics, f, indent=2)
    return metrics


# -- the leave-photos-out evaluation on the labelled photos ----------------------------


def augment_one(img, box, rng, imgsz):
    """One augmented variant (scripts/make_real_detect_corpus.py): a zoom
    window around the box, resized to imgsz² (a square stretch, as
    ``DetectDataset``'s loader), a random flip and brightness / contrast /
    colour jitter. Returns (PIL image, (x1, y1, x2, y2)) in output
    coordinates."""
    from PIL import Image, ImageEnhance

    w, h = img.size
    x1, y1, x2, y2 = box
    bw, bh = x2 - x1, y2 - y1
    mx1 = rng.uniform(0.02, 0.6) * bw
    mx2 = rng.uniform(0.02, 0.6) * bw
    my1 = rng.uniform(0.02, 0.6) * bh
    my2 = rng.uniform(0.02, 0.6) * bh
    wx1 = max(0.0, x1 - mx1)
    wy1 = max(0.0, y1 - my1)
    wx2 = min(float(w), x2 + mx2)
    wy2 = min(float(h), y2 + my2)
    crop = img.crop((int(wx1), int(wy1), int(wx2), int(wy2)))
    cw, ch = crop.size
    ox1 = (x1 - wx1) * imgsz / cw
    oy1 = (y1 - wy1) * imgsz / ch
    ox2 = (x2 - wx1) * imgsz / cw
    oy2 = (y2 - wy1) * imgsz / ch
    out = crop.resize((imgsz, imgsz), Image.Resampling.BILINEAR)
    if rng.random() < 0.5:
        out = out.transpose(Image.Transpose.FLIP_LEFT_RIGHT)
        ox1, ox2 = imgsz - ox2, imgsz - ox1
    for enh, lo, hi in (
        (ImageEnhance.Brightness, 0.7, 1.3),
        (ImageEnhance.Contrast, 0.75, 1.25),
        (ImageEnhance.Color, 0.6, 1.4),
    ):
        out = enh(out).enhance(rng.uniform(lo, hi))

    def clamp(v):
        return max(0.0, min(float(imgsz), v))

    return out, (clamp(ox1), clamp(oy1), clamp(ox2), clamp(oy2))


def unique_photos(labels):
    """Label entries grouped by file basename → sorted [(key, entries)] (a
    photo filed under two directories is one photo)."""
    groups = {}
    for entry in labels["images"]:
        groups.setdefault(os.path.basename(entry["path"]), []).append(entry)
    return sorted(groups.items())


def make_folds(keys_with_classes, n_folds=3, seed=0):
    """Deterministic stratified folds: shuffled within each class, dealt
    round-robin so that each fold's hold-out mixes classes."""
    byc = {}
    for key, cls in keys_with_classes:
        byc.setdefault(cls, []).append(key)
    rng = random.Random(seed)
    folds = [[] for _ in range(n_folds)]
    i = 0
    for cls in sorted(byc):
        ks = sorted(byc[cls])
        rng.shuffle(ks)
        for k in ks:
            folds[i % n_folds].append(k)
            i += 1
    return folds


def _fold_corpus(args, fi, holdout, photos, classes, fold_dir) -> tuple[int, int]:
    """Augmented variants of the photos outside ``holdout`` (train) and the
    held-out originals with their hand boxes (val), written as a corpus."""
    from PIL import Image

    img_dir = os.path.join(fold_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    with open(os.path.join(fold_dir, "classes.txt"), "w") as f:
        f.write("\n".join(classes) + "\n")
    rng = random.Random(args.seed + fi)
    train_rows, val_rows, n = [], [], 0
    for key, entries in photos:
        entry = entries[0]
        src = os.path.join(args.reference_root, entry["path"])
        b = entry["boxes"][0]
        cid = classes.index(b["class"])
        if key in holdout:
            val_rows.append(f"{src},{' '.join(str(round(v, 1)) for v in b['xyxy'])} {cid}")
            continue
        img = Image.open(src).convert("RGB")
        for _ in range(args.per_image):
            out, (x1, y1, x2, y2) = augment_one(img, b["xyxy"], rng, args.imgsz)
            pth = os.path.join(img_dir, f"{n:05d}.jpg")
            out.save(pth, quality=90)
            train_rows.append(f"{pth},{x1:.1f} {y1:.1f} {x2:.1f} {y2:.1f} {cid}")
            n += 1
    rng.shuffle(train_rows)
    for name, rows in (("train", train_rows), ("val", val_rows)):
        with open(os.path.join(fold_dir, f"boxes_{name}.csv"), "w") as f:
            f.write("image_path,boxes\n" + "\n".join(rows) + "\n")
    return len(train_rows), len(val_rows)


def heldout(args) -> dict:
    """scripts/eval_real_detect_heldout.py: K folds over the unique photos,
    each fine-tuned from ``--init-weights`` on augmented variants of its
    in-fold photos and scored on its held-out originals; the pooled metrics
    over every held-out photo are written to ``--out``."""
    from clip_lora_match_tpu_torch.core.config import YoloConfig
    from clip_lora_match_tpu_torch.models.yolo.yolov8 import load_detector

    with open(args.labels) as f:
        labels = json.load(f)
    classes = labels["classes"]
    photos = unique_photos(labels)
    folds = make_folds([(k, es[0]["boxes"][0]["class"]) for k, es in photos],
                       n_folds=args.folds, seed=args.seed)
    print(f"[heldout] {len(photos)} unique photos ({len(labels['images'])} label entries), folds: {folds}")

    work = args.workdir or tempfile.mkdtemp(prefix="clm_heldout_")
    totals = dict(num_images=0, num_gt=0, matched=0, iou_sum=0.0, cls_ok=0, det=0, det_matched=0)
    per_fold = []
    for fi, holdout in enumerate(folds):
        fold_dir = os.path.join(work, f"fold{fi}")
        n_train, _ = _fold_corpus(args, fi, holdout, photos, classes, fold_dir)
        out_dir = os.path.join(fold_dir, "weights")
        print(f"[heldout] fold {fi}: train on {n_train} variants of {len(photos) - len(holdout)} photos, "
              f"hold out {holdout}")
        trained = train(_parser().parse_args([
            "train", "--data", fold_dir, "--out", out_dir, "--imgsz", str(args.imgsz),
            "--epochs", str(args.epochs), "--init-weights", args.init_weights, "--tag", f"heldout{fi}",
            "--seed", str(args.seed), "--batch-size", str(args.batch_size), "--device", args.device,
        ]))
        det = load_detector(trained["weights"], YoloConfig(), device=args.device)
        m = evaluate(det, os.path.join(fold_dir, "boxes_val.csv"), det.cfg)
        m["holdout"] = holdout
        per_fold.append(m)
        print(f"[heldout] fold {fi}: {json.dumps(m)}")
        matched = round(m["recall@0.5"] * m["num_gt"])
        totals["num_images"] += m["num_images"]
        totals["num_gt"] += m["num_gt"]
        totals["matched"] += matched
        totals["iou_sum"] += m["mean_matched_iou"] * matched
        totals["cls_ok"] += round(m["cls_accuracy"] * m["recall@0.5"] * m["num_gt"])
        totals["det"] += m["detections"]
        totals["det_matched"] += round(m["precision@0.5"] * m["detections"])

    pooled = {
        "protocol": (
            "leave-photos-out over unique photos (duplicate file grouped); "
            f"{args.folds} folds, fine-tune from synth weights on augmented "
            "variants of in-fold photos only, eval on held-out originals"
        ),
        "num_unique_photos": len(photos),
        "num_images": totals["num_images"],
        "num_gt": totals["num_gt"],
        "recall@0.5": totals["matched"] / max(totals["num_gt"], 1),
        "mean_matched_iou": totals["iou_sum"] / max(totals["matched"], 1),
        "cls_accuracy": totals["cls_ok"] / max(totals["matched"], 1),
        "precision@0.5": totals["det_matched"] / max(totals["det"], 1),
        "detections": totals["det"],
        "folds": per_fold,
        "epochs": args.epochs,
        "per_image_variants": args.per_image,
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(pooled, f, indent=2)
    print(f"[heldout] pooled: recall@0.5 {pooled['recall@0.5']:.2f}, precision {pooled['precision@0.5']:.2f}, "
          f"cls {pooled['cls_accuracy']:.2f} -> {args.out}")
    return pooled


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train or evaluate the YOLOv8 detector (PyTorch)")
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser("train", help="train YOLOv8 on synthetic boxes")
    s.add_argument("--data", default="data/detect_synth")
    s.add_argument("--out", default="models/yolo_synth")
    s.add_argument("--imgsz", type=int, default=320)
    s.add_argument("--epochs", type=int, default=30)
    s.add_argument("--batch-size", type=int, default=16)
    s.add_argument("--lr", type=float, default=1e-3)
    s.add_argument("--weight-decay", type=float, default=5e-4)
    s.add_argument("--warmup-epochs", type=float, default=3.0)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--init-weights", default=None,
                   help="warm-start: graft every same-shaped leaf from this .npz (the "
                        "class-count-dependent head leaves keep their fresh init when the "
                        "class sets differ)")
    s.add_argument("--tag", default="synth", help="weight filename suffix: yolov8{width}_{tag}.npz")
    s.add_argument("--width", choices=["n", "s"], default="n",
                   help="width plan: -n (synthetic default) or full -s")
    s.add_argument("--log-every", type=int, default=20)
    s.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    s.set_defaults(fn=train)

    s = sub.add_parser("eval", help="evaluate YOLOv8 against GT boxes")
    s.add_argument("--data", default="data/detect_synth")
    s.add_argument("--weights", default="models/yolo_synth/yolov8n_synth.npz")
    s.add_argument("--split", default="val")
    s.add_argument("--limit", type=int, default=None)
    s.add_argument("--out", default=None, help="optional JSON output path")
    s.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    s.set_defaults(fn=evaluate_cmd)

    s = sub.add_parser("heldout", help="leave-photos-out evaluation on the labelled photos "
                                       "(scripts/eval_real_detect_heldout.py)")
    s.add_argument("--labels", default="data/real_labels/real_boxes.json")
    s.add_argument("--reference-root", default=REPO,
                   help="where the labels' photo paths resolve (default: the repository root)")
    s.add_argument("--init-weights", default="models/yolo_synth/yolov8n_synth.npz")
    s.add_argument("--out", default="results/real_detect_eval_heldout.json")
    s.add_argument("--imgsz", type=int, default=320)
    s.add_argument("--per-image", type=int, default=200)
    s.add_argument("--epochs", type=int, default=8)
    s.add_argument("--folds", type=int, default=3)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--batch-size", type=int, default=16, help="train's batch (scripts/train_yolo.py's default)")
    s.add_argument("--workdir", default=None, help="fold corpora dir (tmp)")
    s.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    s.set_defaults(fn=heldout)
    return p


def run(argv=None):
    args = _parser().parse_args(argv)
    return args.fn(args)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
