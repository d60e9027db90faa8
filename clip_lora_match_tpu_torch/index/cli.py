"""The index-building entry points of the port, one subcommand per script of
the JAX package (``scripts/build_custom_index.py``, ``build_text_index.py``,
``rebuild_index.py``):

    python -m clip_lora_match_tpu_torch.index.cli build-custom   # data/custom/my_items.csv
    python -m clip_lora_match_tpu_torch.index.cli build-text --csv data/text/train_fashion.csv
    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        -m clip_lora_match_tpu_torch.index.cli build-text --dist-backend nccl ...
    python -m clip_lora_match_tpu_torch.index.cli rebuild --db found_items.sqlite

Each takes its script's flags and defaults (the encoder's from
``scripts/_common.py``) plus ``--device`` (``cuda`` by default, ``cpu`` for
the plain path), writes the index in the JAX package's format (``.npz`` and
its ``.json`` sidecar) and prints the script's lines. ``build-text`` under
``torchrun``'s environment (``--dist-backend``: nccl, a card a rank, or
gloo, ranks that may share a card) encodes over the ranks
(``parallel.sharded_text_encode_fn``), as the script shards over the devices
it sees; only rank 0 saves and verifies. ``run(argv)`` returns the index.
"""

from __future__ import annotations

import argparse

from clip_lora_match_tpu_torch.eval.cli import _encoder_args, build_encoder


def _build_custom(args):
    from clip_lora_match_tpu_torch.index import build_index_from_csv, verify_index

    index = build_index_from_csv(args.csv, build_encoder(args), custom_format=True)
    index.save(args.out)
    ok = verify_index(index)
    print(f"[build_custom_index] {len(index)} items -> {args.out} (verify={'ok' if ok else 'FAILED'})")
    for t in index.texts:
        print("  -", t)
    return index


def _build_text(args):
    import torch.distributed as dist

    from clip_lora_match_tpu_torch.index import build_index_from_csv, verify_index
    from clip_lora_match_tpu_torch.parallel import (
        initialize_distributed,
        make_mesh,
        process_count,
        sharded_text_encode_fn,
    )

    owned = not dist.is_initialized()  # a group this call starts, this call ends
    initialize_distributed(backend=args.dist_backend, device=args.device)
    try:
        encode_fn, primary = None, True
        if process_count() > 1:  # shard the build over the ranks
            mesh = make_mesh(device=args.device)
            args.device = str(mesh.device)
            primary = mesh.rank == 0
            encoder = build_encoder(args)
            encode_fn = sharded_text_encode_fn(encoder, mesh)
            if primary:
                print(f"[build_text_index] sharding over {mesh.n_data} ranks ({mesh.backend})", flush=True)
        else:
            encoder = build_encoder(args)
        index = build_index_from_csv(
            args.csv, encoder, custom_format=False, batch_size=args.batch_size, encode_fn=encode_fn,
        )
        if primary:
            index.save(args.out)
            ok = verify_index(index)
            print(f"[build_text_index] {len(index)} rows -> {args.out} (verify={'ok' if ok else 'FAILED'})")
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()
    return index


def _rebuild(args):
    from clip_lora_match_tpu_torch.db.store import open_store
    from clip_lora_match_tpu_torch.index import build_text_index, verify_index

    encoder = build_encoder(args)
    store = open_store(args.db, args.db_config)
    items = store.all_items(order_desc=False)  # ordered by id (ref:scripts/rebuild_index.py:49)
    texts = [
        f"{i.description}, ditemukan di {i.location}" if i.location else i.description
        for i in items
    ]
    index = build_text_index(texts, [i.image_path for i in items], encoder)
    index.save(args.out)
    ok = verify_index(index)
    print(
        f"[rebuild_index] {len(items)} DB rows -> {len(index)} index rows -> "
        f"{args.out} (verify={'ok' if ok else 'FAILED'})"
    )
    return index


def run(argv=None):
    p = argparse.ArgumentParser(description="Build the embedding indexes (PyTorch)")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("build-custom", help="the custom items index (scripts/build_custom_index.py)")
    s.add_argument("--csv", default="data/custom/my_items.csv")
    s.add_argument("--out", default="data/index/custom_items_index.npz")
    _encoder_args(s)
    s.set_defaults(fn=_build_custom)

    s = sub.add_parser("build-text", help="a text index from a pairs CSV (scripts/build_text_index.py)")
    s.add_argument("--csv", default="data/text/train_fashion.csv")
    s.add_argument("--out", default="data/index/fashion_text_index.npz")
    s.add_argument("--batch-size", type=int, default=256)
    s.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                   help="the process group's backend under torchrun (default: nccl on cuda, gloo on cpu)")
    _encoder_args(s)
    s.set_defaults(fn=_build_text)

    s = sub.add_parser("rebuild", help="the index from the found-items DB (scripts/rebuild_index.py)")
    s.add_argument("--db", default=None, help="DATABASE_URL / sqlite path")
    s.add_argument("--db-config", default="config/db_config.yaml")
    s.add_argument("--out", default="data/index/custom_items_index.npz")
    _encoder_args(s)
    s.set_defaults(fn=_rebuild)

    args = p.parse_args(argv)
    return args.fn(args)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
