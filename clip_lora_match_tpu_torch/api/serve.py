"""Serve the HTTP API on the card (the port's counterpart of scripts/serve.py).

    python -m clip_lora_match_tpu_torch.api.serve --port 8000
    python -m clip_lora_match_tpu_torch.api.serve --device cpu --port 0
    python -m clip_lora_match_tpu_torch.api.serve --lora <adapter dir> --clip-config <yaml>

``--lora`` takes a native adapter dir or a PEFT one; a ``--clip-config``
whose ``model.quantize`` is ``int8`` serves the towers W8A8
(``quant/int8.py``).

FastAPI + uvicorn when both import (``--binding fastapi``); otherwise the
stdlib binding (``api/http_server.py``) serves the same REST surface. The
encoder runs on ``--device`` (default ``cuda``; without CUDA this raises
unless ``--device cpu`` is given).
"""

from __future__ import annotations

import argparse
import os


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Serve the Balikkin API (PyTorch port)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--data-dir", default="data")
    p.add_argument("--db", default=None)
    p.add_argument(
        "--index-quantize", choices=["none", "int8"], default="none",
        help="serve searches from an int8-quantized index (selection exact over quantized scores)",
    )
    p.add_argument(
        "--binding", choices=["auto", "fastapi", "stdlib"], default="auto",
        help="HTTP stack: fastapi+uvicorn, the stdlib http.server binding, or auto "
        "(fastapi when fastapi and uvicorn import, stdlib otherwise)",
    )
    p.add_argument("--clip-config", default="config/clip_config.yaml",
                   help="CLIP config YAML (model.quantize: int8 serves W8A8)")
    p.add_argument("--weights", default=None, help="base CLIP weights (.npz)")
    p.add_argument("--lora", default=None,
                   help="LoRA adapter dir: native (lora_weights.npz + lora_config.json) or "
                   "PEFT (adapter_model.safetensors + adapter_config.json)")
    p.add_argument("--seed", type=int, default=0, help="random-init seed when no --weights given")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    binding = args.binding
    if binding == "auto":
        try:
            import fastapi  # noqa: F401
            import uvicorn  # noqa: F401

            binding = "fastapi"
        except ImportError:
            binding = "stdlib"

    from clip_lora_match_tpu_torch.db.store import open_store
    from clip_lora_match_tpu_torch.models.encoder import ClipEncoder

    encoder = ClipEncoder.from_config(
        config_path=args.clip_config if os.path.exists(args.clip_config) else None,
        weights_path=args.weights, lora_path=args.lora, seed=args.seed, device=args.device,
    )
    store = open_store(args.db)
    if binding == "fastapi":
        import uvicorn

        from clip_lora_match_tpu_torch.api.main import create_app

        app = create_app(encoder=encoder, store=store, data_dir=args.data_dir,
                         index_quantize=args.index_quantize)
        uvicorn.run(app, host=args.host, port=args.port)
        return

    from clip_lora_match_tpu_torch.api.http_server import create_server

    server = create_server(args.host, args.port, encoder=encoder, store=store,
                           data_dir=args.data_dir, index_quantize=args.index_quantize)
    # wrappers read this line through a pipe: flush it
    print(f"[serve] stdlib binding listening on "
          f"http://{server.server_address[0]}:{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
