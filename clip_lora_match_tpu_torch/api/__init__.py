"""Service wiring shared by the HTTP bindings (port of ``api/``). The
bindings themselves (handlers, schemas, http_server, main) are not ported
yet."""

from clip_lora_match_tpu_torch.api.wiring import ServiceGraph, build_services

__all__ = ["ServiceGraph", "build_services"]
