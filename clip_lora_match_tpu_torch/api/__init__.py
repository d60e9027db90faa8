"""The HTTP API (port of ``api/``): the service graph (``wiring``), the
wire schemas, the framework-free endpoint cores (``handlers``), the stdlib
binding (``http_server``), the fastapi binding (``main``, needs fastapi) and
the serve entry point (``python -m clip_lora_match_tpu_torch.api.serve``)."""

from clip_lora_match_tpu_torch.api.wiring import ServiceGraph, build_services

__all__ = ["ServiceGraph", "build_services"]
