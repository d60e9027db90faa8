"""FastAPI application (port of ``api/main.py``).

The reference's REST surface (GET /health, POST /api/report multipart, POST
/api/search, GET /api/items, the /static mount, CORS *) with its validation
and response schemas. The endpoint logic is ``api/handlers.py``; this module
only binds it to FastAPI (``UploadFile`` → ``Upload``, ``ApiError`` →
``HTTPException``), over one service graph from ``api/wiring.py``.

fastapi is optional: this module imports without it, and ``create_app``
raises ImportError with a clear message when it is missing.
"""

from __future__ import annotations

import os
from typing import Optional

from clip_lora_match_tpu_torch.api.handlers import (
    ApiError,
    Upload,
    handle_items,
    handle_report,
    handle_search,
)
from clip_lora_match_tpu_torch.api.schemas import (
    FoundItemModel,
    ReportItemResponse,
    SearchResponse,
)
from clip_lora_match_tpu_torch.api.wiring import build_services
from clip_lora_match_tpu_torch.core.logging import get_logger
from clip_lora_match_tpu_torch.db.store import BaseStore
from clip_lora_match_tpu_torch.models.encoder import ClipEncoder
from clip_lora_match_tpu_torch.services import FinderService, SeekerService

log = get_logger("api")


def create_app(
    encoder: Optional[ClipEncoder] = None,
    finder: Optional[FinderService] = None,
    seeker: Optional[SeekerService] = None,
    store: Optional[BaseStore] = None,
    data_dir: str = "data",
    index_path: Optional[str] = None,
    use_batch_queue: bool = True,
    index_quantize: str = "none",
):
    try:
        from fastapi import FastAPI, File, Form, HTTPException, UploadFile
        from fastapi.middleware.cors import CORSMiddleware
        from fastapi.staticfiles import StaticFiles
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "fastapi is required for the fastapi binding; the stdlib binding "
            "(api/http_server.py) serves the same API without it"
        ) from e

    graph = build_services(
        encoder=encoder,
        finder=finder,
        seeker=seeker,
        store=store,
        data_dir=data_dir,
        index_path=index_path,
        use_batch_queue=use_batch_queue,
        index_quantize=index_quantize,
    )
    finder, seeker, store = graph.finder, graph.seeker, graph.store

    app = FastAPI(title="Balikkin ML Service (CUDA)", version="0.1.0")
    app.add_middleware(
        CORSMiddleware,
        allow_origins=["*"],
        allow_credentials=True,
        allow_methods=["*"],
        allow_headers=["*"],
    )
    if os.path.isdir(data_dir):
        app.mount("/static", StaticFiles(directory=data_dir), name="static")

    def _upload(u: UploadFile) -> Upload:
        return Upload(file=u.file, filename=u.filename, content_type=u.content_type)

    @app.get("/health")
    def health_check():
        return {"status": "ok"}

    # endpoints are plain ``def`` on purpose: FastAPI runs them in its
    # threadpool, so a long encode cannot freeze the event loop (an
    # ``async def`` here would serialize every request behind the device call)
    @app.post("/api/report", response_model=ReportItemResponse)
    def report_item(
        description: str = Form(...),
        location: Optional[str] = Form(None),
        reporter: Optional[str] = Form(None),
        found_at: Optional[str] = Form(None),
        image: UploadFile = File(...),
    ):
        try:
            return handle_report(
                finder,
                description=description,
                image=_upload(image),
                location=location,
                reporter=reporter,
                found_at=found_at,
            )
        except ApiError as e:
            raise HTTPException(status_code=e.status_code, detail=e.detail)

    @app.post("/api/search", response_model=SearchResponse)
    def search_items(
        description: Optional[str] = Form(None),
        image: Optional[UploadFile] = File(None),
        top_k: int = Form(5),
    ):
        try:
            return handle_search(
                seeker,
                description=description,
                image=_upload(image) if image is not None else None,
                top_k=top_k,
                data_dir=data_dir,
            )
        except ApiError as e:
            raise HTTPException(status_code=e.status_code, detail=e.detail)

    @app.get("/api/items", response_model=list[FoundItemModel])
    def list_found_items():
        try:
            return handle_items(store)
        except ApiError as e:
            raise HTTPException(status_code=e.status_code, detail=e.detail)

    return app
