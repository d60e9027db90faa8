"""Framework-free endpoint cores for the HTTP API (port of
``api/handlers.py``).

The validation and wire semantics live in plain functions over a small
``Upload`` value type, so the stdlib binding (``api/http_server.py``) and the
fastapi binding (``api/main.py``) share them and tests call them directly.
The reference's semantics, kept:
- report: the image content-type check, the ISO-8601 ``found_at`` parse
  (400 otherwise), and the echo of the location-joined text the finder
  stored;
- search: empty description / file read as None, 400 when both are missing;
  the query image saved under ``data/tmp/queries`` and deleted in the
  ``finally`` block while its path is still echoed in the response;
- items: the store's rows, ``found_at`` descending.
"""

from __future__ import annotations

import datetime as dt
import os
import shutil
import tempfile
import uuid
from dataclasses import dataclass
from typing import BinaryIO, Optional

from clip_lora_match_tpu_torch.api.schemas import (
    FoundItemModel,
    ReportItemResponse,
    SearchResponse,
    SearchResultModel,
)
from clip_lora_match_tpu_torch.core.logging import get_logger

log = get_logger("api")


class ApiError(Exception):
    """Transport-agnostic HTTP error; the fastapi binding re-raises it as
    HTTPException with the same status/detail."""

    def __init__(self, status_code: int, detail: str):
        super().__init__(detail)
        self.status_code = status_code
        self.detail = detail


@dataclass
class Upload:
    """Minimal stand-in for fastapi's UploadFile."""

    file: BinaryIO
    filename: Optional[str] = None
    content_type: Optional[str] = None


def _require_image(upload: Upload) -> None:
    if not (upload.content_type or "").startswith("image/"):
        raise ApiError(400, "File yang diupload harus gambar.")


def _sanitized_name(filename: Optional[str], default: str) -> str:
    name = os.path.basename(filename or "") or default
    return name.replace("..", "_") or default


def handle_report(
    finder,
    *,
    description: str,
    image: Upload,
    location: Optional[str] = None,
    reporter: Optional[str] = None,
    found_at: Optional[str] = None,
) -> ReportItemResponse:
    """POST /api/report core (ref:src/api/main.py:102-166)."""
    _require_image(image)
    parsed_at = None
    if found_at:
        try:
            parsed_at = dt.datetime.fromisoformat(found_at)
        except ValueError:
            raise ApiError(400, "found_at harus format ISO 8601.")
    # fresh temp DIR under the upload's own (sanitized) basename — the finder
    # stores items under this name, so the original filename survives like
    # the reference's dest_name = src.name without path-traversal exposure
    name = _sanitized_name(image.filename, "upload.jpg")
    d = tempfile.mkdtemp(prefix="clm_upload_")
    tmp = os.path.join(d, name)
    with open(tmp, "wb") as f:
        shutil.copyfileobj(image.file, f)
    try:
        result = finder.report_item(
            tmp,
            description=description,
            location=location,
            found_at=parsed_at,
            reporter=reporter,
        )
    except Exception:
        log.exception("report failed")
        raise ApiError(500, "Internal report error")
    finally:
        os.unlink(tmp)
        os.rmdir(d)
    return ReportItemResponse(
        id=result.item_id or result.index_row,
        image_path=result.stored_image_path,
        # wire parity: the reference echoes the location-joined full text it
        # stored, not the raw form field (ref:finder_service.py returns
        # db_item.description == full_text)
        description=result.indexed_text,
        location=location,
        found_at=parsed_at,
        reporter=reporter,
    )


def handle_search(
    seeker,
    *,
    description: Optional[str] = None,
    image: Optional[Upload] = None,
    top_k: int = 5,
    data_dir: str = "data",
) -> SearchResponse:
    """POST /api/search core (ref:src/api/main.py:172-250)."""
    # normalize empty form values to None (ref L185-199)
    if description is not None and not description.strip():
        description = None
    if image is not None and not (image.filename or "").strip():
        image = None
    if description is None and image is None:
        raise ApiError(400, "Berikan description, image, atau keduanya.")
    tmp = None
    query_image_path = None
    if image is not None:
        _require_image(image)
        # save to data/tmp/queries like the reference (ref:main.py:210-218)
        # but uuid-prefixed so concurrent same-named uploads cannot overwrite
        # each other; deleted in the finally block exactly like the
        # reference's temp_path.unlink() (ref:main.py:231-234) — the returned
        # query_image_path is a dangling wire-parity echo, not a served file
        queries_dir = os.path.join(data_dir, "tmp", "queries")
        os.makedirs(queries_dir, exist_ok=True)
        name = _sanitized_name(image.filename, "query.jpg")
        tmp = os.path.join(queries_dir, f"{uuid.uuid4().hex[:12]}_{name}")
        with open(tmp, "wb") as f:
            shutil.copyfileobj(image.file, f)
        query_image_path = tmp
    try:
        results = seeker.search_items(
            description=description, image_path=tmp, k=top_k
        )
    except ApiError:
        raise
    except ValueError as e:
        raise ApiError(400, str(e))
    except Exception:
        log.exception("search failed")
        raise ApiError(500, "Internal search error")
    finally:
        if tmp and os.path.exists(tmp):
            os.unlink(tmp)
    return SearchResponse(
        query_text=description,
        query_image_path=query_image_path,
        results=[
            SearchResultModel(
                score=r.score,
                image_path=r.image_path or "",
                text=r.text or "",
            )
            for r in results
        ],
    )


def handle_items(store) -> list[FoundItemModel]:
    """GET /api/items core (ref:src/api/main.py:256-295)."""
    try:
        items = store.all_items(order_desc=True)
    except Exception:
        log.exception("items query failed")
        raise ApiError(500, "Database error")
    return [
        FoundItemModel(
            id=i.id,
            image_path=i.image_path,
            description=i.description,
            location=i.location,
            found_at=i.found_at,
            reporter=i.reporter,
        )
        for i in items
    ]
