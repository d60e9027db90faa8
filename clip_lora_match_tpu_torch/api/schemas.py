"""Wire-compatible response models (port of ``api/schemas.py``).

Field names, optionality and nesting are the reference's, so
``model_dump(mode="json")`` gives the same JSON as the JAX package's models,
ISO datetime strings included, and existing clients work unchanged.
"""

from __future__ import annotations

from datetime import datetime
from typing import List, Optional

from pydantic import BaseModel


class ReportItemResponse(BaseModel):
    id: int
    image_path: str
    description: str
    location: Optional[str] = None
    found_at: Optional[datetime] = None
    reporter: Optional[str] = None


class SearchResultModel(BaseModel):
    score: float
    image_path: str
    text: str


class SearchResponse(BaseModel):
    query_text: Optional[str] = None
    query_image_path: Optional[str] = None
    results: List[SearchResultModel]


class FoundItemModel(BaseModel):
    id: int
    image_path: str
    description: str
    location: Optional[str] = None
    found_at: Optional[datetime] = None
    reporter: Optional[str] = None
