"""found_items persistence with pluggable backends (port of ``db/store.py``;
it imports no torch).

The reference uses three parallel DB access paths: a SQLAlchemy ORM
(ref:src/db/models.py:12-29 — table ``found_items``: id PK, image_path TEXT
NOT NULL, description TEXT NOT NULL, location/found_at/reporter nullable),
a raw psycopg2 connector (ref:src/db/db.py:21-30), and .env-driven engine
setup (ref:src/db/database.py:14-22). Here one interface, two backends:

- ``SqliteStore`` (stdlib sqlite3) — default for local runs and tests;
- ``PostgresStore`` (psycopg2, optional dep) — production, same schema as the
  shipped dump (ref:balikkin_db_full.sql:28-35) including the GIN full-text
  index on description (sqlite approximates with FTS-less LIKE search).
"""

from __future__ import annotations

import datetime as dt
import os
import sqlite3
import threading
from dataclasses import dataclass
from typing import Optional

from clip_lora_match_tpu_torch.core.config import DBConfig, load_db_config


@dataclass
class FoundItem:
    """Row mirror of ref:src/db/models.py:12-20."""

    id: Optional[int]
    image_path: str
    description: str
    location: Optional[str] = None
    found_at: Optional[dt.datetime] = None
    reporter: Optional[str] = None


class BaseStore:
    def init_db(self) -> None:
        raise NotImplementedError

    def insert(self, item: FoundItem) -> int:
        raise NotImplementedError

    def all_items(self, order_desc: bool = True) -> list[FoundItem]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class SqliteStore(BaseStore):
    """stdlib sqlite3 backend (thread-safe via a single lock)."""

    def __init__(self, path: str = ":memory:"):
        if path != ":memory:":
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        self.init_db()

    def init_db(self) -> None:
        with self._lock:
            self._conn.execute(
                """CREATE TABLE IF NOT EXISTS found_items (
                    id INTEGER PRIMARY KEY AUTOINCREMENT,
                    image_path TEXT NOT NULL,
                    description TEXT NOT NULL,
                    location TEXT,
                    found_at TIMESTAMP,
                    reporter TEXT
                )"""
            )
            self._conn.commit()

    def insert(self, item: FoundItem) -> int:
        with self._lock:
            try:
                cur = self._conn.execute(
                    "INSERT INTO found_items (image_path, description, location,"
                    " found_at, reporter) VALUES (?, ?, ?, ?, ?)",
                    (
                        item.image_path,
                        item.description,
                        item.location,
                        item.found_at.isoformat() if item.found_at else None,
                        item.reporter,
                    ),
                )
                self._conn.commit()
                return int(cur.lastrowid)
            except Exception:
                self._conn.rollback()  # rollback parity: ref:finder_service.py:200-202
                raise

    def all_items(self, order_desc: bool = True) -> list[FoundItem]:
        """ORDER BY found_at DESC like ref:src/api/main.py:256-295."""
        order = "DESC" if order_desc else "ASC"
        with self._lock:
            rows = self._conn.execute(
                "SELECT id, image_path, description, location, found_at, reporter"
                f" FROM found_items ORDER BY found_at {order}, id {order}"
            ).fetchall()
        out = []
        for r in rows:
            found_at = dt.datetime.fromisoformat(r[4]) if r[4] else None
            out.append(FoundItem(r[0], r[1], r[2], r[3], found_at, r[5]))
        return out

    def close(self) -> None:
        self._conn.close()


class PostgresStore(BaseStore):
    """psycopg2 backend against the reference schema."""

    def __init__(self, cfg: Optional[DBConfig] = None, dsn: Optional[str] = None):
        import psycopg2  # optional dependency

        self._psycopg2 = psycopg2
        cfg = cfg or DBConfig()
        self._conn = (
            psycopg2.connect(dsn)
            if dsn
            else psycopg2.connect(
                host=cfg.host, port=cfg.port, user=cfg.user,
                password=cfg.password, dbname=cfg.dbname,
            )
        )
        self.init_db()

    def init_db(self) -> None:
        with self._conn.cursor() as cur:
            cur.execute(
                """CREATE TABLE IF NOT EXISTS found_items (
                    id SERIAL PRIMARY KEY,
                    image_path TEXT NOT NULL,
                    description TEXT NOT NULL,
                    location TEXT,
                    found_at TIMESTAMP,
                    reporter TEXT
                )"""
            )
            # GIN full-text index parity with balikkin_db_full.sql
            cur.execute(
                "CREATE INDEX IF NOT EXISTS idx_found_items_description_gin "
                "ON found_items USING gin (to_tsvector('simple', description))"
            )
        self._conn.commit()

    def insert(self, item: FoundItem) -> int:
        try:
            with self._conn.cursor() as cur:
                cur.execute(
                    "INSERT INTO found_items (image_path, description, location,"
                    " found_at, reporter) VALUES (%s, %s, %s, %s, %s) RETURNING id",
                    (
                        item.image_path, item.description, item.location,
                        item.found_at, item.reporter,
                    ),
                )
                new_id = cur.fetchone()[0]
            self._conn.commit()
            return int(new_id)
        except Exception:
            self._conn.rollback()
            raise

    def all_items(self, order_desc: bool = True) -> list[FoundItem]:
        order = "DESC" if order_desc else "ASC"
        with self._conn.cursor() as cur:
            cur.execute(
                "SELECT id, image_path, description, location, found_at, reporter"
                f" FROM found_items ORDER BY found_at {order}, id {order}"
            )
            rows = cur.fetchall()
        return [FoundItem(*r) for r in rows]

    def close(self) -> None:
        self._conn.close()


def open_store(
    url_or_path: Optional[str] = None, db_config_path: Optional[str] = None
) -> BaseStore:
    """Resolve a store: postgres:// URL → PostgresStore; path/None → sqlite.

    Honors DATABASE_URL from the environment like ref:src/db/database.py:12-16
    (but degrades to sqlite instead of hard-crashing when unset).
    """
    url = url_or_path or os.environ.get("DATABASE_URL")
    if url:
        scheme = url.split("://", 1)[0].lower() if "://" in url else ""
        # SQLAlchemy dialect URLs count too: postgresql+psycopg2://... etc.
        if scheme.split("+", 1)[0] in ("postgres", "postgresql"):
            return PostgresStore(dsn=url)
        if scheme == "sqlite":
            # sqlite:///relative.db or sqlite:////abs/path.db → file path
            # (treating the URL as a literal path would mkdir "sqlite:")
            path = url.split("://", 1)[1].lstrip("/")
            if url.startswith("sqlite:////"):
                path = "/" + path
            return SqliteStore(path or ":memory:")
        if scheme:
            raise ValueError(f"unsupported DATABASE_URL scheme: {url!r}")
    if db_config_path and os.path.exists(db_config_path):
        return PostgresStore(load_db_config(db_config_path))
    return SqliteStore(url or ":memory:")
