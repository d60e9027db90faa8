from clip_lora_match_tpu_torch.db.store import (
    BaseStore,
    FoundItem,
    PostgresStore,
    SqliteStore,
    open_store,
)

__all__ = ["BaseStore", "FoundItem", "PostgresStore", "SqliteStore", "open_store"]
