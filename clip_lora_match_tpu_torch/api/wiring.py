"""Service-graph construction shared by every HTTP binding (port of
``api/wiring.py``).

One factory wires encoder → finder / seeker / store: one encoder shared by
both services (behind a ``QueuedEncoder``, so concurrent requests coalesce
into one tower pass), one device-resident index that the seeker reads from
the finder, and the store.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

from clip_lora_match_tpu_torch.db.store import BaseStore, open_store
from clip_lora_match_tpu_torch.models.encoder import ClipEncoder, load_clip_model
from clip_lora_match_tpu_torch.services import (
    FinderConfig,
    FinderService,
    QueuedEncoder,
    SeekerConfig,
    SeekerService,
)


@dataclass
class ServiceGraph:
    finder: FinderService
    seeker: SeekerService
    store: BaseStore
    data_dir: str


def build_services(
    encoder: Optional[ClipEncoder] = None,
    finder: Optional[FinderService] = None,
    seeker: Optional[SeekerService] = None,
    store: Optional[BaseStore] = None,
    data_dir: str = "data",
    index_path: Optional[str] = None,
    use_batch_queue: bool = True,
    index_quantize: str = "none",
) -> ServiceGraph:
    """One shared encoder and one device-resident index behind the finder and
    the seeker. Without an ``encoder`` the default config's model is loaded
    on the card (``load_clip_model()``)."""
    encoder = encoder or load_clip_model()
    if use_batch_queue and finder is None and seeker is None:
        # HTTP handlers run on threads, so requests can overlap
        encoder = QueuedEncoder(encoder)
    store = store or open_store()
    index_path = index_path or os.path.join(data_dir, "index", "items_index.npz")
    if finder is None:
        finder = FinderService(
            encoder,
            FinderConfig(
                index_path=index_path,
                reported_images_dir=os.path.join(data_dir, "reported", "images"),
                k_dim=encoder.arch.projection_dim,
            ),
            store=store,
        )
    if seeker is None:
        seeker = SeekerService(
            encoder,
            SeekerConfig(index_path=index_path, index_quantize=index_quantize),
            index=finder.index,
        )
    return ServiceGraph(finder=finder, seeker=seeker, store=store, data_dir=data_dir)
