"""IndexShard — the per-shard orchestration object.

Copy of the reference's ``index/shard.py`` without the engine-plugin
factory and primary promotion: routes operations to the engine with
primary-term/seqno bookkeeping, tracks the replication group on primaries
(ReplicationTracker), exposes refresh, flush and stats.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from elasticsearch_tpu_torch.common.errors import IllegalArgumentException
from elasticsearch_tpu_torch.index.engine import (DeleteResult, EngineConfig,
                                                  IndexResult, InternalEngine)
from elasticsearch_tpu_torch.index.reader import ShardReader
from elasticsearch_tpu_torch.index.seqno import ReplicationTracker
from elasticsearch_tpu_torch.mapping import MapperService


@dataclasses.dataclass
class ShardId:
    index_name: str
    shard: int

    def __str__(self) -> str:
        return f"[{self.index_name}][{self.shard}]"

    def __hash__(self):
        return hash((self.index_name, self.shard))


class IndexShard:
    def __init__(self, shard_id: ShardId, path: str, mapper: MapperService,
                 *, primary: bool, allocation_id: str, primary_term: int = 1,
                 k1: float = 1.2, b: float = 0.75,
                 durability: str = "request"):
        self.shard_id = shard_id
        self.allocation_id = allocation_id
        self.primary = primary
        self.primary_term = primary_term
        config = EngineConfig(
            path=path, mapper=mapper, primary_term=primary_term,
            durability=durability, k1=k1, b=b)
        self.engine = InternalEngine(config)
        self.tracker: Optional[ReplicationTracker] = (
            ReplicationTracker(allocation_id) if primary else None)
        if self.tracker is not None:
            self.tracker.update_local_checkpoint(
                allocation_id, self.engine.tracker.processed_checkpoint)

    # ---------------- write ops ----------------

    def apply_index_on_primary(self, doc_id: str, source: dict,
                               **version_kwargs) -> IndexResult:
        self._ensure_primary()
        result = self.engine.index(doc_id, source, **version_kwargs)
        self._update_own_checkpoint()
        return result

    def apply_bulk_index_on_primary(self, docs) -> List[Any]:
        """Batched primary upsert: [(doc_id, source), ...] → per-op
        IndexResult | Exception (reference: TransportShardBulkAction's
        one-unit shard bulk)."""
        self._ensure_primary()
        results = self.engine.bulk_index(docs)
        self._update_own_checkpoint()
        return results

    def apply_delete_on_primary(self, doc_id: str, **version_kwargs) -> DeleteResult:
        self._ensure_primary()
        result = self.engine.delete(doc_id, **version_kwargs)
        self._update_own_checkpoint()
        return result

    def _ensure_primary(self) -> None:
        if not self.primary:
            raise IllegalArgumentException(
                f"{self.shard_id} is not a primary")

    def _update_own_checkpoint(self) -> None:
        if self.tracker is not None:
            self.tracker.update_local_checkpoint(
                self.allocation_id, self.engine.tracker.processed_checkpoint)

    # ---------------- reads ----------------

    def get(self, doc_id: str) -> Optional[Dict[str, Any]]:
        return self.engine.get(doc_id)

    def acquire_searcher(self) -> ShardReader:
        return self.engine.acquire_reader()

    # ---------------- maintenance ----------------

    def refresh(self) -> bool:
        return self.engine.refresh()

    def flush(self) -> None:
        self.engine.flush()

    def close(self) -> None:
        self.engine.close()

    # ---------------- checkpoints ----------------

    @property
    def local_checkpoint(self) -> int:
        return self.engine.tracker.processed_checkpoint

    @property
    def global_checkpoint(self) -> int:
        return self.tracker.global_checkpoint if self.tracker else -1

    def stats(self) -> Dict[str, Any]:
        s = self.engine.stats()
        s.update({"shard": self.shard_id.shard,
                  "primary": self.primary,
                  "allocation_id": self.allocation_id,
                  "global_checkpoint": self.global_checkpoint})
        return s
