"""IndicesService / IndexService — the node's registry of open indices.

Copy of the reference's ``indices/service.py`` (IndexService: settings,
mapper and local shards of one index; IndicesService: the registry, its
gateway metadata under ``<data_path>/_state/indices.json`` so a restart
reopens its indices in their open or closed state, aliases, the
close/open lifecycle and the per-shard search-failure counters).
Routing a document to a shard is the port's ``indices/routing.shard_for``,
the reference's murmur3. The dynamic index settings are the reference's,
the slow log's ``index.search.slowlog.threshold.*`` included (a
``SlowLog`` per index, rebuilt on update), but for one whose module is
not ported: ``index.default_pipeline`` (ingest) is refused with a 400
that says so.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import uuid
from typing import Any, Dict, Optional

from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentException,
    IndexAlreadyExistsException,
    IndexBlockException,
    IndexClosedException,
    IndexNotFoundException,
    ResourceNotFoundException,
    ShardNotFoundException,
)
from elasticsearch_tpu_torch.common.logging import SlowLog
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.common.units import parse_seconds
from elasticsearch_tpu_torch.index.shard import IndexShard, ShardId
from elasticsearch_tpu_torch.index.translog import write_atomic
from elasticsearch_tpu_torch.indices.routing import shard_for
from elasticsearch_tpu_torch.mapping import MapperService


def select_write_index(targets: Dict[str, Dict[str, Any]],
                       alias: str) -> str:
    """The index a write through this alias lands on: the single
    is_write_index target, or the sole target of a single-index alias."""
    writers = [i for i, p in targets.items()
               if (p or {}).get("is_write_index")]
    if len(writers) == 1:
        return writers[0]
    if len(targets) == 1 and not writers:
        return next(iter(targets))
    raise IllegalArgumentException(
        f"no write index is defined for alias [{alias}]: an alias "
        f"over multiple indices needs exactly one is_write_index")


def parse_alias_action(action: Dict[str, Any]) -> tuple:
    """Validate one _aliases action → (kind, index_expr, alias, props)."""
    if not isinstance(action, dict) or len(action) != 1:
        raise IllegalArgumentException(
            "[aliases] each action is one {add|remove: {...}} object")
    kind, spec = next(iter(action.items()))
    if kind not in ("add", "remove"):
        raise IllegalArgumentException(
            f"[aliases] unknown action [{kind}]")
    idx_expr = spec.get("index")
    alias = spec.get("alias")
    if not idx_expr or not alias:
        raise IllegalArgumentException(
            f"[aliases] {kind} requires [index] and [alias]")
    props: Dict[str, Any] = {}
    if kind == "add":
        _validate_index_name(alias)
        if spec.get("filter") is not None:
            from elasticsearch_tpu_torch.search import dsl
            dsl.parse_query(spec["filter"])  # validate at request time
            props["filter"] = spec["filter"]
        if spec.get("is_write_index"):
            props["is_write_index"] = True
    return kind, idx_expr, alias, props


class IndexService:
    """One open index on this node: settings, mapper, local shards."""

    def __init__(self, name: str, index_uuid: str, settings: Settings,
                 mapping: Optional[dict], data_path: str):
        self.name = name
        self.index_uuid = index_uuid
        self.settings = Settings(settings.get_as_dict())
        self.num_shards = settings.get_int("index.number_of_shards", 1)
        self.num_replicas = settings.get_int("index.number_of_replicas", 0)
        self.mapper = MapperService(mapping, settings)
        self.data_path = data_path
        self.shards: Dict[int, IndexShard] = {}
        self.closed = False
        self._k1 = settings.get_float("index.similarity.default.k1", 1.2)
        self._b = settings.get_float("index.similarity.default.b", 0.75)
        self._durability = settings.get("index.translog.durability", "request")
        if self._durability not in ("request", "async"):
            raise IllegalArgumentException(
                f"[index.translog.durability] must be [request] or "
                f"[async], got [{self._durability}]")
        # async-durability fsync cadence; <= 0 means the node default
        self.sync_interval_s = settings.get_float(
            "index.translog.sync_interval_seconds", -1.0)
        self.search_slowlog = SlowLog(name, settings)

    def create_shard(self, shard_num: int, *, primary: bool = True,
                     allocation_id: Optional[str] = None) -> IndexShard:
        if shard_num in self.shards:
            return self.shards[shard_num]
        shard = IndexShard(
            ShardId(self.name, shard_num),
            os.path.join(self.data_path, str(shard_num)),
            self.mapper, primary=primary,
            allocation_id=allocation_id or str(uuid.uuid4()),
            k1=self._k1, b=self._b, durability=self._durability)
        self.shards[shard_num] = shard
        return shard

    def shard(self, shard_num: int) -> IndexShard:
        if self.closed:
            raise IndexClosedException(f"closed index [{self.name}]")
        s = self.shards.get(shard_num)
        if s is None:
            raise ShardNotFoundException(
                f"shard [{self.name}][{shard_num}] not found on this node")
        return s

    def check_write_block(self) -> None:
        """Reject writes when index.blocks.write or index.blocks.read_only
        is set."""
        if self.settings.get_bool("index.blocks.write", False):
            raise IndexBlockException(
                f"index [{self.name}] blocked by: "
                f"[FORBIDDEN/8/index write (api)]")
        if self.settings.get_bool("index.blocks.read_only", False):
            raise IndexBlockException(
                f"index [{self.name}] blocked by: "
                f"[FORBIDDEN/5/index read-only (api)]")

    def shard_for_id(self, doc_id: str, routing: Optional[str] = None) -> int:
        return shard_for(routing or doc_id, self.num_shards)

    # -------- dynamic settings --------

    DYNAMIC_PREFIXES = ("index.search.slowlog.threshold.",)
    DYNAMIC_KEYS = ("index.number_of_replicas", "index.blocks.write",
                    "index.blocks.read_only", "index.translog.durability",
                    "index.translog.sync_interval_seconds")
    #: dynamic in the reference, refused here: its module (ingest) is not
    #: ported
    UNPORTED_DYNAMIC = (("index.default_pipeline", "ingest pipelines are"),)

    @classmethod
    def validate_dynamic_settings(cls, changes: Dict[str, Any]) -> None:
        for key, value in changes.items():
            for prefix, what in cls.UNPORTED_DYNAMIC:
                if key.startswith(prefix):
                    raise IllegalArgumentException(
                        f"setting [{key}]: {what} not ported yet")
            if any(key.startswith(p) for p in cls.DYNAMIC_PREFIXES):
                if value is not None:
                    parse_seconds(value)  # a malformed duration is a 400
                continue
            if key not in cls.DYNAMIC_KEYS:
                raise IllegalArgumentException(
                    f"setting [{key}] is not dynamically updateable" if
                    key.startswith("index.") else
                    f"unknown index setting [{key}]")
            if key == "index.number_of_replicas" and value is not None:
                try:
                    if int(value) < 0:
                        raise ValueError
                except (TypeError, ValueError):
                    raise IllegalArgumentException(
                        f"[index.number_of_replicas] must be a "
                        f"non-negative integer, got [{value}]") from None
            if (key == "index.translog.durability"
                    and value not in ("request", "async")):
                raise IllegalArgumentException(
                    f"[index.translog.durability] must be [request] or "
                    f"[async], got [{value}]")

    def apply_dynamic_settings(self, changes: Dict[str, Any]) -> None:
        """Apply validated dynamic changes to this open index."""
        self.settings.update_dynamic(changes)
        self.num_replicas = self.settings.get_int(
            "index.number_of_replicas", self.num_replicas)
        if "index.translog.durability" in changes:
            self._durability = self.settings.get(
                "index.translog.durability", self._durability)
            for s in self.shards.values():
                s.engine.config.durability = self._durability
                s.engine.translog.durability = self._durability
        self.sync_interval_s = self.settings.get_float(
            "index.translog.sync_interval_seconds", self.sync_interval_s)
        self.search_slowlog = SlowLog(self.name, self.settings)

    def refresh(self) -> None:
        for s in self.shards.values():
            s.refresh()

    def replay_visibility(self, reason: str = "recovery") -> Dict[str, int]:
        """Replay every local shard's translog tail above its refresh
        checkpoint, so that every acked write is searchable."""
        total = {"scanned": 0, "applied": 0}
        for s in self.shards.values():
            r = s.replay_visibility(reason=reason)
            total["scanned"] += r["scanned"]
            total["applied"] += r["applied"]
        return total

    def flush(self) -> None:
        for s in self.shards.values():
            s.flush()

    def close(self) -> None:
        from elasticsearch_tpu_torch.search.aggregations import device
        for s in self.shards.values():
            # the aggregations' device columns of the shard's segments
            reader = s.engine._reader
            for view in reader.views if reader is not None else ():
                device.release(view.segment)
            s.close()

    def stats(self) -> Dict[str, Any]:
        docs = sum(s.engine.num_docs() for s in self.shards.values())
        return {"uuid": self.index_uuid, "shards": len(self.shards),
                "docs": {"count": docs},
                "per_shard": [s.stats() for s in self.shards.values()]}


class IndicesService:
    """Registry of open indices on this node. Index metadata (name →
    uuid/settings/mapping) and aliases persist in
    ``<data_path>/_state/indices.json`` and reload at startup."""

    def __init__(self, data_path: str):
        self.data_path = data_path
        self._lock = threading.Lock()
        self.indices: Dict[str, IndexService] = {}
        # alias → index → props ({"filter": query-json,
        # "is_write_index": bool})
        self.aliases: Dict[str, Dict[str, Dict[str, Any]]] = {}
        # (index, shard) → search failures the coordinator's query and
        # fetch phases captured
        self._search_failures: Dict[tuple, int] = {}
        self._failures_lock = threading.Lock()
        self._load_metadata()

    # -------- per-shard search failure accounting --------

    def count_search_failure(self, index: str, shard: int) -> None:
        key = (index, int(shard))
        with self._failures_lock:
            self._search_failures[key] = \
                self._search_failures.get(key, 0) + 1

    def search_failure_stats(self) -> Dict[str, Dict[str, int]]:
        """{index: {shard: failures}}."""
        with self._failures_lock:
            snap = list(self._search_failures.items())
        out: Dict[str, Dict[str, int]] = {}
        for (index, shard), count in snap:
            out.setdefault(index, {})[str(shard)] = count
        return out

    def _state_path(self) -> str:
        return os.path.join(self.data_path, "_state", "indices.json")

    def _persist_metadata_locked(self) -> None:
        meta = {
            "indices": {name: {"uuid": svc.index_uuid,
                               "settings": svc.settings.get_as_dict(),
                               "mapping": svc.mapper.to_mapping(),
                               "state": ("close" if svc.closed
                                         else "open")}
                        for name, svc in self.indices.items()},
            "aliases": self.aliases,
        }
        os.makedirs(os.path.dirname(self._state_path()), exist_ok=True)
        write_atomic(self._state_path(),
                     json.dumps(meta, sort_keys=True).encode("utf-8"))

    def persist_metadata(self) -> None:
        with self._lock:
            self._persist_metadata_locked()

    def _load_metadata(self) -> None:
        p = self._state_path()
        if not os.path.exists(p):
            return
        with open(p, "rb") as f:
            meta = json.loads(f.read().decode("utf-8"))
        self.aliases = meta.get("aliases") or {}
        for name, m in meta["indices"].items():
            svc = IndexService(name, m["uuid"], Settings.of(m["settings"]),
                               m.get("mapping"),
                               os.path.join(self.data_path, m["uuid"]))
            if m.get("state") == "close":
                svc.closed = True  # data stays on disk, shards stay shut
            else:
                for i in range(svc.num_shards):
                    svc.create_shard(i, primary=True)  # recovers from store
            self.indices[name] = svc

    def create_index(self, name: str, settings: Optional[Settings] = None,
                     mapping: Optional[dict] = None,
                     index_uuid: Optional[str] = None) -> IndexService:
        with self._lock:
            if name in self.indices:
                raise IndexAlreadyExistsException(f"index [{name}] already exists")
            _validate_index_name(name)
            settings = settings or Settings.EMPTY
            if settings.get("index.creation_date") is None:
                import time as _time
                d = settings.get_as_dict()
                d["index.creation_date"] = int(_time.time() * 1000)
                settings = Settings(d)
            index_uuid = index_uuid or str(uuid.uuid4())
            svc = IndexService(name, index_uuid, settings, mapping,
                               os.path.join(self.data_path, index_uuid))
            for i in range(svc.num_shards):
                svc.create_shard(i, primary=True)
            self.indices[name] = svc
            self._persist_metadata_locked()
            return svc

    def index(self, name: str) -> IndexService:
        svc = self.indices.get(name)
        if svc is None:
            raise IndexNotFoundException(f"no such index [{name}]")
        return svc

    def has_index(self, name: str) -> bool:
        return name in self.indices

    def put_alias(self, index: str, alias: str,
                  props: Optional[Dict[str, Any]] = None) -> None:
        with self._lock:
            if index not in self.indices:
                raise IndexNotFoundException(f"no such index [{index}]")
            if alias in self.indices:
                raise IllegalArgumentException(
                    f"alias [{alias}] clashes with an index name")
            _validate_index_name(alias)
            self.aliases.setdefault(alias, {})[index] = dict(props or {})
            self._persist_metadata_locked()

    def delete_alias(self, index: str, alias: str) -> None:
        with self._lock:
            entry = self.aliases.get(alias)
            if not entry or index not in entry:
                raise ResourceNotFoundException(
                    f"aliases [{alias}] missing on index [{index}]")
            del entry[index]
            if not entry:
                del self.aliases[alias]
            self._persist_metadata_locked()

    def alias_targets(self, alias: str) -> Optional[Dict[str, Dict]]:
        return self.aliases.get(alias)

    def resolve_write_index(self, name: str) -> str:
        """Writes through an alias land on its write index; a plain
        index name passes through."""
        if name in self.aliases:
            return self.write_index_for(name)
        return name

    def write_index_for(self, alias: str) -> str:
        return select_write_index(self.aliases.get(alias) or {}, alias)

    # -------- the close/open lifecycle --------

    def close_index(self, name: str) -> None:
        """Flush and shut the index's shards; the data stays on disk and
        the index refuses reads and writes until it is opened."""
        with self._lock:
            svc = self.indices.get(name)
            if svc is None:
                raise IndexNotFoundException(f"no such index [{name}]")
            if not svc.closed:
                for s in svc.shards.values():
                    s.flush()
                    s.close()
                svc.shards.clear()
                svc.closed = True
                self._persist_metadata_locked()

    def open_index(self, name: str) -> None:
        """Reopen a closed index from its store."""
        with self._lock:
            svc = self.indices.get(name)
            if svc is None:
                raise IndexNotFoundException(f"no such index [{name}]")
            if svc.closed:
                svc.closed = False
                for i in range(svc.num_shards):
                    svc.create_shard(i, primary=True)
                self._persist_metadata_locked()

    def delete_index(self, name: str) -> None:
        with self._lock:
            svc = self.indices.pop(name, None)
            if svc is None:
                raise IndexNotFoundException(f"no such index [{name}]")
            # aliases pointing at a deleted index go with it
            for alias in [a for a, tgts in self.aliases.items()
                          if name in tgts]:
                del self.aliases[alias][name]
                if not self.aliases[alias]:
                    del self.aliases[alias]
            svc.close()
            self._persist_metadata_locked()
            shutil.rmtree(svc.data_path, ignore_errors=True)

    def close(self) -> None:
        for svc in self.indices.values():
            svc.close()

    def stats(self) -> Dict[str, Any]:
        return {name: svc.stats() for name, svc in self.indices.items()}


def _validate_index_name(name: str) -> None:
    if not name or name != name.lower():
        raise IllegalArgumentException(
            f"invalid index name [{name}], must be lowercase")
    if name.startswith(("_", "-", "+")) or name in (".", ".."):
        raise IllegalArgumentException(f"invalid index name [{name}]")
    bad = set('\\/*?"<>| ,#:')
    if any(c in bad for c in name):
        raise IllegalArgumentException(
            f"invalid index name [{name}], contains illegal characters")
