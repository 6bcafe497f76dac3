"""IndicesService / IndexService — the node's registry of open indices.

Copy of the reference's ``indices/service.py`` (IndexService: settings,
mapper and local shards of one index; IndicesService: the registry, its
gateway metadata under ``<data_path>/_state/indices.json`` so a restart
reopens its indices, and aliases). Routing a document to a shard is the
port's ``indices/routing.shard_for``, the reference's murmur3. Left out:
the slow log, search-failure counters, dynamic index settings and the
close/open lifecycle.
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
    IndexNotFoundException,
    ShardNotFoundException,
)
from elasticsearch_tpu_torch.common.settings import Settings
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
        self._k1 = settings.get_float("index.similarity.default.k1", 1.2)
        self._b = settings.get_float("index.similarity.default.b", 0.75)
        self._durability = settings.get("index.translog.durability", "request")
        if self._durability not in ("request", "async"):
            raise IllegalArgumentException(
                f"[index.translog.durability] must be [request] or "
                f"[async], got [{self._durability}]")

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

    def refresh(self) -> None:
        for s in self.shards.values():
            s.refresh()

    def flush(self) -> None:
        for s in self.shards.values():
            s.flush()

    def close(self) -> None:
        for s in self.shards.values():
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
        self._load_metadata()

    def _state_path(self) -> str:
        return os.path.join(self.data_path, "_state", "indices.json")

    def _persist_metadata_locked(self) -> None:
        meta = {
            "indices": {name: {"uuid": svc.index_uuid,
                               "settings": svc.settings.get_as_dict(),
                               "mapping": svc.mapper.to_mapping(),
                               "state": "open"}
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

    def resolve_write_index(self, name: str) -> str:
        """Writes through an alias land on its write index; a plain
        index name passes through."""
        if name in self.aliases:
            return select_write_index(self.aliases.get(name) or {}, name)
        return name

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
