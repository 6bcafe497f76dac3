"""Index lifecycle admin: rollover, shrink and split.

Copy of the reference's ``lifecycle.py`` for one node (the cluster
branches are left out). Rollover evaluates its conditions on the write
index of an alias, creates ``<name>-NNNNNN`` + 1 and moves the alias's
write pointer to it. Shrink and split copy the source's live documents
through the write path into a fresh index with the target shard count,
as the reference does (it does not hard-link segments either): the
documents route by murmur3 of their ``_id`` over the new count, so each
target shard's BM25 statistics, and with them the scores, are the
target's own. Per-document versions restart at 1, as in the reference.
"""

from __future__ import annotations

import re
import time
from typing import Any, Dict, Optional, Tuple

from elasticsearch_tpu_torch.common.errors import (IllegalArgumentException,
                                                   IndexClosedException)
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.common.units import parse_bytes, parse_seconds
from elasticsearch_tpu_torch.indices.service import select_write_index

_ROLLOVER_RE = re.compile(r"^(.*?)-(\d+)$")


def next_rollover_name(source: str) -> str:
    """`logs-000001` → `logs-000002`."""
    m = _ROLLOVER_RE.match(source)
    if m is None:
        raise IllegalArgumentException(
            f"index name [{source}] does not match pattern '^.*-\\d+$'")
    width = max(6, len(m.group(2)))
    return f"{m.group(1)}-{int(m.group(2)) + 1:0{width}d}"


def evaluate_conditions(conditions: Optional[Dict[str, Any]], *,
                        docs: int, age_ms: int,
                        size_bytes: int) -> Dict[str, bool]:
    """→ {condition key as the reference renders it: met?}."""
    out: Dict[str, bool] = {}
    for key, val in (conditions or {}).items():
        if key == "max_docs":
            out[f"[max_docs: {int(val)}]"] = docs >= int(val)
        elif key == "max_age":
            ms = int(parse_seconds(str(val)) * 1000)
            out[f"[max_age: {val}]"] = age_ms >= ms
        elif key in ("max_size", "max_primary_shard_size"):
            out[f"[{key}: {val}]"] = size_bytes >= parse_bytes(str(val))
        else:
            raise IllegalArgumentException(
                f"unknown rollover condition [{key}]")
    return out


def _source_stats(node, source: str) -> Tuple[int, int, int]:
    """(docs, age_ms, size_bytes) of the rollover source index."""
    svc = node.indices.index(source)
    created = int(svc.settings.get("index.creation_date", 0) or 0)
    docs = sum(s.engine.num_docs() for s in svc.shards.values())
    size = sum(v.segment.ram_bytes_estimate()
               for s in svc.shards.values()
               for v in s.acquire_searcher().views)
    age_ms = int(time.time() * 1000) - created if created else 0
    return docs, age_ms, size


def rollover(node, alias: str, body: Optional[Dict[str, Any]],
             new_index: Optional[str] = None,
             dry_run: bool = False) -> Dict[str, Any]:
    """POST /<alias>/_rollover[/<new_index>]. If any condition is met
    (or none are given), create the next index and move the alias's
    write pointer to it."""
    body = body or {}
    targets = node.indices.alias_targets(alias)
    if targets is None:
        raise IllegalArgumentException(
            f"rollover target [{alias}] is not an alias")
    source = select_write_index(targets, alias)
    docs, age_ms, size = _source_stats(node, source)
    conds = evaluate_conditions(body.get("conditions"),
                                docs=docs, age_ms=age_ms, size_bytes=size)
    rolled = (not conds) or any(conds.values())
    target = new_index or next_rollover_name(source)
    out = {"acknowledged": False, "shards_acknowledged": False,
           "old_index": source, "new_index": target,
           "rolled_over": False, "dry_run": dry_run, "conditions": conds}
    if dry_run or not rolled:
        return out
    had_write_flag = bool((targets.get(source) or {}).get("is_write_index"))
    node.create_index(target, Settings(
        Settings.normalize_index_settings(body.get("settings") or {})),
        body.get("mappings"))
    if had_write_flag:
        # the old index stays under the alias, its write flag off
        node.indices.put_alias(source, alias, {"is_write_index": False})
    else:
        node.indices.delete_alias(source, alias)
    node.indices.put_alias(target, alias, {"is_write_index": True})
    out["acknowledged"] = True
    out["shards_acknowledged"] = True
    out["rolled_over"] = True
    return out


def shrink(node, source: str, target: str,
           body: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """PUT /<source>/_shrink/<target>: the source's live documents in
    an index with fewer shards."""
    return _resize(node, source, target, body, mode="shrink")


def split(node, source: str, target: str,
          body: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """PUT /<source>/_split/<target>: more shards, the target count a
    multiple of the source's."""
    return _resize(node, source, target, body, mode="split")


def _resize(node, source: str, target: str,
            body: Optional[Dict[str, Any]], *, mode: str
            ) -> Dict[str, Any]:
    """Copy the live documents into a fresh index with the target shard
    count. Preconditions as in the reference: the shard counts divide
    in the right direction and the source carries a write block."""
    svc = node.indices.index(source)
    if svc.closed:
        raise IndexClosedException(f"closed index [{source}]")
    if not svc.settings.get_bool("index.blocks.write", False):
        raise IllegalArgumentException(
            f"index [{source}] must be read-only to resize it. Set "
            f"\"index.blocks.write: true\"")
    body = body or {}
    settings = Settings.normalize_index_settings(body.get("settings"))
    n_target = int(settings.get("index.number_of_shards", 1))
    settings["index.number_of_shards"] = n_target
    # the resized index does not inherit the source's write block
    settings = {k: v for k, v in settings.items() if v is not None}
    if mode == "shrink":
        if n_target <= 0 or svc.num_shards % n_target != 0:
            raise IllegalArgumentException(
                f"the number of source shards [{svc.num_shards}] must "
                f"be a multiple of [{n_target}]")
    elif n_target <= 0 or n_target % svc.num_shards != 0:
        raise IllegalArgumentException(
            f"the number of target shards [{n_target}] must be a "
            f"multiple of the source shards [{svc.num_shards}]")
    tgt = node.create_index(target, Settings(settings),
                            svc.mapper.to_mapping())
    copied = 0
    buckets: Dict[int, list] = {i: [] for i in range(n_target)}
    for shard in svc.shards.values():
        for view in shard.acquire_searcher().views:
            seg = view.segment
            for ord_ in range(seg.num_docs):
                if not view.live_mask[ord_]:
                    continue
                doc_id = seg.doc_ids[ord_]
                buckets[tgt.shard_for_id(doc_id)].append(
                    (doc_id, seg.stored_source[ord_] or {}))
                copied += 1
    for shard_num, docs in buckets.items():
        if docs:
            tgt.shard(shard_num).apply_bulk_index_on_primary(docs)
    tgt.refresh()
    tgt.flush()
    return {"acknowledged": True, "shards_acknowledged": True,
            "index": target, "copied_docs": copied}
