"""Search coordinator — the kernel path of ``_search`` across indices.

Copy of the reference's ``search/coordinator.py`` for what its
``_search_fast`` serves: target resolution (``resolve_targets``, over
index and alias names), body parsing (``parse_search_body``), the kernel
query phase per index through ``GpuSearchService.try_search``, the
lexsort merge across indices (score desc, index order, kernel rank) and
columnar hit assembly (``ColumnarHits`` / ``SplicedHits``).

Every request that the reference hands to its planner path (a query
outside the lowering subset, ``min_score``, from + size of 0 or above
10,000, sort, aggregations, ``_source`` filtering, a filtered alias,
knn, PIT, ...) raises ``NotLowerable``, a typed 400, because that path
is not ported yet. Unlike the reference, a fault of the kernel path is
not caught here: it reaches the client as a 5xx.
"""

from __future__ import annotations

import fnmatch
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.common.errors import (IllegalArgumentException,
                                                   IndexNotFoundException,
                                                   NotLowerable)
from elasticsearch_tpu_torch.search import dsl
from elasticsearch_tpu_torch.search.serializer import (ColumnarHits,
                                                       SplicedHits,
                                                       assemble_hits_list)

#: body keys the reference accepts
KNOWN_KEYS = frozenset({
    "query", "aggs", "aggregations", "size", "from", "_source", "min_score",
    "track_total_hits", "sort", "search_after", "timeout", "pit",
    "profile", "highlight", "suggest", "version", "seq_no_primary_term",
    "rescore", "collapse", "knn"})
#: body keys whose presence sends a request to the reference's planner
PLANNER_KEYS = ("sort", "search_after", "highlight", "suggest", "rescore",
                "collapse", "pit")


def resolve_targets(indices, expression: Optional[str]
                    ) -> Tuple[List[str], Dict[str, List[dict]]]:
    """Wildcard/CSV resolution over index and alias names → (index names,
    {index: [alias filter json, ...]}). An index reached directly (or
    through an unfiltered alias) in the same expression is unfiltered."""
    idx_names = sorted(indices.indices.keys())
    alias_map = getattr(indices, "aliases", {})
    alias_names = sorted(alias_map.keys())
    out: List[str] = []
    filters: Dict[str, List[dict]] = {}
    unfiltered: set = set()

    def add_index(name: str, filt: Optional[dict]) -> None:
        if name not in out:
            out.append(name)
        if filt is None:
            unfiltered.add(name)
            filters.pop(name, None)
        elif name not in unfiltered:
            filters.setdefault(name, []).append(filt)

    def add_part(part: str) -> None:
        if part in idx_names:
            add_index(part, None)
            return
        if part in alias_names:
            for idx, props in sorted(alias_map[part].items()):
                if idx in indices.indices:
                    add_index(idx, props.get("filter"))
            return
        raise IndexNotFoundException(f"no such index [{part}]")

    if expression in (None, "", "_all", "*"):
        for n in idx_names:
            add_index(n, None)
        return out, filters
    for part in expression.split(","):
        part = part.strip()
        if not part:
            continue
        if "*" in part or "?" in part:
            for m in fnmatch.filter(idx_names, part):
                add_index(m, None)
            for m in fnmatch.filter(alias_names, part):
                add_part(m)
        else:
            add_part(part)
    return out, filters


def resolve_indices(indices, expression: Optional[str]) -> List[str]:
    """Index-name resolution ignoring alias filters (admin APIs)."""
    return resolve_targets(indices, expression)[0]


def resolve_concrete_indices(indices, expression: Optional[str]) -> List[str]:
    """Destructive admin APIs (delete index) name concrete indices: an
    alias is rejected, never expanded onto its backing index."""
    alias_map = getattr(indices, "aliases", {})
    if expression:
        for part in expression.split(","):
            part = part.strip()
            if part in alias_map:
                raise IllegalArgumentException(
                    f"The provided expression [{part}] matches an alias; "
                    f"this operation requires concrete index names")
    names = sorted(indices.indices.keys())
    if expression in (None, "", "_all", "*"):
        return names
    out: List[str] = []
    for part in expression.split(","):
        part = part.strip()
        if not part:
            continue
        if "*" in part or "?" in part:
            out.extend(m for m in fnmatch.filter(names, part)
                       if m not in out)
        elif part not in names:
            raise IndexNotFoundException(f"no such index [{part}]")
        elif part not in out:
            out.append(part)
    return out


def parse_search_body(body: Optional[Dict[str, Any]]):
    """→ (query node, body). Unknown keys are a 400, as in the
    reference; keys of the planner path raise NotLowerable."""
    body = body or {}
    if "script_fields" in body:
        raise IllegalArgumentException(
            "search body keys ['script_fields'] are not supported "
            "yet by this engine")
    unknown = set(body) - KNOWN_KEYS
    if unknown:
        raise IllegalArgumentException(
            f"unknown search body keys {sorted(unknown)}")
    planner = [k for k in PLANNER_KEYS if k in body]
    planner += [k for k in ("aggs", "aggregations") if body.get(k)]
    planner += [k for k in ("min_score", "knn") if body.get(k) is not None]
    if planner:
        raise NotLowerable(f"search options {planner}")
    for key in ("profile", "timeout"):
        if body.get(key) is not None and body.get(key) is not False:
            raise IllegalArgumentException(
                f"[{key}] is not ported yet to the GPU search path")
    query = dsl.parse_query(body.get("query") or {"match_all": {}})
    return query, body


def search(indices, index_expr: Optional[str],
           body: Optional[Dict[str, Any]],
           params: Optional[Dict[str, str]], gpu_search) -> Dict[str, Any]:
    """One ``_search`` over the indices `index_expr` names, on the
    kernel path."""
    t0 = time.perf_counter()
    params = params or {}
    names, alias_filters = resolve_targets(indices, index_expr)
    query, body = parse_search_body(body)
    size = int(params.get("size", body.get("size", 10)))
    from_ = int(params.get("from", body.get("from", 0)))
    source = body.get("_source", True)
    if not isinstance(source, bool):
        raise NotLowerable("_source filtering")
    if alias_filters:
        raise NotLowerable(f"filtered aliases {sorted(alias_filters)}")
    if params.get("timeout") is not None:
        raise IllegalArgumentException(
            "[timeout] is not ported yet to the GPU search path")
    return _search_fast(indices, names, query, gpu_search, size=size,
                        from_=from_, source=source, t0=t0,
                        version=bool(body.get("version")),
                        seq_no_primary_term=bool(
                            body.get("seq_no_primary_term")))


def _search_fast(indices, names: List[str], query: dsl.QueryNode,
                 gpu_search, *, size: int, from_: int, source, t0: float,
                 version: bool = False,
                 seq_no_primary_term: bool = False) -> Dict[str, Any]:
    """Kernel-path query phase + columnar response assembly."""
    k = from_ + size
    per_index = []
    n_shards_total = 0
    for name in names:
        svc = indices.index(name)
        n_shards_total += len(svc.shards)
        res = gpu_search.try_search(svc, query, k=k)
        per_index.append((name, svc, res))

    t_asm = time.perf_counter()
    total = sum(r.total_hits for _, _, r in per_index)
    relation = ("gte" if any(r.total_relation == "gte"
                             for _, _, r in per_index) else "eq")
    if len(per_index) == 1:
        # single index: the kernel result is already merged best-first —
        # the response window is a pair of array slices, and the hits
        # block stays columnar (a lazy ColumnarHits view)
        name, svc, res = per_index[0]
        scores = res.scores[from_: from_ + size]
        rows = res.rows[from_: from_ + size]
        ords = res.ords[from_: from_ + size]
        if res.resident is None or len(scores) == 0:
            hits_json: Any = []
        else:
            hits_json = ColumnarHits(name, res.resident, scores, rows,
                                     ords, source, version,
                                     seq_no_primary_term)
        max_score = float(res.scores[0]) if len(res.scores) else None
    else:
        # cross-index merge: (score desc, index order, kernel rank), one
        # lexsort
        all_scores = np.concatenate([r.scores for _, _, r in per_index]) \
            if per_index else np.empty(0, dtype=np.float32)
        tags = np.concatenate([np.full(len(r.scores), ii, dtype=np.int32)
                               for ii, (_, _, r) in enumerate(per_index)]
                              + [np.empty(0, dtype=np.int32)])
        ranks = np.concatenate([np.arange(len(r.scores), dtype=np.int32)
                                for _, _, r in per_index]
                               + [np.empty(0, dtype=np.int32)])
        order = np.lexsort((ranks, tags, -all_scores))
        window = order[from_: from_ + size]
        # assemble per index in one batched call each, then restore the
        # merged order
        win_tags = tags[window]
        win_ranks = ranks[window]
        assembled: Dict[int, List[Dict[str, Any]]] = {}
        for ii, (name, svc, res) in enumerate(per_index):
            sel = win_ranks[win_tags == ii]
            if len(sel):
                assembled[ii] = _assemble_hits(
                    name, res.resident, res.scores[sel], res.rows[sel],
                    res.ords[sel], source, version, seq_no_primary_term)
        cursors = {ii: 0 for ii in assembled}
        merged: List[Dict[str, Any]] = []
        for ii in win_tags.tolist():
            merged.append(assembled[ii][cursors[ii]])
            cursors[ii] += 1
        hits_json = SplicedHits(merged)
        max_score = float(all_scores[order[0]]) if len(order) else None
    gpu_search.stages.add("assemble", time.perf_counter() - t_asm)
    return {
        "took": int((time.perf_counter() - t0) * 1000),
        "timed_out": False,
        "_shards": {"total": n_shards_total, "successful": n_shards_total,
                    "skipped": 0, "failed": 0},
        "hits": {"total": {"value": total, "relation": relation},
                 "max_score": max_score,
                 "hits": hits_json},
    }


def _assemble_hits(name: str, resident, scores, rows, ords, source,
                   version: bool, seq_no_primary_term: bool
                   ) -> List[Dict[str, Any]]:
    """Columnar window → response hit dicts (the materialized form)."""
    return assemble_hits_list(name, resident, scores, rows, ords, source,
                              version, seq_no_primary_term)
