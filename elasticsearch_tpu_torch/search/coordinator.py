"""Search coordinator — ``_search`` across indices and shards.

Copy of the reference's ``search/coordinator.py``: target resolution
(``resolve_targets``, over index and alias names), body parsing
(``parse_search_body``), and two paths.

The kernel path (``_search_fast``) runs the query phase of each index
through ``GpuSearchService.try_search``, merges across indices (score
desc, index order, kernel rank) and assembles columnar hits
(``ColumnarHits`` / ``SplicedHits``); a ``_source`` list or tuple
filters each hit's source. The planner path (``_search_planner``) takes
every request the reference hands to its planner: a filtered alias,
from + size of 0 or above 10,000, ``min_score``, or a query outside the
kernel's lowering subset (``NotLowerable(planner=True)``). It skips
shards ``can_match`` rules out, runs ``execute_query`` on each shard's
reader under per-shard failure capture, merges by (score desc, index
order, shard, rank), fetches the window's winners and renders the
reference's response. It runs on the first device of the service's
mesh.

``count`` is the reference's ``_count``: every shard's query phase at
size 0 (totals only, no top-k) on the device it is given, alias filters
applied. A closed index is skipped by a wildcard, ``_all`` or an alias,
and named directly it is the reference's 400 before any shard or pack
is asked.

Refused typed (``NotLowerable``): the planner features not ported yet
(sort, search_after, highlight, suggest, rescore, collapse, pit,
aggregations, knn), and what the reference serves on its kernel path
but the port's does not take yet (``planner=False``: rows of more than
1024 slots). Unlike the reference, a fault of the kernel path
is not retried on the planner: it reaches the client as a 5xx.
"""

from __future__ import annotations

import fnmatch
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.common.errors import (
    CircuitBreakingException, IllegalArgumentException,
    IndexClosedException, IndexNotFoundException, NotLowerable,
    SearchPhaseExecutionException, shard_failure_entry)
from elasticsearch_tpu_torch.search import dsl
from elasticsearch_tpu_torch.search.can_match import can_match
from elasticsearch_tpu_torch.search.gpu_service import MAX_K
from elasticsearch_tpu_torch.search.query_phase import (ShardHit,
                                                        execute_fetch,
                                                        execute_query)
from elasticsearch_tpu_torch.search.serializer import (ColumnarHits,
                                                       SplicedHits,
                                                       assemble_hits_list)

#: body keys the reference accepts
KNOWN_KEYS = frozenset({
    "query", "aggs", "aggregations", "size", "from", "_source", "min_score",
    "track_total_hits", "sort", "search_after", "timeout", "pit",
    "profile", "highlight", "suggest", "version", "seq_no_primary_term",
    "rescore", "collapse", "knn"})
#: body keys of planner features the port does not serve yet
PLANNER_KEYS = ("sort", "search_after", "highlight", "suggest", "rescore",
                "collapse", "pit")

#: failures that abort the whole request rather than degrade to a
#: per-shard failure: a breaker trip is a 429 before work is admitted,
#: and a feature the port does not serve is the client's typed 400
_NON_DEGRADABLE = (CircuitBreakingException, NotLowerable)


def allow_partial_results(params: Optional[Dict[str, str]]) -> bool:
    """The ``allow_partial_search_results`` query param (default true:
    a search survives shard failures and reports them in
    ``_shards.failures``)."""
    raw = (params or {}).get("allow_partial_search_results", "true")
    return str(raw).lower() not in ("false", "0", "no")


def check_shard_failures(failures: List[Dict[str, Any]], successful: int,
                         allow_partial: bool, phase: str = "query") -> None:
    """Every shard failing, or any shard failing when partial results
    are disallowed, raises SearchPhaseExecutionException instead of a
    degraded 200."""
    if not failures:
        return
    if successful == 0:
        raise SearchPhaseExecutionException(phase, "all shards failed",
                                            failures)
    if not allow_partial:
        raise SearchPhaseExecutionException(
            phase, "Search rejected due to failed shards "
            "[allow_partial_search_results=false]", failures)


def resolve_targets(indices, expression: Optional[str]
                    ) -> Tuple[List[str], Dict[str, List[dict]]]:
    """Wildcard/CSV resolution over index and alias names → (index names,
    {index: [alias filter json, ...]}). An index reached directly (or
    through an unfiltered alias) in the same expression is unfiltered.
    Closed indices: a wildcard, ``_all`` or an alias skips them; naming
    one directly raises IndexClosedException."""
    idx_names = sorted(indices.indices.keys())
    alias_map = getattr(indices, "aliases", {})
    alias_names = sorted(alias_map.keys())
    out: List[str] = []
    filters: Dict[str, List[dict]] = {}
    unfiltered: set = set()

    def closed(name: str) -> bool:
        return getattr(indices.indices.get(name), "closed", False)

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
            if closed(part):
                raise IndexClosedException(f"closed index [{part}]")
            add_index(part, None)
            return
        if part in alias_names:
            for idx, props in sorted(alias_map[part].items()):
                if idx in indices.indices and not closed(idx):
                    add_index(idx, props.get("filter"))
            return
        raise IndexNotFoundException(f"no such index [{part}]")

    if expression in (None, "", "_all", "*"):
        for n in idx_names:
            if not closed(n):
                add_index(n, None)
        return out, filters
    for part in expression.split(","):
        part = part.strip()
        if not part:
            continue
        if "*" in part or "?" in part:
            for m in fnmatch.filter(idx_names, part):
                if not closed(m):
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


def with_alias_filters(query: dsl.QueryNode,
                       filts: Optional[List[dict]]) -> dsl.QueryNode:
    """The request query with the matched aliases' filters as a filter
    clause (several filtered aliases OR together)."""
    if not filts:
        return query
    parsed = [dsl.parse_query(f) for f in filts]
    if len(parsed) == 1:
        filt: dsl.QueryNode = parsed[0]
    else:
        filt = dsl.BoolQuery(should=parsed, minimum_should_match=1)
    return dsl.BoolQuery(must=[query], filter=[filt])


def parse_search_body(body: Optional[Dict[str, Any]]):
    """→ (query node, body). Unknown keys are a 400, as in the
    reference; planner features the port does not serve raise
    NotLowerable."""
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
    planner += [k for k in ("knn",) if body.get(k) is not None]
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
    """One ``_search`` over the indices `index_expr` names: the kernel
    path where the reference takes it, else the planner path."""
    t0 = time.perf_counter()
    params = params or {}
    names, alias_filters = resolve_targets(indices, index_expr)
    query, body = parse_search_body(body)
    size = int(params.get("size", body.get("size", 10)))
    from_ = int(params.get("from", body.get("from", 0)))
    source = body.get("_source", True)
    min_score = body.get("min_score")
    version = bool(body.get("version"))
    seq_no_primary_term = bool(body.get("seq_no_primary_term"))
    if params.get("timeout") is not None:
        raise IllegalArgumentException(
            "[timeout] is not ported yet to the GPU search path")
    if not alias_filters:
        # filtered aliases run the planner, as in the reference
        try:
            return _search_fast(indices, names, query, gpu_search,
                                size=size, from_=from_,
                                min_score=min_score, source=source, t0=t0,
                                version=version,
                                seq_no_primary_term=seq_no_primary_term)
        except NotLowerable as exc:
            if not exc.planner:
                raise
    return _search_planner(indices, names, alias_filters, query, params,
                           size=size, from_=from_, min_score=min_score,
                           source=source, t0=t0, version=version,
                           seq_no_primary_term=seq_no_primary_term,
                           device=gpu_search.mesh.grid[0][0])


def _search_planner(indices, names: List[str],
                    alias_filters: Dict[str, List[dict]],
                    query: dsl.QueryNode, params: Dict[str, str], *,
                    size: int, from_: int, min_score, source, t0: float,
                    version: bool, seq_no_primary_term: bool,
                    device) -> Dict[str, Any]:
    """The planner path: per-shard query phase under failure capture,
    the merge, the fetch phase, the response."""
    shard_results = []   # (index name, shard num, reader, result)
    failures: List[Dict[str, Any]] = []
    allow_partial = allow_partial_results(params)
    total = 0
    skipped = 0
    n_shards_expected = sum(len(indices.index(n).shards) for n in names)
    for name in names:
        svc = indices.index(name)
        eff_query = with_alias_filters(query, alias_filters.get(name))
        for shard_num, shard in sorted(svc.shards.items()):
            try:
                reader = shard.acquire_searcher()
                if not can_match(reader, eff_query, svc.mapper):
                    skipped += 1
                    continue
                res = execute_query(reader, eff_query, size=size + from_,
                                    from_=0, min_score=min_score,
                                    device=device)
            except _NON_DEGRADABLE:
                raise
            except Exception as e:  # noqa: BLE001 — per-shard capture
                failures.append(shard_failure_entry(name, shard_num, e))
                indices.count_search_failure(name, shard_num)
                continue
            shard_results.append((name, shard_num, reader, res))
            total += res.total_hits
    check_shard_failures(failures, len(shard_results) + skipped,
                         allow_partial, "query")

    # merge: score desc, ties toward the lower index/shard order, then
    # the shard's rank
    merged: List[Tuple[float, int, int, ShardHit]] = []
    for si, (_, _, _, res) in enumerate(shard_results):
        for rank, hit in enumerate(res.hits):
            merged.append((-hit.score, si, rank, hit))
    merged.sort(key=lambda t: (t[0], t[1], t[2]))
    window = merged[from_: from_ + size]

    # fetch: only the shards that own winners, on the reader the query
    # phase scored
    by_shard: Dict[int, List[ShardHit]] = {}
    for _, si, _, hit in window:
        by_shard.setdefault(si, []).append(hit)
    fetched: Dict[Tuple[int, str], Dict[str, Any]] = {}
    fetch_failed: set = set()
    for si, hits in by_shard.items():
        name, shard_num, reader, _ = shard_results[si]
        try:
            for hit, doc in zip(hits, execute_fetch(
                    reader, hits, source, version=version,
                    seq_no_primary_term=seq_no_primary_term)):
                doc["_index"] = name
                fetched[(si, hit.doc_id)] = doc
        except _NON_DEGRADABLE:
            raise
        except Exception as e:  # noqa: BLE001 — per-shard capture
            failures.append(shard_failure_entry(name, shard_num, e))
            indices.count_search_failure(name, shard_num)
            fetch_failed.add(si)
            fetched = {k: v for k, v in fetched.items() if k[0] != si}
    if fetch_failed:
        # a shard that lost its fetch contributes no hits and counts
        # failed, though its query phase ran
        window = [e for e in window if e[1] not in fetch_failed]
        check_shard_failures(
            failures, len(shard_results) - len(fetch_failed) + skipped,
            allow_partial, "fetch")
    hits_json = []
    for _, si, _, hit in window:
        doc = fetched.get((si, hit.doc_id), {"_id": hit.doc_id})
        doc["_score"] = hit.score
        hits_json.append(doc)
    shards_json: Dict[str, Any] = {
        "total": n_shards_expected,
        "successful": len(shard_results) - len(fetch_failed) + skipped,
        "skipped": skipped,
        "failed": len(failures)}
    if failures:
        shards_json["failures"] = failures
    return {
        "took": int((time.perf_counter() - t0) * 1000),
        "timed_out": False,
        "_shards": shards_json,
        "hits": {"total": {"value": total, "relation": "eq"},
                 "max_score": -merged[0][0] if merged else None,
                 "hits": hits_json},
    }


def _search_fast(indices, names: List[str], query: dsl.QueryNode,
                 gpu_search, *, size: int, from_: int, min_score, source,
                 t0: float, version: bool = False,
                 seq_no_primary_term: bool = False) -> Dict[str, Any]:
    """Kernel-path query phase + columnar response assembly. Raises
    NotLowerable(planner=True) where the reference's fast path declines
    and its planner answers: from + size outside the kernel's window,
    min_score (the kernel counts totals before it), or a query of any
    target index outside the lowering subset."""
    k = from_ + size
    if k <= 0 or k > MAX_K:
        raise NotLowerable(f"from + size = {k} is outside (0, {MAX_K}], "
                           f"the kernel path's window")
    if min_score is not None:
        raise NotLowerable("min_score")
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


def count(indices, index_expr: Optional[str],
          body: Optional[Dict[str, Any]], device) -> Dict[str, Any]:
    """``_count``: the query phase of every shard at size 0 on `device`
    (no top-k: only the totals), alias filters applied."""
    names, alias_filters = resolve_targets(indices, index_expr)
    query = dsl.parse_query((body or {}).get("query") or {"match_all": {}})
    total = 0
    n_shards = 0
    for name in names:
        svc = indices.index(name)
        eff_query = with_alias_filters(query, alias_filters.get(name))
        for _, shard in sorted(svc.shards.items()):
            reader = shard.acquire_searcher()
            res = execute_query(reader, eff_query, size=0, device=device)
            total += res.total_hits
            n_shards += 1
    return {"count": total,
            "_shards": {"total": n_shards, "successful": n_shards,
                        "skipped": 0, "failed": 0}}
