"""Search coordinator — ``_search`` across indices and shards.

Copy of the reference's ``search/coordinator.py``: target resolution
(``resolve_targets``, over index and alias names), body parsing
(``parse_search_body``), and two paths.

The kernel path (``_search_fast``) runs the query phase of each index
through ``GpuSearchService.try_search``, merges across indices (score
desc, index order, kernel rank) and assembles columnar hits
(``ColumnarHits`` / ``SplicedHits``); a ``_source`` list or tuple
filters each hit's source. The planner path (``_search_planner``) takes
every request the reference hands to its planner: a filtered alias, a
scroll or PIT context's pinned readers, from + size of 0 or above
10,000, ``min_score``, a query outside the kernel's lowering subset
(``NotLowerable(planner=True)``), and the planner features: ``sort``
with ``search_after``, ``collapse``, ``rescore``, ``highlight`` and
``suggest``. It skips shards ``can_match`` rules out, runs each shard's
query phase under per-shard failure capture (``execute_query``, sorted
or not, then the rescore chain; or ``collapse_top_groups``), merges by
sort key or (score desc, index order, shard, rank), collapses by key,
fetches the window's winners, highlights them and renders the
reference's response. It runs on the first device of the service's
mesh.

``count`` is the reference's ``_count``: every shard's query phase at
size 0 (totals only, no top-k) on the device it is given, alias filters
applied. A closed index is skipped by a wildcard, ``_all`` or an alias,
and named directly it is the reference's 400 before any shard or pack
is asked.

``timeout`` (the body key or the query parameter, the reference's
duration grammar; -1 is none) makes a ``SearchContext``: the planner
checks it between shards and between segments and returns what it has
with ``"timed_out": true`` and the total's relation ``gte``; the kernel
path bounds its batch wait by it, and a deadline that expires there
hands the request to the planner under the same, expired, context.
``profile: true`` keeps the kernel path, whose response gains a kernel
section per index (the reference's ``"tpu"`` key and
``TpuKernelTopK`` collector); on the planner path each shard's query
and fetch times (``build_profile``). Each index's search slow log
(``index.search.slowlog.threshold.query.*``) logs a shard's query phase
on the planner path and an index's kernel search.

A ``knn`` section (``search/knn.py``) runs its candidate phase on the
service's first device over readers pinned a shard (a scroll's or PIT's,
or acquired here), then the planner path, each shard's query the union
of the text query and its winners; the internal ``_knn_docs`` key (the
winners resolved elsewhere) takes the same path.

Aggregations (``aggs`` / ``aggregations``, ``search/aggregations``) run
on the planner path, as in the reference: each shard's query phase
collects them under its final match mask (``min_score`` included; under
``collapse`` a size-0 query phase of their own), and the shards' parts
are reduced and rendered by ``build_response``.

Refused typed (``NotLowerable``): what the reference serves on its
kernel path but the port's does not take (``planner=False``: rows of
more than T_LIMIT, 16,384, slots). Unlike the reference, a fault of the
kernel path is not retried on the planner: it reaches the client as a
5xx.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import math
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.common.errors import (
    CircuitBreakingException, IllegalArgumentException,
    IndexClosedException, IndexNotFoundException, NotLowerable,
    SearchPhaseExecutionException, shard_failure_entry)
from elasticsearch_tpu_torch.common.units import parse_seconds
from elasticsearch_tpu_torch.index.segment import MISSING_I64
from elasticsearch_tpu_torch.search import dsl
from elasticsearch_tpu_torch.search import sort as sort_mod
from elasticsearch_tpu_torch.search.aggregations import (AggregatorFactories,
                                                         build_response,
                                                         parse_aggregations)
from elasticsearch_tpu_torch.search.can_match import can_match
from elasticsearch_tpu_torch.search.collapse import collapse_top_groups
from elasticsearch_tpu_torch.search.gpu_service import MAX_K
from elasticsearch_tpu_torch.search.highlight import (HighlightSpec,
                                                      build_highlights)
from elasticsearch_tpu_torch.search.knn import (KnnSpec, global_topk,
                                                parse_knn, shard_candidates,
                                                wrap_query)
from elasticsearch_tpu_torch.search.query_phase import (QuerySearchResult,
                                                        SearchContext,
                                                        ShardHit,
                                                        execute_fetch,
                                                        execute_query)
from elasticsearch_tpu_torch.search.rescore import (RescoreSpec,
                                                    parse_rescore,
                                                    rescore_shard_hits)
from elasticsearch_tpu_torch.search.suggest import run_suggest
from elasticsearch_tpu_torch.search.serializer import (ColumnarHits,
                                                       SplicedHits,
                                                       assemble_hits_list)

#: body keys the reference accepts
KNOWN_KEYS = frozenset({
    "query", "aggs", "aggregations", "size", "from", "_source", "min_score",
    "track_total_hits", "sort", "search_after", "timeout", "pit",
    "profile", "highlight", "suggest", "version", "seq_no_primary_term",
    "rescore", "collapse", "knn", "_knn_docs"})
#: body keys of the planner features: a body holding one runs the
#: planner path, as in the reference
PLANNER_KEYS = ("sort", "search_after", "highlight", "suggest", "rescore",
                "collapse")

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
    """→ (query node, parsed aggregations or None, body). Unknown keys
    are a 400, as in the reference, and so are a malformed knn, rescore,
    collapse or aggregation tree and knn with sort or collapse."""
    body = body or {}
    if "script_fields" in body:
        raise IllegalArgumentException(
            "search body keys ['script_fields'] are not supported "
            "yet by this engine")
    unknown = set(body) - KNOWN_KEYS
    if unknown:
        raise IllegalArgumentException(
            f"unknown search body keys {sorted(unknown)}")
    if body.get("knn") is not None:
        parse_knn(body["knn"])  # a malformed knn section is a 400
        if body.get("sort") is not None or body.get("collapse"):
            raise IllegalArgumentException(
                "[knn] cannot be combined with [sort]/[collapse]: knn "
                "results are relevance-ranked")
    query = dsl.parse_query(body.get("query") or {"match_all": {}})
    aggs_spec = body.get("aggs") or body.get("aggregations")
    aggs = parse_aggregations(aggs_spec) if aggs_spec else None
    if body.get("rescore") is not None:
        parse_rescore(body["rescore"])  # a malformed rescore is a 400
    if body.get("collapse") is not None:
        spec = body["collapse"]
        if not isinstance(spec, dict) or not spec.get("field"):
            raise IllegalArgumentException("[collapse] requires [field]")
        if spec.get("inner_hits") is not None:
            raise IllegalArgumentException(
                "[collapse] inner_hits is not supported yet")
        if body.get("sort") is not None or body.get("rescore") is not None:
            raise IllegalArgumentException(
                "[collapse] cannot be combined with [sort]/[rescore] yet")
    return query, aggs, body


def encode_knn_docs(knn_wrap: Dict[Tuple[str, int], List[Tuple[Any, float]]]
                    ) -> Dict[str, Any]:
    """Per-shard knn winners → the JSON-serializable `_knn_docs` body key
    (the wire form of a candidate phase resolved elsewhere)."""
    out: Dict[str, Any] = {}
    for (name, shard_num), sets in knn_wrap.items():
        entry = []
        for seg_map, boost in sets:
            entry.append({
                "boost": boost,
                "segments": {seg: [list(map(int, ords)),
                                   list(map(float, scores))]
                             for seg, (ords, scores) in seg_map.items()}})
        out[f"{name}#{shard_num}"] = entry
    return out


def decode_knn_docs(encoded: Dict[str, Any]
                    ) -> Dict[Tuple[str, int], List[Tuple[Any, float]]]:
    out: Dict[Tuple[str, int], List[Tuple[Any, float]]] = {}
    for key, sets in encoded.items():
        name, _, shard_s = key.rpartition("#")
        decoded = []
        for entry in sets:
            seg_map = {
                seg: (np.asarray(ords, dtype=np.int64),
                      np.asarray(scores, dtype=np.float32))
                for seg, (ords, scores) in entry["segments"].items()}
            decoded.append((seg_map, float(entry["boost"])))
        out[(name, int(shard_s))] = decoded
    return out


def knn_candidate_phase(indices, names: List[str],
                        alias_filters: Dict[str, List[dict]],
                        specs: List[KnnSpec],
                        pinned: Dict[Tuple[str, int], Any], device
                        ) -> Dict[Tuple[str, int], List[Tuple[Any, float]]]:
    """Each knn clause → its GLOBAL top-k winners over the pinned readers
    (an index's alias filters folded into the clause's filter), grouped
    by shard as (segment → (ords, scores), boost) entries."""
    knn_wrap: Dict[Tuple[str, int], List[Tuple[Any, float]]] = {}
    for spec in specs:
        per_shard = {}
        for (name, shard_num), reader in pinned.items():
            if name not in names:
                continue
            eff_spec = spec
            afilts = alias_filters.get(name)
            if afilts:
                base_filt = spec.filter_query or dsl.MatchAllQuery()
                eff_spec = dataclasses.replace(
                    spec, filter_query=with_alias_filters(base_filt,
                                                          afilts))
            per_shard[(name, shard_num)] = shard_candidates(
                reader, eff_spec, device=device)
        for shard_key, seg_map in global_topk(per_shard, spec.k).items():
            knn_wrap.setdefault(shard_key, []).append((seg_map, spec.boost))
    return knn_wrap


def parse_timeout_s(body: Dict[str, Any],
                    params: Dict[str, str]) -> Optional[float]:
    """The ``timeout`` query parameter or body key → seconds, or None
    (absent, or -1, the reference's "no timeout"). A malformed duration
    is a 400."""
    raw = params.get("timeout", body.get("timeout"))
    if raw is None:
        return None
    seconds = parse_seconds(raw)
    return None if seconds < 0 else seconds


@dataclasses.dataclass
class Features:
    """A request's planner features: the sort and its cursor, the
    highlighter, the rescore chain and the collapse field."""
    sort_specs: List[sort_mod.SortSpec]
    search_after: Optional[List[Any]]
    highlight: Optional[HighlightSpec]
    rescore: Optional[List[RescoreSpec]]
    collapse_field: Optional[str]

    @classmethod
    def of(cls, body: Dict[str, Any]) -> "Features":
        """A parsed body's features (400s for a malformed sort, a cursor
        without a sort, or a malformed highlight or rescore)."""
        sort_specs = sort_mod.parse_sort(body.get("sort"))
        search_after = body.get("search_after")
        if search_after is not None and not sort_specs:
            raise IllegalArgumentException(
                "[search_after] requires a [sort] specification")
        return cls(
            sort_specs, search_after,
            HighlightSpec(body["highlight"])
            if body.get("highlight") is not None else None,
            parse_rescore(body["rescore"])
            if body.get("rescore") is not None else None,
            (body.get("collapse") or {}).get("field")
            if body.get("collapse") else None)


def search(indices, index_expr: Optional[str],
           body: Optional[Dict[str, Any]],
           params: Optional[Dict[str, str]], gpu_search, *,
           pinned: Optional[Dict[Tuple[str, int], Any]] = None,
           names_override: Optional[List[str]] = None) -> Dict[str, Any]:
    """One ``_search`` over the indices `index_expr` names: the kernel
    path where the reference takes it, else the planner path. `pinned`
    maps (index, shard) to the reader snapshot of a scroll or PIT
    context (the planner path over those readers, `names_override` its
    indices)."""
    t0 = time.perf_counter()
    params = params or {}
    if names_override is not None:
        names, alias_filters = list(names_override), {}
    else:
        names, alias_filters = resolve_targets(indices, index_expr)
    query, aggs, body = parse_search_body(body)
    size = int(params.get("size", body.get("size", 10)))
    from_ = int(params.get("from", body.get("from", 0)))
    source = body.get("_source", True)
    min_score = body.get("min_score")
    version = bool(body.get("version"))
    seq_no_primary_term = bool(body.get("seq_no_primary_term"))
    ctx = SearchContext(parse_timeout_s(body, params))
    profile = bool(body.get("profile"))
    features = Features.of(body)
    device = gpu_search.mesh.grid[0][0]
    # the knn candidate phase: each clause's global winners, over readers
    # pinned a shard so that the query phase scores the same view
    knn_wrap: Optional[Dict[Tuple[str, int], List[Tuple[Any, float]]]] = None
    knn_only = "query" not in body
    if body.get("_knn_docs") is not None:
        knn_wrap = decode_knn_docs(body["_knn_docs"])
    elif body.get("knn") is not None:
        if pinned is None:
            pinned = {(name, shard_num): shard.acquire_searcher()
                      for name in names
                      for shard_num, shard in sorted(
                          indices.index(name).shards.items())}
        knn_wrap = knn_candidate_phase(indices, names, alias_filters,
                                       parse_knn(body["knn"]), pinned,
                                       device)
    if (aggs is None and pinned is None and not alias_filters
            and knn_wrap is None
            and not any(k in body for k in PLANNER_KEYS)):
        # aggregations, filtered aliases, contexts, knn and the planner
        # features run the planner, as in the reference
        try:
            return _search_fast(indices, names, query, gpu_search,
                                size=size, from_=from_,
                                min_score=min_score, source=source, t0=t0,
                                version=version,
                                seq_no_primary_term=seq_no_primary_term,
                                ctx=ctx, profile=profile)
        except NotLowerable as exc:
            if not exc.planner:
                raise
    out = _search_planner(indices, names, alias_filters, query, params,
                          features, size=size, from_=from_,
                          min_score=min_score, source=source, t0=t0,
                          version=version,
                          seq_no_primary_term=seq_no_primary_term,
                          device=device, pinned=pinned, ctx=ctx,
                          profile=profile, body=body, knn_wrap=knn_wrap,
                          knn_only=knn_only, aggs=aggs)
    if body.get("suggest") is not None:
        out["suggest"] = run_suggest(indices, names, body["suggest"])
    return out


def query_shard(reader, shard_query: dsl.QueryNode, features: Features,
                 *, size: int, from_: int, min_score, device, ctx=None,
                 aggs: Optional[AggregatorFactories] = None):
    """One shard's query phase under the request's features: the
    collapsed groups, or the (sorted) query phase with the rescore
    window and chain; `aggs` collected under its match mask."""
    if features.collapse_field:
        # the exact grouped top-N (no candidate cap: a dominating key
        # cannot starve later groups)
        pairs, total_sh = collapse_top_groups(
            reader, shard_query, features.collapse_field, size + from_,
            device=device)
        res = QuerySearchResult([h for h, _ in pairs], total_sh,
                                pairs[0][0].score if pairs else None)
        if aggs is not None:
            res.aggregations = execute_query(
                reader, shard_query, size=0, aggs=aggs, device=device,
                ctx=ctx).aggregations
        return res
    k_shard = size + from_
    if features.rescore:
        # the rescore window may exceed the response window
        k_shard = max(k_shard, max(s.window_size for s in features.rescore))
    res = execute_query(reader, shard_query, size=k_shard, from_=0,
                        min_score=min_score, aggs=aggs,
                        sort_specs=features.sort_specs or None,
                        search_after=features.search_after, device=device,
                        ctx=ctx)
    if features.rescore:
        res.hits = rescore_shard_hits(reader, res.hits, features.rescore,
                                      device=device)
    return res


def _search_planner(indices, names: List[str],
                    alias_filters: Dict[str, List[dict]],
                    query: dsl.QueryNode, params: Dict[str, str],
                    features: Features, *,
                    size: int, from_: int, min_score, source, t0: float,
                    version: bool, seq_no_primary_term: bool,
                    device, pinned=None, ctx: Optional[SearchContext] = None,
                    profile: bool = False,
                    body: Optional[Dict[str, Any]] = None,
                    knn_wrap: Optional[Dict[Tuple[str, int],
                                            List[Tuple[Any, float]]]] = None,
                    knn_only: bool = False,
                    aggs: Optional[AggregatorFactories] = None
                    ) -> Dict[str, Any]:
    """The planner path: per-shard query phase under failure capture
    (stopped at the request's deadline: partial results, ``timed_out``;
    with knn winners each shard's query unions them, and a knn-only
    request skips a shard that has none),
    the merge (by sort key, or score; collapsed by key), the fetch phase
    with highlighting, the response (with the shards' aggregations,
    reduced, and their profile)."""
    shard_results = []   # (index name, shard num, reader, result)
    failures: List[Dict[str, Any]] = []
    allow_partial = allow_partial_results(params)
    total = 0
    skipped = 0
    timed_out = False
    query_nanos: Dict[Tuple[str, int], int] = {}
    sort_specs = features.sort_specs
    if pinned is not None:
        # a context's accounting is over its snapshot's shards
        name_set = set(names)
        n_shards_expected = sum(1 for (n, _s) in pinned if n in name_set)
    else:
        n_shards_expected = sum(len(indices.index(n).shards) for n in names)
    for name in names:
        svc = indices.index(name)
        eff_query = with_alias_filters(query, alias_filters.get(name))
        for shard_num, shard in sorted(svc.shards.items()):
            if ctx is not None and ctx.should_stop():
                timed_out = True
                break
            if pinned is not None:
                reader = pinned.get((name, shard_num))
                if reader is None:
                    continue  # not part of the pinned snapshot
            try:
                if pinned is None:
                    reader = shard.acquire_searcher()
                shard_query = eff_query
                if knn_wrap is not None:
                    sets = knn_wrap.get((name, shard_num), [])
                    if knn_only and not sets:
                        skipped += 1  # nothing can match on this shard
                        continue
                    shard_query = wrap_query(None if knn_only else eff_query,
                                             sets)
                elif not can_match(reader, eff_query, svc.mapper):
                    skipped += 1
                    continue
                q0 = time.perf_counter()
                res = query_shard(reader, shard_query, features, size=size,
                                   from_=from_, min_score=min_score,
                                   device=device, ctx=ctx, aggs=aggs)
            except _NON_DEGRADABLE:
                raise
            except Exception as e:  # noqa: BLE001 — per-shard capture
                failures.append(shard_failure_entry(name, shard_num, e))
                indices.count_search_failure(name, shard_num)
                continue
            elapsed = time.perf_counter() - q0
            query_nanos[(name, shard_num)] = int(elapsed * 1e9)
            if svc.search_slowlog.enabled:
                svc.search_slowlog.maybe_log(elapsed, shard_num,
                                             source=body,
                                             total_hits=res.total_hits)
            timed_out = timed_out or res.timed_out
            shard_results.append((name, shard_num, reader, res))
            total += res.total_hits
        if timed_out:
            break
    check_shard_failures(failures, len(shard_results) + skipped,
                         allow_partial, "query")

    # merge: by sort key when sorting, else score desc; ties toward the
    # lower index/shard order, then the shard's rank
    merged: List[Tuple[Any, int, int, ShardHit]] = []
    for si, (_, _, _, res) in enumerate(shard_results):
        for rank, hit in enumerate(res.hits):
            key = (sort_mod.sort_key(sort_specs, hit.sort_values or [])
                   if sort_specs else -hit.score)
            merged.append((key, si, rank, hit))
    merged.sort(key=lambda t: (t[0], t[1], t[2]))
    hit_keys: Dict[int, Any] = {}
    if features.collapse_field:
        # the best hit per key down the merged ranking; docs without a
        # key are not collapsed together
        seen_keys: set = set()
        collapsed = []
        for entry in merged:
            _, si, _, hit = entry
            key = _collapse_key(shard_results[si][2], hit,
                                features.collapse_field)
            if key is not None:
                if key in seen_keys:
                    continue
                seen_keys.add(key)
            hit_keys[id(hit)] = key
            collapsed.append(entry)
            if len(collapsed) >= from_ + size:
                break
        window = collapsed[from_: from_ + size]
    else:
        window = merged[from_: from_ + size]

    # fetch: only the shards that own winners, on the reader the query
    # phase scored; the highlighter reads _source even when the
    # response leaves it out
    fetch_source = source
    if features.highlight is not None and source is False:
        fetch_source = True
    by_shard: Dict[int, List[ShardHit]] = {}
    for _, si, _, hit in window:
        by_shard.setdefault(si, []).append(hit)
    fetched: Dict[Tuple[int, str], Dict[str, Any]] = {}
    fetch_failed: set = set()
    fetch_nanos: Dict[Tuple[str, int], int] = {}
    for si, hits in by_shard.items():
        name, shard_num, reader, _ = shard_results[si]
        f0 = time.perf_counter()
        try:
            for hit, doc in zip(hits, execute_fetch(
                    reader, hits, fetch_source, version=version,
                    seq_no_primary_term=seq_no_primary_term)):
                doc["_index"] = name
                if features.highlight is not None:
                    # the request's query only: alias filters select
                    # docs, they are not what the user searched
                    hl = build_highlights(query, doc.get("_source"),
                                          features.highlight)
                    if hl:
                        doc["highlight"] = hl
                    if source is False:
                        doc.pop("_source", None)
                fetched[(si, hit.doc_id)] = doc
        except _NON_DEGRADABLE:
            raise
        except Exception as e:  # noqa: BLE001 — per-shard capture
            failures.append(shard_failure_entry(name, shard_num, e))
            indices.count_search_failure(name, shard_num)
            fetch_failed.add(si)
            fetched = {k: v for k, v in fetched.items() if k[0] != si}
            continue
        fetch_nanos[(name, shard_num)] = int(
            (time.perf_counter() - f0) * 1e9)
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
        doc["_score"] = (None if (sort_specs and hit.sort_values)
                         else hit.score)
        if hit.sort_values is not None:
            doc["sort"] = hit.sort_values
        if features.collapse_field:
            key = hit_keys.get(id(hit))
            if key is not None:
                doc["fields"] = {features.collapse_field: [key]}
        hits_json.append(doc)
    if sort_specs:
        # max_score is null under a field sort
        only_score = all(s.field == "_score" for s in sort_specs)
        max_score = (max((h.score for _, _, _, h in merged), default=None)
                     if only_score else None)
        if only_score:
            for doc, (_, _, _, hit) in zip(hits_json, window):
                doc["_score"] = hit.score
    else:
        max_score = -merged[0][0] if merged else None
    shards_json: Dict[str, Any] = {
        "total": n_shards_expected,
        "successful": len(shard_results) - len(fetch_failed) + skipped,
        "skipped": skipped,
        "failed": len(failures)}
    if failures:
        shards_json["failures"] = failures
    out: Dict[str, Any] = {
        "took": int((time.perf_counter() - t0) * 1000),
        "timed_out": timed_out,
        "_shards": shards_json,
        "hits": {"total": {"value": total,
                           "relation": "gte" if timed_out else "eq"},
                 "max_score": max_score,
                 "hits": hits_json},
    }
    if aggs:
        # the shards' parts reduced, the pipelines run on the result
        parts = [res.aggregations for _, _, _, res in shard_results
                 if res.aggregations is not None]
        reduced = AggregatorFactories.reduce(parts) if parts else aggs.empty()
        out["aggregations"] = build_response(aggs, reduced)
    if profile:
        out["profile"] = {"shards": build_profile(
            query, shard_results, query_nanos, fetch_nanos)}
    return out


def build_profile(query, shard_results, query_nanos, fetch_nanos
                  ) -> List[Dict[str, Any]]:
    """The planner path's profile: one entry a shard with its query's
    time and its fetch phase's (the reference's shape: the dense-mask
    engine runs the whole query as one program a segment, so the
    breakdown reports that one node)."""
    shards = []
    for name, shard_num, _reader, _res in shard_results:
        qn = query_nanos.get((name, shard_num), 0)
        shards.append({
            "id": f"[{name}][{shard_num}]",
            "searches": [{
                "query": [{
                    "type": type(query).__name__,
                    "description": query.query_name(),
                    "time_in_nanos": qn,
                    "breakdown": {
                        "score": qn, "build_scorer": 0,
                        "create_weight": 0, "next_doc": 0, "advance": 0,
                        "match": 0,
                    },
                }],
                "rewrite_time": 0,
                "collector": [{
                    "name": "DenseMaskTopK",
                    "reason": "search_top_hits",
                    "time_in_nanos": qn,
                }],
            }],
            "aggregations": [],
            "fetch": {
                "type": "fetch",
                "description": "",
                "time_in_nanos": fetch_nanos.get((name, shard_num), 0),
            },
        })
    return shards


def _tpu_profile_section(gpu_search, sink: Dict[str, Any]
                         ) -> Dict[str, Any]:
    """The kernel section of one (index, query): what try_search measured
    for this request (variant, plan-cache outcome, stage ms with the
    batch_wait split), and the service's device-stage distributions
    (the stages named ``device_wait`` or ``batch_decode``; a train's
    device time is not the request's own)."""
    out = dict(sink)
    snap = gpu_search.stages.snapshot()
    out["device_stages"] = {
        name: {key: st[key] for key in _PROFILE_STAGE_KEYS if key in st}
        for name, st in snap.items()
        if "device_wait" in name or name == "batch_decode"}
    return out


#: a device stage's fields in the kernel section, the reference's
_PROFILE_STAGE_KEYS = ("seconds", "count", "p50_ms", "p95_ms", "p99_ms")


def build_kernel_profile_shard(query, name: str, elapsed_s: float,
                               tpu: Dict[str, Any]) -> Dict[str, Any]:
    """One profile entry for an index served by the kernel path, shaped
    as build_profile's entries, with the kernel section under the
    reference's key, "tpu"."""
    qn = int(elapsed_s * 1e9)
    return {
        "id": f"[{name}][kernel]",
        "searches": [{
            "query": [{
                "type": type(query).__name__,
                "description": query.query_name(),
                "time_in_nanos": qn,
                "breakdown": {"score": qn, "build_scorer": 0,
                              "next_doc": 0},
            }],
            "rewrite_time": 0,
            "collector": [{
                "name": "TpuKernelTopK",
                "reason": "search_top_hits",
                "time_in_nanos": qn,
            }],
        }],
        "aggregations": [],
        "fetch": {"type": "fetch", "description": "", "time_in_nanos": 0},
        "tpu": tpu,
    }


def _collapse_key(reader, hit: ShardHit, field: str):
    """A hit's collapse key: the first doc value of `field` (None when
    missing: the hit is collapsed with nothing)."""
    for v in reader.views:
        if v.segment.name == hit.ref.segment:
            col = v.segment.doc_values.get(field)
            if col is None:
                return None
            raw = col.values[hit.ref.ord]
            if col.kind == "ord":
                return None if raw < 0 else col.ord_terms[int(raw)]
            if col.kind == "i64":
                return None if raw == MISSING_I64 else int(raw)
            return None if math.isnan(raw) else float(raw)
    return None


def _search_fast(indices, names: List[str], query: dsl.QueryNode,
                 gpu_search, *, size: int, from_: int, min_score, source,
                 t0: float, version: bool = False,
                 seq_no_primary_term: bool = False,
                 ctx: Optional[SearchContext] = None,
                 profile: bool = False) -> Dict[str, Any]:
    """Kernel-path query phase + columnar response assembly. Raises
    NotLowerable(planner=True) where the reference's fast path declines
    and its planner answers: from + size outside the kernel's window,
    min_score (the kernel counts totals before it), a query of any
    target index outside the lowering subset, a prewarm in progress, or
    a request deadline that expired in the batcher."""
    k = from_ + size
    if k <= 0 or k > MAX_K:
        raise NotLowerable(f"from + size = {k} is outside (0, {MAX_K}], "
                           f"the kernel path's window")
    if min_score is not None:
        raise NotLowerable("min_score")
    per_index = []
    profile_entries: List[Dict[str, Any]] = []
    n_shards_total = 0
    for name in names:
        svc = indices.index(name)
        n_shards_total += len(svc.shards)
        q0 = time.perf_counter()
        sink: Optional[Dict[str, Any]] = {} if profile else None
        res = gpu_search.try_search(
            svc, query, k=k,
            timeout_s=ctx.remaining_s() if ctx is not None else None,
            profile_sink=sink)
        if res is None:
            raise NotLowerable("the kernel path did not serve the request")
        q_elapsed = time.perf_counter() - q0
        if svc.search_slowlog.enabled:
            svc.search_slowlog.maybe_log(
                q_elapsed, "kernel", source={"query": query.query_name()},
                total_hits=res.total_hits)
        if profile:
            profile_entries.append(build_kernel_profile_shard(
                query, name, q_elapsed,
                _tpu_profile_section(gpu_search, sink or {})))
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
    out = {
        "took": int((time.perf_counter() - t0) * 1000),
        "timed_out": False,
        "_shards": {"total": n_shards_total, "successful": n_shards_total,
                    "skipped": 0, "failed": 0},
        "hits": {"total": {"value": total, "relation": relation},
                 "max_score": max_score,
                 "hits": hits_json},
    }
    if profile:
        out["profile"] = {"shards": profile_entries,
                          "tpu": [e["tpu"] for e in profile_entries]}
    return out


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
