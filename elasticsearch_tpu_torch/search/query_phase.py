"""Query and fetch phases for one shard, on the planner path.

Copy of the reference's ``search/query_phase.py``: the query phase runs
``SegmentQueryExecutor`` over each segment of a ShardReader on a device,
masks tombstoned docs, takes each segment's top-k (``ops/bm25.topk``:
the ``shard_topk`` kernel on a CUDA tensor) and merges them by (score
desc, segment, doc); it returns doc refs and scores only. Under a
``sort`` it is the reference's sorted query phase: the query's mask and
scores come to the host once per segment, and the doc-value keys are
ordered there by the reference's numpy ``lexsort`` (``search/sort.py``),
``search_after`` a mask over the same keys. Aggregations (an
``AggregatorFactories``) collect per segment under the final match mask
(``min_score`` included), kept on the device, and the segments' parts
reduce to one shard part. The fetch
phase resolves the winners' ``_source`` (``filter_source`` for a list),
``_version`` and ``_seq_no``/``_primary_term``. A ``SearchContext``
carries a request's deadline: the query phase checks it between
segments and returns what it has, ``timed_out``. Like every entry point
of the port it runs on ``cuda:0`` unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.index.reader import ShardReader
from elasticsearch_tpu_torch.ops import bm25
from elasticsearch_tpu_torch.parallel.device import resolve_device
from elasticsearch_tpu_torch.search import dsl
from elasticsearch_tpu_torch.search import sort as sort_mod
from elasticsearch_tpu_torch.search.aggregations import (AggregatorFactories,
                                                         SegmentAggContext)
from elasticsearch_tpu_torch.search.planner import SegmentQueryExecutor


@dataclasses.dataclass
class ShardDocRef:
    segment: str
    ord: int


@dataclasses.dataclass
class ShardHit:
    doc_id: str
    score: float
    ref: ShardDocRef
    sort_values: Optional[List] = None  # set under a field sort


@dataclasses.dataclass
class QuerySearchResult:
    """A shard's query-phase result: top-k (doc ref, score), total hits;
    no _source yet. timed_out: the request's deadline stopped it before
    its last segment."""
    hits: List[ShardHit]
    total_hits: int
    max_score: Optional[float]
    timed_out: bool = False
    aggregations: Optional[Dict[str, Any]] = None  # name → partial


class SearchContext:
    """A search request's deadline and cancellation (the reference's
    SearchContext), checked between segments, the unit of work the
    engine schedules: a passed deadline gives partial results with
    ``"timed_out": true``; a cancelled task raises out of the request
    (`task` stays None until the task manager is ported)."""

    def __init__(self, timeout_s: Optional[float] = None, task=None):
        self.deadline = (time.monotonic() + timeout_s
                         if timeout_s is not None else None)
        self.task = task
        self.timed_out = False

    def remaining_s(self) -> Optional[float]:
        if self.deadline is None:
            return None
        return max(0.0, self.deadline - time.monotonic())

    def should_stop(self) -> bool:
        """True: stop collecting and return the partial result."""
        if self.task is not None:
            self.task.ensure_not_cancelled()  # raises when cancelled
        if self.deadline is not None and time.monotonic() >= self.deadline:
            self.timed_out = True
            return True
        return False


def execute_query(reader: ShardReader, query: dsl.QueryNode, *,
                  size: int = 10, from_: int = 0,
                  min_score: Optional[float] = None,
                  aggs: Optional[Any] = None,
                  sort_specs: Optional[List] = None,
                  search_after: Optional[List] = None,
                  device=None,
                  ctx: Optional[SearchContext] = None) -> QuerySearchResult:
    """The query phase over every segment of `reader` on `device`
    (default: cuda:0; "cpu" for the plain path). min_score filters the
    match set, totals included, and `aggs` (an ``AggregatorFactories``)
    collect under it into one shard part; `sort_specs` (parsed
    ``sort.SortSpec``) sorts by fields, with per-hit sort values, after
    the `search_after` cursor; `ctx`'s deadline, checked between
    segments, stops it with the partial result (timed_out)."""
    dev = resolve_device(device)
    if sort_specs:
        return _execute_sorted_query(reader, query, size=size, from_=from_,
                                     min_score=min_score, aggs=aggs,
                                     sort_specs=sort_specs,
                                     search_after=search_after, device=dev,
                                     ctx=ctx)
    k = size + from_
    per_segment: List[Tuple[int, np.ndarray, np.ndarray]] = []
    agg_parts: List[Dict[str, Any]] = []
    total = 0
    timed_out = False
    for idx, view in enumerate(reader.views):
        if ctx is not None and ctx.should_stop():
            timed_out = True
            break
        executor = SegmentQueryExecutor(reader, idx, dev)
        mask, score = executor.execute(query)
        live = torch.as_tensor(view.live_mask).to(dev)
        final = bm25.mask_scores(score[None, :], mask[None, :], live)[0]
        match = mask & live
        if min_score is not None:
            # min_score filters the match set: totals agree with it
            match = match & (final >= min_score)
        total += int(match.sum())
        if aggs:
            agg_parts.append(aggs.collect(
                SegmentAggContext(reader, idx, dev), match))
        if k > 0:
            vals, idxs = bm25.topk(final[None, :], k=min(k, view.d_pad))
            per_segment.append((idx, vals[0].cpu().numpy(),
                                idxs[0].cpu().numpy()))
    # merge across segments: (score desc, segment asc, doc asc)
    merged: List[Tuple[float, int, int]] = []
    for seg_idx, vals, idxs in per_segment:
        for v, d in zip(vals.tolist(), idxs.tolist()):
            if v == float("-inf"):
                continue
            if min_score is not None and v < min_score:
                continue
            merged.append((v, seg_idx, d))
    merged.sort(key=lambda t: (-t[0], t[1], t[2]))
    window = merged[from_: from_ + size] if size > 0 else []
    hits = []
    for score, seg_idx, ord_ in window:
        seg = reader.views[seg_idx].segment
        hits.append(ShardHit(seg.doc_ids[ord_], score,
                             ShardDocRef(seg.name, ord_)))
    max_score = merged[0][0] if merged else None
    return QuerySearchResult(hits, total, max_score, timed_out=timed_out,
                             aggregations=_shard_aggs(aggs, agg_parts))


def _shard_aggs(aggs, agg_parts: List[Dict[str, Any]]):
    """The segments' agg parts reduced to the shard's (None without
    aggs; the empty tree when no segment collected)."""
    if not aggs:
        return None
    return AggregatorFactories.reduce(agg_parts) if agg_parts \
        else aggs.empty()


def _execute_sorted_query(reader: ShardReader, query: dsl.QueryNode, *,
                          size: int, from_: int, min_score, aggs,
                          sort_specs: List, search_after,
                          device, ctx: Optional[SearchContext] = None
                          ) -> QuerySearchResult:
    """The field-sorted query phase: per segment, the query on the
    device, its mask and scores to the host once, a lexsort of the
    matching docs' sort keys (numeric values, keyword ordinals); then a
    merge across segments on value tuples."""
    k = size + from_
    agg_parts: List[Dict[str, Any]] = []
    total = 0
    timed_out = False
    merged: List[Tuple[Tuple, int, int, float, List]] = []
    for idx, view in enumerate(reader.views):
        if ctx is not None and ctx.should_stop():
            timed_out = True
            break
        executor = SegmentQueryExecutor(reader, idx, device)
        mask, score = executor.execute(query)
        live = torch.as_tensor(view.live_mask).to(device)
        n = view.segment.num_docs
        final_mask = (mask & live).cpu().numpy()[:n]
        scores_np = bm25.mask_scores(score[None, :], mask[None, :],
                                     live)[0].cpu().numpy()[:n]
        if min_score is not None:
            final_mask = final_mask & (scores_np >= min_score)
        total += int(final_mask.sum())
        if aggs:
            pad = np.zeros(view.d_pad, dtype=bool)
            pad[: len(final_mask)] = final_mask
            agg_parts.append(aggs.collect(
                SegmentAggContext(reader, idx, device),
                torch.from_numpy(pad).to(device)))
        columns = sort_mod.segment_sort_values(reader, idx, sort_specs,
                                               scores_np)
        # one rank/adjust pass per column, shared by the cursor mask and
        # the lexsort keys
        ranks = [sort_mod.column_ranks(spec, col)
                 for spec, col in zip(sort_specs, columns)]
        if search_after is not None:
            final_mask = final_mask & sort_mod.after_mask(
                sort_specs, columns, search_after, ranks=ranks)
        ords = np.nonzero(final_mask)[0]
        if len(ords) == 0:
            continue
        keys = []
        for rank, adj in ranks:
            keys.append(rank[ords])
            keys.append(adj[ords])
        # np.lexsort's last key is the primary: (doc, ..., spec 0)
        order = np.lexsort((ords,) + tuple(reversed(keys)))
        top_ords = ords[order[:k]] if k > 0 else ords[:0]
        # keyword ordinals become terms for the winners only
        for o in top_ords:
            vals = [col.resolve(int(o)) for col in columns]
            merged.append((sort_mod.sort_key(sort_specs, vals), idx, int(o),
                           float(scores_np[o]), vals))
    merged.sort(key=lambda t: (t[0], t[1], t[2]))
    window = merged[from_: from_ + size] if size > 0 else []
    hits = []
    for _key, seg_idx, ord_, score_v, vals in window:
        seg = reader.views[seg_idx].segment
        hits.append(ShardHit(
            seg.doc_ids[ord_], score_v, ShardDocRef(seg.name, ord_),
            sort_values=[sort_mod.plain_value(v) for v in vals]))
    # max_score is null under a field sort (without track_scores)
    only_score = all(s.field == "_score" for s in sort_specs)
    max_score = (max((h.score for h in hits), default=None)
                 if only_score else None)
    return QuerySearchResult(hits, total, max_score, timed_out=timed_out,
                             aggregations=_shard_aggs(aggs, agg_parts))


def execute_fetch(reader: ShardReader, hits: List[ShardHit],
                  source: Any = True, *, version: bool = False,
                  seq_no_primary_term: bool = False) -> List[Dict[str, Any]]:
    """The winners' _source (True | False | a list of field-name
    prefixes) and, when asked, _version and _seq_no/_primary_term."""
    by_name = {v.segment.name: v.segment for v in reader.views}
    out = []
    for hit in hits:
        seg = by_name.get(hit.ref.segment)
        doc: Dict[str, Any] = {"_id": hit.doc_id, "_score": hit.score}
        if seg is not None and source is not False:
            src = seg.stored_source[hit.ref.ord]
            if isinstance(source, (list, tuple)):
                src = filter_source(src or {}, list(source))
            doc["_source"] = src
        if seg is not None and version:
            doc["_version"] = int(seg.doc_versions[hit.ref.ord])
        if seg is not None and seq_no_primary_term:
            doc["_seq_no"] = int(seg.seq_nos[hit.ref.ord])
            doc["_primary_term"] = int(seg.primary_terms[hit.ref.ord])
        out.append(doc)
    return out


def filter_source(src: Dict[str, Any],
                  includes: List[str]) -> Dict[str, Any]:
    """Project a stored _source onto an includes list (dotted paths
    descend into objects). Shared by the planner's fetch phase and the
    kernel path's columnar serializer."""
    out: Dict[str, Any] = {}
    for key, value in src.items():
        for inc in includes:
            if key == inc or inc.startswith(key + ".") \
                    or key.startswith(inc + "."):
                if isinstance(value, dict) and inc.startswith(key + "."):
                    sub = filter_source(value, [inc[len(key) + 1:]])
                    if sub:
                        out[key] = sub
                else:
                    out[key] = value
                break
    return out
