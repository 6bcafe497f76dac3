"""can_match prefilter — skip shards that cannot possibly match.

Copy of the reference's ``search/can_match.py``: before the query phase
fans out, a shard whose numeric or date values are disjoint with the
query's range (or numeric term) clauses is skipped and reported in
``_shards.skipped``. The per-shard stats are min/max over each segment's
doc-value column, computed on first use and cached on the segment."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.index.segment import MISSING_I64
from elasticsearch_tpu_torch.search import dsl


def _segment_minmax(seg, field: str) -> Optional[Tuple[float, float]]:
    """(min, max) of a numeric dv column over ALL docs in the segment
    (tombstones included — that only widens the range, never causing a
    wrong skip). None ⇒ no values at all."""
    cache = getattr(seg, "_minmax_cache", None)
    if cache is None:
        cache = {}
        seg._minmax_cache = cache
    if field in cache:
        return cache[field]
    col = seg.doc_values.get(field)
    out: Optional[Tuple[float, float]] = None
    if col is not None and col.kind in ("i64", "f64"):
        vals = col.values
        mask = (vals != MISSING_I64) if col.kind == "i64" \
            else ~np.isnan(vals)
        lo = hi = None
        if mask.any():
            lo = float(vals[mask].min())
            hi = float(vals[mask].max())
        for extras in col.extra.values():
            for v in extras:
                f = float(v)
                lo = f if lo is None else min(lo, f)
                hi = f if hi is None else max(hi, f)
        if lo is not None:
            out = (lo, hi)
    cache[field] = out
    return out


def _shard_minmax(reader, field: str) -> Optional[Tuple[float, float]]:
    lo = hi = None
    for view in reader.views:
        mm = _segment_minmax(view.segment, field)
        if mm is None:
            continue
        lo = mm[0] if lo is None else min(lo, mm[0])
        hi = mm[1] if hi is None else max(hi, mm[1])
    return None if lo is None else (lo, hi)


def _numeric_ft(mapper, field: str):
    ft = mapper.field_type(field)
    if ft is None or getattr(ft, "dv_kind", "none") not in ("i64", "f64"):
        return None
    if not getattr(ft, "has_doc_values", False):
        return None  # doc_values:false → no column stats; postings may
        # still match, so never skip on their absence
    return ft


def can_match(reader, query: dsl.QueryNode, mapper) -> bool:
    """False ⇒ the shard DEFINITELY has no matching doc (safe to skip);
    True ⇒ unknown, run the query phase. Conservative on everything the
    walker doesn't model."""
    return _walk(reader, query, mapper)


def _walk(reader, node: dsl.QueryNode, mapper) -> bool:
    if isinstance(node, dsl.RangeQuery):
        ft = _numeric_ft(mapper, node.field)
        if ft is None:
            return True  # keyword/text ranges: no stats modeled
        mm = _shard_minmax(reader, node.field)
        if mm is None:
            return False  # no doc on this shard has the field
        lo, hi = mm
        try:
            if node.gt is not None and \
                    float(ft.normalize_range_bound(node.gt)) >= hi:
                return False
            if node.gte is not None and \
                    float(ft.normalize_range_bound(node.gte)) > hi:
                return False
            if node.lt is not None and \
                    float(ft.normalize_range_bound(node.lt)) <= lo:
                return False
            if node.lte is not None and \
                    float(ft.normalize_range_bound(node.lte)) < lo:
                return False
        except Exception:  # unparseable bound: the query phase will 400
            return True
        return True
    if isinstance(node, dsl.TermQuery):
        ft = _numeric_ft(mapper, node.field)
        if ft is None:
            return True
        mm = _shard_minmax(reader, node.field)
        if mm is None:
            return False
        try:
            v = float(ft.normalize_range_bound(node.value))
        except Exception:
            return True
        return mm[0] <= v <= mm[1]
    if isinstance(node, dsl.ConstantScoreQuery):
        return _walk(reader, node.filter_query, mapper)
    if isinstance(node, dsl.BoolQuery):
        for q in list(node.must) + list(node.filter):
            if not _walk(reader, q, mapper):
                return False
        if node.should and not node.must and not node.filter:
            # pure should (msm ≥ 1): all clauses impossible ⇒ no match
            if not any(_walk(reader, q, mapper) for q in node.should):
                return False
        return True
    return True
