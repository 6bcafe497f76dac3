"""Field sort and search_after over a segment's doc-value columns.

Copy of the reference's ``search/sort.py`` (FieldSortBuilder,
ScoreSortBuilder, SearchAfterBuilder semantics):

  - the sort spec grammar: "field" | {"field": "asc"} |
    {"field": {"order": ..., "missing": "_last"|"_first"|value}} |
    "_score" (desc by default) | "_doc"
  - missing values go _last whatever the direction, by default
  - search_after is a stateless cursor of the previous page's last sort
    values; a doc qualifies iff its sort tuple is strictly after it
  - hits carry their "sort" values; max_score is null under a sort by
    anything but _score

Keys are numeric arrays per segment, on the host (``SortColumn``:
float64 values with NaN for missing, or keyword ordinals with -1, whose
order is the terms' order): ``column_ranks`` makes the lexsort keys and
``after_mask`` the cursor's mask, one vectorized pass each. Strings are
resolved only for the winners; the cross-segment and cross-shard merge
compares ``sort_key`` tuples.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from elasticsearch_tpu_torch.common.errors import IllegalArgumentException
from elasticsearch_tpu_torch.index.segment import MISSING_I64
# the spec grammar and the comparable keys, re-exported
from elasticsearch_tpu_torch.search.sort_keys import (  # noqa: F401
    SortSpec, _element_key, _invert_str, _is_missing, parse_sort,
    sort_key)


# ---------------------------------------------------------------------------
# per-segment key extraction
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SortColumn:
    """One spec's per-segment sort keys in NUMERIC form end-to-end:
    floats (NaN = missing) or keyword ordinals (-1 = missing, terms
    sorted so ordinal order IS term order). Strings are resolved only
    for the final response window via resolve(), never for every doc."""

    kind: str                       # "num" | "ord"
    values: np.ndarray              # f64[n] | i64[n] ordinals
    terms: Optional[List[str]] = None

    def resolve(self, ord_: int) -> Any:
        v = self.values[ord_]
        if self.kind == "ord":
            o = int(v)
            return self.terms[o] if o >= 0 else None
        f = float(v)
        return None if np.isnan(f) else f


def segment_sort_values(reader, view_idx: int,
                        specs: Sequence[SortSpec],
                        scores: np.ndarray) -> List[SortColumn]:
    """One SortColumn per spec, aligned to segment doc ordinals."""
    view = reader.views[view_idx]
    seg = view.segment
    n = seg.num_docs
    out: List[SortColumn] = []
    for spec in specs:
        if spec.field == "_score":
            out.append(SortColumn("num",
                                  np.asarray(scores[:n], dtype=np.float64)))
            continue
        if spec.field == "_doc":
            # GLOBAL doc ordinal (cumulative across the reader's
            # segments) so _doc is unique per shard — a per-segment
            # ordinal would collide across segments and break strictly-
            # after cursors on tied prefixes
            base = sum(v.segment.num_docs
                       for v in reader.views[:view_idx])
            out.append(SortColumn(
                "num", np.arange(base, base + n, dtype=np.float64)))
            continue
        col = seg.doc_values.get(spec.field)
        if col is None:
            out.append(SortColumn("num", np.full(n, np.nan)))
            continue
        if col.kind == "ord":
            out.append(SortColumn("ord",
                                  col.values[:n].astype(np.int64),
                                  col.ord_terms or []))
        elif col.kind == "f64":
            out.append(SortColumn(
                "num", col.values[:n].astype(np.float64, copy=True)))
        else:
            vals = col.values[:n].astype(np.float64, copy=True)
            vals[col.values[:n] == MISSING_I64] = np.nan
            out.append(SortColumn("num", vals))
    return out


def column_ranks(spec: SortSpec, col: SortColumn
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(rank i8[n], adj f64[n]): lexicographic (missing placement,
    direction-adjusted value) as pure numeric arrays."""
    if col.kind == "ord":
        missing = col.values < 0
        adj = col.values.astype(np.float64)
        if spec.missing not in ("_last", "_first"):
            raise IllegalArgumentException(
                "[sort] literal [missing] values are not supported on "
                "keyword fields")
    else:
        missing = np.isnan(col.values)
        adj = np.where(missing, 0.0, col.values)
        if spec.missing not in ("_last", "_first"):
            adj = np.where(missing, float(spec.missing), adj)
            missing = np.zeros_like(missing)
    if spec.order == "desc":
        adj = -adj
    missing_rank = 0 if spec.missing == "_first" else 2
    rank = np.where(missing, np.int8(missing_rank), np.int8(1))
    return rank, adj


def _cursor_compare(spec: SortSpec, col: SortColumn, cur: Any,
                    rank: np.ndarray, adj: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(gt bool[n], eq bool[n]) of each doc's sort element vs the
    cursor value, honoring order + missing placement. A keyword cursor
    absent from this segment's term dict still resolves exactly via its
    insertion point."""
    if _is_missing(cur):
        ck_rank = 0 if spec.missing == "_first" else 2
        if spec.missing not in ("_first", "_last"):
            cur = spec.missing  # literal replacement, fall through
        else:
            return rank > ck_rank, rank == ck_rank
    if col.kind == "ord":
        terms = col.terms or []
        lo = int(np.searchsorted(terms, str(cur), side="left"))
        hi = int(np.searchsorted(terms, str(cur), side="right"))
        present = hi > lo
        if spec.order == "asc":     # adj = ordinal
            gt_val = adj >= hi
            eq_val = adj == lo if present else np.zeros_like(rank,
                                                             dtype=bool)
        else:                       # adj = -ordinal; after ⇔ term < cur
            gt_val = adj > -lo
            eq_val = adj == -lo if present else np.zeros_like(rank,
                                                              dtype=bool)
    else:
        try:
            v = float(cur)
        except (TypeError, ValueError):
            # a string cursor against a numeric column: legitimate when
            # this segment simply has no values for the (keyword
            # elsewhere) field — every doc is missing-rank and only rank
            # decides. Comparing it against ACTUAL numeric values is a
            # type mismatch the reference 400s on.
            if bool(np.any(rank == 1)):
                raise IllegalArgumentException(
                    f"[search_after] value [{cur}] does not match the "
                    f"sort field [{spec.field}] type") from None
            return rank > 1, np.zeros_like(rank, dtype=bool)
        if spec.order == "desc":
            v = -v
        gt_val = adj > v
        eq_val = adj == v
    gt = (rank > 1) | ((rank == 1) & gt_val)
    eq = (rank == 1) & eq_val
    return gt, eq


def after_mask(specs: Sequence[SortSpec], columns: List[SortColumn],
               cursor: Sequence[Any],
               ranks: Optional[List[Tuple[np.ndarray, np.ndarray]]] = None
               ) -> np.ndarray:
    """bool[n]: docs whose sort tuple is STRICTLY after the cursor —
    fully vectorized over numeric rank/adjusted-value arrays. `ranks`
    accepts precomputed column_ranks output so callers that also lexsort
    don't pay the O(n) pass twice."""
    if len(cursor) != len(specs):
        raise IllegalArgumentException(
            f"[search_after] expects {len(specs)} values, "
            f"got {len(cursor)}")
    n = len(columns[0].values) if columns else 0
    after = np.zeros(n, dtype=bool)
    equal = np.ones(n, dtype=bool)
    for i, (spec, col, cur) in enumerate(zip(specs, columns, cursor)):
        rank, adj = ranks[i] if ranks is not None \
            else column_ranks(spec, col)
        gt, eq = _cursor_compare(spec, col, cur, rank, adj)
        after |= equal & gt
        equal &= eq
    return after


def plain_value(v: Any) -> Any:
    """JSON-safe sort value for the response's "sort" array."""
    if _is_missing(v):
        return None
    if isinstance(v, (np.floating, np.integer)):
        v = v.item()
    if isinstance(v, float) and v.is_integer():
        return int(v)
    return v
