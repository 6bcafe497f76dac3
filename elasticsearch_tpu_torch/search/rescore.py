"""Query rescorer: a second pass that re-ranks each shard's top window.

Copy of the reference's ``search/rescore.py`` (QueryRescorer,
RescorerBuilder): each rescore entry re-scores the shard's top
`window_size` hits with its query; a matched hit combines
`query_weight·original ⊕ rescore_query_weight·secondary` by
`score_mode` (total, multiply, avg, max, min), an unmatched one keeps
`query_weight·original`. Entries chain in order; only the window
re-sorts. The rescore query runs on the planner's device once per
touched segment, and its mask and scores come to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np

from elasticsearch_tpu_torch.common.errors import IllegalArgumentException
from elasticsearch_tpu_torch.search import dsl

SCORE_MODES = ("total", "multiply", "avg", "max", "min")


@dataclasses.dataclass
class RescoreSpec:
    window_size: int
    query: dsl.QueryNode
    query_weight: float = 1.0
    rescore_query_weight: float = 1.0
    score_mode: str = "total"

    def combine(self, orig: float, matched: bool, secondary: float) -> float:
        q = self.query_weight * orig
        if not matched:
            return q
        r = self.rescore_query_weight * secondary
        if self.score_mode == "total":
            return q + r
        if self.score_mode == "multiply":
            return q * r
        if self.score_mode == "avg":
            return (q + r) / 2.0
        if self.score_mode == "max":
            return max(q, r)
        return min(q, r)


def parse_rescore(spec: Any) -> List[RescoreSpec]:
    entries = spec if isinstance(spec, list) else [spec]
    out: List[RescoreSpec] = []
    for entry in entries:
        if not isinstance(entry, dict) or "query" not in entry:
            raise IllegalArgumentException("[rescore] requires [query]")
        q = entry["query"]
        if not isinstance(q, dict) or "rescore_query" not in q:
            raise IllegalArgumentException(
                "[rescore] requires [query.rescore_query]")
        mode = str(q.get("score_mode", "total")).lower()
        if mode not in SCORE_MODES:
            raise IllegalArgumentException(
                f"[rescore] unknown score_mode [{mode}]")
        out.append(RescoreSpec(
            window_size=int(entry.get("window_size", 10)),
            query=dsl.parse_query(q["rescore_query"]),
            query_weight=float(q.get("query_weight", 1.0)),
            rescore_query_weight=float(q.get("rescore_query_weight", 1.0)),
            score_mode=mode))
    return out


def rescore_shard_hits(reader, hits: List, specs: List[RescoreSpec],
                       device=None) -> List:
    """Apply the rescore chain to one shard's query-phase hits (best
    first). Each spec evaluates its query once per touched segment on
    `device`, then combines and re-sorts the window."""
    from elasticsearch_tpu_torch.search.planner import \
        SegmentQueryExecutor
    if not hits:
        return hits
    seg_index = {v.segment.name: i for i, v in enumerate(reader.views)}
    for spec in specs:
        window = hits[: spec.window_size]
        needed = sorted({h.ref.segment for h in window
                         if h.ref.segment in seg_index})
        masks: Dict[str, np.ndarray] = {}
        scores: Dict[str, np.ndarray] = {}
        for seg_name in needed:
            executor = SegmentQueryExecutor(reader, seg_index[seg_name],
                                            device)
            m, s = executor.execute(spec.query)
            masks[seg_name] = m.cpu().numpy()
            scores[seg_name] = s.cpu().numpy()
        for h in window:
            m = masks.get(h.ref.segment)
            matched = bool(m[h.ref.ord]) if m is not None else False
            secondary = float(scores[h.ref.segment][h.ref.ord]) \
                if matched else 0.0
            h.score = spec.combine(h.score, matched, secondary)
        window.sort(key=lambda h: (-h.score, h.doc_id))
        hits = window + hits[spec.window_size:]
    return hits
