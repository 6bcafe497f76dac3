"""ShardReader — an immutable point-in-time view of a shard for search.

Copy of the reference's ``index/reader.py``: a reader holds the segment
set and live-doc masks at acquire time (padded to the pack's doc axis);
refreshes and merges create new readers and never mutate one. Each view
reaches its segment's ``SegmentPack`` (the planner's operand), built on
first use and kept on the immutable segment, so a reader costs nothing
for the kernel path, which packs every segment of an index at once
(``parallel/distributed.build_stacked_pack``).

The shard-level statistics (doc_count, avgdl, docFreq) span every
segment and count tombstoned docs until a merge drops them, as Lucene's
do.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.index.pack import (SegmentPack, _pad_to,
                                                segment_pack)
from elasticsearch_tpu_torch.index.segment import MISSING_I64, Segment


@dataclasses.dataclass
class SegmentView:
    segment: Segment
    live_mask: np.ndarray  # bool[d_pad] — tombstones applied, padding False

    @property
    def d_pad(self) -> int:
        return len(self.live_mask)

    @property
    def pack(self) -> SegmentPack:
        return segment_pack(self.segment)


class ShardReader:
    def __init__(self, segments: List[Tuple[Segment, Optional[np.ndarray]]],
                 mapper, k1: float = 1.2, b: float = 0.75):
        """segments: [(segment, live_docs bool[num_docs] or None)]."""
        self.mapper = mapper
        self.k1 = k1
        self.b = b
        # the engine's live_version at this reader's refresh: a delta
        # chain extends a resident pack only while the old segment set
        # is a prefix of this reader's and this number is unchanged
        self.live_version = 0
        self.views: List[SegmentView] = []
        for seg, live in segments:
            live_mask = np.zeros(_pad_to(seg.num_docs), dtype=bool)
            live_mask[: seg.num_docs] = True if live is None else live
            self.views.append(SegmentView(seg, live_mask))
        self._has_field_cache: Dict[Tuple[int, str], np.ndarray] = {}

    # ---------------- shard-level stats ----------------

    def field_stats(self, field: str) -> Tuple[int, float]:
        """(doc_count, avgdl) across segments, tombstoned docs included."""
        doc_count = 0
        sum_ttf = 0
        for v in self.views:
            st = v.segment.field_stats.get(field)
            if st:
                doc_count += st.doc_count
                sum_ttf += st.sum_total_term_freq
        return doc_count, (sum_ttf / doc_count if doc_count else 1.0)

    def doc_freq(self, field: str, term: str) -> int:
        return sum(v.segment.doc_freq(field, term) for v in self.views)

    def num_docs(self) -> int:
        return sum(int(v.live_mask.sum()) for v in self.views)

    # ---------------- per-segment helpers ----------------

    def has_field_mask(self, view_idx: int, field: str) -> np.ndarray:
        """bool[d_pad]: docs where `field` exists (the exists query):
        a text field by its recorded length, the others by a doc value."""
        key = (view_idx, field)
        cached = self._has_field_cache.get(key)
        if cached is not None:
            return cached
        v = self.views[view_idx]
        pack = v.pack
        mask = np.zeros(pack.d_pad, dtype=bool)
        seg = v.segment
        exact = seg.exact_lengths.get(field)
        if exact is not None:
            mask[: seg.num_docs] |= exact >= 0
        if field in pack.dv_i64:
            mask |= pack.dv_i64[field] != MISSING_I64
        if field in pack.dv_f64:
            mask |= ~np.isnan(pack.dv_f64[field])
        if field in pack.dv_ord:
            mask |= pack.dv_ord[field] >= 0
        # split-column field types store under synthetic suffixes
        # (geo_point ._lat/._lon; ip is covered by its indexed terms)
        lat = pack.dv_f64.get(field + "._lat")
        if lat is not None:
            mask |= ~np.isnan(lat)
        if field in pack.dv_vec:
            mask |= ~np.isnan(pack.dv_vec[field][:, 0])
        self._has_field_cache[key] = mask
        return mask

    def resolve_ids(self, view_idx: int, ids: List[str]) -> np.ndarray:
        v = self.views[view_idx]
        mask = np.zeros(v.d_pad, dtype=bool)
        for i in ids:
            ord_ = v.segment.id_to_ord.get(i)
            if ord_ is not None:
                mask[ord_] = True
        return mask
