"""ShardReader — an immutable point-in-time view of a shard for search.

Copy of the reference's ``index/reader.py`` over the port's
``index/pack.py`` layout: a reader holds the segment set and live-doc
masks at acquire time (padded to the pack's doc axis); refreshes and
merges create new readers and never mutate one. The per-segment device
packs of the reference's planner path are not built here: the port's
search path packs every segment of an index at once
(``parallel/distributed.build_stacked_pack``), whose shard-level BM25
statistics count tombstoned docs until a merge drops them, as Lucene's
do.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.index.pack import _pad_to
from elasticsearch_tpu_torch.index.segment import Segment


@dataclasses.dataclass
class SegmentView:
    segment: Segment
    live_mask: np.ndarray  # bool[d_pad] — tombstones applied, padding False

    @property
    def d_pad(self) -> int:
        return len(self.live_mask)


class ShardReader:
    def __init__(self, segments: List[Tuple[Segment, Optional[np.ndarray]]],
                 mapper, k1: float = 1.2, b: float = 0.75):
        """segments: [(segment, live_docs bool[num_docs] or None)]."""
        self.mapper = mapper
        self.k1 = k1
        self.b = b
        self.views: List[SegmentView] = []
        for seg, live in segments:
            live_mask = np.zeros(_pad_to(seg.num_docs), dtype=bool)
            live_mask[: seg.num_docs] = True if live is None else live
            self.views.append(SegmentView(seg, live_mask))

    def num_docs(self) -> int:
        return sum(int(v.live_mask.sum()) for v in self.views)
