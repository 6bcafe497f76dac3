"""Field collapsing: an exact grouped top-N per shard.

Copy of the reference's ``search/collapse.py`` (CollapseBuilder and the
collapsing top-docs collector): each shard returns its best hit per key
for its top `n_groups` keys, ranked by their best score, and the
coordinator keeps the best per key across shards. The query's mask and
masked scores are the planner's on the device; they come to the host
once per segment, where the doc-value keys group them. No candidate
depth is cut, so a key that dominates the ranking never starves later
groups.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np

import torch

from elasticsearch_tpu_torch.index.segment import MISSING_I64
from elasticsearch_tpu_torch.ops import bm25
from elasticsearch_tpu_torch.search import dsl
from elasticsearch_tpu_torch.search.planner import SegmentQueryExecutor
from elasticsearch_tpu_torch.search.query_phase import ShardDocRef, ShardHit


def collapse_top_groups(reader, query: dsl.QueryNode, field: str,
                        n_groups: int, device=None
                        ) -> Tuple[List[Tuple[ShardHit, Any]], int]:
    """→ ([(best hit, collapse key)] for the shard's top n_groups keys,
    total matching docs), the query evaluated on `device`. Docs without
    a key each form their own group (they are not collapsed
    together)."""
    best: Dict[Any, Tuple[float, int, int]] = {}  # key → (score, seg, ord)
    loose: List[Tuple[float, int, int]] = []      # missing-key docs
    total = 0
    for idx, view in enumerate(reader.views):
        executor = SegmentQueryExecutor(reader, idx, device)
        mask, score = executor.execute(query)
        live = torch.as_tensor(view.live_mask).to(executor.device)
        final = bm25.mask_scores(score[None, :], mask[None, :],
                                 live)[0].cpu().numpy()
        m = (mask & live).cpu().numpy()
        n = view.segment.num_docs
        m = m[:n]
        total += int(m.sum())
        if not m.any():
            continue
        col = view.segment.doc_values.get(field)
        ords = np.nonzero(m)[0]
        scores = final[:n][ords]
        if col is None:
            keys = None
        elif col.kind == "ord":
            raw = col.values[ords]
            keys = [None if r < 0 else col.ord_terms[int(r)]
                    for r in raw.tolist()]
        elif col.kind == "i64":
            raw = col.values[ords]
            keys = [None if r == MISSING_I64 else int(r)
                    for r in raw.tolist()]
        else:
            raw = col.values[ords]
            keys = [None if math.isnan(r) else float(r)
                    for r in raw.tolist()]
        for i, o in enumerate(ords.tolist()):
            s = float(scores[i])
            key = keys[i] if keys is not None else None
            if key is None:
                loose.append((s, idx, o))
                continue
            cur = best.get(key)
            # tie-break toward earlier segment/doc, the merge order rule
            if cur is None or s > cur[0]:
                best[key] = (s, idx, o)
    ranked: List[Tuple[float, int, int, Any]] = [
        (s, seg, o, key) for key, (s, seg, o) in best.items()]
    ranked.extend((s, seg, o, None) for s, seg, o in loose)
    ranked.sort(key=lambda t: (-t[0], t[1], t[2]))
    out = []
    for s, seg, o, key in ranked[: n_groups]:
        segment = reader.views[seg].segment
        out.append((ShardHit(segment.doc_ids[o], s,
                             ShardDocRef(segment.name, o)), key))
    return out, total
