"""kNN search over dense_vector fields: exact top-k on the device.

Copy of the reference's ``search/knn.py`` (the ``knn`` search section and
its KnnScoreDocQuery rewrite) on an explicit device. Two phases, as in
the reference:

  1. the candidate phase (``shard_candidates``): every shard scores its
     segments' vectors against the query with the ``knn_scores`` kernel
     (``ops/knn_kernel.py``: the similarity, NaN rows, live docs, the
     ``filter`` and the ``similarity`` cutoff, in the reference's bits)
     and keeps each segment's top ``num_candidates`` (``knn_topk``:
     ``shard_topk``), then the shard's best ``num_candidates``;
  2. the coordinator keeps each clause's GLOBAL top k (``global_topk``)
     and rewrites them into per-shard KnnScoreDocQuery nodes
     (``wrap_query``) that the planner's query phase unions with the
     text query: hybrid BM25 + kNN scores query_score + Σ knn_score·boost
     on docs in both sets.

Similarity → score (the reference's DenseVectorFieldMapper maps):
  cosine      → (1 + cos(q, d)) / 2
  dot_product → (1 + q·d) / 2        (vectors should be unit-norm)
  l2_norm     → 1 / (1 + ||q - d||²)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.common.errors import IllegalArgumentException
from elasticsearch_tpu_torch.mapping.types import DenseVectorFieldType
from elasticsearch_tpu_torch.ops import knn_kernel
from elasticsearch_tpu_torch.parallel.device import resolve_device
from elasticsearch_tpu_torch.search import dsl
from elasticsearch_tpu_torch.search.planner import SegmentQueryExecutor

NEG_INF = float("-inf")


@dataclasses.dataclass
class KnnSpec:
    field: str
    query_vector: np.ndarray     # f32[dims]
    k: int
    num_candidates: int
    filter_query: Optional[dsl.QueryNode] = None
    boost: float = 1.0
    similarity: Optional[float] = None  # min raw-similarity cutoff


def parse_knn(spec: Any) -> List[KnnSpec]:
    """The `knn` search-body section: one object or a list of them (the
    reference's 400s)."""
    specs = spec if isinstance(spec, list) else [spec]
    out: List[KnnSpec] = []
    for s in specs:
        if not isinstance(s, dict):
            raise IllegalArgumentException("[knn] must be an object")
        unknown = set(s) - {"field", "query_vector", "k",
                            "num_candidates", "filter", "boost",
                            "similarity"}
        if unknown:
            raise IllegalArgumentException(
                f"[knn] unknown parameter {sorted(unknown)}")
        field = s.get("field")
        qv = s.get("query_vector")
        if not field or qv is None:
            raise IllegalArgumentException(
                "[knn] requires [field] and [query_vector]")
        if not isinstance(qv, list) or not qv or not all(
                isinstance(x, (int, float)) and not isinstance(x, bool)
                for x in qv):
            raise IllegalArgumentException(
                "[knn] [query_vector] must be a non-empty array of "
                "numbers")
        k = int(s.get("k", 10))
        num_candidates = int(s.get("num_candidates", max(k * 10, 100)))
        if k < 1:
            raise IllegalArgumentException("[knn] [k] must be >= 1")
        if num_candidates < k:
            raise IllegalArgumentException(
                f"[knn] [num_candidates] ({num_candidates}) cannot be "
                f"less than [k] ({k})")
        filt = None
        if s.get("filter") is not None:
            f = s["filter"]
            if isinstance(f, list):
                filt = dsl.BoolQuery(filter=[dsl.parse_query(x)
                                             for x in f])
            else:
                filt = dsl.parse_query(f)
        out.append(KnnSpec(
            field=str(field),
            query_vector=np.asarray(qv, dtype=np.float32),
            k=k, num_candidates=num_candidates, filter_query=filt,
            boost=float(s.get("boost", 1.0)),
            similarity=(None if s.get("similarity") is None
                        else float(s["similarity"]))))
    return out


def shard_candidates(reader, spec: KnnSpec, device=None
                     ) -> List[Tuple[float, str, int, str]]:
    """The candidate phase on one shard, on `device` (default cuda:0):
    → [(score, segment name, ord, doc id)], its top num_candidates
    (score desc, then segment name and ord), masked by the live docs,
    the filter and the similarity cutoff."""
    ft = reader.mapper.field_type(spec.field)
    if ft is None or not isinstance(ft, DenseVectorFieldType):
        raise IllegalArgumentException(
            f"[knn] field [{spec.field}] is not a [dense_vector] field")
    if len(spec.query_vector) != ft.dims:
        raise IllegalArgumentException(
            f"[knn] query_vector has length [{len(spec.query_vector)}] "
            f"but field [{spec.field}] has [dims={ft.dims}]")
    dev = resolve_device(device)
    out: List[Tuple[float, str, int, str]] = []
    q = torch.from_numpy(spec.query_vector).to(dev)[None, :]
    for idx, view in enumerate(reader.views):
        mat = view.pack.dv_vec.get(spec.field)
        if mat is None:
            continue
        vectors = torch.from_numpy(mat).to(dev)
        ok = torch.from_numpy(view.live_mask).to(dev)
        if spec.filter_query is not None:
            fmask, _ = SegmentQueryExecutor(reader, idx, device=dev)._eval(
                spec.filter_query, scoring=False)
            ok = ok & fmask
        score = knn_kernel.knn_scores(vectors, q, ft.similarity, ok=ok,
                                      similarity=spec.similarity)
        n = min(spec.num_candidates, int(score.shape[1]))
        vals, ords = knn_kernel.knn_topk(score, n)
        vals = vals[0].cpu().numpy()
        ords = ords[0].cpu().numpy()
        seg = view.segment
        for v, d in zip(vals, ords):
            if v == NEG_INF:
                break
            out.append((float(v), seg.name, int(d), seg.doc_ids[int(d)]))
    out.sort(key=lambda t: (-t[0], t[1], t[2]))
    return out[: spec.num_candidates]


def global_topk(per_shard: Dict[Tuple[str, int],
                                List[Tuple[float, str, int, str]]],
                k: int
                ) -> Dict[Tuple[str, int],
                          Dict[str, Tuple[np.ndarray, np.ndarray]]]:
    """Every shard's candidates → the GLOBAL top k, grouped by shard as
    {segment name: (ords, scores)} for the KnnScoreDocQuery rewrite."""
    merged: List[Tuple[float, Tuple[str, int], str, int]] = []
    for shard_key, cands in per_shard.items():
        for score, seg_name, ord_, _doc_id in cands:
            merged.append((score, shard_key, seg_name, ord_))
    merged.sort(key=lambda t: (-t[0], t[1], t[2], t[3]))
    grouped: Dict[Tuple[str, int],
                  Dict[str, Tuple[List[int], List[float]]]] = {}
    for score, shard_key, seg_name, ord_ in merged[:k]:
        seg_map = grouped.setdefault(shard_key, {})
        ords, scores = seg_map.setdefault(seg_name, ([], []))
        ords.append(ord_)
        scores.append(score)
    return {
        shard: {seg: (np.asarray(o, dtype=np.int64),
                      np.asarray(s, dtype=np.float32))
                for seg, (o, s) in seg_map.items()}
        for shard, seg_map in grouped.items()}


def wrap_query(base: Optional[dsl.QueryNode],
               knn_doc_sets: List[Tuple[Dict[str, Tuple[np.ndarray,
                                                        np.ndarray]],
                                        float]]) -> dsl.QueryNode:
    """The base query and a shard's knn winners (one (segment → (ords,
    scores), boost) entry a clause) → the union node its query phase
    runs."""
    return dsl.KnnScoreDocQuery(
        query=base,
        doc_sets=[ds for ds, _ in knn_doc_sets],
        boosts=[b for _, b in knn_doc_sets])
