"""Ranking-quality evaluation: the rank-eval module.

Copy of the reference's ``search/rank_eval.py`` (modules/rank-eval):
given rated (query, document) pairs and a metric, run each query
through the search function it is handed and score the ranking:

  precision@k     |relevant ∩ top-k| / |retrieved ∩ top-k|
  recall@k        |relevant ∩ top-k| / |relevant|
  mrr@k           1/rank of the first relevant hit
  dcg@k / ndcg@k  Σ (2^rel − 1)/log2(rank+1), normalized by the ideal
                  ordering when `normalize`
  err@k           the expected reciprocal rank's cascade model

REST: POST /{index}/_rank_eval with the reference's request shape
(`requests: [{id, request, ratings}]`, `metric: {<name>: {...}}`).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

from elasticsearch_tpu_torch.common.errors import IllegalArgumentException


# ---------------------------------------------------------------------------
# metric math (rating lists are in ranked order, None = unrated)
# ---------------------------------------------------------------------------

def precision_at_k(ratings: Sequence[Optional[int]], k: int,
                   relevant_rating_threshold: int = 1,
                   ignore_unlabeled: bool = False) -> float:
    top = list(ratings[:k])
    if ignore_unlabeled:
        top = [r for r in top if r is not None]
    if not top:
        return 0.0
    rel = sum(1 for r in top
              if r is not None and r >= relevant_rating_threshold)
    return rel / len(top)


def recall_at_k(ratings: Sequence[Optional[int]], k: int,
                total_relevant: int,
                relevant_rating_threshold: int = 1) -> float:
    if total_relevant <= 0:
        return 0.0
    rel = sum(1 for r in ratings[:k]
              if r is not None and r >= relevant_rating_threshold)
    return rel / total_relevant


def reciprocal_rank(ratings: Sequence[Optional[int]], k: int,
                    relevant_rating_threshold: int = 1) -> float:
    for i, r in enumerate(ratings[:k]):
        if r is not None and r >= relevant_rating_threshold:
            return 1.0 / (i + 1)
    return 0.0


def dcg_at_k(ratings: Sequence[Optional[int]], k: int) -> float:
    """Reference DiscountedCumulativeGain: (2^rel − 1) / log2(rank + 1),
    unrated docs contribute 0."""
    out = 0.0
    for i, r in enumerate(ratings[:k]):
        if r is not None and r > 0:
            out += (2.0**r - 1.0) / math.log2(i + 2)
    return out


def ndcg_at_k(ratings: Sequence[Optional[int]], k: int,
              all_ratings: Optional[Sequence[int]] = None) -> float:
    """all_ratings: every known rating for the query (for the ideal DCG);
    defaults to the observed ratings."""
    dcg = dcg_at_k(ratings, k)
    pool = [r for r in (all_ratings if all_ratings is not None else ratings)
            if r is not None and r > 0]
    ideal = dcg_at_k(sorted(pool, reverse=True), k)
    return dcg / ideal if ideal > 0 else 0.0


def err_at_k(ratings: Sequence[Optional[int]], k: int,
             max_rating: Optional[int] = None) -> float:
    """ExpectedReciprocalRank cascade model (Chapelle et al., as in the
    reference's ExpectedReciprocalRank)."""
    rated = [r or 0 for r in ratings[:k]]
    if max_rating is None:
        max_rating = max(rated, default=0)
    if max_rating <= 0:
        return 0.0
    p_continue = 1.0
    err = 0.0
    for i, r in enumerate(rated):
        useful = (2.0**r - 1.0) / (2.0**max_rating)
        err += p_continue * useful / (i + 1)
        p_continue *= 1.0 - useful
    return err


# ---------------------------------------------------------------------------
# request evaluation
# ---------------------------------------------------------------------------

_METRICS = {"precision", "recall", "mean_reciprocal_rank", "dcg",
            "expected_reciprocal_rank"}


def evaluate(search_fn, body: Dict[str, Any]) -> Dict[str, Any]:
    """search_fn(request_body) → search response dict. `body` is the
    reference-shaped rank_eval request."""
    requests = body.get("requests")
    if not requests:
        raise IllegalArgumentException("[rank_eval] requires [requests]")
    metric_spec = body.get("metric")
    if not isinstance(metric_spec, dict) or len(metric_spec) != 1:
        raise IllegalArgumentException(
            "[rank_eval] requires exactly one [metric]")
    metric_name, opts = next(iter(metric_spec.items()))
    if metric_name not in _METRICS:
        raise IllegalArgumentException(
            f"[rank_eval] unknown metric [{metric_name}]")
    opts = opts or {}
    k = int(opts.get("k", 10))
    threshold = int(opts.get("relevant_rating_threshold", 1))

    details = {}
    scores = []
    for req in requests:
        rid = req.get("id")
        if rid is None:
            raise IllegalArgumentException("[rank_eval] request needs [id]")
        ratings_by_doc: Dict[Tuple[Optional[str], str], int] = {}
        for r in req.get("ratings", []):
            ratings_by_doc[(r.get("_index"), r["_id"])] = int(r["rating"])
        search_body = dict(req.get("request") or {})
        search_body.setdefault("size", max(k, 10))
        resp = search_fn(search_body)
        hits = resp["hits"]["hits"]
        ranked: List[Optional[int]] = []
        hit_details = []
        for h in hits:
            key = (h.get("_index"), h["_id"])
            rating = ratings_by_doc.get(key,
                                        ratings_by_doc.get((None, h["_id"])))
            ranked.append(rating)
            hit_details.append({"hit": {"_index": h.get("_index"),
                                        "_id": h["_id"],
                                        "_score": h.get("_score")},
                                "rating": rating})
        all_ratings = list(ratings_by_doc.values())
        if metric_name == "precision":
            score = precision_at_k(ranked, k, threshold,
                                   bool(opts.get("ignore_unlabeled")))
        elif metric_name == "recall":
            total_rel = sum(1 for r in all_ratings if r >= threshold)
            score = recall_at_k(ranked, k, total_rel, threshold)
        elif metric_name == "mean_reciprocal_rank":
            score = reciprocal_rank(ranked, k, threshold)
        elif metric_name == "dcg":
            score = (ndcg_at_k(ranked, k, all_ratings)
                     if opts.get("normalize") else dcg_at_k(ranked, k))
        else:  # expected_reciprocal_rank
            score = err_at_k(ranked, k, opts.get("maximum_relevance"))
        unrated = sum(1 for r in ranked if r is None)
        details[rid] = {"metric_score": score, "unrated_docs": unrated,
                        "hits": hit_details}
        scores.append(score)

    return {
        "metric_score": sum(scores) / len(scores) if scores else 0.0,
        "details": details,
        "failures": {},
    }
