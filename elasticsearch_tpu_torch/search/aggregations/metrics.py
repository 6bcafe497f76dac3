"""Metric aggregations: min/max/sum/avg/value_count/stats/cardinality/
percentiles/top_hits (reference: search/aggregations/metrics/**,
a copy of the reference's metrics.py).

Cardinality uses a real HyperLogLog++-style sketch (murmur3-hashed values,
2^p registers, reduce = register max — the reference's
HyperLogLogPlusPlus), with the linear-counting correction for small
cardinalities. Percentiles uses a merging t-digest (the reference's
TDigestState): per-shard partials and the cross-shard reduce are both
O(compression) centroids, never O(values)."""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from elasticsearch_tpu_torch.common.errors import IllegalArgumentException
from elasticsearch_tpu_torch.search.aggregations.base import (
    Aggregator,
    AggregatorFactories,
    InternalAggregation,
    SegmentAggContext,
    host_mask,
    register_agg,
)


# ---------------------------------------------------------------------------
# simple numeric metrics
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class InternalNumericMetric(InternalAggregation):
    kind: str                    # min|max|sum|avg|value_count
    total: float = 0.0
    count: int = 0
    minv: float = math.inf
    maxv: float = -math.inf

    def reduce(self, others):
        out = dataclasses.replace(self)
        for o in others:
            out.total += o.total
            out.count += o.count
            out.minv = min(out.minv, o.minv)
            out.maxv = max(out.maxv, o.maxv)
        return out

    def to_response(self) -> Dict[str, Any]:
        if self.kind == "value_count":
            return {"value": self.count}
        if self.kind == "sum":
            return {"value": self.total}
        if self.kind == "avg":
            return {"value": self.total / self.count if self.count else None}
        if self.kind == "min":
            return {"value": self.minv if self.count else None}
        if self.kind == "max":
            return {"value": self.maxv if self.count else None}
        if self.kind == "stats":
            return {
                "count": self.count,
                "min": self.minv if self.count else None,
                "max": self.maxv if self.count else None,
                "avg": self.total / self.count if self.count else None,
                "sum": self.total,
            }
        raise AssertionError(self.kind)


class NumericMetricAggregator(Aggregator):
    def __init__(self, name, kind, field, missing=None, sub=None):
        super().__init__(name, sub or AggregatorFactories({}))
        self.kind = kind
        self.field = field
        self.missing = missing

    def collect(self, ctx: SegmentAggContext, mask) -> InternalNumericMetric:
        if self.missing is None:
            res = self._collect_device(ctx, mask)
            if res is not None:
                return res
        vals, docs, ord_terms = ctx.field_values(self.field, mask)
        out = InternalNumericMetric(self.kind)
        if ord_terms is not None and self.kind != "value_count":
            raise IllegalArgumentException(
                f"agg [{self.name}]: field [{self.field}] is not numeric")
        if self.missing is not None:
            n_mask = int(host_mask(mask)[:ctx.view.segment.num_docs].sum())
            missing_docs = n_mask - len(np.unique(docs)) if len(docs) else n_mask
            if missing_docs > 0:
                vals = np.concatenate(
                    [np.asarray(vals, dtype=np.float64),
                     np.full(missing_docs, float(self.missing))])
        if len(vals):
            v = np.asarray(vals, dtype=np.float64)
            out.total = float(v.sum())
            out.count = int(len(v))
            out.minv = float(v.min())
            out.maxv = float(v.max())
        return out

    def _collect_device(self, ctx: SegmentAggContext, mask
                        ) -> "Optional[InternalNumericMetric]":
        """count/sum/min/max as masked device reductions over the numeric
        column; None → host path."""
        seg = ctx.view.segment
        col = seg.doc_values.get(self.field)
        if col is None or col.kind == "ord" or col.extra:
            return None
        from elasticsearch_tpu_torch.search.aggregations import device
        stats = device.numeric_stats(ctx.view.pack, self.field, mask,
                                     ctx.device)
        if stats is None:
            return None
        cnt, total, mn, mx = stats
        out = InternalNumericMetric(self.kind)
        if cnt:
            out.count = cnt
            out.total = total
            out.minv = mn
            out.maxv = mx
        return out

    def empty(self) -> InternalNumericMetric:
        return InternalNumericMetric(self.kind)


for _kind in ("min", "max", "sum", "avg", "value_count", "stats"):
    def _mk(kind):
        @register_agg(kind)
        def _parse(name, body, sub, kind=kind):
            field = body.get("field")
            if field is None:
                raise IllegalArgumentException(f"[{kind}] requires a field")
            return NumericMetricAggregator(name, kind, field,
                                           body.get("missing"), sub)
        return _parse
    _mk(_kind)


# ---------------------------------------------------------------------------
# cardinality (HLL++-style)
# ---------------------------------------------------------------------------

HLL_P = 12  # 4096 registers ≈ 1.6% relative error (ES default ~precision 3000)


@dataclasses.dataclass
class InternalCardinality(InternalAggregation):
    registers: np.ndarray  # uint8[2^p]

    def reduce(self, others):
        regs = self.registers.copy()
        for o in others:
            regs = np.maximum(regs, o.registers)
        return InternalCardinality(regs)

    def to_response(self) -> Dict[str, Any]:
        return {"value": self.estimate()}

    def estimate(self) -> int:
        m = len(self.registers)
        alpha = 0.7213 / (1.0 + 1.079 / m)
        est = alpha * m * m / np.sum(np.exp2(-self.registers.astype(np.float64)))
        zeros = int((self.registers == 0).sum())
        if est <= 2.5 * m and zeros > 0:
            est = m * math.log(m / zeros)  # linear counting for small n
        return int(round(est))


class CardinalityAggregator(Aggregator):
    def __init__(self, name, field, sub=None):
        super().__init__(name, sub or AggregatorFactories({}))
        self.field = field

    def collect(self, ctx: SegmentAggContext, mask) -> InternalCardinality:
        from elasticsearch_tpu_torch.indices.routing import murmur3_hash
        keys = self._device_distinct_keys(ctx, mask)
        if keys is None:
            vals, _, ord_terms = ctx.field_values(self.field, mask)
            keys = []
            if len(vals):
                if ord_terms is not None:
                    uniq = np.unique(np.asarray(vals, dtype=np.int64))
                    keys = [ord_terms[int(v)] for v in uniq]
                else:
                    keys = [repr(v) for v in np.unique(vals)]
        regs = np.zeros(1 << HLL_P, dtype=np.uint8)
        for k in keys:
            h = murmur3_hash(k) & 0xFFFFFFFF
            idx = h >> (32 - HLL_P)
            w = (h << HLL_P) & 0xFFFFFFFF
            rank = (32 - HLL_P) + 1 if w == 0 else (32 - w.bit_length()) + 1
            if rank > regs[idx]:
                regs[idx] = rank
        return InternalCardinality(regs)

    def _device_distinct_keys(self, ctx, mask):
        """Keyword cardinality, device half: a
        scatter-max presence bitmap over the ord column gives this
        segment's DISTINCT ordinals — the host hashes only those into
        the HLL (the cross-shard merge representation), not every doc.
        None → host path (non-keyword, or multi-valued extras)."""
        seg = ctx.view.segment
        col = seg.doc_values.get(self.field)
        if col is None or col.kind != "ord" or col.extra:
            return None
        from elasticsearch_tpu_torch.search.aggregations import device
        present = device.ord_presence(ctx.view.pack, self.field, mask,
                                      ctx.device)
        if present is None:
            return None
        terms = ctx.view.pack.dv_ord_terms[self.field]
        return [terms[i] for i in np.nonzero(present)[0]]

    def empty(self) -> InternalCardinality:
        return InternalCardinality(np.zeros(1 << HLL_P, dtype=np.uint8))


@register_agg("cardinality")
def _parse_cardinality(name, body, sub):
    field = body.get("field")
    if field is None:
        raise IllegalArgumentException("[cardinality] requires a field")
    return CardinalityAggregator(name, field, sub)


# ---------------------------------------------------------------------------
# percentiles (merging t-digest — reduce memory is O(compression), not
# O(values); reference: TDigestState / AbstractTDigestPercentilesAggregator)
# ---------------------------------------------------------------------------

DEFAULT_PERCENTS = (1.0, 5.0, 25.0, 50.0, 75.0, 95.0, 99.0)


class TDigest:
    """Merging t-digest (Dunning's MergingDigest essentials): centroids
    kept sorted by mean; compression bounds their number via the k1
    scale-function size limit, giving tighter bins at the tails."""

    __slots__ = ("compression", "means", "weights", "_min", "_max")

    def __init__(self, compression: float = 100.0,
                 means: Optional[np.ndarray] = None,
                 weights: Optional[np.ndarray] = None,
                 vmin: float = math.inf, vmax: float = -math.inf):
        self.compression = compression
        self.means = means if means is not None else np.empty(0)
        self.weights = weights if weights is not None else np.empty(0)
        self._min = vmin
        self._max = vmax

    @property
    def total_weight(self) -> float:
        return float(self.weights.sum()) if len(self.weights) else 0.0

    def add_values(self, values: np.ndarray) -> "TDigest":
        if len(values) == 0:
            return self
        return self._merged(np.concatenate([self.means, values]),
                            np.concatenate([self.weights,
                                            np.ones(len(values))]),
                            min(self._min, float(values.min())),
                            max(self._max, float(values.max())))

    def merge(self, other: "TDigest") -> "TDigest":
        if len(other.means) == 0:
            return self
        if len(self.means) == 0:
            return other
        return self._merged(
            np.concatenate([self.means, other.means]),
            np.concatenate([self.weights, other.weights]),
            min(self._min, other._min), max(self._max, other._max))

    def _merged(self, means: np.ndarray, weights: np.ndarray,
                vmin: float, vmax: float) -> "TDigest":
        order = np.argsort(means, kind="stable")
        means, weights = means[order], weights[order]
        total = weights.sum()
        out_m: List[float] = []
        out_w: List[float] = []
        acc_m, acc_w, q0 = means[0], weights[0], 0.0
        for m, w in zip(means[1:], weights[1:]):
            q = q0 + (acc_w + w) / total
            # k1 scale function size bound: centroids may hold at most
            # 4·total·q(1−q)/compression weight — small near the tails
            k_size = max(1.0,
                         4.0 * total * q * (1.0 - q) / self.compression)
            if acc_w + w <= k_size:
                acc_m = (acc_m * acc_w + m * w) / (acc_w + w)
                acc_w += w
            else:
                out_m.append(acc_m)
                out_w.append(acc_w)
                q0 += acc_w / total
                acc_m, acc_w = m, w
        out_m.append(acc_m)
        out_w.append(acc_w)
        return TDigest(self.compression, np.asarray(out_m),
                       np.asarray(out_w), vmin, vmax)

    def quantile(self, q: float) -> Optional[float]:
        if len(self.means) == 0:
            return None
        if len(self.means) == 1:
            return float(self.means[0])
        total = self.weights.sum()
        target = q / 100.0 * total
        # centroid i covers cumulative weight centered at its midpoint
        cum = np.cumsum(self.weights) - self.weights / 2.0
        if target <= cum[0]:
            return self._min if q <= 0 else float(
                self._min + (self.means[0] - self._min)
                * max(0.0, target) / max(cum[0], 1e-12))
        if target >= cum[-1]:
            return self._max if q >= 100 else float(
                self.means[-1] + (self._max - self.means[-1])
                * (target - cum[-1]) / max(total - cum[-1], 1e-12))
        i = int(np.searchsorted(cum, target)) - 1
        span = cum[i + 1] - cum[i]
        frac = (target - cum[i]) / max(span, 1e-12)
        return float(self.means[i] + frac * (self.means[i + 1]
                                             - self.means[i]))


@dataclasses.dataclass
class InternalPercentiles(InternalAggregation):
    percents: Sequence[float]
    digest: TDigest

    def reduce(self, others):
        d = self.digest
        for o in others:
            d = d.merge(o.digest)
        return InternalPercentiles(self.percents, d)

    def to_response(self) -> Dict[str, Any]:
        return {"values": {f"{p:g}": self.digest.quantile(p)
                           for p in self.percents}}


class PercentilesAggregator(Aggregator):
    def __init__(self, name, field, percents, compression=100.0, sub=None):
        super().__init__(name, sub or AggregatorFactories({}))
        self.field = field
        self.percents = percents
        self.compression = compression

    def collect(self, ctx, mask) -> InternalPercentiles:
        vals, _, ord_terms = ctx.field_values(self.field, mask)
        if ord_terms is not None:
            raise IllegalArgumentException(
                f"agg [{self.name}]: field [{self.field}] is not numeric")
        digest = TDigest(self.compression).add_values(
            np.asarray(vals, dtype=np.float64))
        return InternalPercentiles(self.percents, digest)

    def empty(self) -> InternalPercentiles:
        return InternalPercentiles(self.percents,
                                   TDigest(self.compression))


@register_agg("percentiles")
def _parse_percentiles(name, body, sub):
    field = body.get("field")
    if field is None:
        raise IllegalArgumentException("[percentiles] requires a field")
    percents = tuple(body.get("percents", DEFAULT_PERCENTS))
    compression = float((body.get("tdigest") or {}).get(
        "compression", 100.0))
    return PercentilesAggregator(name, field, percents, compression, sub)


# ---------------------------------------------------------------------------
# top_hits
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class InternalTopHits(InternalAggregation):
    size: int
    hits: List[Dict[str, Any]]  # {"_id", "_score", "_source"}
    total: int

    def reduce(self, others):
        merged = list(self.hits)
        total = self.total
        for o in others:
            merged.extend(o.hits)
            total += o.total
        merged.sort(key=lambda h: (-(h["_score"] or 0.0), h["_id"]))
        return InternalTopHits(self.size, merged[: self.size], total)

    def to_response(self) -> Dict[str, Any]:
        return {"hits": {
            "total": {"value": self.total, "relation": "eq"},
            "hits": self.hits}}


class TopHitsAggregator(Aggregator):
    def __init__(self, name, size, source, sub=None):
        super().__init__(name, sub or AggregatorFactories({}))
        self.size = size
        self.source = source

    def collect(self, ctx, mask) -> InternalTopHits:
        seg = ctx.view.segment
        m = host_mask(mask)[: seg.num_docs]
        docs = np.nonzero(m)[0][: self.size]  # doc-order hits (no scores here)
        hits = []
        for d in docs:
            h = {"_id": seg.doc_ids[int(d)], "_score": None}
            if self.source:
                h["_source"] = seg.stored_source[int(d)]
            hits.append(h)
        return InternalTopHits(self.size, hits, int(m.sum()))

    def empty(self) -> InternalTopHits:
        return InternalTopHits(self.size, [], 0)


@register_agg("top_hits")
def _parse_top_hits(name, body, sub):
    return TopHitsAggregator(name, int(body.get("size", 3)),
                             body.get("_source", True), sub)
