"""Bucket aggregations: terms, histogram, date_histogram, range,
filter(s), missing, global, composite, significant_terms and
geohash_grid; copy of the reference's ``search/aggregations/bucket.py``.
A bucket is a doc mask; sub-aggregations collect under mask &
bucket_mask. terms (with one level of numeric metrics under it),
histogram and date_histogram (fixed and calendar) collect through the
device reductions of ``device.py`` where the column allows."""

from __future__ import annotations

import dataclasses
import datetime
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from elasticsearch_tpu_torch.common.errors import IllegalArgumentException
from elasticsearch_tpu_torch.common.units import parse_seconds
from elasticsearch_tpu_torch.search.aggregations.base import (
    Aggregator,
    AggregatorFactories,
    InternalAggregation,
    SegmentAggContext,
    host_mask,
    register_agg,
)


@dataclasses.dataclass
class Bucket:
    key: Any
    doc_count: int
    sub: Dict[str, InternalAggregation]
    key_as_string: Optional[str] = None

    def to_response(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"key": self.key, "doc_count": self.doc_count}
        if self.key_as_string is not None:
            out["key_as_string"] = self.key_as_string
        for name, agg in self.sub.items():
            out[name] = agg.to_response()
        return out


def _merge_buckets(parts: Sequence[Dict[Any, Bucket]]) -> Dict[Any, Bucket]:
    merged: Dict[Any, Bucket] = {}
    for part in parts:
        for key, b in part.items():
            cur = merged.get(key)
            if cur is None:
                merged[key] = Bucket(b.key, b.doc_count, dict(b.sub),
                                     b.key_as_string)
            else:
                cur.doc_count += b.doc_count
                cur.sub = AggregatorFactories.reduce([cur.sub, b.sub]) \
                    if cur.sub or b.sub else {}
    return merged


# ---------------------------------------------------------------------------
# terms
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class InternalTerms(InternalAggregation):
    size: int
    min_doc_count: int
    buckets: Dict[Any, Bucket]
    order_by: str = "_count"     # "_count" | "_key"
    order_asc: bool = False

    def reduce(self, others):
        merged = _merge_buckets([self.buckets] + [o.buckets for o in others])
        return InternalTerms(self.size, self.min_doc_count, merged,
                             self.order_by, self.order_asc)

    def _sorted(self) -> List[Bucket]:
        bs = [b for b in self.buckets.values()
              if b.doc_count >= self.min_doc_count]
        if self.order_by == "_key":
            bs.sort(key=lambda b: b.key, reverse=not self.order_asc)
        else:
            # count order; tie-break key asc (the reference's compound order)
            key_fn = (lambda b: (b.doc_count, _neg_key(b.key))) if not \
                self.order_asc else (lambda b: (-b.doc_count, _neg_key(b.key)))
            bs.sort(key=key_fn, reverse=True)
        return bs[: self.size]

    def to_response(self) -> Dict[str, Any]:
        ordered = self._sorted()
        other = sum(b.doc_count for b in self.buckets.values()
                    if b.doc_count >= self.min_doc_count) - \
            sum(b.doc_count for b in ordered)
        return {"doc_count_error_upper_bound": 0,
                "sum_other_doc_count": int(other),
                "buckets": [b.to_response() for b in ordered]}


def _neg_key(key):
    """Invert ordering for tie-break key asc inside a reverse sort."""
    if isinstance(key, (int, float)):
        return -key
    return _StrDesc(key)


class _StrDesc(str):
    def __lt__(self, other):
        return str.__gt__(self, other)


class TermsAggregator(Aggregator):
    DEFAULT_SIZE = 10

    def __init__(self, name, field, size, shard_size, min_doc_count,
                 order_by, order_asc, sub):
        super().__init__(name, sub)
        self.field = field
        self.size = size
        self.shard_size = shard_size
        self.min_doc_count = min_doc_count
        self.order_by = order_by
        self.order_asc = order_asc

    def collect(self, ctx: SegmentAggContext, mask) -> InternalTerms:
        metric_subs = self._device_metric_subs() if self.sub else {}
        if metric_subs is not None:
            res = self._collect_device(ctx, mask, metric_subs or {})
            if res is not None:
                return res
        vals, docs, ord_terms = ctx.field_values(self.field, mask)
        buckets: Dict[Any, Bucket] = {}
        if len(vals):
            if ord_terms is not None:
                ords = np.asarray(vals, dtype=np.int64)
                counts = np.bincount(ords, minlength=len(ord_terms))
                hot = np.nonzero(counts)[0]
                # keep the top shard_size per segment (reference: shard_size
                # over-fetch bounds coordinator error)
                if len(hot) > self.shard_size:
                    top = hot[np.argsort(-counts[hot], kind="stable")]
                    hot = top[: self.shard_size]
                for o in hot:
                    key = ord_terms[int(o)]
                    sub = self._collect_sub(ctx, mask, docs, ords == o)
                    buckets[key] = Bucket(key, int(counts[o]), sub)
            else:
                uniq, inv = np.unique(vals, return_inverse=True)
                counts = np.bincount(inv)
                order = np.argsort(-counts, kind="stable")[: self.shard_size]
                for i in order:
                    key = uniq[i]
                    key = int(key) if float(key).is_integer() and not \
                        isinstance(key, np.floating) else float(key)
                    sub = self._collect_sub(ctx, mask, docs, inv == i)
                    buckets[key] = Bucket(key, int(counts[i]), sub)
        return InternalTerms(self.size, self.min_doc_count, buckets,
                             self.order_by, self.order_asc)

    def _device_metric_subs(self):
        """→ {name: NumericMetricAggregator} when EVERY sub-agg is a
        plain numeric metric (the one-level sub-agg shape the device
        serves via per-ordinal scatter-reductions);
        None otherwise."""
        from elasticsearch_tpu_torch.search.aggregations.metrics import \
            NumericMetricAggregator
        if not self.sub or self.sub.pipelines:
            return None
        out = {}
        for name, agg in self.sub.aggregators.items():
            if not isinstance(agg, NumericMetricAggregator) or \
                    agg.missing is not None or agg.sub.aggregators or \
                    agg.sub.pipelines:
                return None
            out[name] = agg
        return out or None

    def _collect_device(self, ctx: SegmentAggContext, mask,
                        metric_subs) -> Optional[InternalTerms]:
        """Keyword terms counts as one device scatter-add over the ord
        column; numeric-metric sub-aggs as per-ordinal scatter
        reductions; None → host path (multi-valued
        extras or no servable column)."""
        from elasticsearch_tpu_torch.search.aggregations import device
        from elasticsearch_tpu_torch.search.aggregations.metrics import \
            InternalNumericMetric
        seg = ctx.view.segment
        col = seg.doc_values.get(self.field)
        if col is None or col.kind != "ord" or col.extra:
            return None
        counts = device.terms_counts(ctx.view.pack, self.field, mask,
                                     ctx.device)
        if counts is None:
            return None
        sub_stats = {}
        by_field = {}  # sub-aggs sharing a value field share one kernel
        for name, agg in metric_subs.items():
            vcol = seg.doc_values.get(agg.field)
            if vcol is None or vcol.kind == "ord" or vcol.extra:
                return None  # host path handles it
            stats = by_field.get(agg.field)
            if stats is None:
                stats = device.terms_numeric_stats(
                    ctx.view.pack, self.field, agg.field,
                    mask, ctx.device)
                if stats is None:
                    return None
                by_field[agg.field] = stats
            sub_stats[name] = (agg.kind, stats)
        ord_terms = ctx.view.pack.dv_ord_terms[self.field]
        hot = np.nonzero(counts)[0]
        if len(hot) > self.shard_size:
            top = hot[np.argsort(-counts[hot], kind="stable")]
            hot = top[: self.shard_size]
        buckets = {}
        for o in hot:
            key = ord_terms[int(o)]
            sub = {}
            for name, (kind, (cnt, s, mn, mx)) in sub_stats.items():
                m = InternalNumericMetric(kind)
                c = int(cnt[int(o)])
                if c:
                    m.count = c
                    m.total = float(s[int(o)])
                    m.minv = float(mn[int(o)])
                    m.maxv = float(mx[int(o)])
                sub[name] = m
            buckets[key] = Bucket(key, int(counts[o]), sub)
        return InternalTerms(self.size, self.min_doc_count, buckets,
                             self.order_by, self.order_asc)

    def _collect_sub(self, ctx, mask, docs, val_sel) -> Dict[str, InternalAggregation]:
        if not self.sub:
            return {}
        bucket_mask = np.zeros_like(host_mask(mask))
        bucket_mask[docs[val_sel]] = True
        return self.sub.collect(ctx, host_mask(mask) & bucket_mask)

    def empty(self) -> InternalTerms:
        return InternalTerms(self.size, self.min_doc_count, {},
                             self.order_by, self.order_asc)


@register_agg("terms")
def _parse_terms(name, body, sub):
    field = body.get("field")
    if field is None:
        raise IllegalArgumentException("[terms] requires a field")
    size = int(body.get("size", TermsAggregator.DEFAULT_SIZE))
    # reference default: size * 1.5 + 10
    shard_size = int(body.get("shard_size", size * 3 // 2 + 10))
    order_by, order_asc = "_count", False
    order = body.get("order")
    if isinstance(order, dict) and order:
        order_by, direction = next(iter(order.items()))
        order_asc = str(direction).lower() == "asc"
        if order_by not in ("_count", "_key"):
            raise IllegalArgumentException(
                f"[terms] order by [{order_by}] not supported")
    return TermsAggregator(name, field, size, max(size, shard_size),
                           int(body.get("min_doc_count", 1)),
                           order_by, order_asc, sub)


# ---------------------------------------------------------------------------
# histogram / date_histogram
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class InternalHistogram(InternalAggregation):
    buckets: Dict[Any, Bucket]
    min_doc_count: int = 0
    interval: Optional[float] = None   # for empty-bucket fill
    date_format: bool = False

    def reduce(self, others):
        merged = _merge_buckets([self.buckets] + [o.buckets for o in others])
        return InternalHistogram(merged, self.min_doc_count, self.interval,
                                 self.date_format)

    def to_response(self) -> Dict[str, Any]:
        keys = sorted(self.buckets.keys())
        out = []
        if (self.min_doc_count == 0 and self.interval and len(keys) > 1):
            # fill gaps (reference: histogram empty buckets when
            # min_doc_count=0)
            filled = []
            k = keys[0]
            while k <= keys[-1] + 1e-9:
                filled.append(k)
                k += self.interval
            keys = [int(k) if self.date_format else k for k in filled]
        for k in keys:
            b = self.buckets.get(k)
            if b is None:
                b = Bucket(k, 0, {},
                           _millis_iso(k) if self.date_format else None)
            if b.doc_count >= self.min_doc_count:
                out.append(b.to_response())
        return {"buckets": out}


def _millis_iso(ms: float) -> str:
    dt = datetime.datetime.fromtimestamp(ms / 1000.0, datetime.timezone.utc)
    return dt.strftime("%Y-%m-%dT%H:%M:%S.") + f"{dt.microsecond // 1000:03d}Z"


class HistogramAggregator(Aggregator):
    def __init__(self, name, field, interval, offset, min_doc_count, sub,
                 date: bool = False, calendar: Optional[str] = None):
        super().__init__(name, sub)
        self.field = field
        self.interval = interval
        self.offset = offset
        self.min_doc_count = min_doc_count
        self.date = date
        self.calendar = calendar

    def collect(self, ctx, mask) -> InternalHistogram:
        if not self.sub:
            res = (self._collect_device_calendar(ctx, mask)
                   if self.calendar else
                   self._collect_device(ctx, mask))
            if res is not None:
                return res
        vals, docs, ord_terms = ctx.field_values(self.field, mask)
        if ord_terms is not None:
            raise IllegalArgumentException(
                f"agg [{self.name}]: field [{self.field}] is not numeric")
        buckets: Dict[Any, Bucket] = {}
        if len(vals):
            v = np.asarray(vals, dtype=np.float64)
            if self.calendar:
                keys = np.asarray([_calendar_floor(int(x), self.calendar)
                                   for x in v], dtype=np.int64)
            else:
                keys = np.floor((v - self.offset) / self.interval) \
                    * self.interval + self.offset
                if self.date:
                    keys = keys.astype(np.int64)
            uniq, inv = np.unique(keys, return_inverse=True)
            counts = np.bincount(inv)
            for i, k in enumerate(uniq):
                key = int(k) if self.date else float(k)
                sub = {}
                if self.sub:
                    bucket_mask = np.zeros_like(host_mask(mask))
                    bucket_mask[docs[inv == i]] = True
                    sub = self.sub.collect(ctx, host_mask(mask) & bucket_mask)
                buckets[key] = Bucket(key, int(counts[i]), sub,
                                      _millis_iso(key) if self.date else None)
        interval = None if self.calendar else self.interval
        return InternalHistogram(buckets, self.min_doc_count, interval,
                                 self.date)

    MAX_DEVICE_BUCKETS = 65536

    def _collect_device(self, ctx, mask) -> Optional[InternalHistogram]:
        """Fixed-interval histogram as one device scatter-add; the static
        bucket span comes from the segment's min/max column stats
        None → host path."""
        seg = ctx.view.segment
        col = seg.doc_values.get(self.field)
        if col is None or col.kind == "ord" or col.extra:
            return None
        from elasticsearch_tpu_torch.search.aggregations import device
        from elasticsearch_tpu_torch.search.can_match import _segment_minmax
        mm = _segment_minmax(seg, self.field)
        if mm is None:
            return InternalHistogram({}, self.min_doc_count,
                                     self.interval, self.date)
        import math as _math
        lo_idx = int(_math.floor((mm[0] - self.offset) / self.interval))
        hi_idx = int(_math.floor((mm[1] - self.offset) / self.interval))
        n_buckets = hi_idx - lo_idx + 1
        if n_buckets <= 0 or n_buckets > self.MAX_DEVICE_BUCKETS:
            return None
        counts = device.histogram_counts(
            ctx.view.pack, self.field, mask, self.offset,
            self.interval, lo_idx, n_buckets, ctx.device)
        if counts is None:
            return None
        buckets: Dict[Any, Bucket] = {}
        for i in np.nonzero(counts)[0]:
            k = (lo_idx + int(i)) * self.interval + self.offset
            key = int(k) if self.date else float(k)
            buckets[key] = Bucket(key, int(counts[i]), {},
                                  _millis_iso(key) if self.date else None)
        return InternalHistogram(buckets, self.min_doc_count,
                                 self.interval, self.date)

    MAX_CALENDAR_BUCKETS = 16384

    def _collect_device_calendar(self, ctx, mask
                                 ) -> Optional[InternalHistogram]:
        """Calendar intervals on device: the host
        precomputes the calendar bucket BOUNDARIES spanning the
        segment's min/max, the device does one searchsorted +
        scatter-add. None → host path."""
        seg = ctx.view.segment
        col = seg.doc_values.get(self.field)
        if col is None or col.kind == "ord" or col.extra:
            return None
        from elasticsearch_tpu_torch.search.aggregations import device
        from elasticsearch_tpu_torch.search.can_match import _segment_minmax
        mm = _segment_minmax(seg, self.field)
        if mm is None:
            return InternalHistogram({}, self.min_doc_count, None,
                                     self.date)
        start = _calendar_floor(int(mm[0]), self.calendar)
        bounds = [start]
        while bounds[-1] <= mm[1]:
            if len(bounds) > self.MAX_CALENDAR_BUCKETS:
                return None
            nxt = _calendar_floor(
                int(bounds[-1]) + _CAL_STEP_MS[self.calendar],
                self.calendar)
            if nxt <= bounds[-1]:  # DST/guard: force progress
                nxt = bounds[-1] + _CAL_STEP_MS[self.calendar]
            bounds.append(nxt)
        boundaries = np.asarray(bounds, dtype=np.float64)
        counts = device.bounded_bucket_counts(
            ctx.view.pack, self.field, mask, boundaries, ctx.device)
        if counts is None:
            return None
        buckets: Dict[Any, Bucket] = {}
        for i in np.nonzero(counts)[0]:
            key = int(bounds[int(i)])
            buckets[key] = Bucket(key, int(counts[i]), {},
                                  _millis_iso(key) if self.date
                                  else None)
        return InternalHistogram(buckets, self.min_doc_count, None,
                                 self.date)

    def empty(self) -> InternalHistogram:
        return InternalHistogram({}, self.min_doc_count,
                                 None if self.calendar else self.interval,
                                 self.date)


# a step guaranteed to land inside the NEXT calendar bucket when added
# to a bucket start (then re-floored); calendar buckets are never
# shorter than these
_CAL_STEP_MS = {
    "month": 32 * 86400_000, "1M": 32 * 86400_000,
    "year": 367 * 86400_000, "1y": 367 * 86400_000,
    "quarter": 93 * 86400_000, "1q": 93 * 86400_000,
    "week": 7 * 86400_000, "1w": 7 * 86400_000,
    "day": 86400_000, "1d": 86400_000,
    "hour": 3600_000, "1h": 3600_000,
    "minute": 60_000, "1m": 60_000,
}


def _calendar_floor(ms: int, unit: str) -> int:
    dt = datetime.datetime.fromtimestamp(ms / 1000.0, datetime.timezone.utc)
    if unit in ("month", "1M"):
        dt = dt.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
    elif unit in ("year", "1y"):
        dt = dt.replace(month=1, day=1, hour=0, minute=0, second=0,
                        microsecond=0)
    elif unit in ("quarter", "1q"):
        month = ((dt.month - 1) // 3) * 3 + 1
        dt = dt.replace(month=month, day=1, hour=0, minute=0, second=0,
                        microsecond=0)
    elif unit in ("week", "1w"):
        dt = dt.replace(hour=0, minute=0, second=0, microsecond=0)
        dt -= datetime.timedelta(days=dt.weekday())
    elif unit in ("day", "1d"):
        dt = dt.replace(hour=0, minute=0, second=0, microsecond=0)
    elif unit in ("hour", "1h"):
        dt = dt.replace(minute=0, second=0, microsecond=0)
    elif unit in ("minute", "1m"):
        dt = dt.replace(second=0, microsecond=0)
    else:
        raise IllegalArgumentException(f"unknown calendar interval [{unit}]")
    return int(dt.timestamp() * 1000)


@register_agg("histogram")
def _parse_histogram(name, body, sub):
    field = body.get("field")
    interval = body.get("interval")
    if field is None or interval is None:
        raise IllegalArgumentException("[histogram] requires field + interval")
    return HistogramAggregator(name, field, float(interval),
                               float(body.get("offset", 0.0)),
                               int(body.get("min_doc_count", 0)), sub)


@register_agg("date_histogram")
def _parse_date_histogram(name, body, sub):
    field = body.get("field")
    if field is None:
        raise IllegalArgumentException("[date_histogram] requires a field")
    calendar = body.get("calendar_interval")
    fixed = body.get("fixed_interval", body.get("interval"))
    if calendar:
        return HistogramAggregator(name, field, None, 0.0,
                                   int(body.get("min_doc_count", 0)), sub,
                                   date=True, calendar=calendar)
    if not fixed:
        raise IllegalArgumentException(
            "[date_histogram] requires calendar_interval or fixed_interval")
    ms = parse_seconds(str(fixed)) * 1000.0
    return HistogramAggregator(name, field, float(ms), 0.0,
                               int(body.get("min_doc_count", 0)), sub,
                               date=True)


# ---------------------------------------------------------------------------
# range
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class InternalRange(InternalAggregation):
    buckets: Dict[Any, Bucket]
    order: List[Any]
    bounds: Dict[Any, Tuple[float, float]]

    def reduce(self, others):
        merged = _merge_buckets([self.buckets] + [o.buckets for o in others])
        return InternalRange(merged, self.order, self.bounds)

    def to_response(self):
        out = []
        for k in self.order:
            if k not in self.buckets:
                continue
            resp = self.buckets[k].to_response()
            lo, hi = self.bounds[k]
            if np.isfinite(lo):
                resp["from"] = lo
            if np.isfinite(hi):
                resp["to"] = hi
            out.append(resp)
        return {"buckets": out}


class RangeAggregator(Aggregator):
    def __init__(self, name, field, ranges, keyed, sub):
        super().__init__(name, sub)
        self.field = field
        self.ranges = ranges

    def _keys_bounds(self):
        order, bounds = [], {}
        for r in self.ranges:
            lo = float(r.get("from", -np.inf))
            hi = float(r.get("to", np.inf))
            key = r.get("key") or _range_key(lo, hi)
            order.append(key)
            bounds[key] = (lo, hi)
        return order, bounds

    def collect(self, ctx, mask) -> InternalRange:
        vals, docs, ord_terms = ctx.field_values(self.field, mask)
        if ord_terms is not None:
            raise IllegalArgumentException(
                f"agg [{self.name}]: field [{self.field}] is not numeric")
        order, bounds = self._keys_bounds()
        buckets: Dict[Any, Bucket] = {}
        v = np.asarray(vals, dtype=np.float64)
        for key in order:
            lo, hi = bounds[key]
            sel = (v >= lo) & (v < hi) if len(v) else np.zeros(0, dtype=bool)
            sub = {}
            if self.sub:
                bucket_mask = np.zeros_like(host_mask(mask))
                if len(v):
                    bucket_mask[docs[sel]] = True
                sub = self.sub.collect(ctx, host_mask(mask) & bucket_mask)
            buckets[key] = Bucket(key, int(sel.sum()) if len(v) else 0, sub)
        return InternalRange(buckets, order, bounds)

    def empty(self) -> InternalRange:
        order, bounds = self._keys_bounds()
        return InternalRange({k: Bucket(k, 0, {}) for k in order}, order,
                             bounds)


def _range_key(lo, hi) -> str:
    lo_s = "*" if not np.isfinite(lo) else f"{lo:g}"
    hi_s = "*" if not np.isfinite(hi) else f"{hi:g}"
    return f"{lo_s}-{hi_s}"


@register_agg("range")
def _parse_range(name, body, sub):
    field = body.get("field")
    ranges = body.get("ranges")
    if field is None or not ranges:
        raise IllegalArgumentException("[range] requires field + ranges")
    return RangeAggregator(name, field, ranges, body.get("keyed", False), sub)


# ---------------------------------------------------------------------------
# filter / filters / missing / global
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class InternalSingleBucket(InternalAggregation):
    doc_count: int
    sub: Dict[str, InternalAggregation]

    def reduce(self, others):
        count = self.doc_count + sum(o.doc_count for o in others)
        sub = AggregatorFactories.reduce(
            [self.sub] + [o.sub for o in others]) if self.sub else {}
        return InternalSingleBucket(count, sub)

    def to_response(self):
        out = {"doc_count": self.doc_count}
        for name, agg in self.sub.items():
            out[name] = agg.to_response()
        return out


class FilterAggregator(Aggregator):
    def __init__(self, name, query_spec, sub):
        super().__init__(name, sub)
        from elasticsearch_tpu_torch.search import dsl
        self.query = dsl.parse_query(query_spec)

    def collect(self, ctx, mask) -> InternalSingleBucket:
        fmask = host_mask(mask) & ctx.query_mask(self.query) & ctx.live_mask
        sub = self.sub.collect(ctx, fmask) if self.sub else {}
        n = ctx.view.segment.num_docs
        return InternalSingleBucket(int(fmask[:n].sum()), sub)

    def empty(self) -> InternalSingleBucket:
        return InternalSingleBucket(0, self.sub.empty() if self.sub else {})


@register_agg("filter")
def _parse_filter(name, body, sub):
    return FilterAggregator(name, body, sub)


@dataclasses.dataclass
class InternalFilters(InternalAggregation):
    buckets: Dict[str, InternalSingleBucket]
    order: List[str]

    def reduce(self, others):
        merged = {}
        for key in self.order:
            merged[key] = self.buckets[key].reduce(
                [o.buckets[key] for o in others])
        return InternalFilters(merged, self.order)

    def to_response(self):
        return {"buckets": {k: self.buckets[k].to_response()
                            for k in self.order}}


class FiltersAggregator(Aggregator):
    def __init__(self, name, named_filters, sub):
        super().__init__(name, sub)
        from elasticsearch_tpu_torch.search import dsl
        self.filters = {k: dsl.parse_query(v) for k, v in named_filters.items()}

    def collect(self, ctx, mask) -> InternalFilters:
        buckets = {}
        n = ctx.view.segment.num_docs
        for key, q in self.filters.items():
            fmask = host_mask(mask) & ctx.query_mask(q) & ctx.live_mask
            sub = self.sub.collect(ctx, fmask) if self.sub else {}
            buckets[key] = InternalSingleBucket(int(fmask[:n].sum()), sub)
        return InternalFilters(buckets, sorted(self.filters.keys()))

    def empty(self) -> InternalFilters:
        return InternalFilters(
            {k: InternalSingleBucket(0, self.sub.empty() if self.sub else {})
             for k in self.filters}, sorted(self.filters.keys()))


@register_agg("filters")
def _parse_filters(name, body, sub):
    named = body.get("filters")
    if not isinstance(named, dict) or not named:
        raise IllegalArgumentException("[filters] requires named filters")
    return FiltersAggregator(name, named, sub)


class MissingAggregator(Aggregator):
    def __init__(self, name, field, sub):
        super().__init__(name, sub)
        self.field = field

    def collect(self, ctx, mask) -> InternalSingleBucket:
        n = ctx.view.segment.num_docs
        has = ctx.reader.has_field_mask(ctx.view_idx, self.field)
        m = host_mask(mask) & ~np.asarray(has)
        sub = self.sub.collect(ctx, m) if self.sub else {}
        return InternalSingleBucket(int(m[:n].sum()), sub)

    def empty(self) -> InternalSingleBucket:
        return InternalSingleBucket(0, self.sub.empty() if self.sub else {})


@register_agg("missing")
def _parse_missing(name, body, sub):
    field = body.get("field")
    if field is None:
        raise IllegalArgumentException("[missing] requires a field")
    return MissingAggregator(name, field, sub)


class GlobalAggregator(Aggregator):
    """Ignores the query: collects over ALL live docs (reference:
    GlobalAggregator)."""

    def collect(self, ctx, mask) -> InternalSingleBucket:
        n = ctx.view.segment.num_docs
        m = ctx.live_mask.copy()
        sub = self.sub.collect(ctx, m) if self.sub else {}
        return InternalSingleBucket(int(m[:n].sum()), sub)

    def empty(self) -> InternalSingleBucket:
        return InternalSingleBucket(0, self.sub.empty() if self.sub else {})


@register_agg("global")
def _parse_global(name, body, sub):
    return GlobalAggregator(name, sub)


# ---------------------------------------------------------------------------
# composite (after-key paging over a multi-source key space; reference:
# search/aggregations/bucket/composite/CompositeAggregator)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _CompositeSource:
    name: str
    kind: str                 # "terms" | "histogram" | "date_histogram"
    field: str
    interval: Optional[float] = None
    calendar: Optional[str] = None


@dataclasses.dataclass
class InternalComposite(InternalAggregation):
    size: int
    source_names: List[str]
    buckets: Dict[tuple, Bucket]

    def reduce(self, others):
        merged = _merge_buckets([self.buckets]
                                + [o.buckets for o in others])
        return InternalComposite(self.size, self.source_names, merged)

    def to_response(self) -> Dict[str, Any]:
        ordered = sorted(self.buckets.values(),
                         key=lambda b: b.key)[: self.size]
        out_buckets = []
        for b in ordered:
            entry: Dict[str, Any] = {
                "key": dict(zip(self.source_names, b.key)),
                "doc_count": b.doc_count}
            for sname, agg in b.sub.items():
                entry[sname] = agg.to_response()
            out_buckets.append(entry)
        out: Dict[str, Any] = {"buckets": out_buckets}
        if out_buckets:
            out["after_key"] = out_buckets[-1]["key"]
        return out


class CompositeAggregator(Aggregator):
    def __init__(self, name, sources: List[_CompositeSource], size: int,
                 after: Optional[tuple], sub):
        super().__init__(name, sub)
        self.sources = sources
        self.size = size
        self.after = after

    def _source_values(self, ctx, mask, src: _CompositeSource):
        """doc ordinal → single value for this source (first value wins
        on multi-valued fields)."""
        vals, docs, ord_terms = ctx.field_values(src.field, mask)
        if src.kind == "terms":
            if ord_terms is not None:
                resolved = [ord_terms[int(v)] for v in vals]
            else:
                resolved = [float(v) if not float(v).is_integer()
                            else int(v) for v in vals]
        else:
            if ord_terms is not None:
                raise IllegalArgumentException(
                    f"composite source [{src.name}]: field [{src.field}] "
                    f"is not numeric")
            v = np.asarray(vals, dtype=np.float64)
            if src.calendar:
                resolved = [_calendar_floor(int(x), src.calendar)
                            for x in v]
            else:
                keys = np.floor(v / src.interval) * src.interval
                resolved = [int(k) if src.kind == "date_histogram"
                            else float(k) for k in keys]
        first: Dict[int, Any] = {}
        for d, val in zip(docs, resolved):
            first.setdefault(int(d), val)
        return first

    def collect(self, ctx, mask) -> InternalComposite:
        per_source = [self._source_values(ctx, mask, s)
                      for s in self.sources]
        if not per_source:
            return self.empty()
        common = set(per_source[0])
        for m in per_source[1:]:
            common &= set(m)
        by_key: Dict[tuple, List[int]] = {}
        for d in common:
            key = tuple(m[d] for m in per_source)
            if self.after is not None:
                try:
                    if key <= self.after:
                        continue  # paging: strictly after the cursor
                except TypeError:
                    raise IllegalArgumentException(
                        f"[composite] [after] values {list(self.after)} "
                        f"do not match the source key types") from None
            by_key.setdefault(key, []).append(d)
        # keep only the shard-level first `size` keys in key order — the
        # reduce re-sorts and trims identically, so this loses nothing
        buckets: Dict[tuple, Bucket] = {}
        for key in sorted(by_key)[: self.size]:
            doc_list = by_key[key]
            sub = {}
            if self.sub:
                bucket_mask = np.zeros_like(host_mask(mask))
                bucket_mask[np.asarray(doc_list, dtype=np.int64)] = True
                sub = self.sub.collect(ctx,
                                       host_mask(mask) & bucket_mask)
            buckets[key] = Bucket(key, len(doc_list), sub)
        return InternalComposite(self.size,
                                 [s.name for s in self.sources], buckets)

    def empty(self) -> InternalComposite:
        return InternalComposite(self.size,
                                 [s.name for s in self.sources], {})


@register_agg("composite")
def _parse_composite(name, body, sub):
    raw_sources = body.get("sources")
    if not isinstance(raw_sources, list) or not raw_sources:
        raise IllegalArgumentException("[composite] requires [sources]")
    sources: List[_CompositeSource] = []
    for entry in raw_sources:
        if not isinstance(entry, dict) or len(entry) != 1:
            raise IllegalArgumentException(
                "[composite] each source is {name: {type: {...}}}")
        sname, spec = next(iter(entry.items()))
        if not isinstance(spec, dict) or len(spec) != 1:
            raise IllegalArgumentException(
                f"[composite] source [{sname}] needs exactly one type")
        kind, opts = next(iter(spec.items()))
        if kind not in ("terms", "histogram", "date_histogram"):
            raise IllegalArgumentException(
                f"[composite] unsupported source type [{kind}]")
        field = (opts or {}).get("field")
        if field is None:
            raise IllegalArgumentException(
                f"[composite] source [{sname}] requires [field]")
        interval = None
        calendar = None
        if kind == "histogram":
            if opts.get("interval") is None:
                raise IllegalArgumentException(
                    f"[composite] histogram source [{sname}] requires "
                    f"[interval]")
            interval = float(opts["interval"])
        elif kind == "date_histogram":
            calendar = opts.get("calendar_interval")
            fixed = opts.get("fixed_interval")
            if calendar is None and fixed is None:
                raise IllegalArgumentException(
                    f"[composite] date_histogram source [{sname}] needs "
                    f"calendar_interval or fixed_interval")
            if fixed is not None:
                interval = float(parse_seconds(str(fixed)) * 1000.0)
                calendar = None
        sources.append(_CompositeSource(sname, kind, field, interval,
                                        calendar))
    after_raw = body.get("after")
    after = None
    if after_raw is not None:
        if not isinstance(after_raw, dict):
            raise IllegalArgumentException("[composite] [after] must be "
                                           "an object")
        missing = [s.name for s in sources if s.name not in after_raw]
        if missing:
            raise IllegalArgumentException(
                f"[composite] [after] missing keys {missing}")
        after = tuple(after_raw[s.name] for s in sources)
    return CompositeAggregator(name, sources,
                               int(body.get("size", 10)), after, sub)


# ---------------------------------------------------------------------------
# significant_terms (JLH heuristic; reference: search/aggregations/
# bucket/terms/SignificantTermsAggregatorFactory + JLHScore)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class InternalSignificantTerms(InternalAggregation):
    size: int
    min_doc_count: int
    subset_size: int
    superset_size: int
    # key → [subset_df, superset_df, sub]
    stats: Dict[Any, List]

    def reduce(self, others):
        subset = self.subset_size
        superset = self.superset_size
        merged = {k: [v[0], v[1], dict(v[2])]
                  for k, v in self.stats.items()}
        for o in others:
            subset += o.subset_size
            superset += o.superset_size
            for k, (s_df, b_df, sub) in o.stats.items():
                cur = merged.get(k)
                if cur is None:
                    merged[k] = [s_df, b_df, dict(sub)]
                else:
                    cur[0] += s_df
                    cur[1] += b_df
                    cur[2] = AggregatorFactories.reduce([cur[2], sub]) \
                        if cur[2] or sub else {}
        return InternalSignificantTerms(self.size, self.min_doc_count,
                                        subset, superset, merged)

    @staticmethod
    def _jlh(s_df, s_size, b_df, b_size) -> float:
        if s_size == 0 or b_size == 0 or s_df == 0:
            return 0.0
        fg = s_df / s_size
        bg = b_df / b_size
        if fg <= bg or bg == 0:
            return 0.0
        return (fg - bg) * (fg / bg)

    def to_response(self) -> Dict[str, Any]:
        scored = []
        for key, (s_df, b_df, sub) in self.stats.items():
            if s_df < self.min_doc_count:
                continue
            score = self._jlh(s_df, self.subset_size, b_df,
                              self.superset_size)
            if score <= 0:
                continue
            scored.append((score, key, s_df, b_df, sub))
        scored.sort(key=lambda t: (-t[0], t[1]))
        buckets = []
        for score, key, s_df, b_df, sub in scored[: self.size]:
            entry = {"key": key, "doc_count": int(s_df),
                     "score": float(score), "bg_count": int(b_df)}
            for sname, agg in sub.items():
                entry[sname] = agg.to_response()
            buckets.append(entry)
        return {"doc_count": int(self.subset_size),
                "bg_count": int(self.superset_size),
                "buckets": buckets}


class SignificantTermsAggregator(Aggregator):
    def __init__(self, name, field, size, shard_size, min_doc_count, sub):
        super().__init__(name, sub)
        self.field = field
        self.size = size
        self.shard_size = shard_size
        self.min_doc_count = min_doc_count

    def collect(self, ctx, mask) -> InternalSignificantTerms:
        n = ctx.view.segment.num_docs
        fg_mask = host_mask(mask)
        bg_mask = ctx.live_mask
        subset_size = int(fg_mask[:n].sum())
        superset_size = int(np.asarray(bg_mask)[:n].sum())
        fg_vals, fg_docs, ord_terms = ctx.field_values(self.field, fg_mask)
        bg_vals, _, _ = ctx.field_values(self.field, bg_mask)

        def count(vals):
            if ord_terms is not None:
                ords = np.asarray(vals, dtype=np.int64)
                c = np.bincount(ords, minlength=len(ord_terms))
                return {ord_terms[i]: int(c[i])
                        for i in np.nonzero(c)[0]}
            uniq, counts = np.unique(vals, return_counts=True)
            return {(int(u) if float(u).is_integer() else float(u)): int(c)
                    for u, c in zip(uniq, counts)}

        fg_counts = count(fg_vals) if len(fg_vals) else {}
        bg_counts = count(bg_vals) if len(bg_vals) else {}
        # shard-side trim by local JLH score bounds coordinator work
        scored = sorted(
            fg_counts.items(),
            key=lambda kv: -InternalSignificantTerms._jlh(
                kv[1], subset_size, bg_counts.get(kv[0], kv[1]),
                superset_size))[: self.shard_size]
        stats: Dict[Any, List] = {}
        if self.sub and ord_terms is not None:
            fg_ords = np.asarray(fg_vals, dtype=np.int64)
            term_ord = {t: i for i, t in enumerate(ord_terms)}
        for key, s_df in scored:
            sub = {}
            if self.sub:
                if ord_terms is not None:
                    sel = fg_ords == term_ord[key]
                else:
                    sel = np.asarray(fg_vals) == key
                bucket_mask = np.zeros_like(fg_mask)
                bucket_mask[fg_docs[sel]] = True
                sub = self.sub.collect(ctx, fg_mask & bucket_mask)
            stats[key] = [s_df, bg_counts.get(key, s_df), sub]
        return InternalSignificantTerms(self.size, self.min_doc_count,
                                        subset_size, superset_size, stats)

    def empty(self) -> InternalSignificantTerms:
        return InternalSignificantTerms(self.size, self.min_doc_count,
                                        0, 0, {})


@register_agg("significant_terms")
def _parse_significant_terms(name, body, sub):
    field = body.get("field")
    if field is None:
        raise IllegalArgumentException("[significant_terms] requires a "
                                       "field")
    size = int(body.get("size", 10))
    shard_size = int(body.get("shard_size", size * 3 // 2 + 10))
    return SignificantTermsAggregator(
        name, field, size, max(size, shard_size),
        int(body.get("min_doc_count", 3)), sub)


# ---------------------------------------------------------------------------
# geohash_grid
# ---------------------------------------------------------------------------

def geohash_encode_batch(lats: np.ndarray, lons: np.ndarray,
                         precision: int) -> List[str]:
    """Vectorized geohash: interleave lon/lat bisection bits across the
    whole array (reference: Geohash utils behind GeoHashGridAggregator).
    5·precision bisection steps over numpy arrays, no per-doc loop."""
    from elasticsearch_tpu_torch.mapping.types import GeoPointFieldType
    n = len(lats)
    nbits = 5 * precision
    lat_lo = np.full(n, -90.0)
    lat_hi = np.full(n, 90.0)
    lon_lo = np.full(n, -180.0)
    lon_hi = np.full(n, 180.0)
    bits = np.zeros((nbits, n), dtype=np.int8)
    for b in range(nbits):
        if b % 2 == 0:  # even bit: longitude
            mid = (lon_lo + lon_hi) / 2
            hi = lons >= mid
            bits[b] = hi
            lon_lo = np.where(hi, mid, lon_lo)
            lon_hi = np.where(hi, lon_hi, mid)
        else:
            mid = (lat_lo + lat_hi) / 2
            hi = lats >= mid
            bits[b] = hi
            lat_lo = np.where(hi, mid, lat_lo)
            lat_hi = np.where(hi, lat_hi, mid)
    alphabet = GeoPointFieldType._GEOHASH32
    chars = np.zeros((precision, n), dtype=np.int8)
    for c in range(precision):
        for k in range(5):
            chars[c] = chars[c] * 2 + bits[c * 5 + k]
    return ["".join(alphabet[chars[c, i]] for c in range(precision))
            for i in range(n)]


class GeoHashGridAggregator(Aggregator):
    """{"geohash_grid": {"field": f, "precision": 1..12, "size": N}} —
    bucket geo points by geohash cell (reference:
    geogrid/GeoHashGridAggregator). Reduces through
    the InternalTerms machinery (count-ordered cells)."""

    def __init__(self, name, field, precision, size, shard_size, sub):
        super().__init__(name, sub)
        self.field = field
        self.precision = precision
        self.size = size
        self.shard_size = shard_size

    def _points(self, ctx: SegmentAggContext, mask):
        from elasticsearch_tpu_torch.mapping.types import GeoPointFieldType
        pack = ctx.view.pack
        n = ctx.view.segment.num_docs
        lat = pack.dv_f64.get(self.field + GeoPointFieldType.LAT_SUFFIX)
        lon = pack.dv_f64.get(self.field + GeoPointFieldType.LON_SUFFIX)
        if lat is None or lon is None:
            return (np.empty(0), np.empty(0),
                    np.empty(0, dtype=np.int64))
        m = host_mask(mask)[:n] & ~np.isnan(lat[:n])
        docs = np.nonzero(m)[0]
        return lat[:n][m], lon[:n][m], docs

    def collect(self, ctx: SegmentAggContext, mask) -> InternalTerms:
        lats, lons, docs = self._points(ctx, mask)
        buckets: Dict[Any, Bucket] = {}
        if len(lats):
            hashes = np.asarray(geohash_encode_batch(
                lats, lons, self.precision))
            uniq, inv = np.unique(hashes, return_inverse=True)
            counts = np.bincount(inv)
            order = np.argsort(-counts, kind="stable")[: self.shard_size]
            for i in order:
                key = str(uniq[i])
                sub = {}
                if self.sub:
                    bucket_mask = np.zeros_like(host_mask(mask))
                    bucket_mask[docs[inv == i]] = True
                    sub = self.sub.collect(
                        ctx, host_mask(mask) & bucket_mask)
                buckets[key] = Bucket(key, int(counts[i]), sub)
        return InternalTerms(self.size, 1, buckets, "_count", False)

    def empty(self) -> InternalTerms:
        return InternalTerms(self.size, 1, {}, "_count", False)


@register_agg("geohash_grid")
def _parse_geohash_grid(name, body, sub):
    field = body.get("field")
    if field is None:
        raise IllegalArgumentException("[geohash_grid] requires a field")
    precision = int(body.get("precision", 5))
    if not 1 <= precision <= 12:
        raise IllegalArgumentException(
            f"[geohash_grid] precision must be in [1, 12], got "
            f"{precision}")
    size = int(body.get("size", 10000))
    shard_size = int(body.get("shard_size", max(size, 10) * 3 // 2 + 10))
    return GeoHashGridAggregator(name, field, precision, size,
                                 max(size, shard_size), sub)
