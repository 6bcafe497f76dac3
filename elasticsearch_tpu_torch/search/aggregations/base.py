"""Aggregations framework: parse, collect per segment, reduce.

Copy of the reference's ``search/aggregations/base.py``:
``AggregatorFactories`` parse the request's JSON tree, each segment's
collectors fill buckets, the segments' and then the shards' partial
``InternalAggregation``s merge by ``reduce``. A bucket is a boolean mask
over the segment's padded doc axis and a metric a masked reduction over
a doc-value column. The query phase's match mask stays on the device it
was computed on (``SegmentAggContext.device``): the device collectors
(``device.py``) read it there, the host collectors read it as numpy
(``host_mask``), and a sub-aggregation's bucket masks are numpy, as in
the reference. ``query_mask`` evaluates a filter through the port's
planner on the context's device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.common.errors import IllegalArgumentException
from elasticsearch_tpu_torch.index.reader import SegmentView, ShardReader
from elasticsearch_tpu_torch.index.segment import MISSING_I64


def host_mask(mask) -> np.ndarray:
    """A doc mask as numpy (a device mask is copied to the host)."""
    if isinstance(mask, torch.Tensor):
        return mask.cpu().numpy()
    return np.asarray(mask)


class SegmentAggContext:
    """One segment's doc values and query machinery for one collect pass,
    on `device` (the query phase's)."""

    def __init__(self, reader: ShardReader, view_idx: int, device=None):
        from elasticsearch_tpu_torch.parallel.device import resolve_device
        self.reader = reader
        self.view_idx = view_idx
        self.view: SegmentView = reader.views[view_idx]
        self.device = resolve_device(device)

    def field_values(self, field: str, mask: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray, Optional[List[str]]]:
        """(values, doc_ords, ord_terms): all values of `field` for docs
        where mask is True, multi-values expanded. For keyword fields the
        values are ordinals and ord_terms maps them to strings."""
        seg = self.view.segment
        pack = self.view.pack
        n = seg.num_docs
        m = host_mask(mask)[:n]
        col = seg.doc_values.get(field)
        if col is None:
            return np.empty(0), np.empty(0, dtype=np.int64), None
        if col.kind == "ord":
            base = col.values[:n]
            sel = m & (base >= 0)
            vals = base[sel].astype(np.int64)
            docs = np.nonzero(sel)[0]
        elif col.kind == "f64":
            base = col.values[:n]
            sel = m & ~np.isnan(base)
            vals = base[sel]
            docs = np.nonzero(sel)[0]
        else:
            base = col.values[:n]
            sel = m & (base != MISSING_I64)
            vals = base[sel]
            docs = np.nonzero(sel)[0]
        if col.extra:
            ev, ed = [], []
            for d, extra_vals in col.extra.items():
                if d < n and m[d]:
                    for v in extra_vals:
                        ev.append(v)
                        ed.append(d)
            if ev:
                if col.kind == "ord":
                    # extras for ord columns are stored as ordinals
                    vals = np.concatenate([vals, np.asarray(ev, dtype=np.int64)])
                else:
                    vals = np.concatenate([vals, np.asarray(ev, dtype=vals.dtype)])
                docs = np.concatenate([docs, np.asarray(ed, dtype=np.int64)])
        return vals, docs, col.ord_terms

    def query_mask(self, query) -> np.ndarray:
        """A DSL query's doc mask (the filter and filters aggs), run by the
        planner on the context's device."""
        from elasticsearch_tpu_torch.search.planner import \
            SegmentQueryExecutor
        executor = SegmentQueryExecutor(self.reader, self.view_idx,
                                        self.device)
        mask, _ = executor._eval(query, scoring=False)
        return host_mask(mask)

    @property
    def live_mask(self) -> np.ndarray:
        return np.asarray(self.view.live_mask)


class InternalAggregation:
    """Shard-level partial result; reduce() merges across shards
    (reference: InternalAggregation#reduce)."""

    def reduce(self, others: Sequence["InternalAggregation"]) -> "InternalAggregation":
        raise NotImplementedError

    def to_response(self) -> Dict[str, Any]:
        raise NotImplementedError


class Aggregator:
    """One aggregation node: collect(segment ctx, mask) → partial."""

    def __init__(self, name: str, sub: "AggregatorFactories"):
        self.name = name
        self.sub = sub

    def collect(self, ctx: SegmentAggContext,
                mask: np.ndarray) -> InternalAggregation:
        raise NotImplementedError

    def empty(self) -> InternalAggregation:
        """Partial for a shard with no matching segment data."""
        raise NotImplementedError


class AggregatorFactories:
    """A parsed {name: aggregator} level of the tree. Pipelines at this
    level run at response-build time on the reduced results (reference:
    PipelineAggregator#reduce over InternalAggregations)."""

    def __init__(self, aggregators: Dict[str, Aggregator],
                 pipelines: Optional[Dict[str, Any]] = None):
        self.aggregators = aggregators
        self.pipelines = pipelines or {}

    def __bool__(self) -> bool:
        return bool(self.aggregators) or bool(self.pipelines)

    def collect(self, ctx: SegmentAggContext,
                mask: np.ndarray) -> Dict[str, InternalAggregation]:
        return {name: agg.collect(ctx, mask)
                for name, agg in self.aggregators.items()}

    def empty(self) -> Dict[str, InternalAggregation]:
        return {name: agg.empty() for name, agg in self.aggregators.items()}

    @staticmethod
    def reduce(parts: Sequence[Dict[str, InternalAggregation]]
               ) -> Dict[str, InternalAggregation]:
        """Merge segment- or shard-level partial maps."""
        if not parts:
            return {}
        out: Dict[str, InternalAggregation] = {}
        for name in parts[0]:
            first, rest = parts[0][name], [p[name] for p in parts[1:]]
            out[name] = first.reduce(rest)
        return out

    @staticmethod
    def to_response(aggs: Dict[str, InternalAggregation]) -> Dict[str, Any]:
        return {name: a.to_response() for name, a in aggs.items()}


_PARSERS: Dict[str, Any] = {}
_PIPELINE_PARSERS: Dict[str, Any] = {}


def register_agg(type_name: str):
    def deco(fn):
        _PARSERS[type_name] = fn
        return fn
    return deco


def register_pipeline(type_name: str):
    def deco(fn):
        _PIPELINE_PARSERS[type_name] = fn
        return fn
    return deco


def parse_aggregations(spec: Dict[str, Any]) -> AggregatorFactories:
    """Parse the request's "aggs" tree (reference: AggregatorFactories#
    parseAggregators): {name: {<type>: {...}, "aggs": {...}}}."""
    aggregators: Dict[str, Aggregator] = {}
    pipelines: Dict[str, Any] = {}
    for name, body in (spec or {}).items():
        if not isinstance(body, dict):
            raise IllegalArgumentException(f"invalid agg [{name}]")
        sub_spec = body.get("aggs") or body.get("aggregations") or {}
        type_keys = [k for k in body if k not in ("aggs", "aggregations", "meta")]
        if len(type_keys) != 1:
            raise IllegalArgumentException(
                f"expected exactly one aggregation type for [{name}], "
                f"got {type_keys}")
        t = type_keys[0]
        if t in _PIPELINE_PARSERS:
            if sub_spec:
                raise IllegalArgumentException(
                    f"pipeline aggregation [{name}] cannot hold sub-"
                    f"aggregations")
            pipelines[name] = _PIPELINE_PARSERS[t](name, body[t])
            continue
        parser = _PARSERS.get(t)
        if parser is None:
            raise IllegalArgumentException(f"unknown aggregation type [{t}]")
        sub = parse_aggregations(sub_spec)
        aggregators[name] = parser(name, body[t], sub)
    return AggregatorFactories(aggregators, pipelines)
