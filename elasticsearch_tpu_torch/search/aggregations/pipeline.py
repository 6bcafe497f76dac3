"""Pipeline aggregations — computed over REDUCED results at
response-build time, never per shard.

Copy of the reference's `search/aggregations/pipeline.py`:
sibling pipelines (avg_bucket, sum_bucket, min_bucket, max_bucket,
stats_bucket) read a metric across a sibling multi-bucket agg via
`buckets_path` ("histo>metric" / "histo>_count"); parent pipelines
(derivative, cumulative_sum) run inside a histogram and add a value to
each bucket. `build_response` is the reduce-phase entry point the
coordinator calls instead of the raw `to_response`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from elasticsearch_tpu_torch.common.errors import IllegalArgumentException
from elasticsearch_tpu_torch.search.aggregations.base import (AggregatorFactories,
                                                        register_pipeline)

SIBLING = "sibling"
PARENT = "parent"


@dataclasses.dataclass
class Pipeline:
    name: str
    kind: str           # "avg_bucket" | ... | "derivative" | ...
    mode: str           # SIBLING | PARENT
    buckets_path: str
    gap_policy: str = "skip"      # "skip" | "insert_zeros"

    # ---------------- path resolution ----------------

    def _metric_from_bucket(self, bucket: Dict[str, Any],
                            segments: List[str]) -> Optional[float]:
        if segments == ["_count"]:
            return float(bucket.get("doc_count", 0))
        node: Any = bucket
        for seg in segments:
            if not isinstance(node, dict) or seg not in node:
                return None
            node = node[seg]
        if isinstance(node, dict):
            node = node.get("value")
        return None if node is None else float(node)

    def _bucket_values(self, host: Dict[str, Any]
                       ) -> List[Optional[float]]:
        """Sibling mode: resolve `agg>metric` against `host` (the dict
        holding the sibling agg's response)."""
        first, _, rest = self.buckets_path.partition(">")
        sibling = host.get(first)
        if not isinstance(sibling, dict) or "buckets" not in sibling:
            raise IllegalArgumentException(
                f"[{self.name}] buckets_path [{self.buckets_path}] must "
                f"point at a multi-bucket aggregation")
        segments = rest.split(">") if rest else ["_count"]
        buckets = sibling["buckets"]
        if isinstance(buckets, dict):  # keyed filters
            buckets = list(buckets.values())
        return [self._metric_from_bucket(b, segments) for b in buckets]

    def _values(self, host: Dict[str, Any]) -> List[float]:
        vals = self._bucket_values(host)
        if self.gap_policy == "insert_zeros":
            return [0.0 if v is None else v for v in vals]
        return [v for v in vals if v is not None]

    # ---------------- sibling computation ----------------

    def _bucket_keys(self, host: Dict[str, Any]) -> List[Any]:
        first, _, _ = self.buckets_path.partition(">")
        buckets = host.get(first, {}).get("buckets", [])
        if isinstance(buckets, dict):
            return list(buckets.keys())
        return [b.get("key") for b in buckets]

    def compute_sibling(self, host: Dict[str, Any]) -> Dict[str, Any]:
        vals = self._values(host)
        if self.kind == "avg_bucket":
            return {"value": sum(vals) / len(vals) if vals else None}
        if self.kind == "sum_bucket":
            return {"value": sum(vals) if vals else 0.0}
        if self.kind in ("min_bucket", "max_bucket"):
            # the response carries WHICH bucket(s) won (reference:
            # InternalBucketMetricValue#keys)
            if not vals:
                return {"value": None, "keys": []}
            best = min(vals) if self.kind == "min_bucket" else max(vals)
            all_vals = self._bucket_values(host)
            if self.gap_policy == "insert_zeros":
                all_vals = [0.0 if v is None else v for v in all_vals]
            keys = [str(k) for k, v in zip(self._bucket_keys(host),
                                           all_vals) if v == best]
            return {"value": best, "keys": keys}
        if self.kind == "stats_bucket":
            if not vals:
                return {"count": 0, "min": None, "max": None,
                        "avg": None, "sum": 0.0}
            return {"count": len(vals), "min": min(vals),
                    "max": max(vals), "avg": sum(vals) / len(vals),
                    "sum": sum(vals)}
        raise IllegalArgumentException(
            f"unknown sibling pipeline [{self.kind}]")

    # ---------------- parent computation ----------------

    def compute_parent(self, buckets: List[Dict[str, Any]]) -> None:
        segments = (self.buckets_path.split(">")
                    if self.buckets_path != "_count" else ["_count"])
        prev: Optional[float] = None
        running = 0.0
        for b in buckets:
            v = self._metric_from_bucket(b, segments)
            if v is None and self.gap_policy == "insert_zeros":
                v = 0.0
            if self.kind == "cumulative_sum":
                running += 0.0 if v is None else v
                b[self.name] = {"value": running}
            elif self.kind == "derivative":
                # first bucket (prev None) has no derivative; under
                # gap_policy=skip a gap bucket emits none and doesn't
                # advance prev (the next derivative spans the gap)
                if v is not None and prev is not None:
                    b[self.name] = {"value": v - prev}
                if v is not None:
                    prev = v


@dataclasses.dataclass
class ScriptPipeline(Pipeline):
    """bucket_script / bucket_selector (reference:
    BucketScriptPipelineAggregationBuilder): `buckets_path` is a MAP of
    script variable → metric path; the expression script computes one
    value per bucket (bucket_script adds it, bucket_selector keeps the
    bucket iff truthy). One of the four subsystems
    the restricted expression engine unlocks."""

    paths: Dict[str, str] = dataclasses.field(default_factory=dict)
    script: Any = None  # CompiledScript

    def _bucket_vars(self, bucket: Dict[str, Any]
                     ) -> Optional[Dict[str, float]]:
        out: Dict[str, float] = {}
        for var, path in self.paths.items():
            segments = (path.split(">") if path != "_count"
                        else ["_count"])
            v = self._metric_from_bucket(bucket, segments)
            if v is None:
                if self.gap_policy == "insert_zeros":
                    v = 0.0
                else:
                    return None  # skip: bucket lacks an input
            out[var] = v
        return out

    def compute_parent(self, buckets: List[Dict[str, Any]]) -> None:
        from elasticsearch_tpu_torch.script import ScriptException
        keep: List[Dict[str, Any]] = []
        for b in buckets:
            vars_in = self._bucket_vars(b)
            if vars_in is None:
                if self.kind == "bucket_script":
                    continue            # no value emitted for the gap
                keep.append(b)          # selector: gaps are kept
                continue
            try:
                result = self.script.execute(
                    {"params": {**self.script.params, **vars_in},
                     **vars_in})
            except ScriptException as e:
                raise IllegalArgumentException(
                    f"[{self.kind}] [{self.name}] script failed: "
                    f"{e.args[0] if e.args else e}") from None
            if self.kind == "bucket_script":
                if result is not None and not isinstance(
                        result, (int, float)):
                    raise IllegalArgumentException(
                        f"[bucket_script] [{self.name}] must return a "
                        f"number, got [{type(result).__name__}]")
                if result is not None:
                    b[self.name] = {"value": float(result)}
            else:  # bucket_selector
                if bool(result):
                    keep.append(b)
        if self.kind == "bucket_selector":
            buckets[:] = keep


def apply_pipelines(factories: AggregatorFactories,
                    node: Dict[str, Any]) -> None:
    """Walk the response tree alongside the parsed agg tree, recursing
    into buckets, then materialize this level's pipelines."""
    for name, agg in factories.aggregators.items():
        sub = getattr(agg, "sub", None)
        if sub is None or not sub:
            continue
        entry = node.get(name)
        if not isinstance(entry, dict):
            continue
        buckets = entry.get("buckets")
        if isinstance(buckets, list):
            for b in buckets:
                apply_pipelines(sub, b)
            for pname, pipe in sub.pipelines.items():
                if pipe.mode == PARENT:
                    pipe.compute_parent(buckets)
        else:
            # keyed filters (dict buckets) and single-bucket parents
            # cannot host a sequential parent pipeline — reject, never
            # silently drop (reference: 400 on invalid placement)
            for pname, pipe in sub.pipelines.items():
                if pipe.mode == PARENT:
                    raise IllegalArgumentException(
                        f"[{pipe.kind}] aggregation [{pname}] must be "
                        f"declared inside an ordered multi-bucket "
                        f"aggregation (histogram)")
            if isinstance(buckets, dict):
                for b in buckets.values():
                    apply_pipelines(sub, b)
            else:
                # single-bucket agg: sub responses flattened in place
                apply_pipelines(sub, entry)
    for pname, pipe in factories.pipelines.items():
        # PARENT pipelines at this level were computed by the enclosing
        # multi-bucket agg above (build_response rejects top-level ones)
        if pipe.mode == SIBLING:
            node[pname] = pipe.compute_sibling(node)


def build_response(factories: AggregatorFactories,
                   reduced: Dict[str, Any]) -> Dict[str, Any]:
    """Reduced internal aggs → response JSON with pipelines applied
    (the coordinator's final-reduce hook)."""
    out = AggregatorFactories.to_response(reduced)
    # top-level parent pipelines are invalid (no enclosing buckets)
    for pname, pipe in factories.pipelines.items():
        if pipe.mode == PARENT:
            raise IllegalArgumentException(
                f"[{pipe.kind}] aggregation [{pname}] must be declared "
                f"inside a multi-bucket aggregation")
    apply_pipelines(factories, out)
    return out


def _parse(kind: str, mode: str):
    def parser(name, body) -> Pipeline:
        path = (body or {}).get("buckets_path")
        if not path:
            raise IllegalArgumentException(
                f"[{kind}] requires [buckets_path]")
        gap = str((body or {}).get("gap_policy", "skip"))
        if gap not in ("skip", "insert_zeros"):
            raise IllegalArgumentException(
                f"[{kind}] unknown gap_policy [{gap}]")
        return Pipeline(name, kind, mode, str(path), gap)
    return parser


for _kind in ("avg_bucket", "sum_bucket", "min_bucket", "max_bucket",
              "stats_bucket"):
    register_pipeline(_kind)(_parse(_kind, SIBLING))
for _kind in ("derivative", "cumulative_sum"):
    register_pipeline(_kind)(_parse(_kind, PARENT))


def _parse_script_pipeline(kind: str):
    def parser(name, body) -> ScriptPipeline:
        body = body or {}
        paths = body.get("buckets_path")
        if not isinstance(paths, dict) or not paths:
            raise IllegalArgumentException(
                f"[{kind}] requires [buckets_path] as an object of "
                f"script variable → metric path")
        if "script" not in body:
            raise IllegalArgumentException(f"[{kind}] requires [script]")
        from elasticsearch_tpu_torch.script import (ScriptException,
                                              compile_script)
        try:
            script = compile_script(body["script"])
        except ScriptException as e:
            raise IllegalArgumentException(
                f"[{kind}] {e.args[0] if e.args else e}") from None
        gap = str(body.get("gap_policy", "skip"))
        if gap not in ("skip", "insert_zeros"):
            raise IllegalArgumentException(
                f"[{kind}] unknown gap_policy [{gap}]")
        return ScriptPipeline(
            name, kind, PARENT, "", gap,
            paths={str(k): str(v) for k, v in paths.items()},
            script=script)
    return parser


for _kind in ("bucket_script", "bucket_selector"):
    register_pipeline(_kind)(_parse_script_pipeline(_kind))
