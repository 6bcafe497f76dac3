"""Port copy of ``test_aggs_longtail.py``: composite (after-key paging),
significant_terms (JLH), pipeline aggs, and t-digest percentiles.

Every request goes to a reference node and a port node
(``torch_rest_pair.Pair``): status and response bytes must be equal,
``took`` at 0; the original assertions then run on the reference's
answer. The t-digest cases hold the port's ``TDigest`` against the
reference's, quantiles and centroids bit for bit, and against the
original expectations."""

from __future__ import annotations

import json

import numpy as np
import pytest

from elasticsearch_tpu.search.aggregations.metrics import \
    TDigest as RefTDigest

from elasticsearch_tpu_torch.search.aggregations.metrics import TDigest
from torch_rest_pair import Pair


def _handle(node, method, path, params=None, body=None):
    """One request to both nodes of the pair: the same status and bytes
    → (status, the parsed answer)."""
    return node.same(method, path, body=body, params=params)


@pytest.fixture
def node(tmp_path):
    n = Pair(tmp_path, {"search.tpu_serving.enabled": "false"})
    yield n
    n.close()


@pytest.fixture
def sales(node):
    """12 docs over 3 categories x 2 stores, values 1..12; indexed in
    two batches with a flush between so multiple segments exercise the
    segment-level reduce too."""
    _handle(node, "PUT", "/sales", body={"mappings": {"properties": {
        "cat": {"type": "keyword"}, "store": {"type": "keyword"},
        "value": {"type": "integer"}, "day": {"type": "integer"}}}})
    docs = []
    cats = ["kitchen", "garden", "toys"]
    for i in range(12):
        docs.append({"cat": cats[i % 3], "store": f"s{i % 2}",
                     "value": i + 1, "day": i // 4})
    for i, d in enumerate(docs[:6]):
        _handle(node, "PUT", f"/sales/_doc/{i}",
                params={"refresh": "true"}, body=d)
    _handle(node, "POST", "/sales/_flush")
    for i, d in enumerate(docs[6:], start=6):
        _handle(node, "PUT", f"/sales/_doc/{i}",
                params={"refresh": "true"}, body=d)
    return node


def _agg(node, aggs, size=0, index="sales"):
    status, res = _handle(node, "POST", f"/{index}/_search",
                          body={"size": size, "aggs": aggs})
    assert status == 200, res
    return res.get("aggregations", {})


class TestComposite:
    def test_first_page_and_after_key(self, sales):
        out = _agg(sales, {"pages": {"composite": {
            "size": 2,
            "sources": [{"c": {"terms": {"field": "cat"}}}]}}})
        buckets = out["pages"]["buckets"]
        assert [b["key"]["c"] for b in buckets] == ["garden", "kitchen"]
        assert all(b["doc_count"] == 4 for b in buckets)
        assert out["pages"]["after_key"] == {"c": "kitchen"}

    def test_paging_walks_everything_exactly_once(self, sales):
        seen = []
        after = None
        while True:
            spec = {"composite": {
                "size": 2,
                "sources": [{"c": {"terms": {"field": "cat"}}},
                            {"s": {"terms": {"field": "store"}}}]}}
            if after is not None:
                spec["composite"]["after"] = after
            out = _agg(sales, {"p": spec})
            buckets = out["p"]["buckets"]
            if not buckets:
                break
            seen.extend((b["key"]["c"], b["key"]["s"], b["doc_count"])
                        for b in buckets)
            after = out["p"]["after_key"]
        # 3 cats × 2 stores, 2 docs each, ascending key order, no dups
        assert len(seen) == 6
        assert len(set((c, s) for c, s, _ in seen)) == 6
        assert seen == sorted(seen)
        assert all(n == 2 for _, _, n in seen)

    def test_histogram_source_and_subaggs(self, sales):
        out = _agg(sales, {"p": {
            "composite": {
                "size": 10,
                "sources": [{"d": {"histogram": {"field": "day",
                                                 "interval": 1}}}]},
            "aggs": {"total": {"sum": {"field": "value"}}}}})
        buckets = out["p"]["buckets"]
        assert [b["key"]["d"] for b in buckets] == [0.0, 1.0, 2.0]
        # days 0,1,2 hold values 1-4, 5-8, 9-12
        assert [b["total"]["value"] for b in buckets] == [10.0, 26.0, 42.0]

    def test_after_requires_all_keys(self, sales):
        status, res = _handle(sales, "POST", "/sales/_search", body={
            "size": 0, "aggs": {"p": {"composite": {
                "sources": [{"a": {"terms": {"field": "cat"}}},
                            {"b": {"terms": {"field": "store"}}}],
                "after": {"a": "x"}}}}})
        assert status == 400


class TestSignificantTerms:
    def test_jlh_finds_overrepresented_terms(self, node):
        # background: "common" everywhere; "rare" only in the red docs
        _handle(node, "PUT", "/sig", body={"mappings": {"properties": {
            "color": {"type": "keyword"}, "tag": {"type": "keyword"}}}})
        for i in range(20):
            color = "red" if i < 5 else "blue"
            tag = "rare" if i < 5 else "common"
            _handle(node, "PUT", f"/sig/_doc/{i}",
                    params={"refresh": "true"},
                    body={"color": color, "tag": tag})
        status, res = _handle(node, "POST", "/sig/_search", body={
            "size": 0,
            "query": {"term": {"color": "red"}},
            "aggs": {"sig": {"significant_terms": {"field": "tag"}}}})
        assert status == 200, res
        sig = res["aggregations"]["sig"]
        assert sig["doc_count"] == 5          # foreground size
        assert sig["bg_count"] == 20          # background size
        keys = [b["key"] for b in sig["buckets"]]
        assert keys == ["rare"]               # "common" isn't significant
        b = sig["buckets"][0]
        assert b["doc_count"] == 5 and b["bg_count"] == 5
        assert b["score"] > 0

    def test_min_doc_count_filters(self, node):
        _handle(node, "PUT", "/sig2", body={"mappings": {"properties": {
            "color": {"type": "keyword"}, "tag": {"type": "keyword"}}}})
        for i in range(10):
            _handle(node, "PUT", f"/sig2/_doc/{i}",
                    params={"refresh": "true"},
                    body={"color": "red" if i == 0 else "blue",
                          "tag": "solo" if i == 0 else "common"})
        status, res = _handle(node, "POST", "/sig2/_search", body={
            "size": 0,
            "query": {"term": {"color": "red"}},
            "aggs": {"sig": {"significant_terms": {
                "field": "tag", "min_doc_count": 3}}}})
        assert res["aggregations"]["sig"]["buckets"] == []


class TestPipelines:
    def test_sibling_pipelines(self, sales):
        out = _agg(sales, {
            "days": {"histogram": {"field": "day", "interval": 1},
                     "aggs": {"total": {"sum": {"field": "value"}}}},
            "avg_day": {"avg_bucket": {"buckets_path": "days>total"}},
            "best_day": {"max_bucket": {"buckets_path": "days>total"}},
            "worst_day": {"min_bucket": {"buckets_path": "days>total"}},
            "sum_days": {"sum_bucket": {"buckets_path": "days>total"}},
            "stats_days": {"stats_bucket": {"buckets_path": "days>total"}},
        })
        assert out["avg_day"]["value"] == pytest.approx(26.0)
        assert out["best_day"]["value"] == 42.0
        assert out["worst_day"]["value"] == 10.0
        assert out["sum_days"]["value"] == 78.0
        assert out["stats_days"]["count"] == 3
        assert out["stats_days"]["avg"] == pytest.approx(26.0)

    def test_count_path(self, sales):
        out = _agg(sales, {
            "days": {"histogram": {"field": "day", "interval": 1}},
            "avg_count": {"avg_bucket": {"buckets_path": "days>_count"}}})
        assert out["avg_count"]["value"] == pytest.approx(4.0)

    def test_parent_pipelines(self, sales):
        out = _agg(sales, {"days": {
            "histogram": {"field": "day", "interval": 1},
            "aggs": {"total": {"sum": {"field": "value"}},
                     "delta": {"derivative": {"buckets_path": "total"}},
                     "running": {"cumulative_sum": {
                         "buckets_path": "total"}}}}})
        buckets = out["days"]["buckets"]
        assert "delta" not in buckets[0]
        assert buckets[1]["delta"]["value"] == pytest.approx(16.0)
        assert buckets[2]["delta"]["value"] == pytest.approx(16.0)
        assert [b["running"]["value"] for b in buckets] == \
            [10.0, 36.0, 78.0]

    def test_max_bucket_reports_winning_keys(self, sales):
        out = _agg(sales, {
            "days": {"histogram": {"field": "day", "interval": 1},
                     "aggs": {"total": {"sum": {"field": "value"}}}},
            "best": {"max_bucket": {"buckets_path": "days>total"}}})
        assert out["best"]["value"] == 42.0
        assert out["best"]["keys"] == ["2.0"]

    def test_derivative_insert_zeros_emits_on_gaps(self, sales):
        # interval 5 over day values 0..2 leaves no gaps; test the
        # pipeline directly on a synthetic bucket list instead
        from elasticsearch_tpu.search.aggregations.pipeline import \
            Pipeline, PARENT
        buckets = [{"key": 0, "m": {"value": 5.0}},
                   {"key": 1, "m": {"value": None}},
                   {"key": 2, "m": {"value": 7.0}}]
        pipe = Pipeline("d", "derivative", PARENT, "m",
                        gap_policy="insert_zeros")
        pipe.compute_parent(buckets)
        assert buckets[1]["d"]["value"] == -5.0
        assert buckets[2]["d"]["value"] == 7.0
        # skip policy: gap emits nothing, next derivative spans the gap
        buckets = [{"key": 0, "m": {"value": 5.0}},
                   {"key": 1, "m": {"value": None}},
                   {"key": 2, "m": {"value": 7.0}}]
        Pipeline("d", "derivative", PARENT, "m").compute_parent(buckets)
        assert "d" not in buckets[1]
        assert buckets[2]["d"]["value"] == 2.0

    def test_parent_pipeline_under_filter_rejected(self, sales):
        status, _ = _handle(sales, "POST", "/sales/_search", body={
            "size": 0, "aggs": {"f": {
                "filter": {"match_all": {}},
                "aggs": {"bad": {"cumulative_sum": {
                    "buckets_path": "_count"}}}}}})
        assert status == 400

    def test_composite_after_type_mismatch_400(self, sales):
        status, _ = _handle(sales, "POST", "/sales/_search", body={
            "size": 0, "aggs": {"p": {"composite": {
                "sources": [{"c": {"terms": {"field": "cat"}}}],
                "after": {"c": 3}}}}})
        assert status == 400

    def test_parent_pipeline_at_top_level_rejected(self, sales):
        status, _ = _handle(sales, "POST", "/sales/_search", body={
            "size": 0, "aggs": {
                "days": {"histogram": {"field": "day", "interval": 1}},
                "bad": {"derivative": {"buckets_path": "days>_count"}}}})
        assert status == 400

    def test_pipeline_cannot_hold_subaggs(self, sales):
        status, _ = _handle(sales, "POST", "/sales/_search", body={
            "size": 0, "aggs": {"bad": {
                "avg_bucket": {"buckets_path": "x>y"},
                "aggs": {"inner": {"avg": {"field": "value"}}}}}})
        assert status == 400


class TestTDigestPercentiles:
    def test_exact_on_small_sets(self, sales):
        out = _agg(sales, {"p": {"percentiles": {
            "field": "value", "percents": [50.0]}}})
        assert out["p"]["values"]["50"] == pytest.approx(6.5, abs=0.6)

    def test_accuracy_on_large_streams(self):
        rng = np.random.default_rng(7)
        values = rng.normal(100.0, 15.0, size=50_000)
        # shard-style: 10 digests merged pairwise like a reduce
        digests = [TDigest(100.0).add_values(chunk)
                   for chunk in np.array_split(values, 10)]
        merged = digests[0]
        for d in digests[1:]:
            merged = merged.merge(d)
        ref = [RefTDigest(100.0).add_values(chunk)
               for chunk in np.array_split(values, 10)]
        ref_merged = ref[0]
        for d in ref[1:]:
            ref_merged = ref_merged.merge(d)
        assert merged.means.tobytes() == ref_merged.means.tobytes()
        assert merged.weights.tobytes() == ref_merged.weights.tobytes()
        for q in (1, 25, 50, 75, 99):
            assert merged.quantile(q) == ref_merged.quantile(q)
        # bounded memory: centroid count is O(compression), not O(values)
        assert len(merged.means) < 1000
        for q in (1, 25, 50, 75, 99):
            exact = float(np.percentile(values, q))
            est = merged.quantile(q)
            assert est == pytest.approx(exact, abs=1.0), q

    def test_min_max_endpoints_exact(self):
        vals = np.asarray([3.0, 9.0, 1.0, 7.0])
        d = TDigest(100.0).add_values(vals)
        ref = RefTDigest(100.0).add_values(vals)
        assert [d.quantile(q) for q in (0, 50, 100)] == \
            [ref.quantile(q) for q in (0, 50, 100)]
        assert d.quantile(0) == 1.0
        assert d.quantile(100) == 9.0

    def test_empty_yields_nulls(self, node):
        _handle(node, "PUT", "/e/_doc/1", params={"refresh": "true"},
                body={"x": "text only"})
        out = _agg(node, {"p": {"percentiles": {"field": "missing_num"}}},
                   index="e")
        assert all(v is None for v in out["p"]["values"].values())
