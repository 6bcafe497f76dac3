"""Port copy of ``test_aggregations.py``: the AggregatorTestCase pattern
(fixed docs, an aggregation, its expected values) plus the cross-shard
reduce and sub-aggregation nesting.

Each body goes to a reference node and a port node
(``torch_rest_pair.Pair``) as a ``size: 0`` search over the same docs
in 1, 2 or 3 segments (a refresh between batches) of one shard: status
and response bytes must be equal, ``took`` at 0; the original
assertions then run on the answer's aggregations."""

import json

import numpy as np
import pytest

from torch_rest_pair import Pair

MAPPING = {"properties": {
    "category": {"type": "keyword"},
    "price": {"type": "double"},
    "qty": {"type": "long"},
    "day": {"type": "date"},
    "desc": {"type": "text"},
    "tags": {"type": "keyword"},
}}

DOCS = [
    {"category": "fruit", "price": 1.5, "qty": 10, "day": "2024-01-01T10:00:00Z", "desc": "red apple", "tags": ["fresh", "cheap"]},
    {"category": "fruit", "price": 3.0, "qty": 4, "day": "2024-01-02T10:00:00Z", "desc": "green pear", "tags": ["fresh"]},
    {"category": "veg", "price": 0.5, "qty": 50, "day": "2024-02-01T10:00:00Z", "desc": "orange carrot", "tags": ["cheap"]},
    {"category": "veg", "price": 2.0, "qty": 8, "day": "2024-02-15T10:00:00Z", "desc": "green pepper", "tags": []},
    {"category": "meat", "price": 9.0, "qty": 2, "day": "2024-03-01T10:00:00Z", "desc": "red steak", "tags": ["expensive"]},
    {"category": "fruit", "price": 2.5, "qty": 6, "day": "2024-03-02T10:00:00Z", "desc": "yellow banana", "tags": ["cheap"]},
]


def _load(pair, index, docs, n_segments, shards=1):
    pair.same("PUT", f"/{index}", {
        "settings": {"number_of_shards": shards}, "mappings": MAPPING})
    per = (len(docs) + n_segments - 1) // n_segments
    for si in range(n_segments):
        lines = []
        for i, doc in enumerate(docs[si * per:(si + 1) * per]):
            lines.append(json.dumps({"index": {"_id": f"d{si * per + i}"}}))
            lines.append(json.dumps(doc))
        pair.same("POST", f"/{index}/_bulk", params={"refresh": "true"},
                  raw=("\n".join(lines) + "\n").encode())


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    p = Pair(tmp_path_factory.mktemp("aggs_pair"))
    for n in (1, 2, 3):
        _load(p, f"seg{n}", DOCS, n)
    _load(p, "half0", DOCS[:3], 1)
    _load(p, "half1", DOCS[3:], 1)
    yield p
    p.close()


#: set by the module's autouse fixture: the pair run_aggs sends to
_PAIR = []


@pytest.fixture(autouse=True)
def _use_pair(pair):
    _PAIR[:] = [pair]
    yield


def run_aggs(spec, query=None, n_segments=1, index=None):
    """The aggregations of a size-0 search over the docs in
    `n_segments` segments, the same bytes from both nodes."""
    body = {"size": 0, "query": query or {"match_all": {}}, "aggs": spec}
    status, out = _PAIR[0].same("POST", f"/{index or f'seg{n_segments}'}"
                                "/_search", body)
    assert status == 200, out
    return out["aggregations"]


class TestMetrics:
    @pytest.mark.parametrize("n_segments", [1, 3])
    def test_stats_family(self, n_segments):
        out = run_aggs({"p_avg": {"avg": {"field": "price"}},
                        "p_min": {"min": {"field": "price"}},
                        "p_max": {"max": {"field": "price"}},
                        "p_sum": {"sum": {"field": "price"}},
                        "p_cnt": {"value_count": {"field": "price"}},
                        "p_stats": {"stats": {"field": "price"}}},
                       n_segments=n_segments)
        prices = [d["price"] for d in DOCS]
        assert out["p_avg"]["value"] == pytest.approx(np.mean(prices))
        assert out["p_min"]["value"] == min(prices)
        assert out["p_max"]["value"] == max(prices)
        assert out["p_sum"]["value"] == pytest.approx(sum(prices))
        assert out["p_cnt"]["value"] == len(prices)
        assert out["p_stats"]["count"] == len(prices)
        assert out["p_stats"]["avg"] == pytest.approx(np.mean(prices))

    def test_metrics_under_query(self):
        out = run_aggs({"s": {"sum": {"field": "qty"}}},
                       query={"term": {"category": "fruit"}})
        assert out["s"]["value"] == 10 + 4 + 6

    def test_cardinality(self):
        out = run_aggs({"c": {"cardinality": {"field": "category"}}},
                       n_segments=2)
        assert out["c"]["value"] == 3
        out = run_aggs({"c": {"cardinality": {"field": "qty"}}})
        assert out["c"]["value"] == 6

    def test_percentiles(self):
        out = run_aggs({"p": {"percentiles": {"field": "price",
                                              "percents": [50, 100]}}},
                       n_segments=2)
        prices = sorted(d["price"] for d in DOCS)
        assert out["p"]["values"]["100"] == pytest.approx(max(prices))
        assert out["p"]["values"]["50"] == pytest.approx(np.percentile(prices, 50))

    def test_top_hits(self):
        out = run_aggs({"cats": {"terms": {"field": "category"},
                                 "aggs": {"top": {"top_hits": {"size": 2}}}}})
        fruit = next(b for b in out["cats"]["buckets"] if b["key"] == "fruit")
        assert fruit["top"]["hits"]["total"]["value"] == 3
        assert len(fruit["top"]["hits"]["hits"]) == 2


class TestTerms:
    @pytest.mark.parametrize("n_segments", [1, 2, 3])
    def test_keyword_terms_count_order(self, n_segments):
        out = run_aggs({"cats": {"terms": {"field": "category"}}},
                       n_segments=n_segments)
        buckets = out["cats"]["buckets"]
        assert [(b["key"], b["doc_count"]) for b in buckets] == \
            [("fruit", 3), ("veg", 2), ("meat", 1)]
        assert out["cats"]["sum_other_doc_count"] == 0

    def test_multi_valued_keyword(self):
        out = run_aggs({"t": {"terms": {"field": "tags"}}})
        got = {b["key"]: b["doc_count"] for b in out["t"]["buckets"]}
        assert got == {"cheap": 3, "fresh": 2, "expensive": 1}

    def test_numeric_terms(self):
        out = run_aggs({"q": {"terms": {"field": "qty", "size": 3}}})
        assert len(out["q"]["buckets"]) == 3
        assert all(b["doc_count"] == 1 for b in out["q"]["buckets"])

    def test_size_and_other_count(self):
        out = run_aggs({"cats": {"terms": {"field": "category", "size": 1}}})
        assert len(out["cats"]["buckets"]) == 1
        assert out["cats"]["buckets"][0]["key"] == "fruit"
        assert out["cats"]["sum_other_doc_count"] == 3

    def test_key_order(self):
        out = run_aggs({"cats": {"terms": {"field": "category",
                                           "order": {"_key": "asc"}}}})
        assert [b["key"] for b in out["cats"]["buckets"]] == \
            ["fruit", "meat", "veg"]

    def test_sub_aggregation(self):
        out = run_aggs({"cats": {"terms": {"field": "category"},
                                 "aggs": {"avg_p": {"avg": {"field": "price"}}}}},
                       n_segments=2)
        by_key = {b["key"]: b for b in out["cats"]["buckets"]}
        assert by_key["fruit"]["avg_p"]["value"] == pytest.approx((1.5 + 3.0 + 2.5) / 3)
        assert by_key["meat"]["avg_p"]["value"] == pytest.approx(9.0)


class TestHistogram:
    def test_numeric_histogram(self):
        # reference default min_doc_count=0: empty buckets fill the range
        out = run_aggs({"h": {"histogram": {"field": "price", "interval": 2}}})
        got = {b["key"]: b["doc_count"] for b in out["h"]["buckets"]}
        assert got == {0.0: 2, 2.0: 3, 4.0: 0, 6.0: 0, 8.0: 1}
        out = run_aggs({"h": {"histogram": {"field": "price", "interval": 2,
                                            "min_doc_count": 1}}})
        got = {b["key"]: b["doc_count"] for b in out["h"]["buckets"]}
        assert got == {0.0: 2, 2.0: 3, 8.0: 1}

    def test_min_doc_count_zero_fills_gaps(self):
        out = run_aggs({"h": {"histogram": {"field": "price", "interval": 2,
                                            "min_doc_count": 0}}})
        keys = [b["key"] for b in out["h"]["buckets"]]
        assert keys == [0.0, 2.0, 4.0, 6.0, 8.0]

    def test_date_histogram_calendar_month(self):
        out = run_aggs({"d": {"date_histogram": {"field": "day",
                                                 "calendar_interval": "month"}}},
                       n_segments=2)
        buckets = out["d"]["buckets"]
        assert [b["doc_count"] for b in buckets] == [2, 2, 2]
        assert buckets[0]["key_as_string"].startswith("2024-01-01T00:00:00")

    def test_date_histogram_fixed(self):
        out = run_aggs({"d": {"date_histogram": {"field": "day",
                                                 "fixed_interval": "30d"}}})
        assert sum(b["doc_count"] for b in out["d"]["buckets"]) == 6


class TestRangeFiltersMissing:
    def test_range(self):
        out = run_aggs({"r": {"range": {"field": "price", "ranges": [
            {"to": 2.0}, {"from": 2.0, "to": 5.0}, {"from": 5.0}]}}})
        b = out["r"]["buckets"]
        assert [x["doc_count"] for x in b] == [2, 3, 1]
        assert b[0]["to"] == 2.0 and "from" not in b[0]
        assert b[1]["from"] == 2.0 and b[1]["to"] == 5.0

    def test_filter_and_filters(self):
        out = run_aggs({
            "cheap": {"filter": {"range": {"price": {"lt": 2.0}}},
                      "aggs": {"n": {"value_count": {"field": "price"}}}},
            "split": {"filters": {"filters": {
                "red": {"match": {"desc": "red"}},
                "green": {"match": {"desc": "green"}}}}},
        })
        assert out["cheap"]["doc_count"] == 2
        assert out["cheap"]["n"]["value"] == 2
        assert out["split"]["buckets"]["red"]["doc_count"] == 2
        assert out["split"]["buckets"]["green"]["doc_count"] == 2

    def test_missing_and_global(self):
        out = run_aggs({"no_tags": {"missing": {"field": "tags"}}},
                       query={"match_all": {}})
        assert out["no_tags"]["doc_count"] == 1
        out = run_aggs({"all": {"global": {},
                                "aggs": {"n": {"value_count": {"field": "price"}}}}},
                       query={"term": {"category": "meat"}})
        assert out["all"]["doc_count"] == 6  # ignores the query
        assert out["all"]["n"]["value"] == 6


class TestReduceAcrossShards:
    def test_shard_level_reduce_matches_single(self):
        """Sharded collect + reduce == single-shard collect (the two-level
        reduce contract): the docs split over two indices searched
        together give the single index's aggregations."""
        spec = {"cats": {"terms": {"field": "category"},
                         "aggs": {"s": {"stats": {"field": "price"}}}},
                "h": {"histogram": {"field": "qty", "interval": 10}}}
        single = run_aggs(spec, n_segments=1)
        assert run_aggs(spec, index="half0,half1") == single


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_agg_mix_matches_reference(tmp_path, seed):
    """torch_rest_pair's aggregation mix (terms, histograms, stats,
    pipelines under random queries) over two shards of two segments
    each: the reference node's status and bytes, request by request."""
    import torch_rest_pair

    rng = np.random.default_rng(seed)
    p = Pair(tmp_path)
    try:
        p.same("PUT", "/mix", {"settings": {"number_of_shards": 2},
                               "mappings": torch_rest_pair.AGG_MIX_MAPPING})
        for batch in range(2):
            lines = []
            for i, doc in enumerate(torch_rest_pair.random_agg_docs(rng,
                                                                    200)):
                lines.append(json.dumps({"index": {"_id": f"{batch}-{i}"}}))
                lines.append(json.dumps(doc))
            p.same("POST", "/mix/_bulk", params={"refresh": "true"},
                   raw=("\n".join(lines) + "\n").encode())
        for _ in range(25):
            status, _ = p.same("POST", "/mix/_search",
                               torch_rest_pair.random_agg_body(rng))
            assert status in (200, 400)
    finally:
        p.close()


def test_aggs_under_collapse_and_min_score_match_reference(pair):
    """Aggregations beside collapse (a size-0 query phase of their own
    per shard) and under min_score (the final match mask): the
    reference node's bytes."""
    for body in (
            {"query": {"match": {"desc": "red green"}},
             "collapse": {"field": "category"}, "size": 3,
             "aggs": {"cats": {"terms": {"field": "category"},
                               "aggs": {"p": {"sum": {"field": "price"}}}}}},
            {"query": {"match": {"desc": "red green"}}, "min_score": 0.5,
             "aggs": {"q": {"stats": {"field": "qty"}},
                      "h": {"histogram": {"field": "price",
                                          "interval": 2}}}}):
        status, out = pair.same("POST", "/seg3/_search", body)
        assert status == 200 and "aggregations" in out
