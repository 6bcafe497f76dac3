"""Port copy of ``test_device_aggs.py``: the device reductions
(``search/aggregations/device.py`` over ``ops/agg_kernel.py``) against
the host numpy collectors, terms / histogram / date_histogram / stats /
cardinality / one-level sub-aggs, on a seeded two-shard index.

Every body goes to a reference node and a port node
(``torch_rest_pair.Pair``): the device path's bytes must be equal, and
so must the host path's, with every device helper of both packages
forced to decline; the original comparison of the two paths (float
tolerance: numpy's sums associate differently) then runs on the
answers."""

from __future__ import annotations

import json

import numpy as np
import pytest

from torch_rest_pair import Pair


@pytest.fixture()
def node(tmp_path):
    n = Pair(tmp_path, {"search.tpu_serving.enabled": "false"})
    yield n
    n.close()


def _h(node, method, path, params=None, body=None):
    """One request to both nodes: the same status and bytes → (status,
    the parsed answer)."""
    return node.same(method, path, body=body, params=params)


@pytest.fixture()
def seeded(node):
    rng = np.random.default_rng(11)
    s, b = _h(node, "PUT", "/m", body={
        "settings": {"number_of_shards": 2},
        "mappings": {"properties": {
            "tag": {"type": "keyword"}, "n": {"type": "integer"},
            "x": {"type": "double"},
            "when": {"type": "date"}}}})
    assert s == 200, b
    tags = ["a", "b", "c", "d", "e"]
    lines = []
    for i in range(300):
        src = {"tag": tags[int(rng.integers(0, 5))],
               "n": int(rng.integers(0, 50)),
               "x": float(rng.normal(10, 3)),
               "when": int(1_700_000_000_000 + rng.integers(0, 10)
                           * 86_400_000)}
        if i % 17 == 0:
            src.pop("n")  # missing values must not count
        lines.append(json.dumps({"index": {"_id": str(i)}}))
        lines.append(json.dumps(src))
    s, b = node.same("POST", "/m/_bulk",
                     raw=("\n".join(lines) + "\n").encode())
    assert s == 200, b
    _h(node, "POST", "/m/_refresh")
    return node, rng


_HELPERS = ("terms_counts", "histogram_counts", "numeric_stats",
            "ord_presence", "bounded_bucket_counts", "terms_numeric_stats")


def _host_only(monkeypatch):
    """Force every device helper of both packages to decline, driving
    the numpy path."""
    from elasticsearch_tpu.search.aggregations import device as ref_device

    from elasticsearch_tpu_torch.search.aggregations import device
    for module in (ref_device, device):
        for name in _HELPERS:
            monkeypatch.setattr(module, name, lambda *a, **k: None)


AGG_BODIES = [
    {"aggs": {"t": {"terms": {"field": "tag", "size": 10}}}, "size": 0},
    {"aggs": {"h": {"histogram": {"field": "n", "interval": 7}}},
     "size": 0},
    {"aggs": {"d": {"date_histogram": {"field": "when",
                                       "fixed_interval": "1d"}}},
     "size": 0},
    {"aggs": {"s": {"stats": {"field": "x"}}}, "size": 0},
    {"aggs": {"s": {"sum": {"field": "n"}},
              "m": {"max": {"field": "x"}},
              "a": {"avg": {"field": "n"}},
              "c": {"value_count": {"field": "n"}}}, "size": 0},
    # filtered query: the mask reaching the collectors is non-trivial
    {"query": {"range": {"n": {"gte": 10, "lt": 40}}},
     "aggs": {"t": {"terms": {"field": "tag"}},
              "s": {"stats": {"field": "x"}}}, "size": 0},
    # ---- phase 2 (VERDICT r4 item 8) ----
    # cardinality via the device presence bitmap
    {"aggs": {"c": {"cardinality": {"field": "tag"}}}, "size": 0},
    # calendar intervals via device searchsorted buckets
    {"aggs": {"d": {"date_histogram": {"field": "when",
                                       "calendar_interval": "month"}}},
     "size": 0},
    {"aggs": {"d": {"date_histogram": {"field": "when",
                                       "calendar_interval": "week"}}},
     "size": 0},
    # one-level numeric metric sub-aggs under terms, on device
    {"aggs": {"t": {"terms": {"field": "tag"},
                    "aggs": {"mx": {"max": {"field": "n"}},
                             "s": {"stats": {"field": "x"}},
                             "a": {"avg": {"field": "x"}}}}},
     "size": 0},
    {"query": {"range": {"n": {"gte": 5}}},
     "aggs": {"t": {"terms": {"field": "tag"},
                    "aggs": {"sm": {"sum": {"field": "n"}}}}},
     "size": 0},
]


def _approx_equal(a, b, rel=1e-12):
    """Structural equality with float tolerance (summation order differs
    between the device reduction and numpy by last-ulp amounts)."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(
            _approx_equal(a[k], b[k], rel) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(
            _approx_equal(x, y, rel) for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        return a == pytest.approx(b, rel=rel)
    return a == b


@pytest.mark.parametrize("body_idx", range(len(AGG_BODIES)))
def test_device_matches_host(seeded, monkeypatch, body_idx):
    node, _ = seeded
    body = AGG_BODIES[body_idx]
    s, dev = _h(node, "POST", "/m/_search", body=dict(body))
    assert s == 200, dev
    _host_only(monkeypatch)
    s, host = _h(node, "POST", "/m/_search", body=dict(body))
    assert s == 200, host
    assert _approx_equal(dev["aggregations"], host["aggregations"]), \
        (dev["aggregations"], host["aggregations"])


def test_sub_aggs_still_work(seeded):
    """Sub-aggregations force the host path (per-bucket masks) and keep
    composing with device-collected siblings."""
    node, _ = seeded
    s, b = _h(node, "POST", "/m/_search", body={
        "aggs": {"t": {"terms": {"field": "tag"},
                       "aggs": {"mx": {"max": {"field": "n"}}}}},
        "size": 0})
    assert s == 200, b
    buckets = b["aggregations"]["t"]["buckets"]
    assert buckets and all("mx" in bk for bk in buckets)
    assert sum(bk["doc_count"] for bk in buckets) == 300


def test_delete_index_drops_the_agg_columns(tmp_path):
    """DELETE /{index} drops the device columns the aggregations cached
    on its segments' packs (on the card, the memory comes back:
    test_torch_aggs_gpu.py)."""
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.search.aggregations import device

    node = Node(str(tmp_path / "port"), device="cpu")
    try:
        node.handle("PUT", "/m", {}, None, json.dumps({
            "settings": {"number_of_shards": 2},
            "mappings": {"properties": {"tag": {"type": "keyword"},
                                        "x": {"type": "double"}}}}).encode())
        lines = []
        for i in range(50):
            lines.append(json.dumps({"index": {"_id": str(i)}}))
            lines.append(json.dumps({"tag": f"t{i % 3}", "x": i * 0.5}))
        node.handle("POST", "/m/_bulk", {"refresh": "true"}, None,
                    ("\n".join(lines) + "\n").encode())
        before = device.cached_bytes()
        status, _ = node.handle("POST", "/m/_search", {}, None, json.dumps({
            "size": 0, "aggs": {"t": {"terms": {"field": "tag"},
                                      "aggs": {"s": {"sum": {
                                          "field": "x"}}}}}}).encode())
        assert status == 200
        packs = [v.segment._pack
                 for shard in node.indices.index("m").shards.values()
                 for v in shard.acquire_searcher().views]
        assert all(p._dev_cols for p in packs)
        assert device.cached_bytes() > before
        status, _ = node.handle("DELETE", "/m", {}, None, b"")
        assert status == 200
        assert all(not p._dev_cols for p in packs)
        assert device.cached_bytes() == before
    finally:
        node.close()
