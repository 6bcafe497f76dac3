"""The port's node against the reference's node, request for request.

Both nodes get the same ``node.handle(...)`` sequence: an index with 3
shards and the ``body`` text mapping, a ``_bulk`` of the parity corpus,
single-document writes, ``_refresh``, the parity ``_search`` bodies with
``_source`` on and off, a two-index search, a force-merged index, and an
index created by dynamic mapping. Every response is compared as the
bytes ``dumps_response`` renders (what the HTTP layer sends), with
``took`` set to 0 on both sides.

JAX side: ``elasticsearch_tpu.node.Node`` on the virtual CPU mesh with
``search.tpu_serving.kernel.pallas`` on (the fused kernel in interpret
mode); each search must be served by its kernel path. Port side:
``Node(..., device="cpu")``, the plain torch path of the merge kernel.
"""

import http.client
import json

import pytest
import torch

from elasticsearch_tpu.common.settings import Settings as RefSettings
from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.search.serializer import dumps_response as ref_dumps

from elasticsearch_tpu_torch.node import Node, serve
from elasticsearch_tpu_torch.search import gpu_service
from elasticsearch_tpu_torch.search.serializer import dumps_response

from torch_parity_cases import PARITY_BODIES, bulk_ndjson, make_docs

torch.set_num_threads(1)

MAPPING = {"properties": {"body": {"type": "text"}}}
INDEX_BODY = {"settings": {"number_of_shards": 3}, "mappings": MAPPING}
REF_SETTINGS = {"search.tpu_serving.kernel.pallas": True,
                "search.flight_recorder.enabled": False}


def call(node, dumps, method, path, body=None, raw=None, params=None):
    """One request through node.handle → (status, response bytes with
    took = 0)."""
    if raw is None:
        raw = json.dumps(body).encode() if body is not None else b""
    status, payload = node.handle(method, path, dict(params or {}), None,
                                  raw)
    if isinstance(payload, dict) and "took" in payload:
        payload["took"] = 0
    return status, dumps(payload)


class Pair:
    def __init__(self, ref, port):
        self.ref = ref
        self.port = port
        self.log = []   # (label, reference answer, port answer)

    def both(self, method, path, body=None, raw=None, params=None,
             kernel=False):
        served = self.ref.tpu_search.served
        want = call(self.ref, ref_dumps, method, path, body, raw, params)
        if kernel:
            assert self.ref.tpu_search.served > served, \
                "the reference did not take its kernel path"
        got = call(self.port, dumps_response, method, path, body, raw,
                   params)
        self.log.append((f"{method} {path}", want, got))
        return want, got


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    ref = RefNode(str(tmp_path_factory.mktemp("ref")),
                  settings=RefSettings.of(REF_SETTINGS))
    port = Node(str(tmp_path_factory.mktemp("port")), device="cpu")
    p = Pair(ref, port)
    docs = make_docs()
    try:
        for name in ("corpus", "merged"):
            p.both("PUT", f"/{name}", INDEX_BODY)
            p.both("POST", f"/{name}/_bulk", raw=bulk_ndjson(docs))
            p.both("PUT", f"/{name}/_doc/x1",
                   {"body": "alpha beta extra words"})
            p.both("GET", f"/{name}/_doc/x1")
            p.both("PUT", f"/{name}/_doc/d5", {"body": "gamma gamma zeta"})
            p.both("DELETE", f"/{name}/_doc/d3")
            p.both("DELETE", f"/{name}/_doc/nope")
            p.both("POST", f"/{name}/_refresh")
        # a second bulk after the refresh: a second segment per shard,
        # updates and deletes of committed docs among its ops
        p.both("POST", "/_bulk", raw=bulk_ndjson(
            [(f"d{i}", {"body": "delta epsilon alpha"})
             for i in range(0, 40, 3)], index="merged")
            + b'{"delete": {"_index": "merged", "_id": "d10"}}\n'
            + b'{"create": {"_index": "merged", "_id": "d11"}}\n'
            + b'{"body": "exists already"}\n'
            + b'{"create": {"_index": "merged", "_id": "c1"}}\n'
            + b'{"body": "alpha created"}\n')
        p.both("POST", "/_refresh")
        p.both("POST", "/merged/_forcemerge")
        p.both("POST", "/merged/_refresh")
        p.both("PUT", "/other", {"settings": {"number_of_shards": 2},
                                 "mappings": MAPPING})
        p.both("POST", "/other/_bulk", raw=bulk_ndjson(
            [(f"o{i}", src) for i, (_, src) in enumerate(make_docs(60, 7))]))
        p.both("POST", "/other/_refresh")
        yield p
    finally:
        port.close()
        ref.close()


def test_write_responses_match_reference(pair):
    """Index creation, _bulk (index, create, delete; a create conflict),
    _doc put/get/delete (and a delete of a missing doc), _refresh and
    _forcemerge: the same status and bytes, _seq_no, _primary_term,
    _version, result and _shards included."""
    assert len(pair.log) >= 20
    for label, want, got in pair.log:
        assert got == want, label


@pytest.mark.parametrize("source", [True, False], ids=["source", "nosource"])
@pytest.mark.parametrize("body", PARITY_BODIES,
                         ids=[f"body{i}" for i in range(len(PARITY_BODIES))])
def test_search_bytes_match_reference(pair, body, source):
    want, got = pair.both("POST", "/corpus/_search",
                          dict(body, _source=source), kernel=True)
    assert want[0] == 200, want
    assert got == want


@pytest.mark.parametrize("body", PARITY_BODIES[:4] + PARITY_BODIES[6:],
                         ids=[f"body{i}" for i in (0, 1, 2, 3, 6, 7, 8)])
def test_search_after_forcemerge_and_deletes_matches_reference(pair, body):
    """An index whose later bulk updated and deleted committed docs,
    then force-merged into one segment per shard (the merge keeps the
    reference's doc order, so tied scores come back in its order)."""
    want, got = pair.both("GET", "/merged/_search", body, kernel=True)
    assert want[0] == 200, want
    assert got == want


@pytest.mark.parametrize("source", [True, False], ids=["source", "nosource"])
def test_two_index_search_matches_reference(pair, source):
    body = {"query": {"match": {"body": "alpha beta gamma"}}, "size": 50,
            "_source": source}
    want, got = pair.both("POST", "/corpus,other/_search", body,
                          kernel=True)
    assert want[0] == 200, want
    assert got == want
    hits = json.loads(got[1])["hits"]["hits"]
    assert {h["_index"] for h in hits} == {"corpus", "other"}


def test_dynamic_mapping_index_matches_reference(pair):
    """No mapping: strings map to text with a .keyword sub-field."""
    docs = [(f"y{i}", {"title": f"alpha {w} beta", "tag": f"t{i % 3}"})
            for i, w in enumerate(["gamma", "delta", "gamma", "zeta"] * 5)]
    want, got = pair.both("POST", "/dyn/_bulk", raw=bulk_ndjson(docs))
    assert got == want
    pair.both("POST", "/dyn/_refresh")
    for body in ({"query": {"match": {"title": "gamma alpha"}}},
                 {"query": {"term": {"tag": "t1"}}, "size": 4}):
        want, got = pair.both("POST", "/dyn/_search", body, kernel=True)
        assert want[0] == 200, want
        assert got == want
    mapping = pair.port.indices.index("dyn").mapper.to_mapping()
    assert mapping == pair.ref.indices.index("dyn").mapper.to_mapping()


def test_serve_returns_the_bytes_of_handle(pair):
    """One _search over HTTP (an ephemeral port, http.client): the same
    body bytes as handle + dumps_response, and the reference's headers."""
    body = {"query": {"match": {"body": "alpha gamma"}}, "size": 20}
    server = serve(pair.port, "127.0.0.1", 0)
    try:
        conn = http.client.HTTPConnection(*server.server_address,
                                          timeout=60)
        conn.request("POST", "/corpus/_search", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
    assert resp.status == 200
    assert resp.getheader("Content-Type") == \
        "application/json; charset=UTF-8"
    assert resp.getheader("X-elastic-product") == "Elasticsearch-TPU"
    assert int(resp.getheader("Content-Length")) == len(data)
    got = json.loads(data)
    got["took"] = 0
    status, want = call(pair.port, dumps_response, "POST",
                        "/corpus/_search", body)
    assert status == 200
    assert dumps_response(got) == json.dumps(json.loads(want))
    # the bytes past "took" are the handle's bytes verbatim
    assert data.split(b",", 1)[1] == want.encode().split(b",", 1)[1]


def test_restart_with_translog_replay_answers_the_same_bytes(
        pair, tmp_path):
    """A flushed commit plus translog ops above it (a bulk, an update and
    a delete of committed docs): the port node restarted on its data
    path replays the tail and answers what the reference node answers."""
    ref = RefNode(str(tmp_path / "ref"), settings=RefSettings.of(
        REF_SETTINGS))
    path = str(tmp_path / "port")
    port = Node(path, device="cpu")
    p = Pair(ref, port)
    docs = make_docs(120, 3)
    bodies = [PARITY_BODIES[0], PARITY_BODIES[3], PARITY_BODIES[6]]
    try:
        p.both("PUT", "/r", INDEX_BODY)
        p.both("POST", "/r/_bulk", raw=bulk_ndjson(docs[:80]))
        p.both("POST", "/r/_refresh")
        for node in (ref, port):
            node.indices.index("r").flush()
        p.both("POST", "/r/_bulk", raw=bulk_ndjson(docs[80:]))
        p.both("PUT", "/r/_doc/d7", {"body": "alpha alpha beta"})
        p.both("DELETE", "/r/_doc/d9")
        p.both("POST", "/r/_refresh")
        before = [p.both("POST", "/r/_search", b, kernel=True)
                  for b in bodies]
        for label, want, got in p.log:
            assert got == want, label
        port.close()
        port = p.port = Node(path, device="cpu")
        replayed = sum(s.engine.replayed_ops for s in
                       port.indices.index("r").shards.values())
        assert replayed == 42  # 40 bulk ops, the update and the delete
        for b, (want, _) in zip(bodies, before):
            got = call(port, dumps_response, "POST", "/r/_search", b)
            assert got == want
        assert call(port, dumps_response, "GET", "/r/_doc/d9")[0] == 404
    finally:
        port.close()
        ref.close()


PLANNER_BOUND = {
    "match_all": {"query": {"match_all": {}}},
    "match_phrase": {"query": {"match_phrase": {"body": "alpha beta"}}},
    "range": {"query": {"range": {"body": {"gte": "a"}}}},
    "bool_must": {"query": {"bool": {"must": [{"term": {"body": "eta"}}]}}},
    "min_score": {"query": {"match": {"body": "alpha"}}, "min_score": 1.0},
    "size_0": {"query": {"match": {"body": "alpha"}}, "size": 0},
    "k_10001": {"query": {"match": {"body": "alpha"}}, "size": 10001},
    "from_9995": {"query": {"match": {"body": "alpha"}}, "from": 9995,
                  "size": 10},
    "sort": {"query": {"match": {"body": "alpha"}}, "sort": ["_score"]},
    "aggs": {"query": {"match": {"body": "alpha"}},
             "aggs": {"n": {"value_count": {"field": "body"}}}},
    "source_filter": {"query": {"match": {"body": "alpha"}},
                      "_source": ["body"]},
    "knn": {"knn": {"field": "v", "query_vector": [1.0], "k": 1,
                    "num_candidates": 1}},
    "pit": {"query": {"match": {"body": "alpha"}},
            "pit": {"id": "abc"}},
}


@pytest.mark.parametrize("name", sorted(PLANNER_BOUND))
def test_planner_bound_requests_get_a_typed_400(pair, name):
    status, text = call(pair.port, dumps_response, "POST",
                        "/corpus/_search", PLANNER_BOUND[name])
    err = json.loads(text)
    assert status == 400, err
    assert err["error"]["type"] == "not_lowerable"
    assert "planner path" in err["error"]["reason"]
    assert err["error"]["root_cause"][0]["type"] == "not_lowerable"


def test_scroll_filtered_alias_and_wide_rows_get_a_typed_400(pair):
    port = pair.port
    bodies = [("/corpus/_search", {"scroll": "1m"},
               {"query": {"match": {"body": "alpha"}}})]
    port.indices.put_alias("corpus", "filtered",
                           {"filter": {"term": {"body": "beta"}}})
    bodies.append(("/filtered/_search", {},
                   {"query": {"match": {"body": "alpha"}}}))
    # one document of 1100 distinct words: a terms query of all of them
    # needs more than the kernel's 1024 slots a row
    words = [f"w{i}" for i in range(1100)]
    call(port, dumps_response, "PUT", "/wide/_doc/1",
         {"body": " ".join(words)}, params={"refresh": "true"})
    bodies.append(("/wide/_search", {}, {"query": {"terms": {"body": words}}}))
    for path, params, body in bodies:
        status, text = call(port, dumps_response, "POST", path, body,
                            params=params)
        err = json.loads(text)
        assert status == 400, (path, err)
        assert err["error"]["type"] == "not_lowerable", (path, err)


def test_kernel_fault_reaches_the_client_as_5xx(pair, monkeypatch):
    """No fallback: a fault inside the kernel launch is a 500 with the
    fault in its error body, not an answer from another path."""
    def boom(*args, **kwargs):
        raise RuntimeError("injected kernel fault")

    monkeypatch.setattr(gpu_service, "_launch_exact", boom)
    status, text = call(pair.port, dumps_response, "POST", "/corpus/_search",
                        {"query": {"match": {"body": "alpha"}}})
    err = json.loads(text)
    assert status == 500, err
    assert err["error"]["type"] == "runtime_error"
    assert err["error"]["reason"] == "injected kernel fault"
    assert "hits" not in err


def test_unported_field_type_is_refused_with_the_reference_body(pair):
    status, text = call(pair.port, dumps_response, "PUT", "/typed", {
        "mappings": {"properties": {"n": {"type": "long"}}}})
    err = json.loads(text)
    assert status == 400
    assert err["error"]["type"] == "mapper_parsing_exception"
    assert "[long]" in err["error"]["reason"]
    status, text = call(pair.port, dumps_response, "PUT", "/dyn2/_doc/1",
                        {"body": "alpha", "n": 7})
    err = json.loads(text)
    assert status == 400
    assert err["error"]["type"] == "mapper_parsing_exception"
    assert "[long]" in err["error"]["reason"]
