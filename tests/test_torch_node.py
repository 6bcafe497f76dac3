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
from elasticsearch_tpu.parallel.mesh import make_mesh as ref_make_mesh
from elasticsearch_tpu.search.serializer import dumps_response as ref_dumps

from elasticsearch_tpu_torch.node import Node, serve
from elasticsearch_tpu_torch.parallel.mesh import make_mesh
from elasticsearch_tpu_torch.search import gpu_service
from elasticsearch_tpu_torch.search.serializer import dumps_response

from torch_parity_cases import (PARITY_BODIES, TYPED_BODIES,
                                TYPED_MAPPING, bulk_ndjson, make_docs,
                                make_typed_docs)

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
    def __init__(self, ref, port, mesh_port=None):
        self.ref = ref
        self.port = port
        self.log = []   # (label, reference answer, port answer)
        #: a second port node over a (1, 4) CPU mesh: it takes every
        #: request while `mirror` is on (the fixture's writes) and those
        #: sent with mesh=True; its answers go to mesh_log
        self.mesh_port = mesh_port
        self.mirror = mesh_port is not None
        self.mesh_log = []

    def both(self, method, path, body=None, raw=None, params=None,
             kernel=False, mesh=False):
        served = self.ref.tpu_search.served
        want = call(self.ref, ref_dumps, method, path, body, raw, params)
        if kernel:
            assert self.ref.tpu_search.served > served, \
                "the reference did not take its kernel path"
        got = call(self.port, dumps_response, method, path, body, raw,
                   params)
        self.log.append((f"{method} {path}", want, got))
        if self.mesh_port is not None and (self.mirror or mesh):
            self.mesh_log.append((f"{method} {path}", want, call(
                self.mesh_port, dumps_response, method, path, body, raw,
                params)))
        return want, got


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    ref = RefNode(str(tmp_path_factory.mktemp("ref")),
                  settings=RefSettings.of(REF_SETTINGS))
    port = Node(str(tmp_path_factory.mktemp("port")), device="cpu")
    mesh_port = Node(str(tmp_path_factory.mktemp("mesh")),
                     mesh=make_mesh(["cpu"] * 4, (1, 4)))
    p = Pair(ref, port, mesh_port)
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
        p.mirror = False
        yield p
    finally:
        port.close()
        mesh_port.close()
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


@pytest.mark.parametrize("source", [True, False], ids=["source", "nosource"])
@pytest.mark.parametrize("body", PARITY_BODIES,
                         ids=[f"body{i}" for i in range(len(PARITY_BODIES))])
def test_mesh_node_search_bytes_match_reference(pair, body, source):
    """The node laid over a (1, 4) CPU mesh (its 3-shard index padded to
    4 pack rows a segment set, each column's shards searched on their own
    entry, the lists gathered in column order): the reference's bytes,
    and its writes' bytes too."""
    want, _ = pair.both("POST", "/corpus/_search",
                        dict(body, _source=source), kernel=True, mesh=True)
    label, mesh_want, got = pair.mesh_log[-1]
    assert mesh_want is want and want[0] == 200, want
    assert got == want
    assert pair.mesh_port.gpu_search.mesh.shape["shards"] == 4
    for label, want, got in pair.mesh_log:
        if label.split(" ")[1].split("/")[-1] != "_search":
            assert got == want, label


@pytest.mark.parametrize("body", PARITY_BODIES[:4] + PARITY_BODIES[6:],
                         ids=[f"body{i}" for i in (0, 1, 2, 3, 6, 7, 8)])
def test_search_after_forcemerge_and_deletes_matches_reference(pair, body):
    """An index whose later bulk updated and deleted committed docs,
    then force-merged into one segment per shard (the merge keeps the
    reference's doc order, so tied scores come back in its order)."""
    want, got = pair.both("GET", "/merged/_search", body, kernel=True)
    assert want[0] == 200, want
    assert got == want


#: `_source` values other than a bool, on a lowerable match: the
#: reference's kernel path filters a list (``[]`` gives ``{}``) and
#: returns the whole source for every other value but false
SOURCE_VALUES = {"source_filter": ["body"], "source_empty_list": [],
                 "source_null": None, "source_string": "body",
                 "source_string_false": "false", "source_object": {}}


@pytest.mark.parametrize("name", sorted(SOURCE_VALUES))
def test_source_values_match_reference(pair, name):
    body = {"query": {"match": {"body": "alpha beta"}}, "size": 12,
            "_source": SOURCE_VALUES[name]}
    want, got = pair.both("POST", "/corpus/_search", body, kernel=True)
    assert want[0] == 200, want
    assert got == want


#: bodies the reference's query grammar refuses (parsing_exception):
#: an unknown query name, and known names with malformed bodies
GRAMMAR_ERRORS = {
    "unknown_query": {"query": {"no_such_query": {}}},
    "range_not_object": {"query": {"range": {"body": 5}}},
    "exists_no_field": {"query": {"exists": {}}},
    "ids_not_object": {"query": {"ids": 3}},
    "bool_malformed_clause": {"query": {"bool": {"should": [
        {"match": {"body": "alpha"}},
        {"match": {"body": {"operator": "and"}}}]}}},
}


@pytest.mark.parametrize("name", sorted(GRAMMAR_ERRORS))
def test_query_grammar_errors_match_reference(pair, name):
    want, got = pair.both("POST", "/corpus/_search", GRAMMAR_ERRORS[name])
    assert want[0] == 400, want
    assert json.loads(want[1])["error"]["type"] == "parsing_exception"
    assert got == want


@pytest.mark.parametrize("source", [True, False, ["body"]],
                         ids=["source", "nosource", "filtered"])
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


def ndjson(*lines) -> bytes:
    return ("\n".join(json.dumps(x) for x in lines) + "\n").encode()


#: bulk bodies with update items (doc-merge form), each sent to both
#: nodes in this order against the index "upd"
UPDATE_BULKS = {
    # an index then an update of the same doc: the deep merge replaces
    # one key of the nested object and keeps the other
    "merge_nested": ndjson(
        {"index": {"_index": "upd", "_id": "b1"}},
        {"body": "alpha beta", "meta": {"tag": "red", "note": "kept"}},
        {"update": {"_index": "upd", "_id": "b1"}},
        {"doc": {"body": "alpha gamma", "meta": {"tag": "blue"}}}),
    # a missing doc: a per-item 404 without doc_as_upsert, a create with
    "missing_and_upsert": ndjson(
        {"update": {"_index": "upd", "_id": "nope"}},
        {"doc": {"body": "never written"}},
        {"update": {"_index": "upd", "_id": "u2"}},
        {"doc": {"body": "beta upserted"}, "doc_as_upsert": True},
        {"update": {"_index": "upd", "_id": "u2"}},
        {"doc": {"extra": "zeta"}, "doc_as_upsert": True}),
    # "doc" with "script": the reference's per-item validation error
    "doc_and_script": ndjson(
        {"update": {"_index": "upd", "_id": "b1"}},
        {"doc": {"body": "alpha"}, "script": {"source": "ctx._source.x=1"}},
        {"index": {"_index": "upd", "_id": "b3"}},
        {"body": "gamma after the failed item"}),
    # update mixed with delete and create on one _id, in op order
    "mixed_ops": ndjson(
        {"create": {"_index": "upd", "_id": "m1"}}, {"body": "alpha one"},
        {"update": {"_index": "upd", "_id": "m1"}},
        {"doc": {"body": "alpha two", "meta": {"n": "1"}}},
        {"delete": {"_index": "upd", "_id": "m1"}},
        {"update": {"_index": "upd", "_id": "m1"}},
        {"doc": {"body": "gone"}},
        {"create": {"_index": "upd", "_id": "m1"}}, {"body": "beta three"},
        {"update": {"_index": "upd", "_id": "m1"}},
        {"doc": {"meta": {"n": "2"}}},
        {"index": {"_index": "upd", "_id": "m2"}}, {"body": "gamma four"},
        {"update": {"_index": "upd", "_id": "m2"}},
        {"doc": {"body": "gamma five alpha"}}),
}


@pytest.fixture(scope="module")
def updated(pair):
    """The index "upd" after every UPDATE_BULKS body and a _refresh;
    → {name: (reference answer, port answer)}."""
    pair.both("PUT", "/upd", INDEX_BODY)
    out = {name: pair.both("POST", "/_bulk", raw=raw)
           for name, raw in UPDATE_BULKS.items()}
    pair.both("POST", "/upd/_refresh")
    return out


@pytest.mark.parametrize("name", list(UPDATE_BULKS))
def test_bulk_update_items_match_reference(updated, name):
    """A _bulk with update items: the reference node's status and bytes
    (each item's result, _version, _seq_no, status and error)."""
    want, got = updated[name]
    assert want[0] == 200, want
    assert got == want
    assert any("update" in item for item in json.loads(got[1])["items"])


@pytest.mark.parametrize("doc_id", ["b1", "u2", "m1", "m2", "b3", "nope"])
def test_bulk_updated_docs_read_back_as_reference(pair, updated, doc_id):
    want, got = pair.both("GET", f"/upd/_doc/{doc_id}")
    assert got == want
    if doc_id == "b1":
        assert json.loads(got[1])["_source"]["meta"] == {"tag": "blue",
                                                         "note": "kept"}


@pytest.mark.parametrize("text", ["alpha", "gamma beta", "zeta"])
def test_bulk_updated_docs_search_as_reference(pair, updated, text):
    want, got = pair.both("POST", "/upd/_search",
                          {"query": {"match": {"body": text}}},
                          kernel=True)
    assert want[0] == 200, want
    assert got == want


def test_scripted_bulk_update_matches_reference(pair, updated):
    """A bulk with a scripted update item, and a scripted _update with
    params and ctx.op = 'noop': the reference's bytes, and the documents
    read back as the reference's."""
    raw = ndjson({"index": {"_index": "upd", "_id": "s1"}},
                 {"body": "alpha scripted"},
                 {"update": {"_index": "upd", "_id": "b1"}},
                 {"script": {"source": "ctx._source.x = 1"}})
    want, got = pair.both("POST", "/_bulk", raw=raw)
    assert want[0] == 200, want
    assert got == want
    for body in ({"script": {"source": "ctx._source.x += params.n",
                             "params": {"n": 4}}},
                 {"script": "if (ctx._source.x > 100) { ctx._source.x = 0 }"
                            " else { ctx.op = 'noop' }"}):
        want, got = pair.both("POST", "/upd/_update/b1", body)
        assert want[0] == 200, want
        assert got == want
    assert json.loads(want[1])["result"] == "noop"
    for doc_id in ("s1", "b1"):
        want, got = pair.both("GET", f"/upd/_doc/{doc_id}")
        assert want[0] == 200 and got == want
    assert json.loads(got[1])["_source"]["x"] == 5


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


#: bodies the reference answers on its planner path; the port's planner
#: must give its bytes
PLANNER_SERVED = {
    "match_all": {"query": {"match_all": {}}},
    "match_phrase": {"query": {"match_phrase": {"body": "alpha beta"}}},
    "range": {"query": {"range": {"body": {"gte": "a"}}}},
    "bool_must": {"query": {"bool": {"must": [{"term": {"body": "eta"}}]}}},
    "min_score": {"query": {"match": {"body": "alpha"}}, "min_score": 1.0},
    "size_0": {"query": {"match": {"body": "alpha"}}, "size": 0},
    "k_10001": {"query": {"match": {"body": "alpha"}}, "size": 10001},
    "from_9995": {"query": {"match": {"body": "alpha"}}, "from": 9995,
                  "size": 10},
    # served since the sorted query phase and the search contexts came
    # (Queue A5c); a PIT id no node opened is the reference's 404
    "sort": {"query": {"match": {"body": "alpha"}}, "sort": ["_score"]},
    "pit": {"query": {"match": {"body": "alpha"}},
            "pit": {"id": "abc"}},
}

#: planner features the port does not serve yet: a typed 400
PLANNER_BOUND = {
    "aggs": {"query": {"match": {"body": "alpha"}},
             "aggs": {"n": {"value_count": {"field": "body"}}}},
    "knn": {"knn": {"field": "v", "query_vector": [1.0], "k": 1,
                    "num_candidates": 1}},
}


@pytest.mark.parametrize("name", sorted(PLANNER_SERVED))
def test_planner_served_requests_match_reference(pair, name):
    """The planner path: the reference node's status and bytes, on the
    one-device node and on the (1, 4) CPU mesh node."""
    want, got = pair.both("POST", "/corpus/_search", PLANNER_SERVED[name],
                          mesh=True)
    assert got == want
    _, mesh_want, mesh_got = pair.mesh_log[-1]
    assert mesh_want is want
    assert mesh_got == want


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
    """A scroll and a sort on a filtered alias, refused until Queue A5c,
    are served: the reference's bytes (the scroll id aside). Rows of
    more than 1,024 slots, a typed 400 until Queue A3, are served by the
    kernel path on both nodes (a compressed pack): the reference's
    bytes."""
    port = pair.port
    for node in (pair.ref, port):
        node.indices.put_alias("corpus", "filtered400",
                               {"filter": {"term": {"body": "beta"}}})
    for path, params, body in (
            ("/corpus/_search", {"scroll": "1m"},
             {"query": {"match": {"body": "alpha"}}}),
            ("/filtered400/_search", {},
             {"query": {"match": {"body": "alpha"}}, "sort": ["_score"]})):
        want, got = (json.loads(text) for _, text in (
            call(pair.ref, ref_dumps, "POST", path, body, params=params),
            call(port, dumps_response, "POST", path, body,
                 params=params)))
        assert want.pop("_scroll_id", None) is not None or not params
        assert got.pop("_scroll_id", None) is not None or not params
        assert got == want
        assert got["hits"]["hits"]
    # one document of 1,100 distinct words: a terms query of all of them
    # fills 1,100 slots a row (T 2048), past the 1,024 the kernels held
    # before; a train of it takes ~20 s on the reference's interpreted
    # kernel and ~60 s on the port's plain version here, so both waits
    # are raised for it
    words = [f"w{i}" for i in range(1100)]
    pair.both("PUT", "/wide/_doc/1", {"body": " ".join(words)},
              params={"refresh": "true"})
    pair.both("PUT", "/wide/_doc/2", {"body": "w0 w7 w1099"},
              params={"refresh": "true"})
    # the reference's packs on one device of its CPU mesh while it runs
    # (the tests' 8 virtual devices would pad the one shard's rows to 8:
    # ~10 GB), then back on the whole mesh
    tpu = pair.ref.tpu_search
    saved = (tpu.batch_timeout_s, port.gpu_search.batch_timeout_s,
             tpu.packs.mesh)
    tpu.batch_timeout_s = 600.0
    port.gpu_search.batch_timeout_s = 600.0
    tpu.packs.invalidate_all()
    tpu.packs.set_mesh(ref_make_mesh(
        shape=(1, 1), devices=ref_make_mesh().devices.flat[:1]))
    tpu.batcher.mesh = tpu.packs.mesh
    try:
        shapes = dict(port.gpu_search.launch_shapes)
        want, got = pair.both("POST", "/wide/_search",
                              {"query": {"terms": {"body": words}}},
                              kernel=True)
    finally:
        tpu.batch_timeout_s, port.gpu_search.batch_timeout_s = saved[:2]
        tpu.packs.invalidate_all()
        tpu.packs.set_mesh(saved[2])
        tpu.batcher.mesh = saved[2]
    assert want[0] == 200, want
    assert got == want
    assert json.loads(got[1])["hits"]["total"]["value"] == 2
    grown = {s: n - shapes.get(s, 0)
             for s, n in port.gpu_search.launch_shapes.items()}
    assert grown.get((8, 2048, 128)) == 1


@pytest.mark.parametrize("body", [
    {"query": {"match": {"body": "alpha"}}},
    {"query": {"match": {"body": "gamma delta"}}, "size": 30,
     "_source": ["body"]}], ids=["match", "match_source_filter"])
def test_filtered_alias_search_matches_reference(pair, body):
    """A filtered alias joins the request query as a filter clause and
    runs the planner: the reference's bytes."""
    for node in (pair.ref, pair.port, pair.mesh_port):
        if "filtered" not in node.indices.aliases:
            node.indices.put_alias("corpus", "filtered",
                                   {"filter": {"term": {"body": "beta"}}})
    want, got = pair.both("POST", "/filtered/_search", body, mesh=True)
    assert want[0] == 200, want
    assert got == want
    assert pair.mesh_log[-1][2] == want


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
    """A field type of the rarer kinds (ip), refused until Queue A5a-ii
    came, is mapped as the reference maps it: the reference's bytes for
    the index creation, a write and a search, and the same mapping; a
    type neither package maps is the same mapper_parsing_exception; a
    JSON number met by dynamic mapping is a long, as in the reference."""
    want, got = pair.both("PUT", "/typed_ip", {
        "mappings": {"properties": {"addr": {"type": "ip"}}}})
    assert want[0] == 200, want
    assert got == want
    want, got = pair.both("PUT", "/typed_ip/_doc/1", {"addr": "10.1.2.3"},
                          params={"refresh": "true"})
    assert got == want
    want, got = pair.both("POST", "/typed_ip/_search",
                          {"query": {"term": {"addr": "10.1.0.0/16"}}})
    assert want[0] == 200 and '"_id": "1"' in want[1], want
    assert got == want
    assert pair.port.indices.index("typed_ip").mapper.to_mapping() == \
        pair.ref.indices.index("typed_ip").mapper.to_mapping()
    want, got = pair.both("PUT", "/typed_bogus", {
        "mappings": {"properties": {"x": {"type": "bogus_type"}}}})
    err = json.loads(got[1])
    assert got[0] == 400 and got == want
    assert err["error"]["type"] == "mapper_parsing_exception"
    want, got = pair.both("PUT", "/dyn2/_doc/1", {"body": "alpha", "n": 7})
    assert want[0] == 201, want
    assert got == want
    assert pair.port.indices.index("dyn2").mapper.to_mapping() == \
        pair.ref.indices.index("dyn2").mapper.to_mapping()


@pytest.fixture(scope="module")
def typed(pair):
    """The index "typed" (TYPED_MAPPING, 3 shards) on all three nodes:
    a _bulk of make_typed_docs, single writes, a delete, a refresh, a
    second bulk (a second segment per shard) → the write answers."""
    docs = make_typed_docs()
    out = [pair.both("PUT", "/typed", {"settings": {"number_of_shards": 3},
                                       "mappings": TYPED_MAPPING},
                     mesh=True),
           pair.both("POST", "/typed/_bulk", raw=bulk_ndjson(docs[:80]),
                     mesh=True),
           pair.both("PUT", "/typed/_doc/w1",
                     {"body": "alpha beta", "views": 42, "flag": True,
                      "published": "2021-03-04T05:06:07Z",
                      "price": 12.25}, mesh=True),
           pair.both("DELETE", "/typed/_doc/t3", mesh=True),
           pair.both("POST", "/typed/_refresh", mesh=True),
           pair.both("POST", "/typed/_bulk", raw=bulk_ndjson(docs[80:]),
                     mesh=True),
           pair.both("PUT", "/typed/_doc/t10",
                     {"body": "gamma updated", "views": 7, "flag": False},
                     mesh=True),
           pair.both("POST", "/typed/_refresh", mesh=True)]
    return out


def test_typed_writes_match_reference(pair, typed):
    """_bulk and _doc writes of long, double, date, boolean, keyword and
    object fields: the reference's bytes, and the same mapping."""
    for want, got in typed:
        assert got == want
    for label, want, got in pair.mesh_log:
        if "/typed" in label:
            assert got == want, label
    assert pair.port.indices.index("typed").mapper.to_mapping() == \
        pair.ref.indices.index("typed").mapper.to_mapping()


@pytest.mark.parametrize("name", sorted(TYPED_BODIES))
def test_typed_planner_searches_match_reference(pair, typed, name):
    """Range, term, exists, bool and function_score searches over the
    numeric, date and boolean fields: the reference's bytes on both port
    nodes."""
    want, got = pair.both("POST", "/typed/_search", TYPED_BODIES[name],
                          mesh=True)
    assert want[0] == 200, want
    assert got == want
    assert pair.mesh_log[-1][2] == want
