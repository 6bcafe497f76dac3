"""Port copy of ``test_rest.py``, and the rest of the REST routes of one
node: ``_msearch``, ``_count``, ``_mget``, ``_create``, ``_update``,
``_field_caps``, ``_validate/query``, ``_explain`` and ``_termvectors``.

Every request goes to the reference node and the port node
(``torch_rest_pair``); status and response bytes must be equal, with
``took`` at 0 and only the fields of ``torch_rest_pair.MASKED`` masked.
The reference runs its fused kernel in interpret mode on the CPU, the
port its plain torch path. ``test_aggs_through_rest`` (aggregations,
Queue A8) is in ``test_torch_node.py``. ``GET /`` names
each node's own build, so the root case checks the port's fields only.
"""

import http.client
import json

import pytest
import torch

from elasticsearch_tpu_torch.node import serve
from elasticsearch_tpu_torch.search.serializer import dumps_response

from torch_rest_pair import Pair, call

torch.set_num_threads(1)


@pytest.fixture
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.close()


def ndjson(*objs):
    return ("\n".join(json.dumps(o) for o in objs) + "\n").encode()


PRODUCTS = [
    ("1", "red running shoes", "nike", 90.0),
    ("2", "blue running shorts", "nike", 30.0),
    ("3", "red casual shoes", "adidas", 70.0),
    ("4", "green tennis racket", "wilson", 120.0),
    ("5", "red tennis balls", "wilson", 8.0),
]


def seed_products(pair):
    pair.same("PUT", "/prod", {
        "settings": {"index": {"number_of_shards": 3}},
        "mappings": {"properties": {
            "name": {"type": "text"},
            "brand": {"type": "keyword"},
            "price": {"type": "double"}}}})
    for pid, name, brand, price in PRODUCTS:
        pair.same("PUT", f"/prod/_doc/{pid}",
                  {"name": name, "brand": brand, "price": price})
    pair.same("POST", "/prod/_refresh")


@pytest.fixture
def seeded(pair):
    seed_products(pair)
    return pair


class TestRootAndHealth:
    def test_root(self, pair):
        status, text = call(pair.port, dumps_response, "GET", "/")
        body = json.loads(text)
        assert status == 200
        assert body["tagline"].startswith("You Know, for Search")
        assert body["version"]["build_flavor"] == "cuda"

    @pytest.mark.parametrize("params", [{}, {"wait_for_status": "green"}],
                             ids=["plain", "wait_for_green"])
    def test_health_green(self, pair, params):
        status, body = pair.same("GET", "/_cluster/health", params=params)
        assert status == 200 and body["status"] == "green"


class TestIndexAdmin:
    def test_create_get_delete(self, pair):
        status, body = pair.same("PUT", "/books", {
            "settings": {"index": {"number_of_shards": 2}},
            "mappings": {"properties": {"title": {"type": "text"},
                                        "year": {"type": "integer"}}}})
        assert status == 200 and body["acknowledged"]
        status, body = pair.same("GET", "/books")
        assert status == 200
        assert body["books"]["settings"]["index"]["number_of_shards"] == "2"
        assert body["books"]["mappings"]["properties"]["year"]["type"] \
            == "integer"
        assert pair.same("HEAD", "/books")[0] == 200
        assert pair.same("DELETE", "/books")[0] == 200
        assert pair.same("GET", "/books")[0] == 404

    def test_put_mapping_merge(self, pair):
        pair.same("PUT", "/idx", {})
        status, _ = pair.same("PUT", "/idx/_mapping", {
            "properties": {"brand": {"type": "keyword"}}})
        assert status == 200
        _, body = pair.same("GET", "/idx/_mapping")
        assert body["idx"]["mappings"]["properties"]["brand"]["type"] \
            == "keyword"
        # a type change is the reference's 400
        status, _ = pair.same("PUT", "/idx/_mapping", {
            "properties": {"brand": {"type": "long"}}})
        assert status == 400

    def test_invalid_name_400(self, pair):
        status, body = pair.same("PUT", "/BadName")
        assert status == 400
        assert "invalid index name" in body["error"]["reason"]


class TestDocumentCrud:
    def test_index_get_delete_cycle(self, pair):
        status, body = pair.same("PUT", "/idx/_doc/1", {"title": "hello"})
        assert status == 201 and body["result"] == "created"
        assert body["_seq_no"] == 0 and body["_version"] == 1
        status, body = pair.same("PUT", "/idx/_doc/1",
                                 {"title": "hello again"})
        assert status == 200 and body["result"] == "updated"
        status, body = pair.same("GET", "/idx/_doc/1")
        assert status == 200 and body["_source"]["title"] == "hello again"
        status, body = pair.same("DELETE", "/idx/_doc/1")
        assert status == 200 and body["result"] == "deleted"
        status, body = pair.same("GET", "/idx/_doc/1")
        assert status == 404 and body["found"] is False

    def test_auto_id_and_409_on_conflict(self, pair):
        # an auto id is drawn at random by each node: the bodies must
        # be equal but for it
        (ws, want), (gs, got) = pair.both("POST", "/idx/_doc", {"a": 1})
        want, got = json.loads(want), json.loads(got)
        assert ws == gs == 201
        assert len(want.pop("_id")) == len(got.pop("_id")) == 20
        assert got == want
        pair.same("PUT", "/idx/_doc/x", {"a": 1})
        status, body = pair.same("PUT", "/idx/_doc/x", {"a": 2},
                                 params={"if_seq_no": "99",
                                         "if_primary_term": "1"})
        assert status == 409
        assert body["error"]["type"] == "version_conflict_engine_exception"

    def test_update_doc_merge(self, pair):
        pair.same("PUT", "/idx/_doc/1", {"a": {"b": 1}, "c": 2})
        status, body = pair.same("POST", "/idx/_update/1",
                                 {"doc": {"a": {"d": 3}}})
        assert status == 200 and body["result"] == "updated"
        _, body = pair.same("GET", "/idx/_doc/1")
        assert body["_source"] == {"a": {"b": 1, "d": 3}, "c": 2}

    def test_update_forms(self, pair):
        """A merge that changes nothing is a noop; a missing doc is a
        404 unless doc_as_upsert or upsert; a body with neither doc nor
        script, or with both, is a 400."""
        pair.same("PUT", "/idx/_doc/1", {"a": 1})
        for body in ({"doc": {"a": 1}}, {"doc": {"a": 1},
                                         "detect_noop": False}):
            pair.same("POST", "/idx/_update/1", body)
        status, body = pair.same("POST", "/idx/_update/2", {"doc": {"a": 2}})
        assert status == 404
        assert body["error"]["type"] == "document_missing_exception"
        status, _ = pair.same("POST", "/idx/_update/2",
                              {"doc": {"a": 2}, "doc_as_upsert": True})
        assert status == 200
        status, _ = pair.same("POST", "/idx/_update/3",
                              {"doc": {"a": 3}, "upsert": {"a": 0}})
        assert status == 200
        _, body = pair.same("GET", "/idx/_doc/3")
        assert body["_source"] == {"a": 0}
        for bad in ({}, {"doc": {"a": 1}, "script": "ctx._source.a = 2"}):
            assert pair.same("POST", "/idx/_update/1", bad)[0] == 400

    def test_scripted_update_is_refused(self, pair):
        """A scripted _update, refused until the script module came
        (Queue A5c), is served: the reference's bytes, and the document
        updated as the reference updates it."""
        pair.same("PUT", "/idx/_doc/1", {"a": 1})
        status, _ = pair.same("POST", "/idx/_update/1",
                              {"script": {"source": "ctx._source.a = 2"}})
        assert status == 200
        _, body = pair.same("GET", "/idx/_doc/1")
        assert body["_source"] == {"a": 2}

    def test_mget(self, pair):
        pair.same("PUT", "/idx/_doc/1", {"v": 1})
        pair.same("PUT", "/idx/_doc/2", {"v": 2})
        status, body = pair.same("POST", "/_mget", {
            "docs": [{"_index": "idx", "_id": "1"},
                     {"_index": "idx", "_id": "404"},
                     {"_index": "nope", "_id": "1"}]})
        assert status == 200
        assert body["docs"][0]["_source"]["v"] == 1
        assert body["docs"][1]["found"] is False
        _, body = pair.same("GET", "/idx/_mget", {"ids": ["2", "1"]})
        assert [d["_source"]["v"] for d in body["docs"]] == [2, 1]
        assert pair.same("POST", "/_mget", {})[0] == 400


class TestBulk:
    def test_bulk_mixed(self, pair):
        nd = ndjson({"index": {"_index": "logs", "_id": "1"}},
                    {"msg": "first event"},
                    {"index": {"_index": "logs", "_id": "2"}},
                    {"msg": "second event"},
                    {"delete": {"_index": "logs", "_id": "1"}},
                    {"create": {"_index": "logs", "_id": "3"}},
                    {"msg": "third"})
        status, body = pair.same("POST", "/_bulk", raw=nd,
                                 params={"refresh": "true"})
        assert status == 200 and body["errors"] is False
        kinds = [next(iter(i)) for i in body["items"]]
        assert kinds == ["index", "index", "delete", "create"]
        _, body = pair.same("GET", "/logs/_count")
        assert body["count"] == 2

    def test_bulk_create_conflict_flagged(self, pair):
        pair.same("PUT", "/idx/_doc/1", {"a": 1})
        nd = ndjson({"create": {"_index": "idx", "_id": "1"}}, {"a": 2})
        status, body = pair.same("POST", "/_bulk", raw=nd)
        assert status == 200 and body["errors"] is True


class TestSearch:
    def test_match_query_matching(self, seeded):
        status, body = seeded.same("POST", "/prod/_search", {
            "query": {"match": {"name": "red shoes"}}})
        assert status == 200
        assert {h["_id"] for h in body["hits"]["hits"]} == {"1", "3", "5"}
        assert body["hits"]["total"]["value"] == 3
        assert body["hits"]["hits"][0]["_index"] == "prod"

    def test_match_ranking_single_shard(self, pair):
        pair.same("PUT", "/r1", {
            "settings": {"index": {"number_of_shards": 1}},
            "mappings": {"properties": {"name": {"type": "text"}}}})
        for pid, name in [("1", "red running shoes"),
                          ("3", "red casual shoes"),
                          ("5", "red tennis balls")]:
            pair.same("PUT", f"/r1/_doc/{pid}", {"name": name})
        pair.same("POST", "/r1/_refresh")
        _, body = pair.same("POST", "/r1/_search", {
            "query": {"match": {"name": "red shoes"}}})
        ids = [h["_id"] for h in body["hits"]["hits"]]
        assert set(ids[:2]) == {"1", "3"} and ids[2] == "5"

    def test_bool_filter_and_source_filtering(self, seeded):
        _, body = seeded.same("POST", "/prod/_search", {
            "query": {"bool": {
                "must": [{"match": {"name": "red"}}],
                "filter": [{"range": {"price": {"gte": 50}}}]}},
            "_source": ["name"]})
        assert {h["_id"] for h in body["hits"]["hits"]} == {"1", "3"}
        src = body["hits"]["hits"][0]["_source"]
        assert "name" in src and "price" not in src

    def test_pagination(self, seeded):
        _, p1 = seeded.same("POST", "/prod/_search", {
            "query": {"match_all": {}}, "size": 2, "from": 0})
        _, p2 = seeded.same("POST", "/prod/_search", {
            "query": {"match_all": {}}, "size": 2, "from": 2})
        ids1 = [h["_id"] for h in p1["hits"]["hits"]]
        ids2 = [h["_id"] for h in p2["hits"]["hits"]]
        assert len(ids1) == 2 and len(ids2) == 2
        assert not set(ids1) & set(ids2)

    def test_count_and_cat(self, seeded):
        _, body = seeded.same("GET", "/prod/_count")
        assert body["count"] == 5
        status, text = seeded.both("GET", "/_cat/indices",
                                   params={"v": ""})[1]
        assert status == 200 and "prod" in text
        assert seeded.both("GET", "/_cat/indices", params={"v": ""}) == \
            ((200, text), (200, text))

    def test_wildcard_index_resolution(self, seeded):
        seeded.same("PUT", "/other", {})
        seeded.same("PUT", "/other/_doc/9", {"name": "thing"},
                    params={"refresh": "true"})
        _, body = seeded.same("POST", "/prod,other/_search",
                              {"query": {"match_all": {}}})
        assert body["hits"]["total"]["value"] == 6
        _, body = seeded.same("POST", "/pro*/_search",
                              {"query": {"match_all": {}}})
        assert body["hits"]["total"]["value"] == 5

    def test_unknown_route_and_bad_query(self, seeded):
        assert seeded.same("GET", "/prod/_nosuchapi")[0] == 400
        assert seeded.same("POST", "/prod/_search",
                           {"query": {"wibble": {}}})[0] == 400


class TestAnalyzeApi:
    def test_analyze_standard(self, pair):
        status, body = pair.same("POST", "/_analyze", {
            "analyzer": "standard", "text": "The QUICK brown-Fox!"})
        assert status == 200
        assert [t["token"] for t in body["tokens"]] == \
            ["the", "quick", "brown", "fox"]

    def test_analyze_field_list_and_errors(self, seeded):
        _, body = seeded.same("POST", "/prod/_analyze", {
            "field": "name", "text": ["Red Shoes", "blue"]})
        assert [t["token"] for t in body["tokens"]] == \
            ["red", "shoes", "blue"]
        assert seeded.same("POST", "/_analyze", {"text": "x",
                                                 "analyzer": "nope"})[0] \
            == 400
        assert seeded.same("POST", "/_analyze", {"analyzer": "standard"})[0] \
            == 400


class TestCreateOpType:
    def test_create_conflicts_on_existing(self, pair):
        pair.same("PUT", "/idx/_doc/1", {"title": "a"})
        assert pair.same("PUT", "/idx/_create/1", {"title": "b"})[0] == 409
        assert pair.same("POST", "/idx/_create/2", {"title": "c"})[0] == 201
        assert pair.same("PUT", "/idx/_doc/2", {"title": "d"},
                         params={"op_type": "create"})[0] == 409


# ---------------------------------------------------------------------------
# _msearch
# ---------------------------------------------------------------------------

def add_filtered_alias(pair):
    pair.same("PUT", "/prod/_alias/nike", {
        "filter": {"term": {"brand": "nike"}}})


def test_msearch_items_match_reference(seeded):
    """Header/body pairs: items through the kernel path, the planner, a
    filtered alias, a header index given as a list, the path's default
    index, and failing items whose siblings still run."""
    add_filtered_alias(seeded)
    raw = ndjson(
        {"index": "prod"}, {"query": {"match": {"name": "red shoes"}}},
        {"index": "nope"}, {"query": {"match_all": {}}},
        {"index": "nike"}, {"query": {"match": {"name": "running"}}},
        {"index": ["prod", "nike"]}, {"query": {"match_all": {}},
                                      "size": 2},
        {}, {"query": {"range": {"price": {"lte": 30}}}},
        {"index": "prod"}, {"query": {"wibble": {}}})
    status, body = seeded.same("POST", "/prod/_msearch", raw=raw)
    assert status == 200
    statuses = [r["status"] for r in body["responses"]]
    assert statuses == [200, 404, 200, 200, 200, 400]
    assert body["responses"][0]["hits"]["total"]["value"] == 3
    assert body["responses"][2]["hits"]["total"]["value"] == 2
    assert body["responses"][4]["hits"]["total"]["value"] == 2


def test_msearch_item_of_an_unported_feature_fails_alone(seeded):
    """An item the port refuses is that item's 400 and its sibling
    answers. Since aggregations are served (Queue A8) the refused item is
    an unknown aggregation type, the reference's own 400, and the
    answer is the reference's bytes; an aggregation item answers."""
    raw = ndjson({"index": "prod"}, {"query": {"match": {"name": "red"}},
                                     "aggs": {"n": {"maximum": {
                                         "field": "price"}}}},
                 {"index": "prod"}, {"query": {"match": {"name": "red"}}},
                 {"index": "prod"}, {"query": {"match": {"name": "red"}},
                                     "aggs": {"n": {"max": {
                                         "field": "price"}}}})
    status, body = seeded.same("POST", "/_msearch", raw=raw)
    assert status == 200
    first, second, third = body["responses"]
    assert first["status"] == 400
    assert first["error"]["type"] == "illegal_argument_exception"
    assert second["status"] == 200
    assert second["hits"]["total"]["value"] == 3
    assert third["status"] == 200
    assert third["aggregations"]["n"]["value"] is not None


def test_msearch_item_equals_its_search(seeded):
    """Each item answers what _search answers for its body, and the
    request's took is the sum of the items'."""
    bodies = [{"query": {"match": {"name": "red"}}, "_source": False},
              {"query": {"match": {"name": "tennis shoes"}}, "size": 1}]
    raw = ndjson(*[x for b in bodies for x in ({"index": "prod"}, b)])
    status, payload = seeded.port.handle("POST", "/_msearch", {}, None, raw)
    assert status == 200
    assert payload["took"] == sum(r["took"] for r in payload["responses"])
    for item, body in zip(payload["responses"], bodies):
        _, want = seeded.port.handle("POST", "/prod/_search", {}, body)
        assert item.pop("status") == 200
        item["took"] = want["took"] = 0
        assert dumps_response(item) == dumps_response(want)


@pytest.mark.parametrize("raw", [
    b'{"index": "prod"}\n',
    b'{"index": "prod"}\n{}\n{"index": "prod"}\n',
    b"\n\n",
    b"{bad json}\n{}\n"], ids=["odd", "three", "empty", "bad_header"])
def test_msearch_malformed_bodies_match_reference(seeded, raw):
    seeded.same("POST", "/_msearch", raw=raw)


# ---------------------------------------------------------------------------
# _count, the introspection routes
# ---------------------------------------------------------------------------

COUNT_CASES = {
    "match": ("/prod/_count", {"query": {"match": {"name": "red"}}}),
    "no_body": ("/prod/_count", None),
    "all": ("/_count", {"query": {"range": {"price": {"gte": 30}}}}),
    "alias": ("/nike/_count", {"query": {"match_all": {}}}),
    "alias_and_index": ("/nike,prod/_count", None),
    "missing": ("/nope/_count", None),
    "bad_query": ("/prod/_count", {"query": {"wibble": {}}}),
}


@pytest.mark.parametrize("name", sorted(COUNT_CASES))
def test_count_matches_reference(seeded, name):
    add_filtered_alias(seeded)
    path, body = COUNT_CASES[name]
    seeded.same("POST", path, body)


INTROSPECT_CASES = {
    "field_caps": ("GET", "/_field_caps", None, None),
    "field_caps_index_fields": ("GET", "/prod/_field_caps", None,
                                {"fields": "b*,price"}),
    "field_caps_body_fields": ("POST", "/prod,other/_field_caps",
                               {"fields": ["name", "extra"]}, None),
    "validate": ("POST", "/prod/_validate/query",
                 {"query": {"match": {"name": "red"}}}, None),
    "validate_explain": ("POST", "/_validate/query",
                         {"query": {"bool": {"must": [
                             {"term": {"brand": "nike"}}]}}},
                         {"explain": "true"}),
    "validate_invalid": ("POST", "/prod/_validate/query",
                         {"query": {"wibble": {}}}, {"explain": "true"}),
    "explain_match": ("POST", "/prod/_explain/1",
                      {"query": {"match": {"name": "red shoes"}}}, None),
    "explain_planner": ("POST", "/prod/_explain/4",
                        {"query": {"bool": {
                            "must": [{"match": {"name": "tennis"}}],
                            "filter": [{"range": {"price": {
                                "gte": 100}}}]}}}, None),
    "explain_no_match": ("GET", "/prod/_explain/2",
                         {"query": {"match": {"name": "tennis"}}}, None),
    "explain_missing_doc": ("POST", "/prod/_explain/404",
                            {"query": {"match_all": {}}}, None),
    "explain_no_query": ("POST", "/prod/_explain/1", {}, None),
    "termvectors": ("GET", "/prod/_termvectors/1", None,
                    {"term_statistics": "true"}),
    "termvectors_fields": ("POST", "/other/_termvectors/9",
                           {"fields": ["extra.sub"]}, None),
    "termvectors_missing": ("GET", "/prod/_termvectors/404", None, None),
}


@pytest.fixture(scope="module")
def introspect_pair(tmp_path_factory):
    p = Pair(tmp_path_factory.mktemp("introspect"))
    seed_products(p)
    p.same("PUT", "/other", {"mappings": {"properties": {
        "name": {"type": "keyword"},
        "extra": {"properties": {"sub": {"type": "text"}}}}}})
    p.same("PUT", "/other/_doc/9",
           {"name": "thing", "extra": {"sub": ["two words", "three more "
                                                            "words"]}},
           params={"refresh": "true"})
    yield p
    p.close()


@pytest.mark.parametrize("name", sorted(INTROSPECT_CASES))
def test_introspection_routes_match_reference(introspect_pair, name):
    method, path, body, params = INTROSPECT_CASES[name]
    introspect_pair.same(method, path, body, params=params)


# ---------------------------------------------------------------------------
# what stays refused
# ---------------------------------------------------------------------------

#: the search-context routes, refused until scroll, PIT and the ranking
#: evaluation came (Queue A5c); each now answers the reference's status
#: and bytes (a context id masked), the unknown ids' 404s included
REFUSED = {
    "scroll": ("POST", "/prod/_search", {"scroll": "1m"},
               {"query": {"match_all": {}}}),
    "scroll_page": ("POST", "/_search/scroll", {}, {"scroll_id": "x"}),
    "clear_scroll": ("DELETE", "/_search/scroll/x", {}, None),
    "open_pit": ("POST", "/prod/_pit", {"keep_alive": "1m"}, None),
    "pit_search": ("POST", "/_search", {}, {"pit": {"id": "x"}}),
    "close_pit": ("DELETE", "/_pit", {}, {"id": "x"}),
    "rank_eval": ("POST", "/prod/_rank_eval", {}, {"requests": []}),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_unported_search_contexts_get_a_typed_400(seeded, name):
    method, path, params, body = REFUSED[name]
    status, answer = seeded.same(method, path, body, params=params)
    assert status != 500, answer


@pytest.mark.parametrize("path", ["/_cat/plugins", "/_cat/tasks"])
def test_unported_cat_tables_have_no_handler(pair, path):
    status, text = call(pair.port, dumps_response, "GET", path)
    assert status == 400
    assert json.loads(text)["error"]["reason"] == \
        f"no handler found for uri [{path}] and method [GET]"


def test_cat_index_lists_the_tables_served(pair):
    """The _cat index is the reference's without the two tables the
    port does not serve yet."""
    (_, want), (_, got) = pair.both("GET", "/_cat")
    assert got == "".join(line for line in want.splitlines(True)
                          if line not in ("/_cat/plugins\n",
                                          "/_cat/tasks\n"))


# ---------------------------------------------------------------------------
# the HTTP layer: text tables and NDJSON bodies
# ---------------------------------------------------------------------------

def test_http_serves_cat_text_and_msearch_ndjson(seeded):
    server = serve(seeded.port, "127.0.0.1", 0)
    host, port = server.server_address
    try:
        conn = http.client.HTTPConnection(host, port, timeout=60)
        conn.request("GET", "/_cat/shards/prod?v")
        resp = conn.getresponse()
        text = resp.read().decode()
        assert resp.status == 200
        assert resp.getheader("Content-Type") == "text/plain; charset=UTF-8"
        assert text == call(seeded.port, dumps_response, "GET",
                            "/_cat/shards/prod", params={"v": ""})[1]
        raw = ndjson({"index": "prod"}, {"query": {"match": {"name":
                                                             "red"}}})
        conn.request("POST", "/_msearch", raw,
                     {"Content-Type": "application/x-ndjson"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        assert resp.status == 200
        assert resp.getheader("Content-Type") == \
            "application/json; charset=UTF-8"
        assert body["responses"][0]["hits"]["total"]["value"] == 3
        conn.close()
    finally:
        server.shutdown()
        server.server_close()


# ---------------------------------------------------------------------------
# no fallback
# ---------------------------------------------------------------------------

def test_kernel_fault_reaches_the_item_and_the_request_as_5xx(seeded,
                                                             monkeypatch):
    """A fault in the kernel launch is that _msearch item's 500 (its
    planner sibling still answers), and a fault in _explain's executor
    is the request's 500: no other path answers instead."""
    from elasticsearch_tpu_torch.search import gpu_service, planner

    def boom(*args, **kwargs):
        raise RuntimeError("injected kernel fault")

    monkeypatch.setattr(gpu_service, "_launch_exact", boom)
    raw = ndjson({"index": "prod"}, {"query": {"match": {"name": "red"}}},
                 {"index": "prod"}, {"query": {"range": {"price": {
                     "gte": 50}}}})
    status, body = seeded.port.handle("POST", "/_msearch", {}, None, raw)
    assert status == 200
    failed, served = body["responses"]
    assert failed["status"] == 500
    assert failed["error"]["type"] == "runtime_error"
    assert failed["error"]["reason"] == "injected kernel fault"
    assert served["status"] == 200
    assert served["hits"]["total"]["value"] == 3
    monkeypatch.setattr(planner.SegmentQueryExecutor, "execute", boom)
    status, text = call(seeded.port, dumps_response, "POST",
                        "/prod/_explain/1",
                        {"query": {"match": {"name": "red"}}})
    err = json.loads(text)
    assert status == 500, err
    assert err["error"]["reason"] == "injected kernel fault"
