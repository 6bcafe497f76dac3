"""Port copy of ``test_aliases.py``: alias CRUD, search and write
resolution, filtered aliases, write indices and the ``_cat`` tables.

Every request goes to the reference node and the port node
(``torch_rest_pair``); status and response bytes must be equal (``took``
at 0, ``torch_rest_pair.MASKED`` masked). Left out, for its queue:
from the ``_cat`` case the ``plugins`` and ``tasks`` tables (Queues A15
and A4b), which the port does not register yet.
"""

from __future__ import annotations

import json

import pytest
import torch

from torch_rest_pair import Pair

torch.set_num_threads(1)


@pytest.fixture
def logs(tmp_path):
    p = Pair(tmp_path)
    for month, count in (("logs-01", 3), ("logs-02", 5)):
        p.same("PUT", f"/{month}", {"mappings": {
            "properties": {"level": {"type": "keyword"},
                           "n": {"type": "integer"}}}})
        for i in range(count):
            p.same("PUT", f"/{month}/_doc/{i}",
                   {"level": "error" if i % 2 == 0 else "info", "n": i},
                   params={"refresh": "true"})
    yield p
    p.close()


class TestCrud:
    def test_put_get_delete(self, logs):
        assert logs.same("PUT", "/logs-01/_alias/logs")[0] == 200
        _, res = logs.same("GET", "/_alias/logs")
        assert res == {"logs-01": {"aliases": {"logs": {}}}}
        assert logs.same("HEAD", "/_alias/logs")[0] == 200
        assert logs.same("DELETE", "/logs-01/_alias/logs")[0] == 200
        assert logs.same("HEAD", "/_alias/logs")[0] == 404
        # a second delete, and a get of the gone alias: the 404 bodies
        assert logs.same("DELETE", "/logs-01/_alias/logs")[0] == 404
        assert logs.same("GET", "/_alias/logs")[0] == 404

    def test_actions_bulk_update(self, logs):
        status, _ = logs.same("POST", "/_aliases", {"actions": [
            {"add": {"index": "logs-*", "alias": "all-logs"}}]})
        assert status == 200
        _, res = logs.same("GET", "/_alias/all-logs")
        assert set(res) == {"logs-01", "logs-02"}
        logs.same("POST", "/_aliases", {"actions": [
            {"remove": {"index": "logs-01", "alias": "all-logs"}}]})
        _, res = logs.same("GET", "/_alias/all-logs")
        assert set(res) == {"logs-02"}

    @pytest.mark.parametrize("body", [
        {}, {"actions": []}, {"actions": [{"swap": {}}]},
        {"actions": [{"add": {"index": "logs-01"}}]},
        {"actions": [{"add": {"index": "logs-01", "alias": "Bad"}}]},
        {"actions": [{"add": {"index": "logs-01", "alias": "f",
                              "filter": {"wibble": {}}}}]},
        {"actions": [{"add": {}, "remove": {}}]}],
        ids=["no_actions", "empty", "unknown", "no_alias", "bad_name",
             "bad_filter", "two_kinds"])
    def test_bad_actions_match_reference(self, logs, body):
        assert logs.same("POST", "/_aliases", body)[0] == 400

    def test_alias_clashing_with_index_rejected(self, logs):
        assert logs.same("PUT", "/logs-01/_alias/logs-02")[0] == 400

    def test_missing_index_rejected(self, logs):
        assert logs.same("PUT", "/nope/_alias/a")[0] == 404

    def test_alias_dies_with_index(self, logs):
        logs.same("PUT", "/logs-01/_alias/doomed")
        logs.same("DELETE", "/logs-01")
        assert logs.same("HEAD", "/_alias/doomed")[0] == 404

    def test_delete_via_alias_rejected(self, logs):
        """Destructive index APIs do not expand aliases: DELETE on an
        alias name is a 400, never a delete of the backing index."""
        logs.same("PUT", "/logs-01/_alias/precious")
        status, res = logs.same("DELETE", "/precious")
        assert status == 400, res
        assert logs.same("GET", "/logs-01")[0] == 200

    def test_filtered_alias_count_matches_search(self, logs):
        logs.same("PUT", "/logs-02/_alias/cnt", {
            "filter": {"term": {"level": "error"}}})
        _, c = logs.same("POST", "/cnt/_count",
                         {"query": {"match_all": {}}})
        _, r = logs.same("POST", "/cnt/_search",
                         {"query": {"match_all": {}}})
        assert c["count"] == r["hits"]["total"]["value"] == 3

    def test_alias_filter_not_highlighted(self, logs):
        logs.same("PUT", "/logs-02/_alias/hlf",
                  {"filter": {"term": {"level": "error"}}})
        # the alias filter's term "error" must not highlight: only the
        # request's query does
        _, res = logs.same("POST", "/hlf/_search", {
            "query": {"range": {"n": {"gte": 0}}},
            "highlight": {"require_field_match": False,
                          "fields": {"level": {}}}})
        assert all("highlight" not in h for h in res["hits"]["hits"])

    def test_get_index_shows_aliases(self, logs):
        logs.same("PUT", "/logs-01/_alias/shown")
        _, res = logs.same("GET", "/logs-01")
        assert "shown" in res["logs-01"]["aliases"]

    @pytest.mark.parametrize("path", [
        "/_alias", "/_alias/a*", "/logs-01/_alias", "/logs-02/_alias/b",
        "/_alias/none*"])
    def test_get_aliases_shapes_match_reference(self, logs, path):
        logs.same("POST", "/_aliases", {"actions": [
            {"add": {"index": "logs-*", "alias": "a1"}},
            {"add": {"index": "logs-02", "alias": "b",
                     "is_write_index": True,
                     "filter": {"range": {"n": {"gte": 1}}}}}]})
        logs.same("GET", path)


class TestCat:
    def test_cat_endpoints(self, logs):
        logs.same("PUT", "/logs-01/_alias/cat-me", {
            "filter": {"term": {"level": "error"}}})
        status, text = logs.both("GET", "/_cat/aliases",
                                 params={"v": "true"})[1]
        assert status == 200
        assert "cat-me" in text and "logs-01" in text
        assert logs.both("GET", "/_cat/aliases", params={"v": "true"}) \
            == ((200, text), (200, text))
        for path in ("/_cat/master", "/_cat/allocation", "/_cat/recovery",
                     "/_cat/recovery/logs-02", "/_cat/indices/logs-*",
                     "/_cat/shards/logs-01", "/_cat/count/logs-02",
                     "/_cat/health", "/_cat/nodes"):
            for params in ({}, {"v": ""}):
                (ws, want), (gs, got) = logs.both("GET", path,
                                                  params=params)
                assert ws == gs == 200, path
                assert got == want, (path, want, got)


class TestResolution:
    def test_search_through_alias_spans_indices(self, logs):
        logs.same("POST", "/_aliases", {"actions": [
            {"add": {"index": "logs-*", "alias": "logs"}}]})
        status, res = logs.same("POST", "/logs/_search",
                                {"query": {"match_all": {}}, "size": 20})
        assert status == 200
        assert res["hits"]["total"]["value"] == 8
        assert {h["_index"] for h in res["hits"]["hits"]} == \
            {"logs-01", "logs-02"}
        _, c = logs.same("POST", "/logs/_count",
                         {"query": {"match_all": {}}})
        assert c["count"] == 8

    def test_filtered_alias(self, logs):
        logs.same("PUT", "/logs-02/_alias/errors-only", {
            "filter": {"term": {"level": "error"}}})
        status, res = logs.same("POST", "/errors-only/_search",
                                {"query": {"match_all": {}}, "size": 20})
        assert status == 200, res
        assert res["hits"]["total"]["value"] == 3
        assert all(h["_source"]["level"] == "error"
                   for h in res["hits"]["hits"])
        # the filter composes with the request query
        _, res = logs.same("POST", "/errors-only/_search", {
            "query": {"range": {"n": {"gte": 2}}}})
        assert res["hits"]["total"]["value"] == 2

    def test_direct_access_stays_unfiltered(self, logs):
        logs.same("PUT", "/logs-02/_alias/errs", {
            "filter": {"term": {"level": "error"}}})
        _, res = logs.same("POST", "/logs-02,errs/_search",
                           {"query": {"match_all": {}}, "size": 20})
        assert res["hits"]["total"]["value"] == 5

    def test_write_through_single_index_alias(self, logs):
        logs.same("PUT", "/logs-01/_alias/w")
        status, res = logs.same("PUT", "/w/_doc/new", {"n": 99},
                                params={"refresh": "true"})
        assert status == 201 and res["_index"] == "logs-01"
        _, got = logs.same("GET", "/logs-01/_doc/new")
        assert got["_source"]["n"] == 99
        _, got = logs.same("GET", "/w/_doc/new")
        assert got["found"] is True
        assert logs.same("DELETE", "/w/_doc/new")[0] == 200

    def test_write_through_multi_index_alias_needs_write_index(self,
                                                               logs):
        logs.same("POST", "/_aliases", {"actions": [
            {"add": {"index": "logs-*", "alias": "multi"}}]})
        assert logs.same("PUT", "/multi/_doc/x", {"n": 1})[0] == 400
        logs.same("POST", "/_aliases", {"actions": [
            {"add": {"index": "logs-02", "alias": "multi",
                     "is_write_index": True}}]})
        status, res = logs.same("PUT", "/multi/_doc/x", {"n": 1},
                                params={"refresh": "true"})
        assert status == 201 and res["_index"] == "logs-02"
        # _update through the alias lands on the write index too
        status, res = logs.same("POST", "/multi/_update/x",
                                {"doc": {"n": 2}})
        assert status == 200 and res["_index"] == "logs-02"

    def test_bulk_through_alias(self, logs):
        logs.same("PUT", "/logs-01/_alias/bw")
        lines = [json.dumps({"index": {"_index": "bw", "_id": "b1"}}),
                 json.dumps({"n": 7})]
        status, res = logs.same("POST", "/_bulk",
                                raw=("\n".join(lines) + "\n").encode(),
                                params={"refresh": "true"})
        assert status == 200 and res["errors"] is False
        assert res["items"][0]["index"]["_index"] == "logs-01"


def test_aliases_survive_a_restart(logs):
    """Aliases are gateway metadata: a restarted node resolves them."""
    logs.same("PUT", "/logs-02/_alias/kept", {
        "filter": {"term": {"level": "info"}}, "is_write_index": True})
    logs.restart()
    _, res = logs.same("GET", "/_alias/kept")
    assert res["logs-02"]["aliases"]["kept"]["is_write_index"] is True
    _, c = logs.same("POST", "/kept/_count")
    assert c["count"] == 2
