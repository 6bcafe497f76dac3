"""Port copy of ``test_rescore_collapse.py``: the query rescorer and
field collapsing.

Every request goes to the reference node and the port node
(``torch_rest_pair``); status and response bytes must be equal, with
``took`` at 0 and only ``torch_rest_pair.MASKED``'s fields masked; the
reference's assertions then run on the shared answer. A rescored body's
shard window is the planner's top-k (``shard_topk`` on a card), its
rescore query the planner's torch ops; collapse groups the planner's
masked scores by the doc-value key.
"""

from __future__ import annotations

import pytest
import torch

from torch_rest_pair import Pair

torch.set_num_threads(1)

DOCS = {
    "1": {"body": "alpha alpha alpha", "boosted": "nothing",
          "group": "g1", "rank": 1},
    "2": {"body": "alpha alpha", "boosted": "special", "group": "g1",
          "rank": 2},
    "3": {"body": "alpha", "boosted": "special", "group": "g2", "rank": 3},
    "4": {"body": "alpha beta", "boosted": "nothing", "group": "g2",
          "rank": 4},
    "5": {"body": "gamma", "boosted": "special", "group": "g3", "rank": 5},
}
MAPPING = {"properties": {
    "body": {"type": "text"}, "boosted": {"type": "text"},
    "group": {"type": "keyword"}, "rank": {"type": "integer"}}}
SPECIAL = {"rescore_query": {"match": {"boosted": "special"}},
           "rescore_query_weight": 100.0}


@pytest.fixture
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.close()


@pytest.fixture
def seeded(pair):
    assert pair.same("PUT", "/m", {"settings": {"number_of_shards": 2},
                                   "mappings": MAPPING})[0] == 200
    for i, src in DOCS.items():
        pair.same("PUT", f"/m/_doc/{i}", src)
    pair.same("POST", "/m/_refresh")
    return pair


def search(pair, index, body):
    return pair.same("POST", f"/{index}/_search", body)


class TestRescore:
    def test_rescore_promotes_matches(self, seeded):
        base = {"query": {"match": {"body": "alpha"}}, "size": 4}
        s, plain = search(seeded, "m", dict(base))
        assert s == 200 and plain["hits"]["hits"][0]["_id"] == "1"
        s, r = search(seeded, "m", {**base, "rescore": {
            "window_size": 10, "query": SPECIAL}})
        assert s == 200, r
        assert {h["_id"] for h in r["hits"]["hits"][:2]} == {"2", "3"}
        # unmatched docs keep query_weight * original
        scores = {h["_id"]: h["_score"] for h in r["hits"]["hits"]}
        assert scores["1"] == pytest.approx(
            {h["_id"]: h["_score"] for h in plain["hits"]["hits"]}["1"])

    def test_rescore_window_limits_scope(self, pair):
        # windows are per shard: one shard makes it deterministic
        assert pair.same("PUT", "/w", {
            "settings": {"number_of_shards": 1},
            "mappings": {"properties": {"body": {"type": "text"},
                                        "boosted": {"type": "text"}}}}
                         )[0] == 200
        pair.same("PUT", "/w/_doc/1",
                  {"body": "alpha alpha alpha", "boosted": "nothing"})
        pair.same("PUT", "/w/_doc/2", {"body": "alpha", "boosted": "special"})
        pair.same("POST", "/w/_refresh")
        base = {"query": {"match": {"body": "alpha"}}, "size": 4}
        s, r = search(pair, "w", {**base, "rescore": {
            "window_size": 1, "query": SPECIAL}})
        assert s == 200, r
        assert [h["_id"] for h in r["hits"]["hits"]] == ["1", "2"], r
        _, r = search(pair, "w", {**base, "rescore": {
            "window_size": 10, "query": SPECIAL}})
        assert [h["_id"] for h in r["hits"]["hits"]] == ["2", "1"], r

    @pytest.mark.parametrize("mode", ["total", "multiply", "avg", "max",
                                      "min"])
    def test_score_modes_and_chain(self, seeded, mode):
        s, r = search(seeded, "m", {
            "query": {"match": {"body": "alpha"}}, "size": 5,
            "rescore": [{"window_size": 3, "query": dict(
                SPECIAL, score_mode=mode, query_weight=0.5)},
                {"window_size": 2, "query": {
                    "rescore_query": {"term": {"group": "g2"}}}}]})
        assert s == 200, r

    def test_rescore_validation(self, seeded):
        s, r = search(seeded, "m", {
            "query": {"match_all": {}},
            "rescore": {"query": {"rescore_query": {"match_all": {}},
                                  "score_mode": "nope"}}})
        assert s == 400, r


class TestCollapse:
    def test_collapse_keeps_best_per_group(self, seeded):
        s, r = search(seeded, "m", {
            "query": {"match": {"body": "alpha"}}, "size": 10,
            "collapse": {"field": "group"}})
        assert s == 200, r
        hits = r["hits"]["hits"]
        assert [h["_id"] for h in hits] == ["1", "4"], hits
        assert hits[0]["fields"] == {"group": ["g1"]}
        # the total is not collapsed
        assert r["hits"]["total"]["value"] == 4

    def test_collapse_numeric_field(self, seeded):
        s, r = search(seeded, "m", {"query": {"match_all": {}}, "size": 10,
                                    "collapse": {"field": "rank"}})
        assert s == 200, r
        assert len(r["hits"]["hits"]) == 5  # all ranks distinct

    def test_collapse_paging_and_missing_keys(self, seeded):
        seeded.same("PUT", "/m/_doc/6", {"body": "alpha alpha beta"},
                    params={"refresh": "true"})
        s, r = search(seeded, "m", {
            "query": {"match": {"body": "alpha"}}, "size": 2, "from": 1,
            "collapse": {"field": "group"}})
        assert s == 200, r

    def test_collapse_rejects_inner_hits_and_sort(self, seeded):
        s, r = search(seeded, "m", {
            "query": {"match_all": {}},
            "collapse": {"field": "group", "inner_hits": {}}})
        assert s == 400, r
        s, r = search(seeded, "m", {
            "query": {"match_all": {}}, "sort": [{"rank": "asc"}],
            "collapse": {"field": "group"}})
        assert s == 400, r
