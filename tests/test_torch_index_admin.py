"""Index administration of one node against the reference node: close
and open, ``GET /{index}``, mappings and settings, ``_stats`` and
``_flush``, the write block, rollover, shrink and split, and the
cluster settings.

Port copies of ``test_lifecycle.py`` (whole) and of
``test_dynamic_settings.py``. Every request goes to the reference node
and the port node (``torch_rest_pair``); status and response bytes must
be equal (``took`` at 0, ``torch_rest_pair.MASKED`` masked). Left out of
``test_dynamic_settings.py``, each for its queue: the slow-log threshold
(Queues A3/A13; the port refuses the setting, pinned here), the
persistent logger level (A13; refused the same way) and the replica
scaling of a cluster (A12). The port's own cases hold what the card
depends on: a closed index drops its resident pack and its ``hbm``
charge, and an opened one builds one pack from its new readers.
"""

from __future__ import annotations

import json

import pytest
import torch

from elasticsearch_tpu_torch.search.serializer import dumps_response

from torch_rest_pair import Pair, call

torch.set_num_threads(1)


@pytest.fixture
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.close()


def seed(pair, index="logs-000001", n=8, shards=2):
    s, b = pair.same("PUT", f"/{index}", {
        "settings": {"number_of_shards": shards},
        "mappings": {"properties": {"body": {"type": "text"}}}})
    assert s == 200, b
    for i in range(n):
        pair.same("PUT", f"/{index}/_doc/{i}",
                  {"body": f"event number {i}"})
    pair.same("POST", f"/{index}/_refresh")


def write_alias(pair, index="logs-000001", alias="logs"):
    pair.same("POST", "/_aliases", {"actions": [
        {"add": {"index": index, "alias": alias, "is_write_index": True}}]})


# ---------------------------------------------------------------------------
# test_lifecycle.py
# ---------------------------------------------------------------------------

class TestCloseOpen:
    def test_close_rejects_reads_and_writes(self, pair):
        seed(pair)
        s, b = pair.same("POST", "/logs-000001/_close")
        assert s == 200 and b["acknowledged"], b
        s, b = pair.same("POST", "/logs-000001/_search",
                         {"query": {"match_all": {}}})
        assert s == 400 and "index_closed" in json.dumps(b), b
        assert pair.same("PUT", "/logs-000001/_doc/99",
                         {"body": "x"})[0] == 400
        assert pair.same("GET", "/logs-000001/_doc/0")[0] == 400
        # the other routes of a closed index, as the reference answers
        for method, path, body in (
                ("POST", "/logs-000001/_count", None),
                ("POST", "/logs-000001/_update/0", {"doc": {"x": 1}}),
                ("DELETE", "/logs-000001/_doc/0", None),
                ("POST", "/_mget", {"docs": [{"_index": "logs-000001",
                                              "_id": "0"}]}),
                ("GET", "/logs-000001/_stats", None),
                ("GET", "/_stats", None),
                ("GET", "/logs-000001", None),
                ("POST", "/logs-000001/_explain/0",
                 {"query": {"match_all": {}}}),
                ("POST", "/logs-000001/_close", None)):
            pair.same(method, path, body)

    def test_wildcard_search_skips_closed(self, pair):
        seed(pair, "logs-000001")
        seed(pair, "logs-000002")
        pair.same("POST", "/logs-000001/_close")
        s, b = pair.same("POST", "/logs-*/_search",
                         {"query": {"match_all": {}}, "size": 0})
        assert s == 200, b
        assert b["hits"]["total"]["value"] == 8
        for path in ("/_cat/indices", "/_cat/shards", "/_cat/count"):
            (_, want), (_, got) = pair.both("GET", path)
            assert got == want, path

    def test_open_restores_data(self, pair):
        seed(pair)
        pair.same("POST", "/logs-000001/_close")
        s, b = pair.same("POST", "/logs-000001/_open")
        assert s == 200 and b["acknowledged"], b
        s, b = pair.same("POST", "/logs-000001/_search",
                         {"query": {"match": {"body": "event"}},
                          "size": 20})
        assert s == 200 and b["hits"]["total"]["value"] == 8, b

    def test_closed_index_survives_restart_closed(self, pair):
        seed(pair)
        pair.same("POST", "/logs-000001/_close")
        pair.restart()
        s, b = pair.same("POST", "/logs-000001/_search",
                         {"query": {"match_all": {}}})
        assert s == 400, b
        assert pair.same("POST", "/logs-000001/_open")[0] == 200
        s, b = pair.same("POST", "/logs-000001/_search",
                         {"query": {"match_all": {}}, "size": 20})
        assert s == 200 and b["hits"]["total"]["value"] == 8, b


class TestRollover:
    def test_rollover_unconditional(self, pair):
        seed(pair)
        write_alias(pair)
        s, b = pair.same("POST", "/logs/_rollover", {})
        assert s == 200, b
        assert b["rolled_over"] and b["new_index"] == "logs-000002", b
        s, b = pair.same("PUT", "/logs/_doc/new1", {"body": "fresh"})
        assert s in (200, 201), b
        assert pair.same("GET", "/logs-000002/_doc/new1")[0] == 200
        s, b = pair.same("POST", "/logs/_search",
                         {"query": {"match_all": {}}, "size": 0})
        assert s == 200 and b["hits"]["total"]["value"] >= 8, b
        pair.same("GET", "/_alias/logs")

    def test_rollover_conditions_not_met(self, pair):
        seed(pair, n=3)
        write_alias(pair)
        s, b = pair.same("POST", "/logs/_rollover",
                         {"conditions": {"max_docs": 100}})
        assert s == 200 and not b["rolled_over"], b
        assert b["conditions"] == {"[max_docs: 100]": False}, b

    def test_rollover_max_docs_met_and_dry_run(self, pair):
        seed(pair, n=8)
        write_alias(pair)
        s, b = pair.same("POST", "/logs/_rollover",
                         {"conditions": {"max_docs": 5}},
                         params={"dry_run": "true"})
        assert s == 200 and b["dry_run"] and not b["rolled_over"], b
        assert b["conditions"]["[max_docs: 5]"] is True
        s, b = pair.same("POST", "/logs/_rollover",
                         {"conditions": {"max_docs": 5}})
        assert s == 200 and b["rolled_over"], b

    def test_rollover_requires_alias_and_pattern(self, pair):
        seed(pair, "plain")
        assert pair.same("POST", "/plain/_rollover", {})[0] == 400
        write_alias(pair, "plain", "p")
        s, b = pair.same("POST", "/p/_rollover", {})
        assert s == 400 and "pattern" in json.dumps(b), b

    def test_rollover_named_target_and_plain_alias(self, pair):
        """A target named in the path; an alias without the write flag
        moves whole to the new index; an unknown condition is a 400."""
        seed(pair)
        pair.same("PUT", "/logs-000001/_alias/plain")
        assert pair.same("POST", "/plain/_rollover",
                         {"conditions": {"max_rows": 1}})[0] == 400
        s, b = pair.same("POST", "/plain/_rollover/renamed",
                         {"conditions": {"max_docs": 1,
                                         "max_size": "1gb"},
                          "settings": {"number_of_shards": 3}})
        assert s == 200 and b["new_index"] == "renamed", b
        pair.same("GET", "/_alias/plain")
        pair.same("GET", "/renamed/_settings")


class TestShrink:
    def test_shrink_requires_write_block_and_divisibility(self, pair):
        seed(pair, "big", n=20, shards=4)
        s, b = pair.same("PUT", "/big/_shrink/small", {})
        assert s == 400 and "read-only" in json.dumps(b), b
        assert pair.same("PUT", "/big/_settings",
                         {"index": {"blocks": {"write": True}}})[0] == 200
        s, b = pair.same("PUT", "/big/_shrink/bad", {
            "settings": {"index": {"number_of_shards": 3}}})
        assert s == 400 and "multiple" in json.dumps(b), b

    def test_shrink_preserves_docs(self, pair):
        seed(pair, "big", n=20, shards=4)
        pair.same("PUT", "/big/_settings",
                  {"index": {"blocks": {"write": True}}})
        s, b = pair.same("PUT", "/big/_shrink/small", {
            "settings": {"index": {"number_of_shards": 2}}})
        assert s == 200, b
        assert b["copied_docs"] == 20
        pair.same("POST", "/small/_refresh")
        s, b = pair.same("POST", "/small/_search",
                         {"query": {"match": {"body": "event"}},
                          "size": 30})
        assert s == 200 and b["hits"]["total"]["value"] == 20, b
        for i in range(20):
            assert pair.same("GET", f"/small/_doc/{i}")[0] == 200, i
        # the target does not inherit the write block
        s, b = pair.same("PUT", "/small/_doc/extra", {"body": "more"})
        assert s in (200, 201), b

    def test_write_block_rejects_writes(self, pair):
        seed(pair, "big", n=4, shards=2)
        pair.same("PUT", "/big/_settings",
                  {"index": {"blocks": {"write": True}}})
        assert pair.same("PUT", "/big/_doc/xx", {"body": "nope"})[0] == 403
        assert pair.same("PUT", "/big/_settings",
                         {"index": {"blocks": {"write": None}}})[0] == 200
        s, b = pair.same("PUT", "/big/_doc/xx", {"body": "yes"})
        assert s in (200, 201), b


class TestSplit:
    def test_split_requires_a_multiple_and_scores_as_reference(self, pair):
        """Split to 8 shards: murmur3 routes each document anew, each
        target shard scores with its own statistics, and the bar is the
        reference's bytes on the target."""
        seed(pair, "src", n=40, shards=2)
        pair.same("PUT", "/src/_settings",
                  {"index": {"blocks": {"write": True}}})
        s, b = pair.same("PUT", "/src/_split/bad", {
            "settings": {"index": {"number_of_shards": 3}}})
        assert s == 400 and "multiple" in json.dumps(b), b
        s, b = pair.same("POST", "/src/_split/wide", {
            "settings": {"index": {"number_of_shards": 8}}})
        assert s == 200 and b["copied_docs"] == 40, b
        for body in ({"query": {"match": {"body": "event number 7"}}},
                     {"query": {"match": {"body": "number"}}, "size": 50},
                     {"query": {"term": {"body": "3"}}}):
            pair.same("POST", "/wide/_search", body)
        (_, want), (_, got) = pair.both("GET", "/_cat/shards/wide",
                                        params={"v": ""})
        assert got == want
        pair.same("GET", "/wide/_stats")


# ---------------------------------------------------------------------------
# GET /{index}, mappings, settings, _stats, _flush
# ---------------------------------------------------------------------------

def test_get_index_mapping_settings_stats_and_flush(pair):
    seed(pair, "a", n=5, shards=3)
    seed(pair, "b", n=2, shards=1)
    pair.same("PUT", "/a/_settings", {"index.translog.durability": "async"})
    for method, path in (("GET", "/a"), ("GET", "/a,b"), ("GET", "/*"),
                         ("GET", "/nope"), ("HEAD", "/nope"),
                         ("GET", "/_mapping"), ("GET", "/b/_mapping"),
                         ("GET", "/_settings"), ("GET", "/a/_settings"),
                         ("GET", "/_stats"), ("GET", "/b/_stats"),
                         ("POST", "/a/_flush"), ("POST", "/_flush"),
                         ("GET", "/_stats"), ("POST", "/_refresh")):
        pair.same(method, path)


def test_put_mapping_on_a_resident_index_builds_the_new_fields_pack(pair):
    """The port keeps no plan cache yet: after a mapping update a
    search on the new field builds its own (index, field) pack, and the
    old field's pack stays."""
    seed(pair, "m", n=6, shards=1)
    pair.same("POST", "/m/_search", {"query": {"match": {"body": "event"}}})
    assert list(pair.port.gpu_search.packs.stats()["packs"]) == ["m/body"]
    pair.same("PUT", "/m/_mapping", {"properties": {"title": {"type":
                                                              "text"}}})
    pair.same("PUT", "/m/_doc/t1", {"title": "a new title"},
              params={"refresh": "true"})
    s, b = pair.same("POST", "/m/_search",
                     {"query": {"match": {"title": "title"}}})
    assert b["hits"]["total"]["value"] == 1
    assert sorted(pair.port.gpu_search.packs.stats()["packs"]) == \
        ["m/body", "m/title"]


# ---------------------------------------------------------------------------
# test_dynamic_settings.py
# ---------------------------------------------------------------------------

class TestIndexSettings:
    def test_flat_dotted_key_body_accepted(self, pair):
        pair.same("PUT", "/flat/_doc/1", {"m": "x"})
        assert pair.same("PUT", "/flat/_settings",
                         {"index.number_of_replicas": 1})[0] == 200
        assert pair.port.indices.index("flat").num_replicas == 1
        assert pair.same("PUT", "/flat/_settings",
                         {"number_of_replicas": 2})[0] == 200
        assert pair.port.indices.index("flat").num_replicas == 2

    @pytest.mark.parametrize("value", ["two", -1])
    def test_bad_replica_value_400(self, pair, value):
        pair.same("PUT", "/bad/_doc/1", {"m": "x"})
        assert pair.same("PUT", "/bad/_settings", {
            "index": {"number_of_replicas": value}})[0] == 400

    @pytest.mark.parametrize("body", [
        {"index": {"number_of_shards": 5}}, {"index": {"bogus_key": 1}},
        {"settings": {"index": {"translog": {"durability": "never"}}}}],
        ids=["static", "unknown", "bad_durability"])
    def test_static_setting_rejected(self, pair, body):
        pair.same("PUT", "/d2/_doc/1", {"m": "x"})
        assert pair.same("PUT", "/d2/_settings", body)[0] == 400

    def test_replica_count_updates_metadata(self, pair):
        pair.same("PUT", "/d3/_doc/1", {"m": "x"})
        assert pair.same("PUT", "/d3/_settings", {
            "index": {"number_of_replicas": 2}})[0] == 200
        _, res = pair.same("GET", "/d3/_settings")
        assert res["d3"]["settings"]["index"]["number_of_replicas"] == "2"
        pair.same("GET", "/d3")

    @pytest.mark.parametrize("key", ["index.default_pipeline"])
    def test_unported_dynamic_settings_are_refused(self, pair, key):
        """The reference takes this one; its module (ingest) is not
        ported, so the port refuses it with a 400 that says so and
        leaves the index as it was."""
        pair.same("PUT", "/d4/_doc/1", {"m": "x"})
        status, text = call(pair.port, dumps_response, "PUT",
                            "/d4/_settings", {key: "0ms"})
        err = json.loads(text)
        assert status == 400, err
        assert "not ported yet" in err["error"]["reason"]
        assert pair.port.indices.index("d4").settings.get(key) is None


class TestClusterSettings:
    def test_auto_create_toggle(self, pair):
        s, res = pair.same("PUT", "/_cluster/settings", {
            "persistent": {"action": {"auto_create_index": "false"}}})
        assert s == 200
        assert res["persistent"]["action.auto_create_index"] == "false"
        assert pair.same("PUT", "/nope/_doc/1", {"x": 1})[0] == 404
        pair.same("PUT", "/_cluster/settings", {
            "transient": {"action": {"auto_create_index": "true"}}})
        assert pair.same("PUT", "/nope/_doc/1", {"x": 1})[0] == 201

    def test_null_clears_and_reverts_to_base(self, pair):
        pair.same("PUT", "/_cluster/settings", {
            "persistent": {"action.auto_create_index": "false"}})
        assert pair.same("PUT", "/gone/_doc/1", {"x": 1})[0] == 404
        _, res = pair.same("PUT", "/_cluster/settings", {
            "persistent": {"action.auto_create_index": None}})
        assert "action.auto_create_index" not in res["persistent"]
        assert pair.same("PUT", "/gone/_doc/1", {"x": 1})[0] == 201

    @pytest.mark.parametrize("body", [
        {"persistent": {"cluster.routing.allocation.enable": "none"}},
        {}, {"transient": {}}], ids=["unknown", "empty", "empty_transient"])
    def test_unknown_setting_rejected(self, pair, body):
        assert pair.same("PUT", "/_cluster/settings", body)[0] == 400

    def test_get_shape(self, pair):
        s, res = pair.same("GET", "/_cluster/settings")
        assert s == 200 and set(res) == {"persistent", "transient"}

    @pytest.mark.parametrize("key", ["cluster.remote.other.seeds"])
    def test_unported_cluster_settings_are_refused(self, pair, key):
        status, text = call(pair.port, dumps_response, "PUT",
                            "/_cluster/settings",
                            {"persistent": {key: "debug"}})
        err = json.loads(text)
        assert status == 400, err
        assert "not ported yet" in err["error"]["reason"]
        assert pair.port.persistent_settings == {}

    def test_persistent_survives_restart(self, pair):
        pair.same("PUT", "/_cluster/settings", {
            "persistent": {"action.auto_create_index": "false"},
            "transient": {"action.auto_create_index": "false"}})
        pair.restart()
        assert pair.same("PUT", "/later/_doc/1", {"x": 1})[0] == 404
        _, res = pair.same("GET", "/_cluster/settings")
        assert res == {"persistent": {"action.auto_create_index": "false"},
                       "transient": {}}


# ---------------------------------------------------------------------------
# what close and open do to the device state
# ---------------------------------------------------------------------------

def test_close_drops_the_pack_and_open_builds_one(pair):
    """A search on a closed index gets the 400 before the pack cache is
    asked; close releases the pack's hbm charge; the first search after
    open builds from the new readers, and the breaker then holds one
    pack's bytes, not two."""
    seed(pair, "c", n=12, shards=2)
    body = {"query": {"match": {"body": "event number"}}}
    _, before = pair.same("POST", "/c/_search", body)
    gpu = pair.port.gpu_search
    hbm = pair.port.breakers.get_breaker("hbm")
    (resident,) = gpu.packs.residents()
    assert hbm.used == resident.nbytes_device() > 0
    lookups = gpu.packs.hits + gpu.packs.misses
    pair.same("POST", "/c/_close")
    assert hbm.used == 0 and gpu.packs.residents() == []
    assert pair.same("POST", "/c/_search", body)[0] == 400
    assert gpu.packs.hits + gpu.packs.misses == lookups
    pair.same("POST", "/c/_open")
    misses = gpu.packs.misses
    _, after = pair.same("POST", "/c/_search", body)
    assert gpu.packs.misses == misses + 1
    (reopened,) = gpu.packs.residents()
    assert reopened is not resident
    assert hbm.used == reopened.nbytes_device()
    assert after["hits"] == before["hits"]
    pair.same("DELETE", "/c")
    assert hbm.used == 0 and gpu.packs.residents() == []
