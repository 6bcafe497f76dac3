"""Port copy of ``test_indices_service.py``: murmur3 routing, the
IndicesService registry, its gateway metadata, and (the port's own
cases) the alias registry and the close/open lifecycle of one node.

Routing is held against the reference's function on the same keys. Left
out, for its queue: ``test_replica_promotion`` (replicas, Queue A12).
"""

import pytest

from elasticsearch_tpu.indices.service import murmur3_hash as ref_murmur3
from elasticsearch_tpu.indices.service import \
    parse_alias_action as ref_parse_alias_action

from elasticsearch_tpu_torch.common.errors import (EsException,
                                                   IllegalArgumentException,
                                                   IndexAlreadyExistsException,
                                                   IndexClosedException,
                                                   IndexNotFoundException,
                                                   ResourceNotFoundException)
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.indices.routing import murmur3_hash, shard_for
from elasticsearch_tpu_torch.indices.service import (IndicesService,
                                                     parse_alias_action)


def murmur3_hash_bytes_oracle(data: bytes) -> int:
    """Independent murmur3_x86_32 over raw bytes, for the encoding
    test."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h1 = 0
    n = len(data) & ~3
    for i in range(0, n, 4):
        k1 = int.from_bytes(data[i:i + 4], "little")
        k1 = (k1 * c1) & 0xFFFFFFFF
        k1 = ((k1 << 15) | (k1 >> 17)) & 0xFFFFFFFF
        k1 = (k1 * c2) & 0xFFFFFFFF
        h1 ^= k1
        h1 = ((h1 << 13) | (h1 >> 19)) & 0xFFFFFFFF
        h1 = (h1 * 5 + 0xE6546B64) & 0xFFFFFFFF
    k1 = 0
    tail = len(data) & 3
    if tail >= 3:
        k1 ^= data[n + 2] << 16
    if tail >= 2:
        k1 ^= data[n + 1] << 8
    if tail >= 1:
        k1 ^= data[n]
        k1 = (k1 * c1) & 0xFFFFFFFF
        k1 = ((k1 << 15) | (k1 >> 17)) & 0xFFFFFFFF
        k1 = (k1 * c2) & 0xFFFFFFFF
        h1 ^= k1
    h1 ^= len(data)
    h1 ^= h1 >> 16
    h1 = (h1 * 0x85EBCA6B) & 0xFFFFFFFF
    h1 ^= h1 >> 13
    h1 = (h1 * 0xC2B2AE35) & 0xFFFFFFFF
    h1 ^= h1 >> 16
    return h1 - (1 << 32) if h1 >= (1 << 31) else h1


class TestMurmur3Routing:
    def test_published_vectors_utf8(self):
        """Austin Appleby's murmur3_x86_32 seed-0 vectors, fed UTF-8."""
        vectors = [("", 0x0), ("a", 0x3C2569B2), ("abc", 0xB3DD93FA),
                   ("hello", 0x248BFA47), ("Hello, world!", 0xC0363E43),
                   ("The quick brown fox jumps over the lazy dog",
                    0x2E4FF723)]
        for s, exp in vectors:
            assert murmur3_hash(s, encoding="utf-8") & 0xFFFFFFFF == exp

    def test_default_encoding_is_java_chars(self):
        """Two bytes per Java char (little-endian UTF-16 code units)."""
        assert murmur3_hash("a") == murmur3_hash_bytes_oracle(b"a\x00")
        assert murmur3_hash("ab") == \
            murmur3_hash_bytes_oracle(b"a\x00b\x00")

    def test_shard_distribution(self):
        counts = [0] * 5
        for i in range(2000):
            counts[shard_for(f"doc-{i}", 5)] += 1
        for c in counts:
            assert 0.6 * 400 < c < 1.4 * 400

    def test_routing_stability(self):
        assert shard_for("my-doc", 8) == shard_for("my-doc", 8)
        assert 0 <= shard_for("x", 3) < 3

    def test_hash_matches_reference(self, seeded_random):
        keys = ["", "a", "d0", "é", "日本語", "\U0001F600 surrogate pair",
                *(f"doc-{seeded_random.randrange(10 ** 9)}"
                  for _ in range(500))]
        for key in keys:
            assert murmur3_hash(key) == ref_murmur3(key), key


class TestIndicesService:
    def test_create_index_and_crud(self, tmp_path):
        svc = IndicesService(str(tmp_path))
        idx = svc.create_index(
            "logs", Settings.of({"index": {"number_of_shards": 3}}),
            {"properties": {"msg": {"type": "text"}}})
        assert idx.num_shards == 3
        assert len(idx.shards) == 3
        shard = idx.shard(idx.shard_for_id("doc1"))
        shard.apply_index_on_primary("doc1", {"msg": "hello shard"})
        assert shard.get("doc1")["_source"]["msg"] == "hello shard"
        svc.close()

    def test_duplicate_and_missing(self, tmp_path):
        svc = IndicesService(str(tmp_path))
        svc.create_index("a")
        with pytest.raises(IndexAlreadyExistsException):
            svc.create_index("a")
        with pytest.raises(IndexNotFoundException):
            svc.index("nope")
        svc.delete_index("a")
        with pytest.raises(IndexNotFoundException):
            svc.delete_index("a")
        svc.close()

    @pytest.mark.parametrize("bad", ["UPPER", "_hidden", "a b", "x/y", ".."])
    def test_invalid_names(self, tmp_path, bad):
        svc = IndicesService(str(tmp_path))
        with pytest.raises(IllegalArgumentException):
            svc.create_index(bad)

    def test_shard_reopen_from_disk(self, tmp_path):
        svc = IndicesService(str(tmp_path))
        idx = svc.create_index("persist", index_uuid="fixed-uuid")
        shard = idx.shard(0)
        shard.apply_index_on_primary("d", {"field": "value"})
        shard.flush()
        svc.close()
        svc2 = IndicesService(str(tmp_path))
        idx2 = svc2.index("persist")
        assert idx2.index_uuid == "fixed-uuid"
        assert idx2.shard(0).get("d")["_source"]["field"] == "value"
        svc2.close()


class TestGatewayMetadataPersistence:
    def test_indices_survive_service_restart(self, tmp_path):
        svc = IndicesService(str(tmp_path))
        idx = svc.create_index(
            "books", Settings.of({"index": {"number_of_shards": 2}}),
            {"properties": {"title": {"type": "text"}}})
        idx.shard(idx.shard_for_id("1")).apply_index_on_primary(
            "1", {"title": "the hobbit"})
        idx.flush()
        svc.close()
        svc2 = IndicesService(str(tmp_path))
        assert svc2.has_index("books")
        idx2 = svc2.index("books")
        assert idx2.num_shards == 2
        assert idx2.index_uuid == idx.index_uuid
        assert idx2.mapper.to_mapping()["properties"]["title"]["type"] \
            == "text"
        assert idx2.shard(idx2.shard_for_id("1")).get("1")["_source"] == \
            {"title": "the hobbit"}
        svc2.close()

    def test_deleted_index_stays_deleted(self, tmp_path):
        svc = IndicesService(str(tmp_path))
        svc.create_index("a")
        svc.create_index("b")
        svc.delete_index("a")
        svc.close()
        svc2 = IndicesService(str(tmp_path))
        assert not svc2.has_index("a")
        assert svc2.has_index("b")
        svc2.close()


class TestAliasesAndLifecycle:
    @pytest.mark.parametrize("action", [
        {"add": {"index": "a", "alias": "x"}},
        {"add": {"index": "a*", "alias": "x", "is_write_index": True,
                 "filter": {"term": {"t": "v"}}}},
        {"add": {"index": "a", "alias": "x", "is_write_index": False}},
        {"remove": {"index": "a", "alias": "x"}},
        {"remove": {"index": "a", "alias": "x", "filter": {"wibble": {}}}},
    ])
    def test_parse_alias_action_matches_reference(self, action):
        assert parse_alias_action(action) == ref_parse_alias_action(action)

    @pytest.mark.parametrize("action", [
        [], {"add": {}, "remove": {}}, {"rename": {"index": "a",
                                                   "alias": "x"}},
        {"add": {"index": "a"}}, {"add": {"alias": "x"}},
        {"add": {"index": "a", "alias": "X"}},
        {"add": {"index": "a", "alias": "x", "filter": {"wibble": {}}}}])
    def test_parse_alias_action_refuses_as_reference(self, action):
        with pytest.raises(Exception) as ref_exc:
            ref_parse_alias_action(action)
        with pytest.raises(EsException) as port_exc:
            parse_alias_action(action)
        assert str(port_exc.value) == str(ref_exc.value)
        assert port_exc.value.error_type == ref_exc.value.error_type

    def test_alias_registry_persists(self, tmp_path):
        svc = IndicesService(str(tmp_path))
        svc.create_index("a")
        svc.create_index("b")
        svc.put_alias("a", "both")
        svc.put_alias("b", "both", {"is_write_index": True})
        assert svc.write_index_for("both") == "b"
        assert svc.resolve_write_index("both") == "b"
        assert svc.resolve_write_index("a") == "a"
        svc.delete_alias("a", "both")
        with pytest.raises(ResourceNotFoundException):
            svc.delete_alias("a", "both")
        svc.close()
        svc2 = IndicesService(str(tmp_path))
        assert svc2.alias_targets("both") == {"b": {"is_write_index": True}}
        assert svc2.alias_targets("nope") is None
        svc2.close()

    def test_close_and_open_survive_restart(self, tmp_path):
        svc = IndicesService(str(tmp_path))
        idx = svc.create_index("c", Settings.of(
            {"index": {"number_of_shards": 2}}))
        idx.shard(idx.shard_for_id("d")).apply_index_on_primary(
            "d", {"f": "v"})
        svc.close_index("c")
        assert idx.closed and idx.shards == {}
        with pytest.raises(IndexClosedException):
            idx.shard(0)
        svc.close()
        svc2 = IndicesService(str(tmp_path))
        assert svc2.index("c").closed and svc2.index("c").shards == {}
        svc2.open_index("c")
        idx2 = svc2.index("c")
        assert not idx2.closed and len(idx2.shards) == 2
        assert idx2.shard(idx2.shard_for_id("d")).get("d")["_source"] == \
            {"f": "v"}
        with pytest.raises(IndexNotFoundException):
            svc2.close_index("nope")
        svc2.close()

    def test_search_failure_counters(self, tmp_path):
        svc = IndicesService(str(tmp_path))
        svc.count_search_failure("a", 0)
        svc.count_search_failure("a", 0)
        svc.count_search_failure("a", 2)
        svc.count_search_failure("b", 1)
        assert svc.search_failure_stats() == {"a": {"0": 2, "2": 1},
                                              "b": {"1": 1}}
        svc.close()
