"""The lowered-plan cache, the prewarm and the service's stats: port copy
of tests/test_plan_cache.py (all of it but test_rest_tpu_stats_endpoint,
whose ``_tpu/stats`` route comes with the observability module).

Repeated query shapes skip the lowering, and every invalidation seam (a
mapping update, a pack rebuilt mid-traffic, an index delete) evicts or
revalidates the cached plan: a FlatQuery never runs against a pack it
was not validated on. Where the reference's try_search returns None for
its planner, the port's raises NotLowerable (a query outside the
lowering subset) or returns None (the prewarm's grace), and a kernel
fault reaches the caller (the reference falls back and counts it).
"""

import pytest
import torch

from elasticsearch_tpu_torch.common.errors import NotLowerable
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.indices.service import IndicesService
from elasticsearch_tpu_torch.search import coordinator, dsl
from elasticsearch_tpu_torch.search import gpu_service as svc_mod
from elasticsearch_tpu_torch.search.gpu_service import (NOT_LOWERABLE,
                                                         GpuSearchService,
                                                         PlanCache,
                                                         plan_key)

torch.set_num_threads(1)

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
         "theta", "iota", "kappa", "lamda", "mu"]


@pytest.fixture
def svc(tmp_path):
    s = IndicesService(str(tmp_path))
    yield s
    s.close()


def make_corpus(svc, seeded_np, *, name="corpus", shards=2, docs=80):
    idx = svc.create_index(
        name, Settings.of({"index": {"number_of_shards": shards}}),
        {"properties": {"body": {"type": "text"},
                        "tag": {"type": "keyword"}}})
    for i in range(docs):
        n_words = int(seeded_np.integers(3, 12))
        words = [WORDS[int(w)] for w in
                 seeded_np.integers(0, len(WORDS), n_words)]
        doc_id = f"d{i}"
        shard = idx.shard(idx.shard_for_id(doc_id))
        shard.apply_index_on_primary(
            doc_id, {"body": " ".join(words), "tag": f"t{i % 3}"})
    idx.refresh()
    return idx


BODY = {"query": {"match": {"body": "alpha beta"}}, "size": 10,
        "_source": False}


def search(svc, gpu, body, name="corpus"):
    return coordinator.search(svc, name, dict(body), {}, gpu)


def service(**kw):
    return GpuSearchService(device="cpu", window_s=0.0,
                            batch_timeout_s=300.0, **kw)


class TestPlanKey:
    def test_equal_bodies_equal_keys(self):
        a = plan_key(dsl.MatchQuery(field="body", query="x y"))
        b = plan_key(dsl.MatchQuery(field="body", query="x y"))
        assert a == b and hash(a) == hash(b)

    def test_different_bodies_differ(self):
        a = plan_key(dsl.MatchQuery(field="body", query="x"))
        b = plan_key(dsl.MatchQuery(field="body", query="y"))
        c = plan_key(dsl.TermQuery(field="body", value="x"))
        assert a != b and a != c

    def test_nested_trees(self):
        q = dsl.BoolQuery(should=[dsl.TermQuery(field="body", value="a"),
                                  dsl.TermQuery(field="body", value="b")])
        q2 = dsl.BoolQuery(should=[dsl.TermQuery(field="body", value="a"),
                                   dsl.TermQuery(field="body", value="b")])
        assert plan_key(q) == plan_key(q2)

    def test_unhashable_payload_uncacheable(self):
        q = dsl.TermsQuery(field="body", values=[{"nested": set()}])
        assert plan_key(q) is None


class TestPlanCacheLru:
    def test_lru_bound_and_counters(self):
        pc = PlanCache(max_entries=4)
        for i in range(10):
            pc.put(("i", 0, i), i)
        assert len(pc) == 4
        s = pc.stats()
        assert s["evictions"] == 6 and s["size"] == 4
        assert pc.get(("i", 0, 9)) == 9
        assert pc.get(("i", 0, 0)) is None  # evicted
        s = pc.stats()
        assert s["hits"] == 1 and s["misses"] == 1

    def test_invalidate_index_only_touches_that_index(self):
        pc = PlanCache()
        pc.put(("a", 0, 1), 1)
        pc.put(("b", 0, 1), 2)
        pc.invalidate_index("a")
        assert pc.get(("a", 0, 1)) is None
        assert pc.get(("b", 0, 1)) == 2


class TestServingCacheCoherence:
    def test_repeat_query_hits_cache(self, svc, seeded_np):
        make_corpus(svc, seeded_np)
        gpu = service()
        try:
            r1 = search(svc, gpu, BODY)
            misses_after_first = gpu.plans.stats()["misses"]
            r2 = search(svc, gpu, BODY)
            st = gpu.plans.stats()
            assert st["hits"] >= 1
            assert st["misses"] == misses_after_first  # no re-lowering
            assert [h["_id"] for h in r1["hits"]["hits"]] == \
                   [h["_id"] for h in r2["hits"]["hits"]]
            assert gpu.served >= 2
        finally:
            gpu.close()

    def test_mapping_update_changes_generation_key(self, svc, seeded_np):
        idx = make_corpus(svc, seeded_np)
        gpu = service()
        try:
            search(svc, gpu, BODY)
            gen0 = idx.mapper.generation
            size0 = len(gpu.plans)
            assert size0 >= 1
            idx.mapper.merge(
                {"properties": {"extra": {"type": "keyword"}}})
            assert idx.mapper.generation == gen0 + 1
            # the REST seam also purges the now-unreachable entries
            gpu.invalidate_plans("corpus")
            assert len(gpu.plans) == 0
            # a search after it lowers afresh under the new generation
            misses0 = gpu.plans.stats()["misses"]
            r = search(svc, gpu, BODY)
            assert gpu.plans.stats()["misses"] > misses0
            assert r["hits"]["total"]["value"] >= 0
        finally:
            gpu.close()

    def test_pack_rebuild_revalidates_entry(self, svc, seeded_np):
        idx = make_corpus(svc, seeded_np)
        gpu = service()
        try:
            search(svc, gpu, BODY)
            resident0 = gpu.packs.get(idx, "body")
            # a write and a refresh swap the shard readers: the next
            # lookup rebuilds the pack, the cached plan is revalidated
            # against the new one, and the new doc is visible
            shard = idx.shard(idx.shard_for_id("fresh"))
            shard.apply_index_on_primary(
                "fresh", {"body": "alpha alpha alpha alpha alpha beta"})
            idx.refresh()
            sink = {}
            gpu.try_search(idx, dsl.parse_query(BODY["query"]), k=10,
                           profile_sink=sink)
            assert sink["plan_cache"] == "revalidated"
            fast = search(svc, gpu, BODY)
            resident1 = gpu.packs.get(idx, "body")
            assert resident1 is not resident0
            assert resident1.reader_key != resident0.reader_key
            ids = [h["_id"] for h in fast["hits"]["hits"]]
            assert "fresh" in ids
            # and the kernel path still agrees with the planner path
            slow = search(svc, gpu, dict(BODY, min_score=0.0))
            assert ids == [h["_id"] for h in slow["hits"]["hits"]]
        finally:
            gpu.close()

    def test_index_delete_evicts_plans_and_packs(self, svc, seeded_np):
        make_corpus(svc, seeded_np)
        gpu = service()
        try:
            search(svc, gpu, BODY)
            assert len(gpu.plans) >= 1
            gpu.invalidate_index("corpus")
            assert len(gpu.plans) == 0
            assert gpu.packs.stats()["resident"] == 0
        finally:
            gpu.close()

    def test_not_lowerable_is_cached(self, svc, seeded_np):
        idx = make_corpus(svc, seeded_np)
        gpu = service()
        try:
            phrase = dsl.MatchPhraseQuery(field="body",
                                          query="alpha beta")
            for _ in range(2):
                with pytest.raises(NotLowerable):
                    gpu.try_search(idx, phrase, k=10)
            st = gpu.plans.stats()
            assert st["hits"] >= 1  # the second probe hit the negative
            assert gpu.fallback == 2
            key = ("corpus", idx.mapper.generation, plan_key(phrase))
            assert gpu.plans.get(key) is NOT_LOWERABLE
        finally:
            gpu.close()

    def test_kernel_error_still_retried_with_cached_plan(
            self, svc, seeded_np, monkeypatch):
        """The plan cache memoizes the lowering, not a train's outcome:
        a kernel failure is not replayed from the cache, the next equal
        query runs its train again (and the fault reaches the caller)."""
        idx = make_corpus(svc, seeded_np)
        gpu = service()
        calls = []

        def boom(resident, flats, k, **kw):
            calls.append(len(flats))
            raise RuntimeError("injected kernel failure")

        monkeypatch.setattr(svc_mod, "launch_flat_batch", boom)
        try:
            q = dsl.MatchQuery(field="body", query="alpha")
            for _ in range(2):
                with pytest.raises(RuntimeError,
                                   match="injected kernel failure"):
                    gpu.try_search(idx, q, k=10)
            assert calls == [1, 1] and gpu.served == 0
            assert gpu.plans.stats()["hits"] >= 1
        finally:
            gpu.close()


class TestColdStartGrace:
    def test_warming_declines_to_planner(self, svc, seeded_np):
        make_corpus(svc, seeded_np)
        gpu = service()
        try:
            gpu._warming = True
            r = search(svc, gpu, BODY)
            assert gpu.served == 0 and gpu.fallback >= 1
            assert r["hits"]["total"]["value"] >= 0  # the planner answered
            gpu._warming = False
            search(svc, gpu, BODY)
            assert gpu.served >= 1
        finally:
            gpu.close()

    def test_prewarm_dedupes_and_reports_progress(self, svc, seeded_np,
                                                  monkeypatch):
        idx = make_corpus(svc, seeded_np)
        monkeypatch.setattr(svc_mod, "_execute_pruned",
                            lambda *a, **kw: ([], []))
        monkeypatch.setattr(svc_mod, "_execute_exact",
                            lambda *a, **kw: [])
        # a raw pack: the pruned tiers' signatures (packed and ref) are
        # in its warm table; a compressed pack warms the exact ones only
        gpu = service(compressed_pack=False)
        try:
            warm = gpu.prewarm(idx, "body", concurrency=3)
            assert not gpu._warming  # cleared on the happy path too
            prog = gpu.stats()["prewarm"]
            assert prog["state"] == "done"
            assert prog["done"] == prog["total"] == len(warm["compiled"])
            # deduped: each warmed entry is one signature (the variant
            # is part of it)
            sigs = []
            for e in warm["compiled"]:
                if e.get("exact"):
                    sigs.append((e["batch"], "exact",
                                 svc_mod._candidate_k(e["k"]),
                                 e.get("variant")))
                else:
                    sigs.append((e["batch"], svc_mod._candidate_k(e["k"]),
                                 e["slots"], e["prefix"],
                                 e.get("variant")))
            assert len(sigs) == len(set(sigs))
            # packed_sort on (the default) and a packable corpus: both
            # variants are in the table
            assert {e.get("variant") for e in warm["compiled"]} == \
                {"packed", "ref"}
            assert not any(e.get("error") for e in warm["compiled"])
        finally:
            gpu.close()

    def test_prewarm_async_sets_done_state(self, svc, seeded_np,
                                           monkeypatch):
        idx = make_corpus(svc, seeded_np)
        monkeypatch.setattr(svc_mod, "_execute_pruned",
                            lambda *a, **kw: ([], []))
        monkeypatch.setattr(svc_mod, "_execute_exact",
                            lambda *a, **kw: [])
        gpu = service()
        try:
            t = gpu.prewarm_async(idx, "body")
            t.join(timeout=60)
            assert not t.is_alive()
            assert gpu.stats()["prewarm"]["state"] == "done"
        finally:
            gpu.close()

    def test_prewarm_runs_every_signature_of_a_compressed_pack(self, svc,
                                                               seeded_np):
        """Unpatched: the compressed pack's two exact variants at their
        two signatures run for real, and a search after it is served."""
        idx = make_corpus(svc, seeded_np)
        gpu = service()
        try:
            warm = gpu.prewarm(idx, "body")
            assert sorted((e["batch"], e["variant"])
                          for e in warm["compiled"]) == [
                (8, "compressed"), (8, "compressed_exact"),
                (64, "compressed"), (64, "compressed_exact")]
            assert not any(e.get("error") for e in warm["compiled"])
            search(svc, gpu, BODY)
            assert gpu.served == 1 and gpu.fallback == 0
        finally:
            gpu.close()


class TestStatsExposure:
    def test_service_stats_shape(self, svc, seeded_np):
        make_corpus(svc, seeded_np)
        gpu = service()
        try:
            search(svc, gpu, BODY)
            search(svc, gpu, BODY)
            st = gpu.stats()
            assert st["plan_cache"]["hits"] >= 1
            assert st["pack_cache"]["resident"] == 1
            assert st["prewarm"]["state"] == "idle"
            lower = st["stages"]["lower"]
            assert {"seconds", "count", "p50_ms", "p95_ms",
                    "p99_ms"} <= set(lower)
        finally:
            gpu.close()
