"""The port's write path and pack residency against the reference.

Engine and segments: the same operations through the reference's and the
port's IndicesService give the same results (seq_no, version, result,
conflicts), the same realtime gets and the same segments — postings,
norms, exact lengths, statistics, keyword doc values and per-doc
metadata — before and after a force merge and across a flush and reload.

Pack residency: the port's IndexPackCache charges the ``hbm`` breaker
with exactly the resident bytes, drains it to 0 across a rebuild and an
index delete and after a failed upload, and rebuilds a pack when the
readers it was built from are replaced (ports of
``tests/test_pack_hbm_accounting.py``). An evicted pack takes no new
work: a search that looked it up just before its eviction is served by
its successor, and no batcher queue keeps the evicted arrays alive.
"""

import gc
import os
import threading
import weakref

import numpy as np
import pytest
import torch

from elasticsearch_tpu.common.errors import (
    VersionConflictEngineException as RefConflict)
from elasticsearch_tpu.common.settings import Settings as RefSettings
from elasticsearch_tpu.indices.service import IndicesService as RefIndices

from elasticsearch_tpu_torch.common.breaker import (
    CircuitBreaker, HierarchyCircuitBreakerService)
from elasticsearch_tpu_torch.common.errors import (
    CircuitBreakingException, IndexNotFound, VersionConflictEngineException)
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index.seqno import LocalCheckpointTracker
from elasticsearch_tpu_torch.index.translog import Translog, TranslogOp
from elasticsearch_tpu_torch.indices.service import IndicesService
from elasticsearch_tpu_torch.parallel import distributed as dist
from elasticsearch_tpu_torch.search import dsl
from elasticsearch_tpu_torch.search.gpu_service import GpuSearchService

torch.set_num_threads(1)

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
         "theta"]
MAPPING = {"properties": {"body": {"type": "text"},
                          "tag": {"type": "keyword"}}}


def index_settings(shards):
    return {"index": {"number_of_shards": shards}}


def make_corpus(indices, rng, *, name="corpus", shards=2, docs=80,
                settings_cls=Settings):
    """docs with a text body and a keyword tag, a flush half way (two
    segments a shard), refreshed."""
    idx = indices.create_index(name, settings_cls.of(index_settings(shards)),
                               MAPPING)
    for i in range(docs):
        words = [WORDS[int(w)] for w in
                 rng.integers(0, len(WORDS), int(rng.integers(3, 12)))]
        doc_id = f"d{i}"
        idx.shard(idx.shard_for_id(doc_id)).apply_index_on_primary(
            doc_id, {"body": " ".join(words), "tag": f"t{i % 3}"})
        if i == docs // 2:
            idx.flush()
    idx.refresh()
    return idx


# ---------------------------------------------------------------------------
# engine and segments against the reference
# ---------------------------------------------------------------------------

OPS = [
    ("index", "a", {"body": "alpha beta", "tag": "x"}, {}),
    ("index", "b", {"body": "beta gamma gamma", "tag": ["x", "y"]}, {}),
    ("index", "a", {"body": "alpha alpha", "tag": "z"}, {}),
    ("create", "a", {"body": "conflict"}, {}),
    ("delete", "b", None, {}),
    ("delete", "b", None, {}),
    ("index", "b", {"body": "back again"}, {}),
    ("index", "c", {"body": "cas"}, {"if_seq_no": 99, "if_primary_term": 1}),
    ("index", "d", {"body": "external", "nested": {"k": "v w"}},
     {"version": 7, "version_type": "external"}),
    ("refresh",),
    ("index", "a", {"body": "after refresh"}, {}),
    ("delete", "d", None, {}),
    ("index", "e", {"body": "delta " * 300, "tag": "long"}, {}),
]


def run_ops(idx, conflict_cls):
    shard = idx.shard(0)
    out = []
    for op in OPS:
        if op[0] == "refresh":
            shard.refresh()
            out.append(("refresh",))
            continue
        kind, doc_id, src, kw = op
        try:
            if kind == "delete":
                r = shard.apply_delete_on_primary(doc_id, **kw)
                out.append((kind, r.seq_no, r.primary_term, r.version,
                            r.found))
            else:
                if kind == "create":
                    kw = dict(kw, op_type="create")
                r = shard.apply_index_on_primary(doc_id, src, **kw)
                out.append((kind, r.seq_no, r.primary_term, r.version,
                            r.created, r.result))
        except conflict_cls as exc:
            out.append(("conflict", str(exc)))
        out.append(("get", shard.get(doc_id)))
    return out


def segment_state(seg, live):
    post = {f: {t: (d.tolist(), tf.tolist()) for t, (d, tf) in terms.items()}
            for f, terms in seg.postings.items()}
    dv = {f: (c.kind, c.values.tolist(), c.extra, c.ord_terms)
          for f, c in seg.doc_values.items()}
    return dict(
        n=seg.num_docs, ids=list(seg.doc_ids), post=post,
        norms={f: v.tolist() for f, v in seg.norms.items()},
        exact={f: v.tolist() for f, v in seg.exact_lengths.items()},
        stats={f: (s.doc_count, s.sum_total_term_freq)
               for f, s in seg.field_stats.items()},
        dv=dv, seq=seg.seq_nos.tolist(), terms=seg.primary_terms.tolist(),
        versions=seg.doc_versions.tolist(),
        source=[seg.stored_source[i] for i in range(seg.num_docs)],
        live=live.tolist())


def shard_state(idx):
    reader = idx.shard(0).acquire_searcher()
    return [segment_state(v.segment, v.live_mask[:v.segment.num_docs])
            for v in reader.views]


def test_engine_ops_and_segments_match_reference(tmp_path):
    ref = RefIndices(str(tmp_path / "ref"))
    port = IndicesService(str(tmp_path / "port"))
    try:
        r_idx = ref.create_index("e", RefSettings.of(index_settings(1)),
                                 MAPPING)
        p_idx = port.create_index("e", Settings.of(index_settings(1)),
                                  MAPPING)
        assert run_ops(p_idx, VersionConflictEngineException) == \
            run_ops(r_idx, RefConflict)
        for idx in (r_idx, p_idx):
            idx.refresh()
        assert shard_state(p_idx) == shard_state(r_idx)
        assert p_idx.mapper.to_mapping() == r_idx.mapper.to_mapping()
        for idx in (r_idx, p_idx):
            assert idx.shard(0).engine.force_merge()
        merged = shard_state(p_idx)
        assert len(merged) == 1
        assert merged == shard_state(r_idx)
        assert p_idx.shard(0).engine.num_docs() == \
            r_idx.shard(0).engine.num_docs()
    finally:
        ref.close()
        port.close()


def test_flush_and_reload_keeps_segments_and_tombstones(tmp_path, seeded_np):
    port = IndicesService(str(tmp_path))
    idx = make_corpus(port, seeded_np, name="f", shards=1, docs=40)
    shard = idx.shard(0)
    shard.apply_delete_on_primary("d3")
    shard.apply_index_on_primary("d4", {"body": "replaced"})
    idx.refresh()
    idx.flush()
    shard.apply_index_on_primary("late", {"body": "after the commit"})
    before = shard_state(idx)
    live_before = shard.engine.num_docs()
    port.close()
    again = IndicesService(str(tmp_path))
    try:
        idx2 = again.index("f")
        # the op above the commit replays from the translog
        assert idx2.shard(0).engine.replayed_ops == 1
        assert idx2.shard(0).engine.num_docs() == live_before
        assert shard_state(idx2)[:len(before)] == before
        assert idx2.shard(0).get("late")["_source"] == \
            {"body": "after the commit"}
        assert idx2.shard(0).get("d3") is None
    finally:
        again.close()


def test_translog_async_durability_and_torn_tail(tmp_path):
    log = Translog(str(tmp_path), Translog.DURABILITY_ASYNC)
    log.add(TranslogOp("index", 0, 1, "a", {"body": "x"}))
    log.add_batch([{"op": "index", "seq_no": 1, "primary_term": 1,
                    "version": 1, "id": "b", "source": {"body": "y"}},
                   TranslogOp("delete", 2, 1, "a")])
    assert log.stats()["uncommitted_operations"] == 3
    log.sync()
    assert log.stats()["uncommitted_operations"] == 0
    log.close()
    path = os.path.join(str(tmp_path), "translog-1.tlog")
    with open(path, "ab") as f:
        f.write(b"\x10\x00\x00")  # a torn record header
    again = Translog(str(tmp_path))
    assert [(o.op_type, o.seq_no, o.doc_id) for o in again.snapshot()] == \
        [("index", 0, "a"), ("index", 1, "b"), ("delete", 2, "a")]
    assert [o.seq_no for o in again.snapshot(2)] == [2]
    again.close()


def test_local_checkpoint_waits_for_gaps():
    t = LocalCheckpointTracker()
    seqs = [t.generate_seq_no() for _ in range(4)]
    assert seqs == [0, 1, 2, 3]
    for s in (0, 2, 3):
        t.mark_processed(s)
    assert t.processed_checkpoint == 0
    t.mark_processed(1)
    assert t.processed_checkpoint == 3
    assert t.persisted_checkpoint == -1


def test_breaker_hierarchy_trips_and_rolls_back():
    svc = HierarchyCircuitBreakerService(total_limit_bytes=1000)
    hbm = svc.get_breaker("hbm")
    assert hbm.limit == 900
    hbm.add_estimate_bytes_and_maybe_break(800, label="pack")
    with pytest.raises(CircuitBreakingException):
        hbm.add_estimate_bytes_and_maybe_break(200, label="pack")
    svc.get_breaker("request").add_estimate_bytes_and_maybe_break(100)
    with pytest.raises(CircuitBreakingException):
        svc.get_breaker("request").add_estimate_bytes_and_maybe_break(200)
    assert svc.get_breaker("request").used == 100  # rolled back
    hbm.release(800)
    assert svc.stats()["parent"]["estimated_size_in_bytes"] == 100
    assert hbm.trip_count == 1


def test_settings_flatten_like_the_reference():
    body = {"index": {"number_of_shards": 3, "translog": {
        "durability": "async"}}, "refresh_interval_seconds": 2}
    assert Settings.of(body).get_as_dict() == \
        RefSettings.of(body).get_as_dict()
    assert Settings.normalize_index_settings(body) == \
        RefSettings.normalize_index_settings(body)
    s = Settings.of({"a": {"b": "true", "n": "5"}})
    assert s.get_bool("a.b") is True and s.get_int("a.n") == 5


# ---------------------------------------------------------------------------
# the hbm breaker across the pack lifecycle (tests/test_pack_hbm_accounting)
# ---------------------------------------------------------------------------

def resident_bytes(svc):
    return sum(t.numel() * t.element_size()
               for r in svc.packs.residents() for t in r.device_arrays)


def test_hbm_drains_to_zero_across_pack_lifecycle(tmp_path, seeded_np):
    indices = IndicesService(str(tmp_path))
    idx = make_corpus(indices, seeded_np, name="acct", docs=80)
    breaker = CircuitBreaker("hbm", 1 << 30)
    gpu = GpuSearchService(device="cpu", window_s=0.0, breaker=breaker)
    try:
        q = dsl.MatchQuery(field="body", query="alpha beta")
        # build: exactly one pack charged, the charge is its bytes
        assert breaker.used == 0
        assert gpu.try_search(idx, q, k=10).total_hits > 0
        detail = gpu.packs.stats()["packs"]["acct/body"]
        assert breaker.used == detail["hbm_bytes"] == resident_bytes(gpu) > 0
        # rebuild under concurrent search: the old charge is released
        # exactly once, only the new pack stays charged
        for i in range(80, 110):
            shard = idx.shard(idx.shard_for_id(f"d{i}"))
            shard.apply_index_on_primary(f"d{i}", {"body": "alpha gamma",
                                                   "tag": "t0"})
        idx.refresh()
        errs = []

        def hammer():
            try:
                for _ in range(3):
                    gpu.try_search(idx, q, k=10)
            except Exception as e:  # pragma: no cover - surfaced below
                errs.append(e)

        threads = [threading.Thread(target=hammer) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs
        detail2 = gpu.packs.stats()["packs"]["acct/body"]
        assert breaker.used == detail2["hbm_bytes"] == resident_bytes(gpu)
        assert detail2["hbm_bytes"] != detail["hbm_bytes"]
        assert gpu.packs.misses == 2
        # evict: the drain is exact
        indices.delete_index("acct")
        gpu.invalidate_index("acct")
        assert gpu.packs.stats()["packs"] == {}
        assert breaker.used == 0
    finally:
        gpu.close()
        indices.close()


def test_build_failure_refunds_charge(tmp_path, seeded_np, monkeypatch):
    """An upload that dies mid-build refunds the whole charge; the cache
    recovers once placement works again."""
    indices = IndicesService(str(tmp_path))
    idx = make_corpus(indices, seeded_np, name="boom", docs=40)
    breaker = CircuitBreaker("hbm", 1 << 30)
    gpu = GpuSearchService(device="cpu", window_s=0.0, breaker=breaker)
    try:
        monkeypatch.setattr(
            dist, "device_put_compressed",
            lambda *a, **k: (_ for _ in ()).throw(RuntimeError("hbm oom")))
        q = dsl.MatchQuery(field="body", query="alpha")
        with pytest.raises(RuntimeError, match="hbm oom"):
            gpu.try_search(idx, q, k=5)
        assert breaker.used == 0
        monkeypatch.undo()
        assert gpu.try_search(idx, q, k=5).total_hits > 0
        detail = gpu.packs.stats()["packs"]["boom/body"]
        assert breaker.used == detail["hbm_bytes"] == resident_bytes(gpu) > 0
    finally:
        gpu.close()
        indices.close()
    assert breaker.used == 0  # close drops every pack


def queued_residents(svc):
    return [q.resident for q in svc.batcher._queues.values()]


def test_submit_after_eviction_opens_no_queue(tmp_path, seeded_np):
    """A search holds the pack it looked up; a rebuild evicts that pack
    before the search submits. The submit is refused, the search runs on
    the new pack, and the batcher keeps queues only for cached packs."""
    indices = IndicesService(str(tmp_path))
    idx = make_corpus(indices, seeded_np, name="race", docs=60)
    breaker = CircuitBreaker("hbm", 1 << 30)
    gpu = GpuSearchService(device="cpu", window_s=0.0, breaker=breaker)
    q = dsl.MatchQuery(field="body", query="alpha zznew")
    try:
        assert gpu.try_search(idx, q, k=10).total_hits > 0
        old = gpu.packs.residents()[0]
        for i in range(60, 70):
            shard = idx.shard(idx.shard_for_id(f"d{i}"))
            shard.apply_index_on_primary(f"d{i}", {"body": "zznew"})
        idx.refresh()
        real_get, real_submit = gpu.packs.get, gpu.batcher.submit
        calls = []

        def stale_get(index_service, field):
            # the lookup returns the pack of the previous refresh, as a
            # lookup made just before the refresh would
            return old if not calls else real_get(index_service, field)

        def submit(resident, flat, k):
            calls.append(resident)
            if resident is old:
                # the rebuild lands between the lookup and the submit
                assert real_get(idx, "body") is not old
                assert old.retired
            return real_submit(resident, flat, k)

        gpu.packs.get, gpu.batcher.submit = stale_get, submit
        got = gpu.try_search(idx, q, k=10)
        gpu.packs.get, gpu.batcher.submit = real_get, real_submit
        assert calls[0] is old and calls[1] is not old
        new = gpu.packs.residents()[0]
        assert calls[1] is new
        assert got.total_hits == gpu.try_search(idx, q, k=10).total_hits
        assert got.resident is new
        assert queued_residents(gpu) == [new]
        assert breaker.used == new.hbm_bytes == resident_bytes(gpu)
        assert real_submit(old, None, 10) is None
        assert queued_residents(gpu) == [new]
    finally:
        gpu.close()
        indices.close()
    assert breaker.used == 0


def test_bare_service_search_after_refresh_retires_its_pack():
    """The service's own indices: a refresh between a search's pack
    lookup and its submit retires the pack; the search runs on the pack
    rebuilt from the refreshed segments."""
    gpu = GpuSearchService(device="cpu", window_s=0.0)
    body = {"query": {"match": {"body": "alpha"}}, "size": 50}
    try:
        gpu.create_index("bare", number_of_shards=2, mapping=MAPPING)
        gpu.index("bare", [(f"d{i}", {"body": "alpha beta"})
                           for i in range(20)])
        gpu.refresh("bare")
        assert gpu.search("bare", body)["hits"]["total"]["value"] == 20
        old = gpu.resident("bare", "body")
        real_submit = gpu.batcher.submit
        calls = []

        def submit(resident, flat, k):
            calls.append(resident)
            if resident is old:
                gpu.index("bare", [(f"n{i}", {"body": "alpha"})
                                   for i in range(5)])
                gpu.refresh("bare")
                assert old.retired
            return real_submit(resident, flat, k)

        gpu.batcher.submit = submit
        got = gpu.search("bare", body)
        gpu.batcher.submit = real_submit
        assert calls[0] is old and calls[1] is not old
        assert got["hits"]["total"]["value"] == 25
        assert queued_residents(gpu) == [gpu.resident("bare", "body")]
    finally:
        gpu.close()


def test_build_racing_index_delete_is_not_cached(tmp_path, seeded_np,
                                                 monkeypatch):
    """An index deleted while its pack builds: the pack is not cached,
    its charge is released, and the search answers index-not-found."""
    indices = IndicesService(str(tmp_path))
    idx = make_corpus(indices, seeded_np, name="gone", docs=40)
    breaker = CircuitBreaker("hbm", 1 << 30)
    gpu = GpuSearchService(device="cpu", window_s=0.0, breaker=breaker)
    real_build = gpu.packs._build
    built = []

    def build(readers, field, reader_key):
        entry = real_build(readers, field, reader_key)
        built.append(entry)
        assert breaker.used == entry.hbm_bytes > 0
        indices.delete_index("gone")
        gpu.invalidate_index("gone")
        return entry

    monkeypatch.setattr(gpu.packs, "_build", build)
    try:
        with pytest.raises(IndexNotFound, match=r"no such index \[gone\]"):
            gpu.try_search(idx, dsl.MatchQuery(field="body", query="alpha"),
                           k=5)
        assert built[0].retired
        assert breaker.used == 0
        assert gpu.packs.residents() == [] and queued_residents(gpu) == []
    finally:
        gpu.close()
        indices.close()


def test_breaker_trip_refuses_the_build(tmp_path, seeded_np):
    indices = IndicesService(str(tmp_path))
    idx = make_corpus(indices, seeded_np, name="tiny", docs=40)
    breaker = CircuitBreaker("hbm", 1024)
    gpu = GpuSearchService(device="cpu", window_s=0.0, breaker=breaker)
    try:
        with pytest.raises(CircuitBreakingException):
            gpu.try_search(idx, dsl.MatchQuery(field="body", query="alpha"),
                           k=5)
        assert breaker.used == 0 and gpu.packs.residents() == []
    finally:
        gpu.close()
        indices.close()


def test_pack_rebuilt_when_its_readers_are_replaced(tmp_path, seeded_np):
    """The cache keys on id() of the shard readers. The pack holds the
    readers it was built from, so no freed reader's id can come back on
    a new reader while the pack serves: refresh, drop every other
    reference, refresh again, and the pack is rebuilt."""
    indices = IndicesService(str(tmp_path))
    idx = make_corpus(indices, seeded_np, name="ids", shards=1, docs=30)
    gpu = GpuSearchService(device="cpu", window_s=0.0)
    q = dsl.TermQuery(field="body", value="zzfresh")
    try:
        assert gpu.try_search(idx, q, k=5).total_hits == 0
        first = gpu.packs.residents()[0]
        shard = idx.shard(0)
        assert first.readers[0] is shard.acquire_searcher()
        ref = weakref.ref(first.readers[0])
        del first
        for round_ in range(3):
            shard.apply_index_on_primary(f"n{round_}", {"body": "zzfresh"})
            shard.refresh()  # a new reader; the old one only in the pack
            gc.collect()
            assert ref() is not None  # held by the resident pack
            got = gpu.try_search(idx, q, k=5)
            assert got.total_hits == round_ + 1
            resident = gpu.packs.residents()[0]
            assert resident.readers[0] is shard.acquire_searcher()
            ref = weakref.ref(resident.readers[0])
            del resident
        assert gpu.packs.misses == 4
    finally:
        gpu.close()
        indices.close()


def test_bare_service_concurrent_first_searches_build_one_pack():
    """Searches that arrive together at a fresh index of the service's
    own share one reader per shard, so one pack is built, not one each."""
    from concurrent.futures import ThreadPoolExecutor
    gpu = GpuSearchService(device="cpu", window_s=0.0)
    body = {"query": {"match": {"body": "alpha"}}, "size": 5}
    try:
        gpu.create_index("fresh", number_of_shards=4, mapping=MAPPING)
        gpu.index("fresh", [(f"d{i}", {"body": "alpha beta"})
                            for i in range(40)])
        gpu.refresh("fresh")
        with ThreadPoolExecutor(max_workers=8) as pool:
            totals = list(pool.map(
                lambda _: gpu.search("fresh", body)["hits"]["total"][
                    "value"], range(8)))
        assert totals == [40] * 8
        assert gpu.packs.misses == 1
    finally:
        gpu.close()
