"""The port's streaming delta chain against the JAX package's, bit for bit.

An append-only refresh of a resident index rides a small raw delta pack
chained on the base (each delta bakes the statistics of its own rows);
a search unions the base's and the deltas' top-k on the host; a
compaction folds the chain into one base. The same writes go into a
reference IndicesService and a port one; the reference's
TpuSearchService and the port's GpuSearchService (device "cpu", the
plain path) then answer the same lowered queries, and the results must
agree: ids in order, scores as uint32, totals and their relation.

Port copies of tests/test_delta_packs.py's six tests (its flight-recorder
assertions wait for the port's flight recorder), each held against the
reference's chain on the same operands; then the smallest REST sequence
that showed the port leaving the reference after an append-only refresh,
through both nodes on compressed and raw packs; a (1, 4) CPU mesh; and a
delta's OR body on the prefix tier with one u32 key a lane (pack_keys).
"""

import json

import numpy as np
import pytest
import torch

from elasticsearch_tpu.common.breaker import CircuitBreaker as RefBreaker
from elasticsearch_tpu.common.settings import Settings as RefSettings
from elasticsearch_tpu.indices.service import IndicesService as RefIndices
from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.search import dsl as ref_dsl
from elasticsearch_tpu.search import tpu_service as jtpu
from elasticsearch_tpu.search.serializer import dumps_response as ref_dumps

from elasticsearch_tpu_torch.common.breaker import CircuitBreaker
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.indices.service import IndicesService
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops import merge_kernel
from elasticsearch_tpu_torch.parallel.mesh import make_mesh
from elasticsearch_tpu_torch.search import dsl, gpu_service
from elasticsearch_tpu_torch.search.gpu_service import (
    COMPACTION_FAULT_HOOKS, GpuSearchService)
from elasticsearch_tpu_torch.search.serializer import dumps_response

pytestmark = pytest.mark.streaming

torch.set_num_threads(1)

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
         "theta", "iota", "kappa", "lamda", "mu"]
MAPPING = {"properties": {"body": {"type": "text"},
                          "tag": {"type": "keyword"}}}
KEY = "body"


class Pair:
    """The same index in a reference and a port IndicesService; every
    write goes to both."""

    def __init__(self, tmp_path, name, docs, seed, shards=2):
        self.ref = RefIndices(str(tmp_path / "ref"))
        self.port = IndicesService(str(tmp_path / "port"))
        self.name = name
        settings = {"index": {"number_of_shards": shards}}
        self.ridx = self.ref.create_index(name, RefSettings.of(settings),
                                          MAPPING)
        self.pidx = self.port.create_index(name, Settings.of(settings),
                                           MAPPING)
        rng = np.random.default_rng(seed)
        for i in range(docs):
            words = [WORDS[int(w)] for w in
                     rng.integers(0, len(WORDS), int(rng.integers(3, 12)))]
            self.index(f"d{i}", {"body": " ".join(words),
                                 "tag": f"t{i % 3}"})
            if i == docs // 2:
                self.flush()   # several segments a shard
        self.refresh()

    def _both(self, fn):
        for idx in (self.ridx, self.pidx):
            fn(idx)

    def index(self, doc_id, source):
        self._both(lambda idx: idx.shard(idx.shard_for_id(doc_id))
                   .apply_index_on_primary(doc_id, source))

    def delete(self, doc_id):
        self._both(lambda idx: idx.shard(idx.shard_for_id(doc_id))
                   .apply_delete_on_primary(doc_id))

    def append(self, lo, hi, text="alpha sigma"):
        for i in range(lo, hi):
            self.index(f"s{i}", {"body": text, "tag": "t9"})

    def refresh(self):
        self._both(lambda idx: idx.refresh())

    def flush(self):
        self._both(lambda idx: idx.flush())

    def close(self):
        self.ref.close()
        self.port.close()


@pytest.fixture
def pair_factory(tmp_path):
    made = []

    def make(name, docs, seed=7, **kw):
        p = Pair(tmp_path / name, name, docs, seed, **kw)
        made.append(p)
        return p
    yield make
    for p in made:
        p.close()


def port_service(**kw):
    delta = kw.pop("delta", {"enabled": True})
    return GpuSearchService(device=kw.pop("device", "cpu"), window_s=0.0,
                            batch_timeout_s=300.0, delta=delta, **kw)


def ref_service(**delta_kw):
    delta = {"enabled": True}
    delta.update(delta_kw)
    return jtpu.TpuSearchService(window_s=0.0, batch_timeout_s=300.0,
                                 delta=delta)


def query(text):
    return (ref_dsl.MatchQuery(field="body", query=text),
            dsl.MatchQuery(field="body", query=text))


def ids_of(result):
    if result.resident is None:
        return []
    return result.resident.resolve_ids(result.rows, result.ords).tolist()


def assert_same(got, want):
    """Port result == reference result: ids in order, scores as uint32,
    totals and relation."""
    assert got is not None and want is not None
    assert ids_of(got) == ids_of(want)
    np.testing.assert_array_equal(
        np.asarray(got.scores, dtype=np.float32).view(np.uint32),
        np.asarray(want.scores, dtype=np.float32).view(np.uint32))
    assert got.total_hits == want.total_hits
    assert got.total_relation == want.total_relation


def search_both(pair, port, ref, text, k):
    rq, pq = query(text)
    want = ref.try_search(pair.ridx, rq, k=k)
    got = port.try_search(pair.pidx, pq, k=k)
    assert_same(got, want)
    return got


def test_append_only_refresh_rides_a_delta(pair_factory):
    pair = pair_factory("dp", 60)
    port = port_service(breaker=CircuitBreaker("hbm", 1 << 30))
    ref = ref_service()
    try:
        r0 = search_both(pair, port, ref, "alpha sigma", 100)
        assert port.packs.misses == 1
        pair.append(0, 25)
        pair.refresh()
        r1 = search_both(pair, port, ref, "alpha sigma", 100)
        # no full rebuild: the refresh rode a delta, as the reference's
        assert port.packs.misses == 1
        assert port.delta_stats.appends == ref.delta_stats.appends == 1
        st = port.stats()["deltas"]
        assert st["packs"] == 1 and st["bytes"] > 0
        assert r1.total_hits > r0.total_hits
        assert {f"s{i}" for i in range(25)} <= set(ids_of(r1))
    finally:
        port.close()
        ref.close()


def test_tombstones_force_full_rebuild(pair_factory):
    pair = pair_factory("dp2", 40)
    port, ref = port_service(), ref_service()
    try:
        search_both(pair, port, ref, "alpha", 10)
        assert port.packs.misses == 1
        # a delete changes committed live masks: live_version bumps and
        # the image rebuilds whole
        pair.delete("d0")
        pair.refresh()
        search_both(pair, port, ref, "alpha", 10)
        assert port.packs.misses == 2
        assert port.delta_stats.appends == ref.delta_stats.appends == 0
        assert port.stats()["deltas"]["packs"] == 0
    finally:
        port.close()
        ref.close()


def test_breaker_drains_to_exactly_zero_across_delta_lifecycle(
        pair_factory):
    pair = pair_factory("dp3", 50)
    breaker = CircuitBreaker("hbm", 1 << 30)
    port, ref = port_service(breaker=breaker), ref_service()
    try:
        search_both(pair, port, ref, "alpha sigma", 10)
        base_bytes = breaker.used
        assert base_bytes > 0
        pair.append(0, 15)
        pair.refresh()
        search_both(pair, port, ref, "alpha sigma", 10)
        st = port.stats()["deltas"]
        assert st["packs"] == 1
        # the delta's charge is exactly its own bytes
        assert breaker.used == base_bytes + st["bytes"]
        # a fold releases the old base and the delta exactly
        assert port.packs.compact(("dp3", KEY)) is True
        assert ref.packs.compact(("dp3", KEY)) is True
        st = port.stats()["deltas"]
        assert st["packs"] == 0 and st["bytes"] == 0
        assert st["compactions"] == 1
        detail = port.packs.stats()["packs"]["dp3/body"]
        assert breaker.used == detail["hbm_bytes"] > 0
        search_both(pair, port, ref, "alpha sigma", 10)
        # a chain again, then the delete: every charge drains to 0
        pair.append(15, 20)
        pair.refresh()
        search_both(pair, port, ref, "alpha sigma", 10)
        assert port.stats()["deltas"]["packs"] == 1
        port.invalidate_index("dp3")
        assert breaker.used == 0
        assert port.stats()["deltas"]["packs"] == 0
    finally:
        port.close()
        ref.close()


def test_compaction_matches_delta_disabled_full_build(pair_factory):
    """A fold is one pack over every segment with the row groups a full
    build uses: equal to a delta-off service's pack, and to the
    reference's fold."""
    pair = pair_factory("dp4", 60)
    port, ref = port_service(), ref_service()
    full = port_service(delta=None)
    try:
        search_both(pair, port, ref, "alpha sigma", 10)
        pair.append(0, 20)
        pair.refresh()
        search_both(pair, port, ref, "alpha sigma", 10)
        assert port.stats()["deltas"]["packs"] == 1
        assert port.packs.compact(("dp4", KEY)) is True
        assert ref.packs.compact(("dp4", KEY)) is True
        a = search_both(pair, port, ref, "alpha sigma", 50)
        b = full.try_search(pair.pidx, query("alpha sigma")[1], k=50)
        assert_same(a, b)
        assert full.stats()["deltas"]["enabled"] is False
    finally:
        port.close()
        ref.close()
        full.close()


def test_chain_bit_identical_to_independent_rebuild(pair_factory):
    """Two port services through the same refresh history build their
    images apart and answer alike, and as the reference's chain."""
    pair = pair_factory("dp5", 60)
    a, b, ref = port_service(), port_service(), ref_service()
    try:
        for lo, hi in ((0, 0), (0, 18), (18, 40)):
            if hi > lo:
                pair.append(lo, hi)
                pair.refresh()
            ra = search_both(pair, a, ref, "alpha sigma", 50)
            rb = b.try_search(pair.pidx, query("alpha sigma")[1], k=50)
            assert_same(ra, rb)
        assert a.delta_stats.appends == b.delta_stats.appends == 2
        assert ref.delta_stats.appends == 2
    finally:
        a.close()
        b.close()
        ref.close()


def test_compaction_failure_keeps_chain_serving(pair_factory):
    pair = pair_factory("dp6", 40)
    breaker = CircuitBreaker("hbm", 1 << 30)
    port, ref = port_service(breaker=breaker), ref_service()

    def boom(key):
        raise RuntimeError("injected compaction fault")

    COMPACTION_FAULT_HOOKS.append(boom)
    try:
        search_both(pair, port, ref, "alpha sigma", 10)
        pair.append(0, 10)
        pair.refresh()
        search_both(pair, port, ref, "alpha sigma", 10)
        used_before = breaker.used
        assert port.packs.compact(("dp6", KEY)) is False
        assert port.delta_stats.compaction_failures == 1
        # the failed fold charged and released nothing; the chain serves
        assert breaker.used == used_before
        r = search_both(pair, port, ref, "alpha sigma", 50)
        assert "s0" in ids_of(r)
        COMPACTION_FAULT_HOOKS.remove(boom)
        assert port.packs.compact(("dp6", KEY)) is True
        assert ref.packs.compact(("dp6", KEY)) is True
        search_both(pair, port, ref, "alpha sigma", 50)
    finally:
        if boom in COMPACTION_FAULT_HOOKS:
            COMPACTION_FAULT_HOOKS.remove(boom)
        port.close()
        ref.close()


def test_compactor_folds_a_long_chain(pair_factory):
    """Past max_packs the background compactor folds the chain; at the
    quiescent point after both folds the two services agree."""
    pair = pair_factory("dp7", 40)
    port, ref = port_service(delta={"enabled": True, "max_packs": 2}), \
        ref_service(max_packs=2)
    try:
        search_both(pair, port, ref, "alpha sigma", 30)
        for i in range(3):
            pair.append(10 * i, 10 * i + 10)
            pair.refresh()
            search_both(pair, port, ref, "alpha sigma", 30)
        deadline = 60.0
        import time
        t0 = time.monotonic()
        while time.monotonic() - t0 < deadline and not (
                port.compaction_idle()
                and port.delta_stats.compactions == 1
                and ref.delta_stats.compactions == 1
                and ref.stats()["deltas"]["packs"] == 0):
            time.sleep(0.02)
        assert port.delta_stats.compactions == 1
        assert port.stats()["deltas"]["packs"] == 0
        assert ref.stats()["deltas"]["packs"] == 0
        search_both(pair, port, ref, "alpha sigma", 30)
    finally:
        port.close()
        ref.close()


# ---------------------------------------------------------------------------
# through both nodes' REST
# ---------------------------------------------------------------------------

def call(node, dumps, method, path, body=None, params=None):
    raw = json.dumps(body).encode() if body is not None else b""
    status, payload = node.handle(method, path, params or {}, None, raw)
    if isinstance(payload, dict) and "took" in payload:
        payload["took"] = 0
    return status, dumps(payload)


@pytest.fixture(scope="module", autouse=True)
def restore_reference_config():
    """The reference's kernel settings are process-wide: put them back."""
    saved = dict(jtpu.KERNEL_CONFIG)
    yield
    jtpu.KERNEL_CONFIG.clear()
    jtpu.KERNEL_CONFIG.update(saved)


@pytest.mark.parametrize("compressed", [True, False],
                         ids=["compressed", "raw"])
def test_append_after_a_search_gives_the_reference_bytes(tmp_path,
                                                         compressed):
    """Two docs, a refresh, a search (the pack resident), one more doc
    with refresh=true, a search: the reference scores the first doc
    with the base's statistics and the new one with its delta's, and so
    does the port (a rebuild of the whole pack would score both with
    the statistics of all three)."""
    kernel = {"search.tpu_serving.kernel.compressed_pack": compressed}
    ref = RefNode(str(tmp_path / "ref"), settings=RefSettings.of(
        dict(kernel, **{"search.flight_recorder.enabled": False})))
    port = Node(str(tmp_path / "port"), device="cpu",
                settings=Settings.of(kernel))
    steps = [
        ("PUT", "/i", {"settings": {"number_of_shards": 1},
                       "mappings": {"properties": {
                           "body": {"type": "text"}}}}, None),
        ("PUT", "/i/_doc/a", {"body": "theta alpha gamma"}, None),
        ("PUT", "/i/_doc/b", {"body": "alpha beta beta"}, None),
        ("POST", "/i/_refresh", None, None),
        ("POST", "/i/_search", {"query": {"match": {"body": "alpha"}}},
         None),
        ("PUT", "/i/_doc/c", {"body": "alpha zeta zeta zeta"},
         {"refresh": "true"}),
        ("POST", "/i/_search", {"query": {"match": {
            "body": "theta alpha"}}, "size": 1}, None),
        ("POST", "/i/_search", {"query": {"match": {"body": "alpha"}}},
         None),
    ]
    try:
        for method, path, body, params in steps:
            want = call(ref, ref_dumps, method, path, body, params)
            got = call(port, dumps_response, method, path, body, params)
            assert got == want, (method, path)
        last = json.loads(call(port, dumps_response, "POST", "/i/_search",
                               steps[6][2])[1])
        assert last["hits"]["max_score"] == 0.8754687309265137
        assert port.gpu_search.stats()["deltas"]["appends"] == 1
        assert ref.tpu_search.delta_stats.appends == 1
    finally:
        port.close()
        ref.close()


# ---------------------------------------------------------------------------
# a (1, 4) CPU mesh; the pack_keys route on a delta
# ---------------------------------------------------------------------------

def test_chain_on_a_cpu_mesh(pair_factory):
    """Deltas pad their rows to the mesh's shards axis and run the (1, 4)
    step and its tail as the base does: equal to the reference's chain,
    through a fold too."""
    pair = pair_factory("dpm", 60, shards=3)
    port = port_service(device=None, mesh=make_mesh(
        devices=["cpu"] * 4, shape=(1, 4)))
    ref = ref_service()
    try:
        search_both(pair, port, ref, "alpha sigma gamma", 40)
        for lo, hi in ((0, 9), (9, 30)):
            pair.append(lo, hi, text="sigma alpha alpha")
            pair.refresh()
            search_both(pair, port, ref, "alpha sigma gamma", 40)
            search_both(pair, port, ref, "sigma", 40)
        for p in port.packs._deltas[("dpm", KEY)]:
            assert p.pack.num_shards % 4 == 0
        assert port.packs.compact(("dpm", KEY)) is True
        assert ref.packs.compact(("dpm", KEY)) is True
        search_both(pair, port, ref, "alpha sigma gamma", 40)
    finally:
        port.close()
        ref.close()


def test_delta_or_body_takes_the_pack_keys_route(pair_factory, monkeypatch):
    """With the full-postings tiers shrunk (both packages), a delta's OR
    body takes the prefix tier, where the packed variant sorts one u32
    key a lane (a delta's rows fit 16 bits); the union equals the
    reference's."""
    for mod in (jtpu, gpu_service):
        monkeypatch.setattr(mod, "FULL_SLOT_BUCKETS", (1,))
    modes = []
    real = merge_kernel.pruned_candidates

    def record(*args, **kw):
        modes.append(kw.get("pack_keys", False))
        return real(*args, **kw)

    monkeypatch.setattr(merge_kernel, "pruned_candidates", record)
    pair = pair_factory("dpk", 50)
    port, ref = port_service(), ref_service()
    try:
        search_both(pair, port, ref, "alpha sigma", 20)
        assert modes == []          # a compressed base: the exact launch
        pair.append(0, 20, text="sigma beta alpha")
        pair.refresh()
        search_both(pair, port, ref, "alpha sigma", 20)
        search_both(pair, port, ref, "sigma beta gamma", 20)
        assert modes and all(modes)
        assert port.tier_queries.get("prefix-16k", 0) >= 2
    finally:
        port.close()
        ref.close()
