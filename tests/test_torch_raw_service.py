"""Raw resident packs through the port's service and node against the
JAX package's, byte for byte.

With ``search.tpu_serving.kernel.compressed_pack`` off on both sides
(the setting the reference's own raw-pack tests use) every pack stays in
the raw format, so small corpora reach what a segment above 65,408
documents reaches by itself: the impact-sorted copy, the pruned tiers and
the raw exact variant. Port copies of tests/test_tpu_serving.py::
TestBlockMaxPruning (test_truncated_equivalence at prefix caps 64 and
128, test_validity_failure_falls_back_exact, test_impact_sorted_layout)
and of the raw_pack case of tests/test_pack_hbm_accounting.py. The
reference's copies of the first two run on compressed packs, which send
every query to the exact kernel; these pass compressed_pack=False to both
nodes, compare the reference node's response bytes (the total's relation
included) and check which tier the port took. Last, the boundary: one
segment of 65,409 documents (d_pad 65,536, past the 16-bit doc stream),
which the port refused before raw packs, searched through both services'
routing with equal hits.
"""

import dataclasses
import gc
import json
import weakref

import numpy as np
import pytest
import torch

from elasticsearch_tpu.common.breaker import CircuitBreaker as RefBreaker
from elasticsearch_tpu.common.settings import Settings as RefSettings
from elasticsearch_tpu.index.segment import FieldStats as RefFieldStats
from elasticsearch_tpu.index.segment import Segment as RefSegment
from elasticsearch_tpu.indices.service import IndicesService as RefIndices
from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.parallel import distributed as jdist
from elasticsearch_tpu.parallel.mesh import make_mesh as ref_make_mesh
from elasticsearch_tpu.search import dsl as ref_dsl
from elasticsearch_tpu.search import tpu_service as jtpu
from elasticsearch_tpu.search.serializer import dumps_response as ref_dumps

from elasticsearch_tpu_torch.common.breaker import CircuitBreaker
from elasticsearch_tpu_torch.indices.service import IndicesService
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops import merge_kernel
from elasticsearch_tpu_torch.index.segment import segment_from_token_ids
from elasticsearch_tpu_torch.parallel import distributed as tdist
from elasticsearch_tpu_torch.search import dsl
from elasticsearch_tpu_torch.search import gpu_service
from elasticsearch_tpu_torch.search.gpu_service import (FlatQuery,
                                                         GpuSearchService)
from elasticsearch_tpu_torch.search.serializer import dumps_response

from torch_parity_cases import bulk_ndjson

torch.set_num_threads(1)

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
         "theta", "iota", "kappa", "lamda", "mu"]
MAPPING = {"properties": {"body": {"type": "text"}}}
RAW = {"search.tpu_serving.kernel.compressed_pack": False}


@pytest.fixture(scope="module", autouse=True)
def restore_reference_config():
    """The reference's kernel settings are process-wide: put them back."""
    saved = dict(jtpu.KERNEL_CONFIG)
    yield
    jtpu.KERNEL_CONFIG.clear()
    jtpu.KERNEL_CONFIG.update(saved)


def dense_docs(n=400, seed=61):
    """TestBlockMaxPruning's corpus: one very common term, a rarer one."""
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        words = ["common"] * int(rng.integers(1, 4))
        if i % 3 == 0:
            words += ["rare"] * int(rng.integers(1, 3))
        words += [WORDS[int(w)] for w in rng.integers(0, 6, 4)]
        docs.append((f"d{i}", {"body": " ".join(words)}))
    return docs


def call(node, dumps, method, path, body=None, raw=None):
    if raw is None:
        raw = json.dumps(body).encode() if body is not None else b""
    status, payload = node.handle(method, path, {}, None, raw)
    if isinstance(payload, dict) and "took" in payload:
        payload["took"] = 0
    return status, dumps(payload)


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    ref = RefNode(str(tmp_path_factory.mktemp("ref")), settings=
                  RefSettings.of(dict(RAW, **{
                      "search.flight_recorder.enabled": False})))
    port = Node(str(tmp_path_factory.mktemp("port")), device="cpu",
                settings=gpu_settings())
    body = {"settings": {"number_of_shards": 2}, "mappings": MAPPING}
    for node, dumps in ((ref, ref_dumps), (port, dumps_response)):
        assert call(node, dumps, "PUT", "/dense", body)[0] == 200
        assert call(node, dumps, "POST", "/dense/_bulk",
                    raw=bulk_ndjson(dense_docs()))[0] == 200
        assert call(node, dumps, "POST", "/dense/_refresh")[0] == 200
    try:
        yield ref, port
    finally:
        port.close()
        ref.close()


def gpu_settings():
    from elasticsearch_tpu_torch.common.settings import Settings
    return Settings.of(RAW)


def search_both(nodes, body):
    """The same _search on both nodes → (bytes, the port's new routes)."""
    ref, port = nodes
    served = ref.tpu_search.served
    before = dict(port.gpu_search.tier_queries)
    want = call(ref, ref_dumps, "POST", "/dense/_search", body)
    assert ref.tpu_search.served > served, "reference took its planner"
    got = call(port, dumps_response, "POST", "/dense/_search", body)
    assert got == want
    after = port.gpu_search.tier_queries
    routes = {t: after.get(t, 0) - before.get(t, 0) for t in after
              if after.get(t, 0) != before.get(t, 0)}
    return json.loads(want[1]), routes


BODIES = {
    "or_full_tier": ({"query": {"match": {"body": "common rare"}},
                      "size": 20}, "full-32"),
    "term_full_tier": ({"query": {"term": {"body": "rare"}}, "size": 5,
                        "from": 3}, "full-32"),
    "and_exact_packed": ({"query": {"match": {"body": {
        "query": "common rare alpha", "operator": "and"}}}}, "exact"),
    "msm_exact_packed": ({"query": {"match": {"body": {
        "query": "rare alpha beta gamma", "minimum_should_match": 2}}},
        "size": 30}, "exact"),
    "k_over_1000_exact": ({"query": {"match": {"body": "common"}},
                           "size": 1100}, "exact"),
    "nine_terms_exact": ({"query": {"match": {"body": " ".join(
        ["common", "rare"] + WORDS[:7])}}}, "exact"),
    "boosted_bool": ({"query": {"bool": {"should": [
        {"term": {"body": "alpha"}}, {"term": {"body": "zeta"}}],
        "boost": 3.0}}, "_source": False}, "full-32"),
}


@pytest.mark.parametrize("name", sorted(BODIES))
def test_raw_pack_routes_match_reference_bytes(nodes, name):
    body, tier = BODIES[name]
    resp, routes = search_both(nodes, body)
    assert routes == {tier: 1}
    assert resp["hits"]["total"]["relation"] == "eq"
    ports = nodes[1].gpu_search.packs.stats()["packs"]
    assert ports["dense/body"]["compressed"] is False


@pytest.mark.parametrize("cap", [64, 128])
def test_truncated_equivalence(nodes, monkeypatch, cap):
    """The hot tier at a prefix cap below the common term's postings:
    the same hits, scores and totals as the reference, relation gte."""
    for mod in (jtpu, gpu_service):
        # every query is hot: no full-postings tier holds two slots
        monkeypatch.setattr(mod, "FULL_SLOT_BUCKETS", (1,))
        monkeypatch.setattr(mod, "PREFIX_CAP2", cap)
        monkeypatch.setattr(mod, "PREFIX_CAP3", 2 * cap)
    resp, routes = search_both(nodes, {
        "query": {"match": {"body": "common rare"}}, "size": 20})
    assert routes in ({"prefix-16k": 1},
                      {"prefix-16k": 1, "escalated-64k": 1})
    assert resp["hits"]["total"]["relation"] == "gte"


def test_validity_failure_falls_back_exact(nodes, monkeypatch):
    """A cap so small the bound cannot hold: both prefix tiers fail, the
    exact launch answers (relation eq)."""
    for mod in (jtpu, gpu_service):
        monkeypatch.setattr(mod, "FULL_SLOT_BUCKETS", (1,))
        monkeypatch.setattr(mod, "PREFIX_CAP2", 1)
        monkeypatch.setattr(mod, "PREFIX_CAP3", 1)
    resp, routes = search_both(nodes, {
        "query": {"match": {"body": "common beta"}}, "size": 300})
    assert routes == {"prefix-16k": 1, "escalated-64k": 1, "exact": 1}
    assert resp["hits"]["total"]["relation"] == "eq"


def test_impact_sorted_layout(nodes):
    ref, port = nodes
    resident = port.gpu_search.packs.residents()[0]
    pack = resident.pack
    imp_docs, imp_impacts = resident.imp_host
    for si in range(pack.num_shards):
        rstart = pack.row_starts[si]
        for term, r in pack.vocabs[si].items():
            a, b = int(rstart[r]), int(rstart[r + 1])
            assert (np.diff(imp_impacts[si, a:b]) <= 0).all(), term
            assert sorted(imp_docs[si, a:b].tolist()) == \
                pack.flat_docs[si, a:b].tolist()
    # the reference's copy, bit for bit (its pack pads the rows to its 8
    # virtual devices; the padding rows hold no postings)
    (ref_resident,) = ref.tpu_search.packs._cache.values()
    for got, want in zip(resident.imp_host, ref_resident.imp_host):
        np.testing.assert_array_equal(got, want[:got.shape[0]])
        assert (want[got.shape[0]:] == want[-1, -1]).all()
    np.testing.assert_array_equal(resident.image.parts[0][0][3].numpy(),
                                  imp_docs)


def test_raw_pack_hbm_drains_to_zero(tmp_path):
    """The raw_pack case of the reference's lifecycle test: the charge is
    the reference's (the doc-sorted pack with its live masks, plus the
    impact-sorted copy), equal to the resident bytes, released exactly
    on rebuild and on delete."""
    docs = dense_docs(80, seed=62)
    charges = []
    ref_indices = RefIndices(str(tmp_path / "ref"))
    indices = IndicesService(str(tmp_path / "port"))
    ref_breaker = RefBreaker("hbm", 1 << 30)
    breaker = CircuitBreaker("hbm", 1 << 30)
    tpu = jtpu.TpuSearchService(window_s=0.0, batch_timeout_s=300.0,
                                breaker=ref_breaker, compressed_pack=False)
    gpu = GpuSearchService(device="cpu", window_s=0.0, breaker=breaker,
                           compressed_pack=False)
    try:
        idxs = []
        for svc, settings_of in ((ref_indices, RefSettings.of),
                                 (indices, gpu_settings().of)):
            idx = svc.create_index("acct", settings_of(
                {"index": {"number_of_shards": 2}}), MAPPING)
            for doc_id, src in docs:
                idx.shard(idx.shard_for_id(doc_id)).apply_index_on_primary(
                    doc_id, src)
            idx.refresh()
            idxs.append(idx)
        ref_idx, idx = idxs
        for round_ in range(2):
            want = tpu.try_search(ref_idx, ref_dsl.MatchQuery(
                field="body", query="common rare"), k=10)
            got = gpu.try_search(idx, dsl.MatchQuery(
                field="body", query="common rare"), k=10)
            assert got.total_hits == want.total_hits
            detail = gpu.packs.stats()["packs"]["acct/body"]
            assert detail["compressed"] is False
            resident = sum(t.numel() * t.element_size()
                           for r in gpu.packs.residents()
                           for t in r.device_arrays)
            assert breaker.used == detail["hbm_bytes"] == resident > 0
            # the reference's charge of the same pack; its rows are
            # padded to its 8 virtual devices, and each row costs alike
            (ref_res,) = tpu.packs._cache.values()
            (res,) = gpu.packs.residents()
            assert (breaker.used * ref_res.pack.num_shards
                    == ref_breaker.used * res.pack.num_shards)
            assert breaker.used == (res.pack.nbytes_device()
                                    + sum(a.nbytes for a in res.imp_host))
            charges.append(breaker.used)
            for svc_idx in (ref_idx, idx):   # a rebuild: a new reader
                svc_idx.shard(svc_idx.shard_for_id("x1")
                              ).apply_index_on_primary(
                    "x1", {"body": f"common alpha {round_}"})
                svc_idx.refresh()
        assert charges[0] != charges[1] or gpu.packs.misses == 2
        indices.delete_index("acct")
        gpu.invalidate_index("acct")
        assert gpu.packs.stats()["packs"] == {}
        assert breaker.used == 0
    finally:
        gpu.close()
        tpu.close()
        indices.close()
        ref_indices.close()


def test_delete_index_frees_the_device_arrays():
    """delete_index returns once the retired pack's batcher thread has
    ended: no tensor of the raw image outlives the call (a thread still
    ending would hold them, and the card's memory, a moment longer)."""
    breaker = CircuitBreaker("hbm", 1 << 30)
    svc = GpuSearchService(device="cpu", window_s=0.0, breaker=breaker,
                           compressed_pack=False)
    try:
        svc.create_index("gone", number_of_shards=2, mapping=MAPPING)
        svc.index("gone", dense_docs(120, seed=65))
        svc.refresh("gone")
        for query in ("common rare", "alpha"):
            resp = svc.search("gone", {"query": {"match": {
                "body": query}}, "size": 5})
            assert resp["hits"]["hits"]
        resident = svc.resident("gone", "body")
        assert resident.streams is None
        arrays = [weakref.ref(t) for t in resident.device_arrays]
        del resident
        svc.delete_index("gone")
        gc.collect()
        assert breaker.used == 0
        assert [r() for r in arrays] == [None] * len(arrays)
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# the boundary: one segment of 65,409 documents
# ---------------------------------------------------------------------------

N_BOUNDARY = 65_409
VOCAB = [f"w{i}" for i in range(300)]


@pytest.fixture(scope="module")
def boundary():
    rng = np.random.default_rng(64)
    tokens = [rng.integers(0, len(VOCAB), int(n)).astype(np.int32)
              for n in rng.integers(1, 6, N_BOUNDARY)]
    # a Zipf head: a few terms in many documents
    for i in range(0, N_BOUNDARY, 3):
        tokens[i] = np.append(tokens[i], i % 5)
    ids = [f"b{i}" for i in range(N_BOUNDARY)]
    seg = segment_from_token_ids("big", ids, tokens, VOCAB, "body")
    ref_seg = RefSegment(
        "big", seg.num_docs, list(seg.doc_ids),
        {"body": {t: (d.copy(), tf.copy())
                  for t, (d, tf) in seg.postings["body"].items()}},
        {"body": seg.norms["body"].copy()},
        {"body": RefFieldStats(seg.field_stats["body"].doc_count,
                               seg.field_stats["body"].sum_total_term_freq)},
        {}, [None] * seg.num_docs)
    return seg, ref_seg


FLATS = [(["w0", "w7"], 1), (["w3"], 1), (["w1", "w2", "w9"], 2),
         (["w4", "w11", "w250"], 3), (VOCAB[:9], 1), (["w5", "w299"], 1)]


@pytest.mark.parametrize("k", [10, 1500])
def test_boundary_segment_is_served(boundary, k):
    seg, ref_seg = boundary
    port = GpuSearchService(device="cpu", window_s=0.0)
    port.create_index("big", 1, MAPPING)
    port.add_segment("big", 0, seg)
    resident = port.resident("big", "body")
    assert resident.streams is None and resident.pack.d_pad >= 1 << 16
    tiers = {}
    got = gpu_service.execute_flat_batch(
        resident, [FlatQuery("body", t, 1.0, m) for t, m in FLATS], k,
        tiers=tiers)
    assert tiers == ({"full-32": 3, "exact": 3} if k <= 1000
                     else {"exact": 6})
    jtpu.KERNEL_CONFIG["compressed_pack"] = True
    mesh = ref_make_mesh(shape=(1, 1), devices=ref_make_mesh().devices.flat[:1])
    cache = jtpu.IndexPackCache(mesh=mesh)
    jpack = jdist.build_stacked_pack([ref_seg], "body")
    ref_resident = cache._place_pack(jpack, "body", [], (), [(0, "big")],
                                     [ref_seg], label="pack[body]",
                                     compressible=True)
    assert ref_resident.comp_streams is None
    want = jtpu.execute_flat_batch(
        ref_resident, [jtpu.FlatQuery("body", t, 1.0, m) for t, m in FLATS],
        k, mesh=mesh)
    for g, w in zip(got, want):
        assert g.total_hits == w.total_hits
        assert g.total_relation == w.total_relation
        np.testing.assert_array_equal(g.scores.view(np.uint32),
                                      w.scores.view(np.uint32))
        np.testing.assert_array_equal(g.ords, w.ords)
    hits = port.search("big", {"query": {"match": {"body": "w0 w7"}},
                               "size": 3})["hits"]
    assert [h["_id"] for h in hits["hits"]] == [
        seg.doc_ids[o] for o in want[0].ords[:3]]
    port.close()
