"""The whole slice against the JAX package: the same documents with the
same _ids in 3 shards on both sides, the same _search bodies, and the
responses must agree — _id order, _score bit for bit, TotalHits, _source.

JAX side: IndicesService (one segment per shard) + coordinator.search
through TpuSearchService(pallas=True), the fused kernel in interpret
mode. Port side: GpuSearchService(device="cpu"), the plain torch path.
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu.common.settings import Settings
from elasticsearch_tpu.indices.service import IndicesService
from elasticsearch_tpu.search import coordinator
from elasticsearch_tpu.search import tpu_service as jax_tpu
from elasticsearch_tpu.search.tpu_service import TpuSearchService

from elasticsearch_tpu_torch.common.errors import NotLowerable
from elasticsearch_tpu_torch.search import dsl
from elasticsearch_tpu_torch.search.gpu_service import (GpuSearchService,
                                                         lower_query)

torch.set_num_threads(1)

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
         "theta", "iota", "kappa", "lamda", "mu", "nu", "xi"]
MAPPING = {"properties": {"body": {"type": "text"}}}
SHARDS = 3


def make_docs(n=240, seed=20):
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        n_words = int(rng.integers(2, 14))
        # Zipf-ish skew: early words are common, late words rare
        picks = np.minimum(rng.zipf(1.3, n_words) - 1, len(WORDS) - 1)
        docs.append((f"d{i}", {"body": " ".join(WORDS[int(w)]
                                                for w in picks)}))
    return docs


BODIES = [
    {"query": {"match": {"body": "alpha beta"}}},
    {"query": {"match": {"body": "gamma delta epsilon"}}, "size": 25},
    {"query": {"match": {"body": {"query": "alpha beta gamma",
                                  "operator": "and"}}}},
    {"query": {"match": {"body": {"query": "beta gamma delta zeta",
                                  "minimum_should_match": 2}}},
     "size": 30},
    {"query": {"term": {"body": "eta"}}, "size": 7, "from": 3},
    {"query": {"terms": {"body": ["theta", "iota", "kappa"]}}},
    {"query": {"bool": {"should": [{"term": {"body": "lamda"}},
                                   {"term": {"body": "mu"}},
                                   {"term": {"body": "alpha"}}],
                        "minimum_should_match": 2}}, "size": 40},
    {"query": {"match": {"body": {"query": "nu xi absentword",
                                  "boost": 2.5}}}},
    {"query": {"match": {"body": "alpha"}}, "size": 200},
]


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    docs = make_docs()
    saved = dict(jax_tpu.KERNEL_CONFIG)
    ref = IndicesService(str(tmp_path_factory.mktemp("ref")))
    idx = ref.create_index(
        "corpus", Settings.of({"index": {"number_of_shards": SHARDS}}),
        MAPPING)
    for doc_id, src in docs:
        idx.shard(idx.shard_for_id(doc_id)).apply_index_on_primary(
            doc_id, src)
    idx.refresh()  # one segment per shard
    tpu = TpuSearchService(window_s=0.0, batch_timeout_s=300.0, pallas=True)
    port = GpuSearchService(device="cpu", window_s=0.0)
    port.create_index("corpus", SHARDS, MAPPING)
    port.index("corpus", docs)
    port.refresh("corpus")
    try:
        yield ref, tpu, port
    finally:
        port.close()
        tpu.close()
        ref.close()
        jax_tpu.KERNEL_CONFIG.clear()
        jax_tpu.KERNEL_CONFIG.update(saved)


def f32_bits(x):
    return np.float32(x).view(np.uint32)


def assert_same_response(want, got):
    """_id order, _score bits, TotalHits, _source and max_score equal."""
    wh, gh = want["hits"], got["hits"]
    assert gh["total"] == {"value": wh["total"]["value"],
                           "relation": wh["total"]["relation"]}
    w_hits = list(wh["hits"])
    assert [h["_id"] for h in gh["hits"]] == [h["_id"] for h in w_hits]
    assert [f32_bits(h["_score"]) for h in gh["hits"]] == \
        [f32_bits(h["_score"]) for h in w_hits]
    assert [h["_source"] for h in gh["hits"]] == \
        [h["_source"] for h in w_hits]
    if wh["max_score"] is None:
        assert gh["max_score"] is None
    else:
        assert f32_bits(gh["max_score"]) == f32_bits(wh["max_score"])


def reference_search(ref, tpu, body):
    served = tpu.served
    want = coordinator.search(ref, "corpus", dict(body), tpu_search=tpu)
    assert tpu.served == served + 1, "reference did not take its kernel"
    return want


@pytest.mark.parametrize("body", BODIES,
                         ids=[f"body{i}" for i in range(len(BODIES))])
def test_search_response_matches_reference(both, body):
    ref, tpu, port = both
    want = reference_search(ref, tpu, body)
    assert_same_response(want, port.search("corpus", dict(body)))


def test_kernel_variant_served(both):
    _, _, port = both
    port.search("corpus", {"query": {"match": {"body": "alpha"}}})
    assert port.variant_launches.get("compressed", 0) > 0


@pytest.mark.parametrize("body", [
    {"query": {"match_phrase": {"body": "alpha beta"}}},
    {"query": {"range": {"body": {"gte": 1}}}},
    {"query": {"bool": {"must": [{"term": {"body": "alpha"}}]}}},
    {"query": {"match_all": {}}},
    {"query": {"match": {"body": "alpha"}}, "aggs": {}},
    {"query": {"match": {"body": "alpha"}}, "size": 10001},
    {"query": {"match": {"body": "alpha"}}, "size": 10, "from": 9991},
])
def test_outside_lowering_subset_raises(both, body):
    _, _, port = both
    with pytest.raises(NotLowerable):
        port.search("corpus", body)


def test_oversized_k_refused_beside_concurrent_query(both):
    """from + size past the reference's 10,000 is refused per request,
    and a query sent with it is answered as if alone."""
    from concurrent.futures import ThreadPoolExecutor
    _, _, port = both
    small = {"query": {"match": {"body": "alpha beta"}}, "size": 10}
    big = {"query": {"match": {"body": "alpha beta"}}, "size": 10001}
    alone = port.search("corpus", dict(small))
    with ThreadPoolExecutor(max_workers=2) as pool:
        f_big = pool.submit(port.search, "corpus", dict(big))
        f_small = pool.submit(port.search, "corpus", dict(small))
        with pytest.raises(NotLowerable):
            f_big.result()
        got = f_small.result()
    assert got["hits"] == alone["hits"]


@pytest.mark.parametrize("big_size", [5000, 10000])
def test_large_size_beside_small_in_one_train_matches_reference(both,
                                                               big_size):
    """size 5000 or 10,000 (kernel k 8192 or 16,384) and size 10 share one
    train; each response equals the reference service's."""
    ref, tpu, _ = both
    small = {"query": {"match": {"body": "alpha beta"}}, "size": 10}
    big = {"query": {"match": {"body": "gamma alpha"}}, "size": big_size}
    want_small = reference_search(ref, tpu, small)
    want_big = reference_search(ref, tpu, big)
    svc = GpuSearchService(device="cpu", window_s=0.5)
    try:
        svc.create_index("corpus", SHARDS, MAPPING)
        svc.index("corpus", make_docs())
        svc.refresh("corpus")
        svc.search("corpus", dict(small))  # resident before the train
        svc.batcher.batch_sizes.clear()
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=2) as pool:
            f_big = pool.submit(svc.search, "corpus", dict(big))
            f_small = pool.submit(svc.search, "corpus", dict(small))
            got_big, got_small = f_big.result(), f_small.result()
        assert svc.batcher.batch_sizes == {2: 1}
    finally:
        svc.close()
    assert_same_response(want_big, got_big)
    assert_same_response(want_small, got_small)
    assert len(got_big["hits"]["hits"]) == got_big["hits"]["total"]["value"]


def test_failed_train_fails_only_its_culprit(both):
    """A train that raises is run again query by query: the query at
    fault gets the error, the others their answers."""
    _, _, port = both
    svc = GpuSearchService(device="cpu", window_s=0.5)
    try:
        svc.create_index("corpus", SHARDS, MAPPING)
        svc.index("corpus", make_docs())
        svc.refresh("corpus")
        mapper = svc._index("corpus").mapper
        resident = svc.resident("corpus", "body")
        texts = ["alpha beta", "gamma zeta", "delta", "epsilon eta"]
        flats = [lower_query(dsl.parse_query({"match": {"body": t}}),
                             mapper) for t in texts]
        real = svc.batcher.launch
        trains = []

        def launch(resident, batch, k):
            trains.append(len(batch))
            if any("zeta" in f.terms for f in batch):
                raise RuntimeError("poisoned train")
            return real(resident, batch, k)

        svc.batcher.launch = launch
        futures = [svc.batcher.submit(resident, f, 10) for f in flats]
        with pytest.raises(RuntimeError, match="poisoned"):
            futures[1].result(timeout=60)
        for text, fut in zip(texts, futures):
            if text == "gamma zeta":
                continue
            want = port.search("corpus", {"query": {"match": {"body": text}},
                                          "size": 10})
            res = fut.result(timeout=60)
            assert res.total_hits == want["hits"]["total"]["value"]
            assert [f32_bits(x) for x in res.scores] == \
                [f32_bits(h["_score"]) for h in want["hits"]["hits"]]
        assert trains == [4, 1, 1, 1, 1]
        assert svc.batcher.batch_sizes == {1: 3}
    finally:
        svc.close()


@pytest.mark.parametrize("shards", [1, 3, 16])
def test_routing_matches_reference(shards):
    """The port's murmur3 routing puts every _id on the reference's
    shard: short, long, tail-length and non-ASCII ids."""
    from elasticsearch_tpu.indices.service import shard_for as ref_shard
    from elasticsearch_tpu_torch.indices.routing import shard_for
    rng = np.random.default_rng(shards)
    ids = [f"d{i}" for i in range(1000)]
    ids += ["".join(chr(int(c)) for c in rng.integers(32, 0x3000, n))
            for n in rng.integers(1, 40, 300)]
    assert [shard_for(i, shards) for i in ids] == \
        [ref_shard(i, shards) for i in ids]


def test_wide_rows_match_reference(tmp_path):
    """A terms query over the 1,100 distinct words of one document: its
    rows fill 1,100 slots (T 2048), and the document's run of 1,100 lanes
    takes the doubling run sum's 11th step. The reference's kernel path
    serves it (not its planner), and so does the port's, with the
    reference's answer; a query past T_LIMIT slots is still the typed
    400 on every device."""
    from elasticsearch_tpu_torch.ops import merge_kernel
    words = [f"w{i}" for i in range(1100)]
    docs = [("d0", {"body": " ".join(words)}), ("d1", {"body": "w0 w1"}),
            ("d2", {"body": " ".join(words[::3])})]
    body = {"query": {"terms": {"body": words}}, "size": 10}
    saved = dict(jax_tpu.KERNEL_CONFIG)
    ref = IndicesService(str(tmp_path / "ref"))
    idx = ref.create_index("wide", Settings.of(
        {"index": {"number_of_shards": 1}}), MAPPING)
    for doc_id, src in docs:
        idx.shard(0).apply_index_on_primary(doc_id, src)
    idx.refresh()
    # one device of the reference's CPU mesh: the 8 virtual devices the
    # tests give JAX would pad the one shard's rows to 8 and take ~10 GB
    from elasticsearch_tpu.parallel.mesh import make_mesh as ref_make_mesh
    one = ref_make_mesh(shape=(1, 1), devices=ref_make_mesh().devices.flat[:1])
    tpu = TpuSearchService(window_s=0.0, batch_timeout_s=600.0, pallas=True,
                           mesh=one)
    svc = GpuSearchService(device="cpu", window_s=0.0,
                           batch_timeout_s=600.0)
    try:
        want = coordinator.search(ref, "wide", dict(body), tpu_search=tpu)
        assert tpu.served == 1 and tpu.fallback == 0
        svc.create_index("wide", 1, MAPPING)
        svc.index("wide", docs)
        svc.refresh("wide")
        got = svc.search("wide", dict(body))
        assert svc.launch_shapes == {(8, 2048, 128): 1}
        assert_same_response(want, got)
        assert [h["_id"] for h in got["hits"]["hits"]] == ["d0", "d2", "d1"]
        too_wide = [f"x{i}" for i in range(merge_kernel.T_LIMIT + 8)]
        svc.index("wide", [("d3", {"body": " ".join(too_wide)})])
        svc.refresh("wide")
        with pytest.raises(NotLowerable, match="slots"):
            svc.search("wide", {"query": {"terms": {"body": too_wide}}})
    finally:
        svc.close()
        tpu.close()
        ref.close()
        jax_tpu.KERNEL_CONFIG.clear()
        jax_tpu.KERNEL_CONFIG.update(saved)


#: bodies whose slot weights fail packable(): boost 1e-15 puts
#: idf·(k1+1)·boost below PACKED_WEIGHT_MIN, a negative boost makes the
#: weights negative (every total ≤ 0: no hits)
UNPACKABLE_BODIES = [
    {"query": {"match": {"body": {"query": "alpha beta gamma",
                                  "boost": 1e-15}}}, "size": 30},
    {"query": {"match": {"body": {"query": "beta gamma delta zeta",
                                  "minimum_should_match": 2,
                                  "boost": 1e-15}}}},
    {"query": {"terms": {"body": ["theta", "iota"], "boost": 1e-15}}},
    {"query": {"match": {"body": {"query": "alpha beta",
                                  "boost": -1.0}}}},
]


@pytest.mark.parametrize("body", UNPACKABLE_BODIES,
                         ids=[f"body{i}" for i in
                              range(len(UNPACKABLE_BODIES))])
def test_unpackable_weights_take_the_exact_variant_on_both_sides(
        both, body, monkeypatch):
    """The reference routes these bodies to compressed_exact (its
    dist.distributed_search_raw sees variant="compressed_exact"); the
    port does too, and answers the same bytes."""
    ref, tpu, port = both
    seen = []
    real = jax_tpu.dist.distributed_search_raw

    def spy(*a, **kw):
        seen.append(kw.get("variant"))
        return real(*a, **kw)

    monkeypatch.setattr(jax_tpu.dist, "distributed_search_raw", spy)
    want = reference_search(ref, tpu, body)
    assert seen == ["compressed_exact"]
    before = port.variant_launches.get("compressed_exact", 0)
    assert_same_response(want, port.search("corpus", dict(body)))
    assert port.variant_launches["compressed_exact"] == before + 1
