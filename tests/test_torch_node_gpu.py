"""The port's node on the card against the same node on the CPU: the
same REST requests give the same response bytes (``took`` set to 0)
when the merge kernel answers on the card and its plain version on the
CPU, and when the planner path runs on the card (its segment top-k the
shard_topk kernel) and on the CPU; deleting the index drains the
``hbm`` breaker to 0 and returns ``torch.cuda.memory_allocated()`` to
its value before the pack. shard_topk on dense segment rows (ties,
-inf) against its plain version, bit for bit. The REST remainder
(_msearch, _count, _explain, a filtered alias) gives the CPU node's
bytes, and so do the search features (sort, search_after, collapse,
rescore, highlight, suggest, score scripts).

Marked gpu: skips without a CUDA device. On the card:
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_node_gpu.py -q``.
"""

import gc
import json
import re
import time

import pytest
import torch

from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops import merge_kernel
from elasticsearch_tpu_torch.search.serializer import dumps_response

from torch_parity_cases import (LOG_BODIES, PARITY_BODIES,
                                TYPED_BODIES, TYPED_MAPPING, bulk_ndjson,
                                make_docs, make_typed_docs)

pytestmark = pytest.mark.gpu

INDEX_BODY = {"settings": {"number_of_shards": 3},
              "mappings": {"properties": {"body": {"type": "text"}}}}


def call(node, method, path, body=None, raw=None):
    if raw is None:
        raw = json.dumps(body).encode() if body is not None else b""
    status, payload = node.handle(method, path, {}, None, raw)
    if isinstance(payload, dict) and "took" in payload:
        payload["took"] = 0
    return status, dumps_response(payload)


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    gpu = Node(str(tmp_path_factory.mktemp("gpu")))
    cpu = Node(str(tmp_path_factory.mktemp("cpu")), device="cpu")
    try:
        for node in (gpu, cpu):
            call(node, "PUT", "/corpus", INDEX_BODY)
            call(node, "POST", "/corpus/_bulk", raw=bulk_ndjson(make_docs()))
            call(node, "POST", "/corpus/_refresh")
            call(node, "PUT", "/typed", {"settings": {"number_of_shards": 3},
                                         "mappings": TYPED_MAPPING})
            call(node, "POST", "/typed/_bulk",
                 raw=bulk_ndjson(make_typed_docs()))
            call(node, "POST", "/typed/_refresh")
        yield gpu, cpu
    finally:
        gpu.close()
        cpu.close()


@pytest.mark.parametrize("source", [True, False], ids=["source", "nosource"])
@pytest.mark.parametrize("body", PARITY_BODIES,
                         ids=[f"body{i}" for i in range(len(PARITY_BODIES))])
def test_card_bytes_match_cpu_bytes(nodes, body, source):
    gpu, cpu = nodes
    before = merge_kernel.LAUNCHES["select_rescore"]
    got = call(gpu, "POST", "/corpus/_search", dict(body, _source=source))
    assert merge_kernel.LAUNCHES["select_rescore"] > before
    want = call(cpu, "POST", "/corpus/_search", dict(body, _source=source))
    assert got[0] == 200, got
    assert got == want


#: bodies the planner answers (the kernel path declines them)
PLANNER_BODIES = {
    "match_all": {"query": {"match_all": {}}},
    "match_all_k10000": {"query": {"match_all": {}}, "from": 9990,
                         "size": 10},
    "match_phrase": {"query": {"match_phrase": {"body": "alpha beta"}}},
    "bool_must": {"query": {"bool": {"must": [{"term": {"body": "eta"}}],
                                     "must_not": [{"term": {
                                         "body": "beta"}}]}}},
    "min_score": {"query": {"match": {"body": "alpha"}}, "min_score": 1.0},
    "size_0": {"query": {"match": {"body": "alpha"}}, "size": 0},
    "k_10001": {"query": {"match": {"body": "alpha"}}, "size": 10001},
    "prefix": {"query": {"prefix": {"body": "e"}}, "size": 30},
    "fuzzy": {"query": {"fuzzy": {"body": "gamna"}}},
    "no_match": {"query": {"bool": {"must_not": [{"match_all": {}}]}}},
}


@pytest.mark.parametrize("name", sorted(PLANNER_BODIES))
def test_planner_card_bytes_match_cpu_bytes(nodes, name):
    gpu, cpu = nodes
    before = merge_kernel.LAUNCHES["shard_topk"]
    got = call(gpu, "POST", "/corpus/_search", PLANNER_BODIES[name])
    if PLANNER_BODIES[name].get("size", 10):
        assert merge_kernel.LAUNCHES["shard_topk"] > before
    want = call(cpu, "POST", "/corpus/_search", PLANNER_BODIES[name])
    assert got[0] == 200, got
    assert got == want


@pytest.mark.parametrize("name", sorted(set(TYPED_BODIES) - LOG_BODIES))
def test_typed_planner_card_bytes_match_cpu_bytes(nodes, name):
    gpu, cpu = nodes
    got = call(gpu, "POST", "/typed/_search", TYPED_BODIES[name])
    want = call(cpu, "POST", "/typed/_search", TYPED_BODIES[name])
    assert got[0] == 200, got
    assert got == want


#: the planner path's search features over TYPED_MAPPING fields: sort
#: and search_after, collapse, rescore, highlight, suggesters, and score
#: scripts whose transcendentals, NaNs and vector sums must give the
#: same bits on the card as on the CPU
FEATURE_BODIES = {
    "sort": {"query": {"match_all": {}}, "size": 30, "sort": [
        {"views": "desc"}, {"published": "asc"},
        {"tag": {"order": "desc", "missing": "_first"}}]},
    "search_after": {"query": {"match_all": {}}, "size": 20,
                     "sort": [{"price": "asc"}, {"views": "desc"}],
                     "search_after": [100.0, 3]},
    "collapse": {"query": {"match": {"body": "alpha beta"}}, "size": 20,
                 "collapse": {"field": "tag"}},
    "rescore": {"query": {"match": {"body": "alpha"}}, "size": 20,
                "rescore": {"window_size": 40, "query": {
                    "rescore_query": {"range": {"views": {"gte": 3}}},
                    "score_mode": "multiply"}}},
    "highlight": {"query": {"match": {"body": "alpha gamma"}},
                  "highlight": {"fields": {"body": {}}}},
    "suggest": {"query": {"match": {"body": "alpha"}}, "suggest": {
        "t": {"text": "alpah gama", "term": {"field": "body"}},
        "p": {"text": "alpah beta", "phrase": {"field": "body"}}}},
    "script_log_pow": {"query": {"script_score": {
        "query": {"match": {"body": "alpha"}}, "script": {
            "source": "Math.log(2 + doc['views'].value) "
                      "* Math.pow(_score, 0.5) + exp(-_score)"}}},
        "size": 30},
    "script_trig": {"query": {"script_score": {
        "query": {"match_all": {}}, "script": {
            "source": "sin(doc['price'].value) + cos(_score) "
                      "+ tan(doc['views'].value) + 2 "
                      "+ sqrt(doc['views'].value) % 3"}}}, "size": 30},
    "script_weak_scalars": {"query": {"script_score": {
        "query": {"match_all": {}}, "script": {
            "source": "log(0.1) * _score + pow(2, 0.5) + max(2, 3.5) "
                      "+ pow(3, 2) + (doc['price'].empty ? 0.5 : 2) "
                      "+ doc['views'].size() + (params.f ? 1.5 : 2.5)",
            "params": {"f": True}}}}, "size": 30},
    "script_nan": {"query": {"script_score": {
        "query": {"match_all": {}}, "script": {
            "source": "Math.log(doc['price'].value - 200)"}}}, "size": 60},
    "function_score_script": {"query": {"function_score": {
        "query": {"match": {"body": "alpha beta"}},
        "functions": [{"script_score": {"script": "pow(doc['views'].value,"
                                                  " 2) + 1"}},
                      {"filter": {"term": {"flag": True}}, "weight": 3}],
        "score_mode": "sum"}}, "size": 30},
    "function_score_nan": {"query": {"function_score": {
        "query": {"match_all": {}}, "score_mode": "max",
        "boost_mode": "multiply", "functions": [
            {"script_score": {"script": "Math.log(doc['price'].value - 200)"}},
            {"filter": {"term": {"flag": True}}, "weight": 3}]}},
        "size": 60},
}


@pytest.mark.parametrize("name", sorted(FEATURE_BODIES))
def test_search_features_card_bytes_match_cpu_bytes(nodes, name):
    gpu, cpu = nodes
    body = FEATURE_BODIES[name]
    before = merge_kernel.LAUNCHES["shard_topk"]
    got = call(gpu, "POST", "/typed/_search", body)
    # a sort orders on the host and collapse groups there: no top-k
    if body.get("size", 10) and "sort" not in body \
            and "collapse" not in body:
        assert merge_kernel.LAUNCHES["shard_topk"] > before
    want = call(cpu, "POST", "/typed/_search", body)
    assert got[0] == 200, got
    assert got == want


@pytest.mark.parametrize("name", sorted(LOG_BODIES))
def test_typed_log_bodies_on_the_card_match_cpu(nodes, name):
    """A log modifier: ``xla_logf`` is the same ops on the card as on
    the CPU, so the bytes are equal."""
    gpu, cpu = nodes
    got = call(gpu, "POST", "/typed/_search", TYPED_BODIES[name])
    want = call(cpu, "POST", "/typed/_search", TYPED_BODIES[name])
    assert got[0] == 200, got
    assert got == want


@pytest.mark.parametrize("kind,k", [("ties", 10), ("ties", 10_000),
                                    ("neg_inf", 10), ("neg_inf", 10_000),
                                    ("few_live", 10_000),
                                    ("scores", 10), ("scores", 10_000)])
def test_shard_topk_on_dense_segment_rows_matches_plain(kind, k):
    """The planner's operand: one row a segment, 62,592 wide (a padded
    62,5xx-doc segment), all ties, all -inf, a few live docs among -inf,
    or BM25-like scores with many repeats."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    n = 62_592
    gen = torch.Generator().manual_seed(3)
    if kind == "ties":
        row = torch.ones((1, n))
        row[0, n - 70:] = float("-inf")
    elif kind == "neg_inf":
        row = torch.full((1, n), float("-inf"))
    elif kind == "few_live":
        row = torch.full((1, n), float("-inf"))
        row[0, ::997] = 2.5
    else:
        row = torch.randint(0, 300, (1, n), generator=gen).float() / 7
    vals = row.to("cuda")
    got = merge_kernel.shard_topk(vals, k)
    want = merge_kernel.shard_topk_plain(vals, k)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


def test_delete_drains_breaker_and_device_memory(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    node = Node(str(tmp_path))
    try:
        call(node, "PUT", "/drain", INDEX_BODY)
        call(node, "POST", "/drain/_bulk", raw=bulk_ndjson(make_docs(120, 5)))
        call(node, "POST", "/drain/_refresh")
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        hbm = node.breakers.get_breaker("hbm")
        assert call(node, "POST", "/drain/_search",
                    {"query": {"match": {"body": "alpha"}}})[0] == 200
        resident = node.gpu_search.packs.residents()[0]
        assert hbm.used == resident.nbytes_device() > 0
        del resident
        assert call(node, "DELETE", "/drain")[0] == 200
        assert hbm.used == 0
        after = None
        for _ in range(50):  # the retired batcher thread lets go
            gc.collect()
            torch.cuda.synchronize()
            after = torch.cuda.memory_allocated()
            if after == before:
                break
            time.sleep(0.1)
        assert after == before
    finally:
        node.close()


def _took0(text):
    return re.sub(r'"took": \d+', '"took": 0', text)


def _ndjson(*objs):
    return ("\n".join(json.dumps(o) for o in objs) + "\n").encode()


#: the REST remainder on the card: _msearch items on the kernel path and
#: the planner, _count, _explain and a filtered alias (planner on the
#: card, its segment top-k shard_topk)
REST_API_REQUESTS = {
    "msearch": ("POST", "/_msearch", None, _ndjson(
        *[x for b in PARITY_BODIES[:6] for x in ({"index": "corpus"}, b)],
        *[x for b in list(TYPED_BODIES.values())[:2]
          for x in ({"index": "typed"}, b)])),
    "count": ("POST", "/corpus/_count",
              {"query": {"match": {"body": "alpha beta"}}}, None),
    "count_typed": ("POST", "/typed/_count",
                    TYPED_BODIES["range_long"], None),
    "explain": ("POST", "/corpus/_explain/d3",
                {"query": {"match": {"body": "alpha beta gamma"}}}, None),
    "alias_search": ("POST", "/corpus-filtered/_search",
                     {"query": {"match": {"body": "alpha"}}, "size": 20},
                     None),
    "alias_count": ("POST", "/corpus-filtered/_count", None, None),
}


@pytest.fixture
def filtered_alias(nodes):
    """`corpus-filtered` over corpus on both nodes for one test, deleted
    after it, so that no other test sees it."""
    for node in nodes:
        status, _ = call(node, "PUT", "/corpus/_alias/corpus-filtered",
                         {"filter": {"term": {"body": "beta"}}})
        assert status == 200
    yield nodes
    for node in nodes:
        call(node, "DELETE", "/corpus/_alias/corpus-filtered")


@pytest.mark.parametrize("name", sorted(REST_API_REQUESTS))
def test_rest_remainder_card_bytes_match_cpu_bytes(filtered_alias, name):
    method, path, body, raw = REST_API_REQUESTS[name]
    gpu, cpu = (call(node, method, path, body, raw)
                for node in filtered_alias)
    assert gpu[0] == 200, gpu
    assert _took0(gpu[1]) == _took0(cpu[1])


#: the timing fields of a `profile` answer, masked on both nodes
PROFILE_TIMING = ("took", "time_in_nanos", "breakdown", "stages_ms",
                  "device_stages", "batch_wait_split")


def mask_profile(text):
    def walk(obj):
        if isinstance(obj, dict):
            return {k: "<timing>" if k in PROFILE_TIMING else walk(v)
                    for k, v in obj.items()}
        if isinstance(obj, list):
            return [walk(v) for v in obj]
        return obj
    return json.dumps(walk(json.loads(text)))


@pytest.mark.parametrize("boost", [1.0, 1e-15], ids=["fused", "exact"])
def test_wide_rows_card_bytes_match_cpu_bytes(nodes, boost):
    """A terms query over 1,100 words of one document: rows of 1,100
    slots (T 2048) and a run of 1,100 lanes, through the fused kernels or
    (boost 1e-15) exact_merge on the card, the plain versions on the
    CPU (a train of ~1 min there: both nodes wait up to 600 s)."""
    gpu, cpu = nodes
    words = [f"w{i}" for i in range(1100)]
    for node in (gpu, cpu):
        node.gpu_search.batch_timeout_s = 600.0
        call(node, "PUT", "/wide/_doc/1", {"body": " ".join(words)})
        call(node, "PUT", "/wide/_doc/2", {"body": "w0 w7 w1099"})
        call(node, "POST", "/wide/_refresh")
    body = {"query": {"terms": {"body": words, "boost": boost}}}
    kernel = "exact_merge" if boost != 1.0 else "select_rescore"
    before = merge_kernel.LAUNCHES[kernel]
    got = call(gpu, "POST", "/wide/_search", body)
    assert merge_kernel.LAUNCHES[kernel] == before + 1
    want = call(cpu, "POST", "/wide/_search", body)
    assert got[0] == 200, got
    assert got == want
    assert gpu.gpu_search.launch_shapes.get((8, 2048, 128))


def test_profile_and_timeout_card_bytes_match_cpu_bytes(nodes):
    """A `profile: true` body (the kernel section; timing fields masked
    by name on both nodes) and a planner body at `timeout: 0ms` (timed
    out before any shard) give the CPU node's bytes."""
    gpu, cpu = nodes
    profile = {"query": {"match": {"body": "alpha beta"}}, "profile": True}
    got = call(gpu, "POST", "/corpus/_search", profile)
    want = call(cpu, "POST", "/corpus/_search", profile)
    assert got[0] == want[0] == 200
    assert mask_profile(got[1]) == mask_profile(want[1])
    assert json.loads(got[1])["profile"]["tpu"][0]["variant"] == \
        "compressed"
    timed = {"query": {"match": {"body": "alpha"}}, "sort": ["_score"],
             "timeout": "0ms"}
    got = call(gpu, "POST", "/corpus/_search", timed)
    assert got == call(cpu, "POST", "/corpus/_search", timed)
    assert json.loads(got[1])["timed_out"] is True
