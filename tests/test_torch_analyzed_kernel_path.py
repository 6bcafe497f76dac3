"""The kernel path under a custom analyzer chain: a text field analyzed
by a standard tokenizer, lowercase, stop words, synonyms and Porter
stemming, served by the merge kernels over a compressed pack and over a
raw pack.

Both nodes (``torch_rest_pair``) get the same index and ``_bulk``; each
match / term / terms / bool body whose terms expand through the synonym
rules must be served by both nodes' kernel paths with the same bytes,
and the port's ``lower_query`` must give the reference's flat query
(field, terms in order, boost, minimum count). The documents' field
lengths (the BM25 norms: stacked synonyms count, stop-word holes do not)
are held per segment against the reference's.
"""

import json

import numpy as np
import pytest
import torch

from elasticsearch_tpu.search import dsl as ref_dsl
from elasticsearch_tpu.search import tpu_service as jtpu

from elasticsearch_tpu_torch.search import dsl
from elasticsearch_tpu_torch.search.gpu_service import lower_query

from torch_parity_cases import bulk_ndjson
from torch_rest_pair import Pair

torch.set_num_threads(1)

RAW = {"search.tpu_serving.kernel.compressed_pack": False}

WORDS = ["fast", "quick", "rapid", "car", "cars", "auto", "vehicle",
         "running", "runs", "runner", "jumped", "jumping", "jumps", "the",
         "a", "of", "river", "rivers", "boat", "boats", "ship", "red",
         "blue", "quickly", "connection", "connected", "connecting"]

INDEX = {"settings": {"number_of_shards": 2, "analysis": {
    "filter": {
        "my_stop": {"type": "stop", "stopwords": ["the", "a", "of"]},
        "my_syn": {"type": "synonym", "synonyms": [
            "fast, quick, rapid", "car, auto, vehicle", "boat, ship"]}},
    "analyzer": {"chain": {
        "type": "custom", "tokenizer": "standard",
        "filter": ["lowercase", "my_stop", "my_syn", "porter_stem"]}}}},
    "mappings": {"properties": {"body": {"type": "text",
                                         "analyzer": "chain"}}}}

BODIES = {
    "match_or": {"query": {"match": {"body": "fast cars"}}, "size": 20},
    "match_and": {"query": {"match": {"body": {
        "query": "quick boat", "operator": "and"}}}, "size": 15},
    "match_msm": {"query": {"match": {"body": {
        "query": "rapid auto running river", "minimum_should_match": 2}}},
        "size": 25},
    "match_stop_only_and_words": {"query": {"match": {
        "body": "the Connected Rivers of a runner"}}, "from": 3, "size": 9},
    "term_stemmed": {"query": {"term": {"body": "connect"}}},
    "terms": {"query": {"terms": {"body": ["ship", "jump", "vehicl"]}},
              "size": 30},
    "bool_should": {"query": {"bool": {"should": [
        {"match": {"body": "quick"}}, {"match": {"body": "vehicle"}},
        {"term": {"body": "red"}}]}}, "size": 40},
    "boosted": {"query": {"match": {"body": {"query": "ship jumping",
                                            "boost": 2.5}}}},
}


def make_docs(n=300, seed=12):
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        words = [WORDS[int(w)] for w in rng.integers(0, len(WORDS),
                                                      int(rng.integers(2, 12)))]
        if i % 9 == 0:   # an array value: the 100-position gap
            docs.append((f"d{i}", {"body": [" ".join(words[:2]),
                                            " ".join(words[2:])]}))
        else:
            docs.append((f"d{i}", {"body": " ".join(words)}))
    return docs


@pytest.fixture(scope="module", params=["compressed", "raw"])
def nodes(request, tmp_path_factory):
    # the reference's kernel settings are process-wide: its node's
    # settings set them, and the fixture puts them back
    saved = dict(jtpu.KERNEL_CONFIG)
    p = Pair(tmp_path_factory.mktemp(f"analyzed_{request.param}"),
             RAW if request.param == "raw" else None)
    p.same("PUT", "/an", INDEX)
    docs = make_docs()
    p.same("POST", "/an/_bulk", raw=bulk_ndjson(docs[:200], index="an"))
    p.same("POST", "/an/_refresh")
    p.same("POST", "/an/_bulk", raw=bulk_ndjson(docs[200:], index="an"))
    p.same("POST", "/an/_refresh")
    try:
        yield request.param, p
    finally:
        p.close()
        jtpu.KERNEL_CONFIG.clear()
        jtpu.KERNEL_CONFIG.update(saved)


@pytest.mark.parametrize("name", sorted(BODIES))
def test_analyzed_bodies_take_the_kernel_path_with_reference_bytes(
        nodes, name):
    kind, p = nodes
    ref_served = p.ref.tpu_search.served
    port_served = p.port.gpu_search.served
    s, res = p.same("POST", "/an/_search", BODIES[name])
    assert s == 200, res
    assert p.ref.tpu_search.served > ref_served, "reference: planner"
    assert p.port.gpu_search.served > port_served, "port: planner"
    if kind == "raw":
        assert sum(p.port.gpu_search.tier_queries.values()) > 0
    if name != "match_and":
        assert res["hits"]["total"]["value"] > 0, res


@pytest.mark.parametrize("name", sorted(BODIES))
def test_flat_query_slots_match_reference_lowering(nodes, name):
    _, p = nodes
    body = BODIES[name]["query"]
    want = jtpu.lower_query(ref_dsl.parse_query(body),
                            p.ref.indices.index("an").mapper)
    got = lower_query(dsl.parse_query(body),
                      p.port.indices.index("an").mapper)
    assert (got.field, got.terms, got.boost, got.min_count) == \
        (want.field, want.terms, want.boost, want.min_count)
    if name == "match_or":
        # fast stacks its synonyms; cars is stemmed after the synonym
        # filter, so it does not expand
        assert got.terms == ["fast", "quick", "rapid", "car"]


def test_field_lengths_count_stacks_and_not_holes(nodes):
    """Per shard and segment: the same exact field lengths, norms and
    field statistics as the reference's (a synonym stack counts each
    term, a stop-word hole none, an array value adds the gap)."""
    _, p = nodes
    for shard_num in range(2):
        ref_segs = p.ref.indices.index("an").shard(
            shard_num).engine.acquire_reader().views
        segs = p.port.indices.index("an").shard(
            shard_num).engine.acquire_reader().views
        assert len(segs) == len(ref_segs)
        for v, rv in zip(segs, ref_segs):
            np.testing.assert_array_equal(v.segment.exact_lengths["body"],
                                          rv.segment.exact_lengths["body"])
            np.testing.assert_array_equal(v.segment.norms["body"],
                                          rv.segment.norms["body"])
            assert (v.segment.field_stats["body"].sum_total_term_freq ==
                    rv.segment.field_stats["body"].sum_total_term_freq)
    parsed = p.port.indices.index("an").mapper.parse_document(
        "x", {"body": "the fast car"})
    assert parsed.field_lengths["body"] == 6   # 2 stacks of 3, 1 hole
    assert json.loads(json.dumps(parsed.term_slots["body"])) == \
        [[None, ["fast", "quick", "rapid"], ["car", "auto", "vehicl"]]]
