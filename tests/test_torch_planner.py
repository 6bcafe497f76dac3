"""The port's planner path against the JAX package's, bit for bit.

The same documents go through both packages' mapper and segment writer
into two-segment shards with tombstones; each query then runs through
``SegmentQueryExecutor`` per segment (masks and score bits) and through
``execute_query`` / ``execute_fetch`` on the shard (ids, scores as
uint32, totals, fetched docs), in JAX on the CPU and in torch on the CPU
(the plain path). Every body is held bitwise, those whose scores pass
through a log (field_value_factor's log modifiers: the port computes
XLA:CPU's f32 log op for op, ``ops/xla_math.py``) and ``sqrt`` too. Also the port copies of the execution cases of
``test_query_dsl.py`` and ``test_dsl_longtail.py`` (with their
expectations) and of ``test_can_match.py``.
"""

import json

import numpy as np
import pytest
import torch

from elasticsearch_tpu.common.errors import QueryShardException as RefQSE
from elasticsearch_tpu.common.settings import Settings as RefSettings
from elasticsearch_tpu.index.reader import ShardReader as RefReader
from elasticsearch_tpu.index.segment import SegmentWriter as RefWriter
from elasticsearch_tpu.mapping import MapperService as RefMapper
from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.search import can_match as ref_can_match
from elasticsearch_tpu.search import dsl as ref_dsl
from elasticsearch_tpu.search import query_phase as ref_qp
from elasticsearch_tpu.search.planner import \
    SegmentQueryExecutor as RefExecutor
from elasticsearch_tpu.search.serializer import dumps_response as ref_dumps

from elasticsearch_tpu_torch.common.errors import (IllegalArgumentException,
                                                   NotLowerable,
                                                   QueryShardException)
from elasticsearch_tpu_torch.index.reader import ShardReader
from elasticsearch_tpu_torch.index.segment import SegmentWriter
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.parallel.device import NoDeviceError
from elasticsearch_tpu_torch.search import (can_match, coordinator, dsl,
                                            query_phase)
from elasticsearch_tpu_torch.search.planner import (SegmentQueryExecutor,
                                                    _edit_distance_lte)
from elasticsearch_tpu_torch.search.serializer import dumps_response

torch.set_num_threads(1)

MAPPING = {"properties": {
    "title": {"type": "text"},
    "body": {"type": "text"},
    "tags": {"type": "keyword"},
    "views": {"type": "long"},
    "price": {"type": "double"},
    "published": {"type": "date"},
    "active": {"type": "boolean"},
    "rank": {"type": "integer"},
}}

#: test_query_dsl.py's documents
DOCS = [
    {"title": "quick brown fox", "body": "the quick brown fox jumps over the lazy dog",
     "tags": ["animal", "story"], "views": 100, "price": 9.99,
     "published": "2024-01-01", "active": True},
    {"title": "lazy dog", "body": "a lazy dog sleeps all day, the dog is very lazy",
     "tags": ["animal"], "views": 50, "price": 5.0,
     "published": "2024-02-01", "active": False},
    {"title": "brown bear", "body": "brown bears eat fish in the river",
     "tags": ["animal", "wild"], "views": 200, "price": 20.0,
     "published": "2024-03-01", "active": True},
    {"title": "stock market", "body": "the stock market rallied as tech stocks jumped",
     "tags": ["finance"], "views": 1000, "price": 0.5,
     "published": "2023-12-01", "active": True},
    {"title": "fox hunting ban", "body": "the ban on fox hunting divided the countryside",
     "tags": ["politics"], "views": 10, "price": 3.5,
     "published": "2024-01-15", "active": False},
]

#: test_dsl_longtail.py's books
BOOKS = [
    {"title": "searching fast", "body": "quick brown fox", "rank": 10},
    {"title": "quick results", "body": "searching the web", "rank": 5},
    {"title": "slow snail", "body": "nothing here", "rank": 2},
    {"title": "quick quick quick", "body": "fox fox", "rank": 0},
    {"title": "searcher manual", "body": "grep and find", "rank": 7},
]

WORDS = ["quick", "brown", "fox", "lazy", "dog", "the", "stock", "market",
         "searching", "searcher", "bear", "river", "fish", "ban", "web",
         "quack", "brawn", "foxes", "dogs", "alpha"]


def seeded_docs(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        doc = {"title": " ".join(rng.choice(WORDS, int(rng.integers(1, 4)))),
               "body": " ".join(rng.choice(WORDS, int(rng.integers(2, 12)))),
               "tags": [f"g{int(rng.integers(0, 4))}"]}
        if i % 4:
            doc["views"] = int(rng.integers(0, 2000))
        if i % 3:
            doc["price"] = round(float(rng.uniform(0, 50)), 2)
        if i % 5:
            doc["published"] = f"2024-0{1 + i % 9}-1{i % 10}"
        if i % 2:
            doc["active"] = bool(rng.integers(0, 2))
        if i % 6 != 1:
            doc["rank"] = int(rng.integers(0, 20))
        out.append(doc)
    return out


def build(segment_docs, lives=None):
    """[[(id, source)], ...] one list a segment → (reference reader,
    port reader) over the same documents and tombstones."""
    ref_ms = RefMapper(RefSettings.EMPTY, MAPPING)
    ms = MapperService(MAPPING)
    ref_segs, segs = [], []
    for si, docs in enumerate(segment_docs):
        rw, w = RefWriter(f"s{si}"), SegmentWriter(f"s{si}")
        for doc_id, src in docs:
            rw.add_document(ref_ms.parse_document(doc_id, src),
                            {f: t.dv_kind
                             for f, t in ref_ms.mapper.fields.items()})
            w.add_document(ms.parse_document(doc_id, src),
                           dv_kinds=ms.dv_kinds())
        ref_segs.append(rw.freeze())
        segs.append(w.freeze())
    lives = lives or [None] * len(segs)
    return (RefReader(list(zip(ref_segs, lives)), ref_ms),
            ShardReader(list(zip(segs, lives)), ms))


@pytest.fixture(scope="module")
def dsl_readers():
    """test_query_dsl.py's one-segment shard."""
    return build([[(f"d{i}", d) for i, d in enumerate(DOCS)]])


@pytest.fixture(scope="module")
def books_readers():
    return build([[(str(i), d) for i, d in enumerate(BOOKS)]])


@pytest.fixture(scope="module")
def shard():
    """Two segments with tombstones: test_query_dsl's and the books'
    documents among seeded ones."""
    first = [(f"d{i}", d) for i, d in enumerate(DOCS)] + \
        [(f"a{i}", d) for i, d in enumerate(seeded_docs(60, 1))]
    second = [(f"b{i}", d) for i, d in enumerate(BOOKS)] + \
        [(f"c{i}", d) for i, d in enumerate(seeded_docs(45, 2))]
    live1 = np.ones(len(first), dtype=bool)
    live1[[1, 9, 30]] = False
    live2 = np.ones(len(second), dtype=bool)
    live2[[0, 17]] = False
    return build([first, second], [live1, live2])


def f32_bits(x):
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def hits_of(res):
    return [(h.doc_id, h.ref.segment, h.ref.ord) for h in res.hits]


def scores_of(res):
    return np.array([h.score for h in res.hits], dtype=np.float32)


#: query bodies → (kwargs of execute_query); the slice's query types
QUERIES = {
    "match_all": {"match_all": {}},
    "match_all_boost": {"match_all": {"boost": 1.7}},
    "match": {"match": {"body": "fox"}},
    "match_two": {"match": {"body": "lazy dog"}},
    "match_and": {"match": {"body": {"query": "quick dog", "operator": "and"}}},
    "match_msm": {"match": {"body": {"query": "quick brown fox dog",
                                     "minimum_should_match": 2}}},
    "match_keyword": {"match": {"tags": "animal"}},
    "match_long": {"match": {"views": "100"}},
    "match_unmapped": {"match": {"nope": "x"}},
    "term_keyword": {"term": {"tags": "finance"}},
    "term_text_raw": {"term": {"title": "Quick"}},
    "term_long": {"term": {"views": 50}},
    "term_double": {"term": {"price": 5.0}},
    "term_date": {"term": {"published": "2024-02-01"}},
    "term_bool": {"term": {"active": True}},
    "terms_keyword": {"terms": {"tags": ["wild", "politics", "g1"]}},
    "terms_long": {"terms": {"views": [10, 200, 1000]}},
    "range_long": {"range": {"views": {"gte": 100}}},
    "range_long_gt_lte": {"range": {"views": {"gt": 100, "lte": 1000}}},
    "range_double_lt": {"range": {"price": {"lt": 5.0}}},
    "range_double_gt": {"range": {"price": {"gt": 9.99, "boost": 2.0}}},
    "range_date": {"range": {"published": {"gte": "2024-01-01",
                                           "lt": "2024-02-01"}}},
    "range_bool": {"range": {"active": {"gte": True}}},
    "range_int": {"range": {"rank": {"gte": 5, "lt": 11}}},
    "exists_views": {"exists": {"field": "views"}},
    "exists_text": {"exists": {"field": "title"}},
    "exists_missing": {"exists": {"field": "nope"}},
    "ids": {"ids": {"values": ["d1", "d3", "nope", "b2", "c4"]}},
    "constant_score": {"constant_score": {
        "filter": {"term": {"tags": "animal"}}, "boost": 2.5}},
    "bool_combination": {"bool": {
        "must": [{"match": {"body": "the"}}],
        "filter": [{"term": {"active": True}}],
        "must_not": [{"term": {"tags": "finance"}}]}},
    "bool_should_adds": {"bool": {
        "must": [{"match": {"body": "fox"}}],
        "should": [{"match": {"title": "ban"}}]}},
    "bool_nested_should": {"bool": {
        "must": [{"match": {"body": "the"}}],
        "should": [{"bool": {"must": [
            {"match": {"body": "stock"}},
            {"match": {"body": "nonexistentterm"}}]}}]}},
    "bool_msm": {"bool": {
        "should": [{"match": {"body": "fox"}}, {"match": {"body": "lazy"}},
                   {"term": {"tags": "politics"}}],
        "minimum_should_match": 2}},
    "bool_boost": {"bool": {"must": [{"match": {"title": "quick"}}],
                            "should": [{"range": {"rank": {"gte": 3}}}],
                            "boost": 0.3}},
    "match_phrase": {"match_phrase": {"body": "quick brown fox"}},
    "match_phrase_reversed": {"match_phrase": {"body": "brown quick"}},
    "match_phrase_slop": {"match_phrase": {"body": {"query": "fox dog",
                                                    "slop": 2}}},
    "match_phrase_keyword": {"match_phrase": {"tags": "animal"}},
    "multi_match": {"multi_match": {"query": "quick",
                                    "fields": ["title", "body"]}},
    "multi_match_most": {"multi_match": {"query": "searching",
                                         "fields": ["title", "body"],
                                         "type": "most_fields"}},
    "multi_match_caret": {"multi_match": {"query": "quick fox",
                                          "fields": ["title^3", "body"]}},
    "multi_match_tie": {"multi_match": {"query": "searching dog",
                                        "fields": ["title", "body"],
                                        "tie_breaker": 0.5}},
    "prefix": {"prefix": {"title": {"value": "search"}}},
    "prefix_boost": {"prefix": {"title": {"value": "search", "boost": 2.5}}},
    "prefix_keyword": {"prefix": {"tags": {"value": "g"}}},
    "wildcard": {"wildcard": {"title": {"value": "s*ing"}}},
    "wildcard_question": {"wildcard": {"body": {"value": "f?x"}}},
    "wildcard_none": {"wildcard": {"title": {"value": "zz*"}}},
    "fuzzy": {"fuzzy": {"title": {"value": "quikc"}}},
    "fuzzy_zero": {"fuzzy": {"title": {"value": "quikc", "fuzziness": 0}}},
    "fuzzy_prefix": {"fuzzy": {"title": {"value": "suick",
                                         "prefix_length": 1}}},
    "fs_weight": {"function_score": {
        "query": {"match": {"title": "quick"}},
        "functions": [{"weight": 4.0}]}},
    "fs_fvf_replace": {"function_score": {
        "query": {"match_all": {}},
        "field_value_factor": {"field": "rank", "factor": 2.0,
                               "missing": 0},
        "boost_mode": "replace"}},
    "fs_filtered": {"function_score": {
        "query": {"match_all": {}},
        "functions": [{"filter": {"range": {"rank": {"gte": 7}}},
                       "weight": 10.0}],
        "boost_mode": "replace"}},
    "fs_sum": {"function_score": {
        "query": {"match": {"body": "fox"}},
        "functions": [{"weight": 2.0}, {"weight": 3.0},
                      {"field_value_factor": {"field": "price"}}],
        "score_mode": "sum", "boost_mode": "sum"}},
    "fs_multiply": {"function_score": {
        "query": {"match": {"body": "the dog"}},
        "functions": [{"weight": 1.1},
                      {"field_value_factor": {"field": "views",
                                              "factor": 0.01}},
                      {"filter": {"term": {"active": False}},
                       "weight": 0.7}],
        "score_mode": "multiply", "boost_mode": "avg", "boost": 1.3}},
    "fs_max_boost": {"function_score": {
        "query": {"match_all": {}},
        "field_value_factor": {"field": "rank", "missing": 0},
        "max_boost": 3.0, "boost_mode": "replace"}},
    "fs_avg": {"function_score": {
        "query": {"match_all": {}},
        "functions": [
            {"filter": {"range": {"rank": {"gte": 7}}}, "weight": 10.0},
            {"filter": {"range": {"rank": {"gte": 100}}}, "weight": 4.0},
            {"filter": {"term": {"tags": "g2"}}, "weight": 3.3}],
        "score_mode": "avg", "boost_mode": "replace"}},
    "fs_max_min": {"function_score": {
        "query": {"match": {"body": "brown"}},
        "functions": [{"weight": 2.5},
                      {"field_value_factor": {"field": "price",
                                              "modifier": "square",
                                              "missing": 1}}],
        "score_mode": "max", "boost_mode": "min"}},
    "fs_min_modes": {"function_score": {
        "query": {"match": {"body": "fish river"}},
        "functions": [{"weight": 0.25},
                      {"field_value_factor": {"field": "views",
                                              "modifier": "reciprocal",
                                              "missing": 4}}],
        "score_mode": "min", "boost_mode": "max"}},
    "fs_no_functions": {"function_score": {
        "query": {"match": {"title": "quick"}},
        "boost": 2.0, "max_boost": 5.0}},
    "fs_sqrt": {"function_score": {
        "query": {"match_all": {}},
        "field_value_factor": {"field": "price", "modifier": "sqrt",
                               "missing": 2},
        "boost_mode": "multiply"}},
    "fs_log1p": {"function_score": {
        "query": {"match_all": {}},
        "field_value_factor": {"field": "rank", "modifier": "log1p",
                               "missing": 0},
        "boost_mode": "replace"}},
    "fs_ln": {"function_score": {
        "query": {"match": {"body": "dog"}},
        "field_value_factor": {"field": "views", "modifier": "ln",
                               "missing": 1}}},
    "fs_log_log2p_ln1p_ln2p": {"function_score": {
        "query": {"match": {"title": "brown quick"}},
        "functions": [
            {"field_value_factor": {"field": "price", "modifier": "log"}},
            {"field_value_factor": {"field": "views",
                                    "modifier": "log2p"}},
            {"field_value_factor": {"field": "rank", "modifier": "ln1p"}},
            {"field_value_factor": {"field": "rank", "modifier": "ln2p"}}],
        "score_mode": "sum"}},
    "geo_unmapped": {"geo_distance": {"distance": "10km",
                                      "loc": {"lat": 1.0, "lon": 2.0}}},
    "nested_unmapped": {"nested": {"path": "kids",
                                   "query": {"match_all": {}}}},
    "rank_feature_text": {"rank_feature": {"field": "title"}},
}

def run_query(readers, body, **kw):
    ref_reader, reader = readers
    want = ref_qp.execute_query(ref_reader, ref_dsl.parse_query(body), **kw)
    got = query_phase.execute_query(reader, dsl.parse_query(body),
                                    device="cpu", **kw)
    return got, want


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_executor_masks_and_scores_match_jax(shard, name):
    """SegmentQueryExecutor per segment: the same mask, score bits."""
    ref_reader, reader = shard
    for idx in range(len(reader.views)):
        w_mask, w_score = RefExecutor(ref_reader, idx).execute(
            ref_dsl.parse_query(QUERIES[name]))
        g_mask, g_score = SegmentQueryExecutor(reader, idx, "cpu").execute(
            dsl.parse_query(QUERIES[name]))
        np.testing.assert_array_equal(g_mask.numpy(), np.asarray(w_mask))
        np.testing.assert_array_equal(f32_bits(g_score.numpy()),
                                      f32_bits(w_score))


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_execute_query_matches_jax(shard, name):
    """The shard's query phase: ids in order, score bits, totals."""
    got, want = run_query(shard, QUERIES[name], size=40)
    assert got.total_hits == want.total_hits
    assert hits_of(got) == hits_of(want)
    np.testing.assert_array_equal(f32_bits(scores_of(got)),
                                  f32_bits(scores_of(want)))
    assert (got.max_score is None) == (want.max_score is None)
    if want.max_score is not None:
        assert f32_bits(got.max_score) == f32_bits(want.max_score)


@pytest.mark.parametrize("kw", [
    {"size": 3, "from_": 2}, {"size": 0}, {"size": 500},
    {"size": 20, "min_score": 1.5}, {"size": 7, "from_": 130}],
    ids=["paged", "size0", "all", "min_score", "past_the_end"])
def test_execute_query_windows_match_jax(shard, kw):
    got, want = run_query(shard, {"bool": {"should": [
        {"match": {"body": "the fox dog"}},
        {"range": {"views": {"gte": 500}}}]}}, **kw)
    assert got.total_hits == want.total_hits
    assert hits_of(got) == hits_of(want)
    np.testing.assert_array_equal(f32_bits(scores_of(got)),
                                  f32_bits(scores_of(want)))


@pytest.mark.parametrize("source", [True, False, ["title", "views"]],
                         ids=["source", "nosource", "filtered"])
def test_execute_fetch_matches_jax(shard, source):
    ref_reader, reader = shard
    got, want = run_query(shard, {"match": {"body": "fox brown"}}, size=15)
    g = query_phase.execute_fetch(reader, got.hits, source, version=True,
                                  seq_no_primary_term=True)
    w = ref_qp.execute_fetch(ref_reader, want.hits, source, version=True,
                             seq_no_primary_term=True)
    assert json.dumps(g) == json.dumps(w)


@pytest.mark.parametrize("body,exc", [
    ({"range": {"title": {"gte": "a"}}}, "range query on [text]"),
    ({"range": {"tags": {"gte": "a"}}}, "range query on [keyword]"),
    ({"percolate": {"field": "q", "document": {"a": 1}}},
     "is not a [percolator] field"),
    ({"prefix": {"body": {"value": "qu"}}}, None),
], ids=["range_text", "range_keyword", "percolate", "prefix"])
def test_query_shard_exceptions_match_jax(shard, body, exc):
    """The same QueryShardException text where the reference raises."""
    if exc is None:   # a prefix of a few terms: no raise
        got, want = run_query(shard, body, size=5)
        assert got.total_hits == want.total_hits
        return
    with pytest.raises(RefQSE) as want:
        run_query((shard[0], None), body)
    with pytest.raises(QueryShardException) as got:
        query_phase.execute_query(shard[1], dsl.parse_query(body),
                                  device="cpu")
    assert str(got.value) == str(want.value)
    assert exc in str(got.value)


def test_expansion_past_the_clause_limit_raises_as_jax():
    words = [f"pre{i:04d}" for i in range(1030)]
    readers = build([[("x", {"title": " ".join(words)})]])
    body = {"prefix": {"title": {"value": "pre"}}}
    with pytest.raises(RefQSE) as want:
        run_query((readers[0], None), body)
    with pytest.raises(QueryShardException) as got:
        query_phase.execute_query(readers[1], dsl.parse_query(body),
                                  device="cpu")
    assert str(got.value) == str(want.value)


def test_thirty_two_term_pass_is_served():
    """A pass of 32 slots: slot 31's bit is the int32 sign bit. The
    reference builds that bit as a Python int and overflows int32 there
    (a fault recorded in ROADMAP Queue C); the port serves it, and its
    hits are those of the same terms in two passes of 16."""
    words = [f"t{i:02d}" for i in range(40)]
    docs = [(f"x{i}", {"title": " ".join(words[i % 40: i % 40 + 3])})
            for i in range(80)]
    ref_reader, reader = build([docs])
    body = {"prefix": {"title": {"value": "t"}}}
    with pytest.raises(OverflowError):
        ref_qp.execute_query(ref_reader, ref_dsl.parse_query(body))
    res = query_phase.execute_query(reader, dsl.parse_query(body), size=80,
                                    device="cpu")
    assert res.total_hits == 80
    halves = [query_phase.execute_query(reader, dsl.parse_query(
        {"terms": {"title": words[a:a + 20]}}), size=80, device="cpu")
        for a in (0, 20)]
    assert {h.doc_id for h in res.hits} == \
        {h.doc_id for r in halves for h in r.hits}


@pytest.mark.parametrize("body,reason", [
    ({"script_score": {"query": {"match_all": {}},
                       "script": {"source": "_score * 2"}}}, None),
    ({"function_score": {"query": {"match_all": {}},
                         "script_score": {"script": "_score"}}}, None),
    ({"rank_feature": {"field": "views"}}, None),
], ids=["script_score", "fs_script_score", "rank_feature_numeric"])
def test_refused_branches_raise_not_lowerable(shard, body, reason):
    """The branches that wait for a later module raise NotLowerable
    naming it. None is left here: a rank_feature over a numeric column
    (refused until the rarer field types came, Queue A5a-ii) and
    script_score, the query and the function_score function (refused
    until the script module came, Queue A5c), are served: the
    reference's hits and score bits."""
    if reason is None:
        got, want = run_query(shard, body, size=40)
        assert got.total_hits == want.total_hits
        assert hits_of(got) == hits_of(want)
        np.testing.assert_array_equal(f32_bits(scores_of(got)),
                                      f32_bits(scores_of(want)))
        return
    with pytest.raises(NotLowerable) as err:
        query_phase.execute_query(shard[1], dsl.parse_query(body),
                                  device="cpu")
    assert reason in str(err.value)
    assert "planner path" in str(err.value)


def test_query_phase_runs_on_the_card_unless_asked_for_the_cpu(
        shard, monkeypatch):
    """execute_query and SegmentQueryExecutor default to cuda:0: with
    no GPU and no device="cpu" they raise instead of running on the
    host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = dsl.parse_query({"match_all": {}})
    with pytest.raises(NoDeviceError):
        query_phase.execute_query(shard[1], q)
    with pytest.raises(NoDeviceError):
        SegmentQueryExecutor(shard[1], 0)
    assert query_phase.execute_query(shard[1], q, device="cpu").hits


def test_sort_and_aggs_are_refused():
    """Nothing of these is refused any more: a sort parses (since the
    sorted query phase, Queue A5c) and so do aggregations (since Queue
    A8: parse_search_body returns the parsed tree); a malformed
    aggregation tree is the reference's 400 (IllegalArgumentException),
    not a typed not_lowerable."""
    query, aggs, body = coordinator.parse_search_body(
        {"sort": [{"views": "desc"}]})
    assert isinstance(query, dsl.MatchAllQuery)
    assert aggs is None
    assert body["sort"] == [{"views": "desc"}]
    _, aggs, _ = coordinator.parse_search_body(
        {"aggs": {"n": {"max": {"field": "views"}}}})
    assert list(aggs.aggregators) == ["n"]
    with pytest.raises(IllegalArgumentException) as err:
        coordinator.parse_search_body({"aggs": {"n": {"wibble": {}}}})
    assert not isinstance(err.value, NotLowerable)
    assert "unknown aggregation type [wibble]" in str(err.value)


# ---- test_query_dsl.py's execution cases, with their expectations ----

def ids(res):
    return [h.doc_id for h in res.hits]


DSL_CASES = {
    "match_basic": ({"match": {"body": "fox"}}, {}, {"d0", "d4"}),
    "match_and": ({"match": {"body": {"query": "quick dog",
                                      "operator": "and"}}}, {}, ["d0"]),
    "match_or": ({"match": {"body": "quick dog"}}, {}, {"d0", "d1"}),
    "term_keyword": ({"term": {"tags": "finance"}}, {}, ["d3"]),
    "term_not_analyzed": ({"term": {"title": "Quick"}}, {}, []),
    "terms": ({"terms": {"tags": ["wild", "politics"]}}, {}, {"d2", "d4"}),
    "range_long": ({"range": {"views": {"gte": 100}}}, {},
                   {"d0", "d2", "d3"}),
    "range_long_gt": ({"range": {"views": {"gt": 100, "lte": 1000}}}, {},
                      {"d2", "d3"}),
    "range_double": ({"range": {"price": {"lt": 5.0}}}, {}, {"d3", "d4"}),
    "range_date": ({"range": {"published": {"gte": "2024-01-01",
                                            "lt": "2024-02-01"}}}, {},
                   {"d0", "d4"}),
    "bool": ({"bool": {"must": [{"match": {"body": "the"}}],
                       "filter": [{"term": {"active": True}}],
                       "must_not": [{"term": {"tags": "finance"}}]}}, {},
             {"d0", "d2"}),
    "msm": ({"bool": {"should": [{"match": {"body": "fox"}},
                                 {"match": {"body": "lazy"}},
                                 {"term": {"tags": "politics"}}],
                      "minimum_should_match": 2}}, {}, {"d0", "d4"}),
    "phrase": ({"match_phrase": {"body": "quick brown fox"}}, {}, ["d0"]),
    "phrase_reversed": ({"match_phrase": {"body": "brown quick"}}, {}, []),
    "match_all_paged": ({"match_all": {}}, {"size": 2, "from_": 2}, 2),
    "exists": ({"exists": {"field": "views"}}, {}, 5),
    "ids": ({"ids": {"values": ["d1", "d3", "nope"]}}, {}, {"d1", "d3"}),
    "constant_score": ({"constant_score": {
        "filter": {"term": {"tags": "animal"}}, "boost": 2.5}}, {},
        {"d0", "d1", "d2"}),
    "unmapped": ({"match": {"nope": "x"}}, {}, []),
}


@pytest.mark.parametrize("name", sorted(DSL_CASES))
def test_query_dsl_cases(dsl_readers, name):
    body, kw, expect = DSL_CASES[name]
    got, want = run_query(dsl_readers, body, **kw)
    assert ids(got) == ids(want)
    np.testing.assert_array_equal(f32_bits(scores_of(got)),
                                  f32_bits(scores_of(want)))
    if isinstance(expect, set):
        assert set(ids(got)) == expect
    elif isinstance(expect, list):
        assert ids(got) == expect
    else:
        assert len(got.hits) == expect or got.total_hits == expect


def test_match_orders_the_heaviest_doc_first(dsl_readers):
    got, _ = run_query(dsl_readers, {"match": {"body": "lazy dog"}})
    assert ids(got)[0] == "d1"


def test_multi_segment_tombstones_as_jax():
    docs = [(f"a{i}", d) for i, d in enumerate(DOCS[:3])]
    docs2 = [(f"b{i}", d) for i, d in enumerate(DOCS[3:])]
    readers = build([docs, docs2], [np.array([True, False, True]), None])
    got, want = run_query(readers, {"match": {"body": "lazy dog"}})
    assert ids(got) == ids(want) == ["a0"]
    got, want = run_query(readers, {"match_all": {}})
    assert got.total_hits == want.total_hits == 4


# ---- test_dsl_longtail.py's execution cases ----

LONGTAIL = {
    "multi_match_or": ({"multi_match": {"query": "quick",
                                        "fields": ["title", "body"]}},
                       {"0", "1", "3"}),
    "prefix": ({"prefix": {"title": {"value": "search"}}}, {"0", "4"}),
    "wildcard_star": ({"wildcard": {"title": {"value": "s*ing"}}}, {"0"}),
    "wildcard_question": ({"wildcard": {"body": {"value": "f?x"}}},
                          {"0", "3"}),
    "wildcard_none": ({"wildcard": {"title": {"value": "zz*"}}}, set()),
    "fuzzy": ({"fuzzy": {"title": {"value": "quikc"}}}, {"1", "3"}),
    "fuzzy_zero": ({"fuzzy": {"title": {"value": "quikc",
                                        "fuzziness": 0}}}, set()),
    "fuzzy_prefix_length": ({"fuzzy": {"title": {
        "value": "suick", "prefix_length": 1}}}, set()),
    "fvf_replace": ({"function_score": {
        "query": {"match_all": {}},
        "field_value_factor": {"field": "rank", "factor": 2.0,
                               "missing": 0},
        "boost_mode": "replace"}}, {"0", "1", "2", "3", "4"}),
    "filtered_function": ({"function_score": {
        "query": {"match_all": {}},
        "functions": [{"filter": {"range": {"rank": {"gte": 7}}},
                       "weight": 10.0}],
        "boost_mode": "replace"}}, {"0", "1", "2", "3", "4"}),
}


@pytest.mark.parametrize("name", sorted(LONGTAIL))
def test_dsl_longtail_cases(books_readers, name):
    body, expect = LONGTAIL[name]
    got, want = run_query(books_readers, body, size=20)
    assert ids(got) == ids(want)
    np.testing.assert_array_equal(f32_bits(scores_of(got)),
                                  f32_bits(scores_of(want)))
    assert set(ids(got)) == expect


def test_edit_distance_helper():
    assert _edit_distance_lte("quick", "quikc", 1)   # transposition
    assert _edit_distance_lte("quick", "quack", 1)
    assert not _edit_distance_lte("quick", "quake", 1)
    assert _edit_distance_lte("abc", "abc", 0)


def test_field_value_factor_replace_scores(books_readers):
    got, _ = run_query(books_readers, LONGTAIL["fvf_replace"][0], size=20)
    assert {h.doc_id: h.score for h in got.hits}["0"] == 20.0


# ---- test_can_match.py: shards skipped by their value ranges ----

@pytest.fixture(scope="module")
def ranked_shards():
    """Four shards, shard i holding ranks [100i, 100i + 9]."""
    return [build([[(f"r{i}-{j}", {"rank": 100 * i + j,
                                   "body": f"doc {j}"})
                    for j in range(10)]]) for i in range(4)]


CAN_MATCH = {
    "range_gte_300": ({"range": {"rank": {"gte": 300}}},
                      [False, False, False, True]),
    "range_gt_far": ({"range": {"rank": {"gt": 10_000}}}, [False] * 4),
    "bool_filter_lt_100": ({"bool": {"must": [{"match": {"body": "doc"}}],
                                     "filter": [{"range": {"rank": {
                                         "lt": 100}}}]}},
                           [True, False, False, False]),
    "term_105": ({"term": {"rank": 105}}, [False, True, False, False]),
    "range_95_205": ({"range": {"rank": {"gte": 95, "lte": 205}}},
                     [False, True, True, False]),
    "should_only": ({"bool": {"should": [
        {"range": {"rank": {"lt": 5}}}, {"term": {"rank": 309}}]}},
        [True, False, False, True]),
    "constant_score": ({"constant_score": {"filter": {"range": {
        "rank": {"lte": 9}}}}}, [True, False, False, False]),
    "unmapped_range": ({"range": {"nope": {"gte": 1}}}, [True] * 4),
    "text_match": ({"match": {"body": "doc"}}, [True] * 4),
}


@pytest.mark.parametrize("name", sorted(CAN_MATCH))
def test_can_match_matches_jax(ranked_shards, name):
    body, expect = CAN_MATCH[name]
    got = [can_match.can_match(r, dsl.parse_query(body), r.mapper)
           for _, r in ranked_shards]
    want = [ref_can_match.can_match(r, ref_dsl.parse_query(body), r.mapper)
            for r, _ in ranked_shards]
    assert got == want == expect


def _handle(node, dumps, method, path, body=None):
    status, payload = node.handle(method, path, {}, None,
                                  json.dumps(body).encode()
                                  if body is not None else b"")
    if isinstance(payload, dict) and "took" in payload:
        payload["took"] = 0
    return status, dumps(payload)


@pytest.fixture(scope="module")
def ranked_nodes(tmp_path_factory):
    """test_can_match.py's index on a reference node (its kernel path
    off) and a port CPU node: 4 shards, ranks clustered by shard."""
    ref = RefNode(str(tmp_path_factory.mktemp("cm_ref")),
                  settings=RefSettings.of(
                      {"search.tpu_serving.enabled": "false",
                       "search.flight_recorder.enabled": False}))
    port = Node(str(tmp_path_factory.mktemp("cm_port")), device="cpu")
    body = {"settings": {"number_of_shards": 4},
            "mappings": {"properties": {"rank": {"type": "integer"},
                                        "body": {"type": "text"}}}}
    nodes = ((ref, ref_dumps), (port, dumps_response))
    for node, dumps in nodes:
        assert _handle(node, dumps, "PUT", "/m", body)[0] == 200
    svc = port.indices.index("m")
    placed = {i: 0 for i in range(4)}
    doc = 0
    while min(placed.values()) < 10:
        target = svc.shard_for_id(str(doc))
        if placed[target] < 10:
            for node, dumps in nodes:
                _handle(node, dumps, "PUT", f"/m/_doc/{doc}",
                        {"rank": 100 * target + placed[target],
                         "body": f"doc {doc}"})
            placed[target] += 1
        doc += 1
    for node, dumps in nodes:
        _handle(node, dumps, "POST", "/m/_refresh")
    yield nodes
    port.close()
    ref.close()


@pytest.mark.parametrize("body,skipped", [
    ({"query": {"range": {"rank": {"gte": 300}}}, "size": 20}, 3),
    ({"query": {"range": {"rank": {"gt": 10_000}}}}, 4),
    ({"query": {"bool": {"must": [{"match": {"body": "doc"}}],
                         "filter": [{"range": {"rank": {"lt": 100}}}]}},
      "size": 20}, 3),
    ({"query": {"term": {"rank": 105}}, "size": 5}, 3),
], ids=["disjoint_range", "fully_disjoint", "bool_filter", "term"])
def test_can_match_skips_in_the_response_as_reference(ranked_nodes, body,
                                                      skipped):
    (ref, ref_d), (port, port_d) = ranked_nodes
    want = _handle(ref, ref_d, "POST", "/m/_search", body)
    got = _handle(port, port_d, "POST", "/m/_search", body)
    assert got == want
    assert json.loads(got[1])["_shards"]["skipped"] == skipped
