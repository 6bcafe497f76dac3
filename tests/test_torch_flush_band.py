"""XLA:CPU's flush of float32 products and quotients near FLT_MIN at each
site of the planner, the script module and BM25 that rounds one (ROADMAP
Queue C, C10), the port against the reference, score bits (CPU).

XLA:CPU runs with FTZ: a result that is tiny after rounding to 24 bits
with an unbounded exponent is a zero of its sign. An exact result in
[2^-126 - 2^-150, 2^-126 - 2^-151) rounds to FLT_MIN on float32's
subnormal grid, so flushing a float32 op's result afterwards keeps it;
``xla_mulf`` / ``xla_divf`` round it as XLA:CPU does. Each test builds a
one-document shard in both packages and runs the query through both
``SegmentQueryExecutor``s; the inputs put the site's result in that band
(the sites that cannot reach it are the squares, the reciprocals of one
float32 value, and a product clamped at 1e-12 after it).
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu.common.settings import Settings as RefSettings
from elasticsearch_tpu.index.reader import ShardReader as RefReader
from elasticsearch_tpu.index.segment import SegmentWriter as RefWriter
from elasticsearch_tpu.mapping import MapperService as RefMapper
from elasticsearch_tpu.search import dsl as ref_dsl
from elasticsearch_tpu.search.planner import \
    SegmentQueryExecutor as RefExecutor

from elasticsearch_tpu_torch.index.reader import ShardReader
from elasticsearch_tpu_torch.index.segment import SegmentWriter
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.search import dsl
from elasticsearch_tpu_torch.search.planner import SegmentQueryExecutor

torch.set_num_threads(1)

MAPPING = {"properties": {
    "pr": {"type": "rank_feature"},
    "body": {"type": "text"},
    "vec": {"type": "dense_vector", "dims": 2},
}}

FLT_MIN = 2.0 ** -126
#: the largest float32 below 2^-100: divided by 2^26, the band's low end
BELOW_2_M100 = float(np.float32(2.0 ** -100 - 2.0 ** -124))


def _in_band(exact: float) -> bool:
    return FLT_MIN - 2.0 ** -150 <= exact < FLT_MIN - 2.0 ** -151


def _scores(doc, query_json):
    """(reference score bits, port score bits) of the one doc."""
    ref_ms = RefMapper(RefSettings.EMPTY, MAPPING)
    ms = MapperService(MAPPING)
    rw, w = RefWriter("s0"), SegmentWriter("s0")
    rw.add_document(ref_ms.parse_document("d0", doc), ref_ms.dv_kinds())
    w.add_document(ms.parse_document("d0", doc), ms.dv_kinds())
    ref_reader = RefReader([(rw.freeze(), None)], ref_ms)
    reader = ShardReader([(w.freeze(), None)], ms)
    want_mask, want = RefExecutor(ref_reader, 0).execute(
        ref_dsl.parse_query(query_json))
    got_mask, got = SegmentQueryExecutor(reader, 0, "cpu").execute(
        dsl.parse_query(query_json))
    assert bool(np.asarray(want_mask)[0]) and bool(got_mask[0])
    return (np.asarray(want, dtype=np.float32)[:1].view(np.uint32),
            got.numpy()[:1].view(np.uint32))


def _same(doc, query_json):
    want, got = _scores(doc, query_json)
    # the band is reached: the reference flushed the site's result
    assert want[0] == 0, want
    np.testing.assert_array_equal(want, got)


def test_rank_feature_boost_product():
    """planner: a linear rank_feature score times its boost."""
    x = float(np.float32(1.0 - 2.0 ** -24))
    assert _in_band(x * FLT_MIN)
    _same({"pr": x}, {"rank_feature": {"field": "pr", "linear": {},
                                       "boost": FLT_MIN}})


def test_rank_feature_saturation_quotient():
    """planner: saturation's x / (x + pivot)."""
    assert _in_band(BELOW_2_M100 / 2.0 ** 26)
    _same({"pr": BELOW_2_M100},
          {"rank_feature": {"field": "pr",
                            "saturation": {"pivot": 2.0 ** 26}}})


def test_rank_feature_sigmoid_quotient():
    """planner: sigmoid's x^e / (x^e + pivot^e)."""
    _same({"pr": BELOW_2_M100},
          {"rank_feature": {"field": "pr",
                            "sigmoid": {"pivot": 2.0 ** 26,
                                        "exponent": 1}}})


def _script(source, score, params=None, vec=None):
    doc = {"body": "a"}
    if vec is not None:
        doc["vec"] = vec
    return doc, {"script_score": {
        "query": {"constant_score": {"filter": {"match": {"body": "a"}},
                                     "boost": score}},
        "script": {"source": source, "params": params or {}}}}


def test_script_product():
    """script: a float32 product (``_score * params.f``)."""
    s = float(np.float32(1.0 - 2.0 ** -24))
    _same(*_script("_score * params.f", s, {"f": FLT_MIN}))


def test_script_quotient():
    """script: a float32 quotient (``_score / params.d``)."""
    _same(*_script("_score / params.d", BELOW_2_M100, {"d": 2.0 ** 26}))


def _pow_last_product(s: float, n: int) -> float:
    """The exact value of integer_pow(s, n)'s last multiply of the
    accumulator, with float32 rounding of every earlier step
    (square-and-multiply over n's bits)."""
    acc, x, last = None, np.float32(s), None
    while n:
        if n & 1:
            if acc is not None:
                last = float(acc) * float(x)   # exact in float64
                acc = np.float32(last)
            else:
                acc = x
        n >>= 1
        if n:
            x = np.float32(float(x) * float(x))
    return last


def test_script_integer_power_product():
    """script: integer_pow's multiply of the accumulator (Math.pow with
    an int exponent). Such a product lands in the band rarely: a search
    over n < 3,000 with bases next to 2^(-126 / n) finds n = 933."""
    s, n = 0.9106394052505493, 933
    assert float(np.float32(s)) == s
    assert _in_band(_pow_last_product(s, n))
    _same(*_script(f"Math.pow(_score, {n})", s))


def test_script_cosine_quotient():
    """script: cosineSimilarity's dot / max(|v| |q|, 1e-12): v = (1, 0),
    q = (t, 2), so the quotient is t / 2 (a quotient reaches the band only
    as the largest float32 below a power of two over a power of two)."""
    t = float(np.float32(2.0 ** -125 - 2.0 ** -149))
    assert _in_band(t / 2.0)
    _same(*_script("cosineSimilarity(params.qv, 'vec')", 1.0,
                   {"qv": [t, 2.0]}, vec=[1.0, 0.0]))


def test_bm25_impact_with_a_tiny_boost():
    """ops/bm25: the impact w * tf / (tf + k1 (1 - b + b dl / avgdl)) of a
    match whose boost makes it subnormal: the reference flushes it."""
    doc = {"body": "a"}
    for boost in (1e-38, 3e-39, 2e-38):
        want, got = _scores(doc, {"match": {"body": {"query": "a",
                                                     "boost": boost}}})
        np.testing.assert_array_equal(want, got)
    want, _ = _scores(doc, {"match": {"body": {"query": "a",
                                               "boost": 3e-39}}})
    assert want[0] == 0
