"""Bitwise sweeps of the rarer field types' parity traps, executor
against executor.

The same seeded documents go through both packages' mapper and segment
writer into a two-segment shard with tombstones; each query runs
through the reference's ``SegmentQueryExecutor`` (JAX on the CPU) and
the port's (torch on the CPU) per segment, and the masks and score bits
must be equal, and so must ``execute_query``'s hits. The traps:

* ``rank_feature``'s sigmoid: XLA:CPU's f32 pow is the C library's
  ``powf`` (``ops/xla_math.xla_powf``), over feature values from 1e-30
  to 1e30, a subnormal among them; its log (``xla_logf``); the
  negative-impact reciprocal; the f64 default pivot;
* the f64 haversine mask with points on the radius: each radius is a
  point's own reference distance and its neighbouring doubles, so the
  mask turns at that point;
* ip (hi, lo) columns at the IPv4-mapped and sentinel edges (0.0.0.0 and
  :: give the MISSING_I64 hi), with CIDR and range bounds on them;
* the range fields' relations at their bounds, open bounds and NaN
  presence for the f64 kind;
* nested score modes and percolate over the same shard.
"""

import ipaddress

import numpy as np
import pytest
import torch

from elasticsearch_tpu.common.settings import Settings as RefSettings
from elasticsearch_tpu.index.reader import ShardReader as RefReader
from elasticsearch_tpu.index.segment import SegmentWriter as RefWriter
from elasticsearch_tpu.mapping import MapperService as RefMapper
from elasticsearch_tpu.search import dsl as ref_dsl
from elasticsearch_tpu.search import query_phase as ref_qp
from elasticsearch_tpu.search.planner import \
    SegmentQueryExecutor as RefExecutor

from elasticsearch_tpu_torch.index.reader import ShardReader
from elasticsearch_tpu_torch.index.segment import SegmentWriter
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.ops import geo
from elasticsearch_tpu_torch.ops.xla_math import xla_powf
from elasticsearch_tpu_torch.search import dsl, query_phase
from elasticsearch_tpu_torch.search.planner import SegmentQueryExecutor

torch.set_num_threads(1)

MAPPING = {"properties": {
    "pr": {"type": "rank_feature"},
    "cost": {"type": "rank_feature", "positive_score_impact": False},
    "views": {"type": "long"},
    "loc": {"type": "geo_point"},
    "addr": {"type": "ip"},
    "span": {"type": "integer_range"},
    "band": {"type": "double_range"},
    "tag": {"type": "keyword"},
    "q": {"type": "percolator"},
    "sugg": {"type": "completion"},
    "vec": {"type": "dense_vector", "dims": 4},
    "kids": {"type": "nested", "properties": {
        "name": {"type": "keyword"}, "age": {"type": "long"},
        "bio": {"type": "text"}}},
}}

IPS = ["0.0.0.0", "::", "::1", "::ffff:0:0", "0.0.0.1", "255.255.255.255",
       "10.0.0.0", "10.0.255.255", "10.1.0.0", "ffff:ffff:ffff:ffff:ffff:"
       "ffff:ffff:ffff", "8000::", "7fff:ffff:ffff:ffff:ffff:ffff:ffff:"
       "ffff", "2001:db8::", "2001:db8::ffff:ffff"]

STORED = [
    {"match": {"tag": "t1"}}, {"term": {"tag": "t2"}},
    {"range": {"views": {"gte": 50}}},
    {"bool": {"must": [{"match": {"tag": "t0"}}],
              "filter": [{"range": {"views": {"lt": 500}}}]}},
    {"geo_distance": {"distance": "2000km", "loc": [10, 50]}},
    {"term": {"addr": "10.0.0.0/16"}}, {"match_all": {}},
    {"range": {"span": {"gte": 5, "lte": 9, "relation": "within"}}},
    {"term": {"views": "not a number"}},   # raises: skipped
]


def make_docs(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        d = {"tag": f"t{i % 4}"}
        if i % 7:
            d["pr"] = float(10.0 ** rng.uniform(-30, 30)) if i % 3 == 0 \
                else float(rng.uniform(0.01, 100))
        if i % 5:
            d["cost"] = float(rng.uniform(1e-3, 1e3))
        if i % 4:
            d["views"] = int(rng.integers(-50, 2000))
        if i % 6:
            d["loc"] = {"lat": float(rng.uniform(-90, 90)),
                        "lon": float(rng.uniform(-180, 180))}
        if i % 3:
            if i < 2 * len(IPS):
                d["addr"] = IPS[i % len(IPS)]
            elif i % 2:
                d["addr"] = str(ipaddress.IPv4Address(
                    int(rng.integers(0, 2 ** 32))))
            else:
                d["addr"] = str(ipaddress.IPv6Address(
                    int(rng.integers(0, 2 ** 63)) << 64
                    | int(rng.integers(0, 2 ** 63))))
        if i % 4 != 1:
            lo = int(rng.integers(0, 20))
            d["span"] = {"gte": lo, "lte": lo + int(rng.integers(0, 8))}
            if i % 9 == 0:
                d["span"] = {"gt": lo}
        if i % 5 != 2:
            lo = float(rng.integers(0, 20)) / 2
            d["band"] = {"gte": lo, "lt": lo + 2.5} if i % 2 \
                else {"lte": lo}
        if i % 8 == 0:
            d["kids"] = [{"name": f"k{j}", "age": int(rng.integers(0, 18)),
                          "bio": "likes red boats" if j % 2 else
                          "likes blue trains"}
                         for j in range(int(rng.integers(1, 4)))]
        if i % 10 == 3:
            d["q"] = STORED[(i // 10) % len(STORED)]
        if i % 4 == 2:
            d["vec"] = [float(v) for v in rng.standard_normal(4)]
            d["sugg"] = {"input": [f"s{i}", f"t{i % 9}"], "weight": i}
        out.append(d)
    # a subnormal feature (f32) and values on the exact edges
    out[1]["pr"] = 1e-40
    out[2]["pr"] = 1.0
    return out


def build(segment_docs, lives):
    ref_ms = RefMapper(RefSettings.EMPTY, MAPPING)
    ms = MapperService(MAPPING)
    ref_segs, segs = [], []
    for si, docs in enumerate(segment_docs):
        rw, w = RefWriter(f"s{si}"), SegmentWriter(f"s{si}")
        for doc_id, src in docs:
            rw.add_document(ref_ms.parse_document(doc_id, src),
                            ref_ms.dv_kinds())
            w.add_document(ms.parse_document(doc_id, src), ms.dv_kinds())
        ref_segs.append(rw.freeze())
        segs.append(w.freeze())
    return (RefReader(list(zip(ref_segs, lives)), ref_ms),
            ShardReader(list(zip(segs, lives)), ms))


@pytest.fixture(scope="module")
def shard():
    first = [(f"a{i}", d) for i, d in enumerate(make_docs(300, 1))]
    second = [(f"b{i}", d) for i, d in enumerate(make_docs(200, 2))]
    live1 = np.ones(len(first), dtype=bool)
    live1[[3, 13, 40, 77]] = False
    live2 = np.ones(len(second), dtype=bool)
    live2[[0, 23]] = False
    return build([first, second], [live1, live2])


def f32_bits(x):
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def assert_same(shard, body):
    """Per segment: the same mask and score bits; the shard's query
    phase: the same hits, score bits and totals."""
    ref_reader, reader = shard
    for idx in range(len(reader.views)):
        w_mask, w_score = RefExecutor(ref_reader, idx).execute(
            ref_dsl.parse_query(body))
        g_mask, g_score = SegmentQueryExecutor(reader, idx, "cpu").execute(
            dsl.parse_query(body))
        np.testing.assert_array_equal(g_mask.numpy(), np.asarray(w_mask))
        np.testing.assert_array_equal(f32_bits(g_score.numpy()),
                                      f32_bits(w_score))
    want = ref_qp.execute_query(ref_reader, ref_dsl.parse_query(body),
                                size=600)
    got = query_phase.execute_query(reader, dsl.parse_query(body), size=600,
                                    device="cpu")
    assert got.total_hits == want.total_hits
    assert [(h.doc_id, h.ref.segment, h.ref.ord) for h in got.hits] == \
        [(h.doc_id, h.ref.segment, h.ref.ord) for h in want.hits]
    np.testing.assert_array_equal(
        f32_bits([h.score for h in got.hits]),
        f32_bits([h.score for h in want.hits]))
    return want


# ---- rank_feature ----

RANK_FEATURE = [
    {"field": "pr"}, {"field": "pr", "saturation": {"pivot": 3.7}},
    {"field": "pr", "linear": {}, "boost": 0.3},
    {"field": "pr", "log": {"scaling_factor": 1.0}},
    {"field": "pr", "log": {"scaling_factor": 4.25}, "boost": 2.0},
    {"field": "cost"}, {"field": "cost", "sigmoid": {"pivot": 7,
                                                     "exponent": 0.6}},
    {"field": "cost", "log": {"scaling_factor": 2}},
    {"field": "views", "sigmoid": {"pivot": 10, "exponent": 1.5}},
    {"field": "views", "saturation": {"pivot": 2}},
] + [{"field": "pr", "sigmoid": {"pivot": p, "exponent": e}}
     for p, e in ((1.0, 0.6), (8.0, 0.5), (0.003, 1.7), (1e6, 0.25),
                  (42.0, 3.0), (0.5, 0.01), (2.0, 9.5))]


@pytest.mark.parametrize("i", range(len(RANK_FEATURE)))
def test_rank_feature_scores_bitwise(shard, i):
    assert_same(shard, {"rank_feature": RANK_FEATURE[i]})


def test_rank_feature_in_bool_should_with_match(shard):
    assert_same(shard, {"bool": {
        "must": [{"match": {"tag": "t1"}}],
        "should": [{"rank_feature": {"field": "pr", "sigmoid": {
            "pivot": 5.5, "exponent": 0.7}}},
            {"rank_feature": {"field": "cost"}}]}})


@pytest.mark.parametrize("y", [0.6, 0.25, 1.7, 3.0, -0.5, 0.0])
def test_powf_sweep_matches_xla(y):
    """xla_powf against jnp.power on XLA:CPU over a logarithmic sweep of
    f32 values, special values included."""
    import jax.numpy as jnp
    rng = np.random.default_rng(7)
    xs = np.concatenate([
        10.0 ** rng.uniform(-38, 38, 20000), rng.uniform(0.5, 2.0, 20000),
        [0.0, 1.0, np.inf, 1e-40, 3e-39, 2.0 ** -126, 65504.0],
        -rng.uniform(0, 4, 100)]).astype(np.float32)
    want = np.asarray(jnp.power(jnp.asarray(xs), y))
    got = xla_powf(torch.from_numpy(xs), y).numpy()
    same = (f32_bits(got) == f32_bits(want)) | (np.isnan(got)
                                               & np.isnan(want))
    assert same.all(), xs[~same][:5]


# ---- geo ----

def geo_points(shard):
    ref_reader = shard[0]
    seg = ref_reader.views[0].segment
    return (seg.doc_values["loc._lat"].values,
            seg.doc_values["loc._lon"].values)


@pytest.mark.parametrize("center", [(50.0, 10.0), (-33.9, 151.2),
                                    (0.0, 179.9), (89.5, -45.0)])
def test_geo_distance_mask_on_the_radius(shard, center):
    """Radii equal to a point's own reference distance, and the doubles
    either side of it: the mask turns at that point on both sides."""
    lat, lon = geo_points(shard)
    ok = ~np.isnan(lat)
    for j in np.nonzero(ok)[0][:4]:
        d = geo.reference_distance(float(lat[j]), float(lon[j]), *center)
        for r in (d, np.nextafter(d, 0.0), np.nextafter(d, np.inf)):
            assert_same(shard, {"geo_distance": {
                "distance": f"{float(r)!r}m",
                "loc": {"lat": center[0], "lon": center[1]}}})


def test_geo_distance_band_is_resolved_exactly():
    """Points within a few ulps of the radius: ops/geo's mask is the
    reference formula's, and torch's own haversine alone would not be."""
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    lat = rng.uniform(-90, 90, 4000)
    lon = rng.uniform(-180, 180, 4000)
    qlat, qlon = 12.5, -33.25
    rad = jnp.pi / 180.0
    a = jnp.sin((jnp.asarray(lat) - qlat) * rad / 2) ** 2 + \
        jnp.cos(jnp.asarray(lat) * rad) * jnp.cos(qlat * rad) * \
        jnp.sin((jnp.asarray(lon) - qlon) * rad / 2) ** 2
    dist = np.asarray(2 * geo.EARTH_R_M
                      * jnp.arcsin(jnp.sqrt(jnp.clip(a, 0.0, 1.0))))
    for j in range(40):
        for r in (dist[j], np.nextafter(dist[j], 0.0)):
            got = geo.distance_mask(torch.from_numpy(lat),
                                    torch.from_numpy(lon), qlat, qlon,
                                    float(r)).numpy()
            np.testing.assert_array_equal(got, dist <= r)


@pytest.mark.parametrize("box", [
    {"top": 45, "left": -20, "bottom": -10, "right": 60},
    {"top": 80, "left": 150, "bottom": -80, "right": -150},
    {"top_left": "u0", "bottom_right": [30, 20]},
    {"top": 90, "left": -180, "bottom": -90, "right": 180}])
def test_geo_bounding_box_bitwise(shard, box):
    assert_same(shard, {"geo_bounding_box": {"loc": box, "boost": 1.5}})


# ---- ip ----

@pytest.mark.parametrize("body", [
    {"range": {"addr": {"lte": "0.0.0.0"}}},
    {"range": {"addr": {"gte": "::", "lte": "::"}}},
    {"range": {"addr": {"gt": "::"}}},
    {"range": {"addr": {"lt": "::1"}}},
    {"range": {"addr": {"gte": "::ffff:0:0", "lt": "::ffff:0.0.0.1"}}},
    {"range": {"addr": {"gte": "7fff:ffff:ffff:ffff:ffff:ffff:ffff:ffff",
                        "lte": "8000::"}}},
    {"range": {"addr": {"gt": "ffff:ffff:ffff:ffff:ffff:ffff:ffff:ffff"}}},
    {"range": {"addr": {"gte": "10.0.0.0", "lt": "10.1.0.0",
                        "boost": 3.0}}},
    {"term": {"addr": "0.0.0.0/8"}}, {"term": {"addr": "::/0"}},
    {"term": {"addr": "::/127"}}, {"term": {"addr": "10.0.0.0/16"}},
    {"term": {"addr": "2001:db8::/32"}}, {"term": {"addr": "::ffff:0:0"}},
    {"terms": {"addr": ["::", "0.0.0.0", "10.0.0.0"]}},
    {"exists": {"field": "addr"}}],
    ids=lambda b: str(b)[:60])
def test_ip_edges_bitwise(shard, body):
    assert_same(shard, body)


# ---- range fields ----

@pytest.mark.parametrize("relation", ["intersects", "within", "contains",
                                      "INTERSECTS"])
@pytest.mark.parametrize("bounds", [
    {"gte": 5, "lte": 9}, {"gt": 5, "lt": 9}, {"gte": 19}, {"lte": 0},
    {"gte": 7, "lte": 7}, {}])
def test_integer_range_relations_at_bounds(shard, relation, bounds):
    assert_same(shard, {"range": {"span": dict(bounds,
                                                relation=relation)}})


@pytest.mark.parametrize("relation", ["intersects", "within", "contains"])
@pytest.mark.parametrize("bounds", [
    {"gte": 2.5, "lte": 5.0}, {"gt": 2.5, "lt": 5.0}, {"gte": 9.5},
    {"lte": 0.0}])
def test_double_range_relations_at_bounds(shard, relation, bounds):
    assert_same(shard, {"range": {"band": dict(bounds,
                                                relation=relation)}})


def test_range_field_term_and_unknown_relation(shard):
    assert_same(shard, {"term": {"span": 7}})
    assert_same(shard, {"term": {"band": 2.5}})
    from elasticsearch_tpu.common.errors import ParsingException as RefPE
    from elasticsearch_tpu_torch.common.errors import ParsingException
    body = {"range": {"span": {"gte": 1, "relation": "overlaps"}}}
    with pytest.raises(RefPE) as want:
        ref_dsl.parse_query(body)
    with pytest.raises(ParsingException) as got:
        dsl.parse_query(body)
    assert str(got.value) == str(want.value)


# ---- nested and percolate ----

@pytest.mark.parametrize("mode", ["sum", "avg", "min", "max", "none"])
def test_nested_score_modes_bitwise(shard, mode):
    assert_same(shard, {"nested": {"path": "kids", "score_mode": mode,
                                   "boost": 1.25, "query": {"bool": {
                                       "should": [
                                           {"range": {"kids.age": {
                                               "lt": 9}}},
                                           {"match": {"kids.bio":
                                                      "red"}}]}}}})


def test_nested_cross_object_and_direct_queries(shard):
    assert_same(shard, {"nested": {"path": "kids", "query": {"bool": {
        "must": [{"term": {"kids.name": "k1"}},
                 {"match": {"kids.bio": "blue"}}]}}}})
    assert_same(shard, {"term": {"kids.name": "k0"}})


@pytest.mark.parametrize("documents", [
    [{"tag": "t1", "views": 10}],
    [{"tag": "t0", "views": 100, "loc": [10.5, 49.5]}],
    [{"addr": "10.0.3.4"}, {"span": {"gte": 6, "lte": 8}}],
    [{"views": 7, "extra": "dynamic text"}]])
def test_percolate_bitwise(shard, documents):
    assert_same(shard, {"percolate": {"field": "q",
                                      "documents": documents}})


@pytest.mark.parametrize("body", [
    {"range": {"addr": {"gte": "10.0.0.0"}}},
    {"range": {"span": {"gte": 1000}}},
    {"range": {"band": {"lte": -5}}},
    {"range": {"pr": {"gte": 1e40}}},
    {"range": {"views": {"gte": 10 ** 6}}},
    {"term": {"views": -999}},
    {"geo_distance": {"distance": "1km", "loc": [0, 0]}},
    {"bool": {"filter": [{"range": {"views": {"lt": -100}}},
                         {"term": {"addr": "::1"}}]}}],
    ids=lambda b: str(b)[:50])
def test_can_match_on_the_rarer_types_as_reference(shard, body):
    """can_match models only numeric and date doc-value columns: the
    rarer types' synthetic columns never skip a shard there either."""
    from elasticsearch_tpu.search import can_match as ref_can_match
    from elasticsearch_tpu_torch.search import can_match
    ref_reader, reader = shard
    assert can_match.can_match(reader, dsl.parse_query(body),
                               reader.mapper) == \
        ref_can_match.can_match(ref_reader, ref_dsl.parse_query(body),
                                ref_reader.mapper)


def test_store_round_trips_the_rarer_columns(shard, tmp_path):
    """save_segment / load_segment keep the synthetic ip, geo and range
    columns, the rank feature, the completion ordinals, the vectors and
    the nested objects."""
    from elasticsearch_tpu_torch.index.store import (load_segment,
                                                     save_segment)
    for view in shard[1].views:
        seg = view.segment
        crcs = save_segment(str(tmp_path), seg)
        back = load_segment(str(tmp_path), seg.name, crcs)
        assert sorted(back.doc_values) == sorted(seg.doc_values)
        assert {"addr._ip_hi", "addr._ip_lo", "loc._lat", "loc._lon",
                "span._gte", "band._lte", "pr", "cost", "vec", "sugg",
                "sugg._weight"} <= set(seg.doc_values)
        assert seg.doc_values["vec"].kind == "vec"
        for field, col in seg.doc_values.items():
            got = back.doc_values[field]
            assert got.kind == col.kind
            np.testing.assert_array_equal(got.values, col.values)
            assert got.extra == col.extra and got.ord_terms == col.ord_terms
        assert back.nested_store == seg.nested_store
        assert back.nested_store["kids"]
        assert back.token_slots == seg.token_slots


@pytest.mark.parametrize("field", ["vec", "loc", "sugg", "span", "pr",
                                   "q", "kids", "kids.name"])
def test_exists_on_the_rarer_types_bitwise(shard, field):
    assert_same(shard, {"exists": {"field": field}})
