"""Port copy of ``test_rank_feature_geo.py``: the rank_feature and
geo_point mappers, the rank_feature query's functions and the
geo_distance / geo_bounding_box queries.

The geohash codec is held against the reference's functions directly;
every REST case goes to the reference node and the port node
(``torch_rest_pair``) and must give the same status and bytes, scores
included, as well as the reference file's expectations, the
geohash_grid aggregation (``TestGeohashGridAgg``) among them.
"""

import math

import numpy as np
import pytest
import torch

from elasticsearch_tpu.mapping.types import \
    GeoPointFieldType as RefGeoPoint
from elasticsearch_tpu.search.aggregations.bucket import \
    geohash_encode_batch as ref_geohash_batch

from elasticsearch_tpu_torch.common.errors import MapperParsingException
from elasticsearch_tpu_torch.mapping.types import GeoPointFieldType

from torch_rest_pair import Pair

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    p = Pair(tmp_path_factory.mktemp("rank_feature_geo"))
    yield p
    p.close()


class TestGeohashCodec:
    def test_known_values(self):
        assert GeoPointFieldType.geohash_encode(57.64911, 10.40744,
                                                11) == "u4pruydqqvj"
        lat, lon = GeoPointFieldType.geohash_decode("u4pruydqqvj")
        assert (lat, lon) == RefGeoPoint.geohash_decode("u4pruydqqvj")
        assert lat == pytest.approx(57.64911, abs=1e-4)
        assert lon == pytest.approx(10.40744, abs=1e-4)

    def test_roundtrip_matches_reference(self):
        rng = np.random.RandomState(5)
        for _ in range(50):
            lat = float(rng.uniform(-90, 90))
            lon = float(rng.uniform(-180, 180))
            for precision in (1, 5, 9, 12):
                gh = GeoPointFieldType.geohash_encode(lat, lon, precision)
                assert gh == RefGeoPoint.geohash_encode(lat, lon, precision)
                assert GeoPointFieldType.geohash_decode(gh) == \
                    RefGeoPoint.geohash_decode(gh)
            dlat, dlon = GeoPointFieldType.geohash_decode(
                GeoPointFieldType.geohash_encode(lat, lon, 9))
            assert dlat == pytest.approx(lat, abs=1e-3)
            assert dlon == pytest.approx(lon, abs=1e-3)

    @pytest.mark.parametrize("precision", [1, 6, 12])
    def test_batch_matches_scalar_and_reference(self, precision):
        rng = np.random.RandomState(6)
        lats = rng.uniform(-90, 90, 40)
        lons = rng.uniform(-180, 180, 40)
        lats[:3] = [90.0, -90.0, 0.0]
        lons[:3] = [180.0, -180.0, 0.0]
        batch = GeoPointFieldType.geohash_encode_batch(lats, lons,
                                                       precision)
        assert batch == ref_geohash_batch(lats, lons, precision)
        for i in range(40):
            assert batch[i] == GeoPointFieldType.geohash_encode(
                lats[i], lons[i], precision)

    @pytest.mark.parametrize("value", [
        {"lat": 1.5, "lon": 2.5}, "1.5,2.5", [2.5, 1.5], "u4pruydqqvj",
        {"lat": 95.0, "lon": 0}, {"lat": 0, "lon": 181}, {"lat": 1},
        "1,2,3", "a,b", "u4pru!", [1.0], 7, {"lat": "x", "lon": 1}])
    def test_point_forms_and_errors_match_reference(self, value):
        def outcome(cls):
            try:
                return ("ok", cls.parse_point(value))
            except Exception as e:  # noqa: BLE001
                return ("error", type(e).__name__, str(e))
        got = outcome(GeoPointFieldType)
        want = outcome(RefGeoPoint)
        assert got == want
        if got[0] == "error" and got[1] == "MapperParsingException":
            with pytest.raises(MapperParsingException):
                GeoPointFieldType.parse_point(value)


CITIES = {
    "london": (51.5074, -0.1278),
    "paris": (48.8566, 2.3522),
    "berlin": (52.52, 13.405),
    "nyc": (40.7128, -74.0060),
    "sydney": (-33.8688, 151.2093),
}


@pytest.fixture(scope="module")
def geo(pair):
    pair.same("PUT", "/places", {"mappings": {"properties": {
        "location": {"type": "geo_point"},
        "name": {"type": "keyword"}}}})
    forms = {
        "london": {"lat": 51.5074, "lon": -0.1278},     # object
        "paris": "48.8566,2.3522",                       # "lat,lon"
        "berlin": [13.405, 52.52],                       # [lon, lat]
        "nyc": {"lat": 40.7128, "lon": -74.0060},
        "sydney": "r3gx2f9tt5sn",                        # geohash
    }
    for name, loc in forms.items():
        pair.same("PUT", f"/places/_doc/{name}", {"location": loc,
                                                  "name": name},
                  params={"refresh": "true"})
    pair.same("PUT", "/places/_doc/nowhere", {"name": "nowhere"},
              params={"refresh": "true"})
    return pair


def _haversine_km(a, b):
    r = 6371.0088
    la1, lo1, la2, lo2 = map(math.radians, [a[0], a[1], b[0], b[1]])
    h = (math.sin((la2 - la1) / 2) ** 2
         + math.cos(la1) * math.cos(la2) * math.sin((lo2 - lo1) / 2) ** 2)
    return 2 * r * math.asin(math.sqrt(h))


def _id_set(res):
    return {h["_id"] for h in res["hits"]["hits"]}


class TestGeoQueries:
    def test_all_input_forms_parse(self, geo):
        s, res = geo.same("POST", "/places/_search", {
            "query": {"exists": {"field": "location"}}, "size": 10})
        assert res["hits"]["total"]["value"] == 5

    def test_geo_distance(self, geo):
        s, res = geo.same("POST", "/places/_search", {
            "query": {"geo_distance": {
                "distance": "500km",
                "location": {"lat": 51.5074, "lon": -0.1278}}},
            "size": 10})
        assert s == 200, res
        assert _id_set(res) == {"london", "paris"}
        assert _haversine_km(CITIES["london"], CITIES["paris"]) < 500
        assert _haversine_km(CITIES["london"], CITIES["berlin"]) > 500

    @pytest.mark.parametrize("distance,want", [
        ("250mi", {"london", "paris"}), ("402000m", {"london", "paris"}),
        ("0.5km", {"london"}), ("3000nmi", {"london", "paris", "berlin"}),
        ("1000000yd", {"london", "paris"}),
        ("12000000ft", {"london", "paris", "berlin"}),
        ("40000000in", {"london", "paris", "berlin"}), ("800", {"london"})])
    def test_geo_distance_units(self, geo, distance, want):
        s, res = geo.same("POST", "/places/_search", {
            "query": {"geo_distance": {
                "distance": distance, "location": [-0.1278, 51.5074]}},
            "size": 10})
        assert s == 200, res
        assert _id_set(res) == want

    def test_geo_bounding_box(self, geo):
        s, res = geo.same("POST", "/places/_search", {
            "query": {"geo_bounding_box": {"location": {
                "top_left": {"lat": 60.0, "lon": -10.0},
                "bottom_right": {"lat": 45.0, "lon": 20.0}}}},
            "size": 10})
        assert s == 200, res
        assert _id_set(res) == {"london", "paris", "berlin"}

    def test_bbox_crossing_antimeridian(self, pair):
        pair.same("PUT", "/pac", {"mappings": {"properties": {
            "p": {"type": "geo_point"}}}})
        for name, p in (("fiji", {"lat": -17.7, "lon": 178.0}),
                        ("samoa", {"lat": -13.8, "lon": -171.8}),
                        ("london", {"lat": 51.5, "lon": -0.13})):
            pair.same("PUT", f"/pac/_doc/{name}", {"p": p},
                      params={"refresh": "true"})
        s, res = pair.same("POST", "/pac/_search", {
            "query": {"geo_bounding_box": {"p": {
                "top": 0.0, "left": 170.0,
                "bottom": -30.0, "right": -160.0}}},
            "size": 10})
        assert _id_set(res) == {"fiji", "samoa"}

    @pytest.mark.parametrize("body", [
        {"query": {"geo_distance": {"distance": "10zz",
                                    "location": [0, 0]}}},
        {"query": {"geo_distance": {"distance": "10km",
                                    "location": {"lat": 91, "lon": 0}}}},
        {"query": {"geo_distance": {"distance": "10km",
                                    "location": "u4!"}}},
        {"query": {"geo_bounding_box": {"location": {
            "top": 10, "left": 0, "bottom": 20, "right": 5}}}},
        {"query": {"geo_bounding_box": {"location": {
            "top_left": {"lat": 1}, "bottom_right": [0, 0]}}}}],
        ids=["unit", "lat", "geohash", "bottom_above_top", "corner"])
    def test_bad_points_400(self, geo, body):
        s, res = geo.same("POST", "/places/_search", body)
        assert s == 400, res

    def test_bad_point_on_write_400(self, geo):
        s, res = geo.same("PUT", "/places/_doc/bad",
                          {"location": {"lat": 95.0, "lon": 0}})
        assert s == 400, res

    def test_geo_distance_filter_context(self, geo):
        s, res = geo.same("POST", "/places/_search", {
            "query": {"bool": {
                "filter": [{"geo_distance": {
                    "distance": "500km", "location": [2.35, 48.85]}}],
                "must": [{"term": {"name": "paris"}}]}},
            "size": 10})
        assert s == 200, res
        assert [h["_id"] for h in res["hits"]["hits"]] == ["paris"]


class TestGeohashGridAgg:
    def test_cells(self, geo):
        status, res = geo.same("POST", "/places/_search", {
            "size": 0, "aggs": {"cells": {"geohash_grid": {
                "field": "location", "precision": 3}}}})
        assert status == 200, res
        buckets = res["aggregations"]["cells"]["buckets"]
        keys = {b["key"] for b in buckets}
        # london's gcpv..., paris u09..., known prefixes
        assert GeoPointFieldType.geohash_encode(51.5074, -0.1278,
                                                3) in keys
        assert len(buckets) == 5
        assert all(b["doc_count"] == 1 for b in buckets)

    def test_precision_groups(self, pair):
        pair.same("PUT", "/pts", {"mappings": {"properties": {
            "p": {"type": "geo_point"}}}})
        # two points very close together + one far away
        for i, loc in enumerate([(48.8566, 2.3522), (48.8570, 2.3530),
                                 (-33.8, 151.2)]):
            pair.same("PUT", f"/pts/_doc/{i}",
                      {"p": {"lat": loc[0], "lon": loc[1]}},
                      params={"refresh": "true"})
        _, res = pair.same("POST", "/pts/_search", {
            "size": 0, "aggs": {"g": {"geohash_grid": {
                "field": "p", "precision": 4}}}})
        buckets = res["aggregations"]["g"]["buckets"]
        assert len(buckets) == 2
        assert buckets[0]["doc_count"] == 2  # count-ordered

    def test_sub_aggs(self, geo):
        status, res = geo.same("POST", "/places/_search", {
            "size": 0, "aggs": {"cells": {
                "geohash_grid": {"field": "location", "precision": 1},
                "aggs": {"names": {"terms": {"field": "name"}}}}}})
        assert status == 200, res
        for b in res["aggregations"]["cells"]["buckets"]:
            assert b["names"]["buckets"], b

    def test_bad_precision_400(self, geo):
        status, _ = geo.same("POST", "/places/_search", {
            "size": 0, "aggs": {"g": {"geohash_grid": {
                "field": "location", "precision": 13}}}})
        assert status == 400


FEATURES = [0.5, 2.0, 8.0, 32.0]


@pytest.fixture(scope="module")
def featured(pair):
    pair.same("PUT", "/docs", {"mappings": {"properties": {
        "pagerank": {"type": "rank_feature"},
        "cost": {"type": "rank_feature", "positive_score_impact": False},
        "title": {"type": "text"}}}})
    for i, pr in enumerate(FEATURES):
        pair.same("PUT", f"/docs/_doc/{i}",
                  {"pagerank": pr, "cost": 1.0 + 3.5 * i,
                   "title": f"doc {i}"}, params={"refresh": "true"})
    return pair


def _scores(res):
    return {h["_id"]: h["_score"] for h in res["hits"]["hits"]}


class TestRankFeature:
    def test_saturation_with_pivot(self, featured):
        s, res = featured.same("POST", "/docs/_search", {
            "query": {"rank_feature": {"field": "pagerank",
                                       "saturation": {"pivot": 8}}},
            "size": 10})
        assert s == 200, res
        by_id = _scores(res)
        for i, pr in enumerate(FEATURES):
            assert by_id[str(i)] == pytest.approx(pr / (pr + 8), rel=1e-5)

    def test_default_pivot_is_geometric_mean(self, featured):
        s, res = featured.same("POST", "/docs/_search", {
            "query": {"rank_feature": {"field": "pagerank"}},
            "size": 10})
        assert s == 200, res
        gm = float(np.exp(np.mean(np.log(FEATURES))))
        assert _scores(res)["3"] == pytest.approx(32 / (32 + gm), rel=1e-4)

    def test_log_and_sigmoid(self, featured):
        s, res = featured.same("POST", "/docs/_search", {
            "query": {"rank_feature": {
                "field": "pagerank",
                "log": {"scaling_factor": 2}}}, "size": 10})
        assert _scores(res)["2"] == pytest.approx(math.log(10), rel=1e-5)
        s, res = featured.same("POST", "/docs/_search", {
            "query": {"rank_feature": {
                "field": "pagerank",
                "sigmoid": {"pivot": 8, "exponent": 0.6}}}, "size": 10})
        expect = 8 ** 0.6 / (8 ** 0.6 + 8 ** 0.6)
        assert _scores(res)["2"] == pytest.approx(expect, rel=1e-5)

    @pytest.mark.parametrize("function", [
        {"linear": {}}, {"saturation": {"pivot": 3.3}}, {"saturation": {}},
        {"log": {"scaling_factor": 1.5}},
        {"sigmoid": {"pivot": 2.5, "exponent": 1.7}}],
        ids=["linear", "saturation", "default_pivot", "log", "sigmoid"])
    def test_negative_impact_inverts(self, featured, function):
        body = {"field": "cost", "boost": 1.5}
        body.update(function)
        s, res = featured.same("POST", "/docs/_search", {
            "query": {"rank_feature": body}, "size": 10})
        assert s == 200, res
        assert [h["_id"] for h in res["hits"]["hits"]] == \
            ["0", "1", "2", "3"]

    def test_missing_docs_dont_match(self, featured):
        featured.same("PUT", "/docs/_doc/nofeat", {"title": "no rank"},
                      params={"refresh": "true"})
        s, res = featured.same("POST", "/docs/_search", {
            "query": {"rank_feature": {"field": "pagerank"}},
            "size": 10})
        assert "nofeat" not in _id_set(res)

    def test_hybrid_with_bm25_via_bool_should(self, featured):
        s, res = featured.same("POST", "/docs/_search", {
            "query": {"bool": {
                "must": [{"match": {"title": "doc"}}],
                "should": [{"rank_feature": {"field": "pagerank",
                                             "saturation": {
                                                 "pivot": 8}}}]}},
            "size": 10})
        assert s == 200, res
        assert res["hits"]["hits"][0]["_id"] == "3"

    @pytest.mark.parametrize("value", [-1, 0, "x", None, [1.0, -2.0]])
    def test_rejects_non_positive(self, featured, value):
        s, res = featured.same("PUT", "/docs/_doc/bad",
                               {"pagerank": value})
        assert s == (201 if value is None else 400), res

    def test_validation_400s(self, featured):
        for query in ({"field": "pagerank", "log": {}},
                      {"field": "pagerank", "saturation": {},
                       "log": {"scaling_factor": 1}},
                      {"field": "pagerank", "sigmoid": {"pivot": 1}},
                      {"field": "pagerank", "bogus": 1}):
            s, res = featured.same("POST", "/docs/_search",
                                   {"query": {"rank_feature": query}})
            assert s == 400, res
        s, res = featured.same("POST", "/docs/_search", {
            "query": {"term": {"pagerank": 1}}})
        assert s == 400, res
