"""The port's query grammar against the reference's: the parse-only
cases of ``tests/test_query_dsl.py::TestParse``, and every query type of
``_PARSERS`` with well-formed and malformed bodies, parsed by both
packages: the same node (class and fields) or the same exception type
and text."""

import dataclasses

import pytest

from elasticsearch_tpu.search import dsl as ref_dsl

from elasticsearch_tpu_torch.common.errors import ParsingException
from elasticsearch_tpu_torch.search import dsl


class TestParse:
    def test_parse_shapes(self):
        q = dsl.parse_query({"match": {"title": "fox"}})
        assert isinstance(q, dsl.MatchQuery) and q.field == "title"
        q = dsl.parse_query({"match": {"title": {"query": "fox",
                                                 "operator": "AND"}}})
        assert q.operator == "and"
        q = dsl.parse_query({"bool": {"must": {"term": {"tags": "animal"}}}})
        assert isinstance(q.must[0], dsl.TermQuery)

    def test_parse_errors(self):
        with pytest.raises(ParsingException):
            dsl.parse_query({"mathc": {"title": "fox"}})
        with pytest.raises(ParsingException):
            dsl.parse_query({"match": {"title": "a"}, "term": {"x": 1}})
        with pytest.raises(ParsingException):
            dsl.parse_query({"range": {"views": {"gte": 1, "bogus": 2}}})
        with pytest.raises(ParsingException):
            dsl.parse_query({"bool": {"mustt": []}})


GEO = {"distance": "12km", "loc": {"lat": 40.0, "lon": -70.0}}
BODIES = [
    {"match": {"body": "alpha beta"}},
    {"match": {"body": {"query": "a", "operator": "xor"}}},
    {"match": {"body": {"operator": "and"}}},
    {"match_phrase": {"body": {"query": "a b", "slop": 2}}},
    {"term": {"tag": {"value": "x", "boost": 2}}},
    {"term": {"tag": "x", "other": "y"}},
    {"terms": {"tag": ["x", "y"], "boost": 1.5}},
    {"terms": {"tag": "x"}},
    {"terms": 7},
    {"range": {"n": {"gte": 1, "lt": 9, "relation": "within"}}},
    {"range": {"n": {"gte": 1, "relation": "near"}}},
    {"range": {"body": 5}},
    {"range": {"n": {"gte": 1}, "m": {"lt": 2}}},
    {"bool": {"should": [{"term": {"a": "b"}}],
              "minimum_should_match": 1, "boost": 2}},
    {"bool": {"should": [{"match": {"body": "a"}},
                         {"match": {"body": {"operator": "and"}}}]}},
    {"bool": {"filter": "x"}},
    {"match_all": {}},
    {"match_all": None},
    {"exists": {"field": "f"}},
    {"exists": {}},
    {"ids": {"values": [1, "b"]}},
    {"ids": 3},
    {"nested": {"path": "p", "query": {"match_all": {}},
                "score_mode": "max"}},
    {"nested": {"path": "p", "query": {"match_all": {}},
                "score_mode": "median"}},
    {"constant_score": {"filter": {"term": {"a": "b"}}, "boost": 3}},
    {"constant_score": {"query": {}}},
    {"multi_match": {"query": "a", "fields": ["t^2", "b"],
                     "type": "most_fields"}},
    {"multi_match": {"query": "a", "fields": ["t"], "type": "phrase"}},
    {"multi_match": {"query": "a"}},
    {"prefix": {"f": {"value": "ab"}}},
    {"wildcard": {"f": {"wildcard": "a*", "case_insensitive": True}}},
    {"wildcard": {"f": {"x": 1}}},
    {"fuzzy": {"f": {"value": "ab", "fuzziness": "1"}}},
    {"fuzzy": {"f": {"value": "ab", "fuzziness": 3}}},
    {"function_score": {"query": {"match_all": {}},
                        "functions": [{"weight": 2},
                                      {"field_value_factor": {
                                          "field": "n",
                                          "modifier": "log1p"}}],
                        "score_mode": "sum"}},
    {"function_score": {"functions": [{"field_value_factor": {
        "field": "n", "modifier": "cube"}}]}},
    {"function_score": {"functions": [{"filter": {"match_all": {}}}]}},
    {"function_score": {"boost_mode": "replace", "weight": 3}},
    {"function_score": {"functions": [{"script_score": {
        "script": {"source": "1", "lang": "lua"}}}]}},
    {"script_score": {"query": {"match_all": {}}, "min_score": 1}},
    {"script_score": {"query": {"match_all": {}},
                      "script": {"id": "stored"}}},
    {"rank_feature": {"field": "r", "sigmoid": {"pivot": 1,
                                                "exponent": 2}}},
    {"rank_feature": {"field": "r", "log": {}, "linear": {}}},
    {"rank_feature": {"field": "r", "saturation": {"pivot": 5}}},
    {"geo_distance": GEO},
    {"geo_distance": {"distance": "12 parsecs", "loc": "1,2"}},
    {"geo_distance": {"distance": "1km", "loc": "u4pruydqqvj"}},
    {"geo_distance": {"distance": "1km", "loc": [200, 1]}},
    {"geo_distance": {"distance": "1km", "loc": "1,2", "other": "3,4"}},
    {"geo_bounding_box": {"loc": {"top_left": {"lat": 10, "lon": 0},
                                  "bottom_right": {"lat": 0,
                                                   "lon": 10}}}},
    {"geo_bounding_box": {"loc": {"top": 0, "left": 0, "bottom": 10,
                                  "right": 1}}},
    {"geo_bounding_box": {"loc": {"top_left": "a"}}},
    {"percolate": {"field": "q", "document": {"a": 1}}},
    {"percolate": {"field": "q", "documents": []}},
    {"no_such_query": {}},
    [],
]


def outcome(module, body):
    try:
        q = module.parse_query(body)
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        return ("error", type(e).__name__, str(e))
    return ("node", type(q).__name__, node_fields(q))


def node_fields(q):
    """A parsed node's fields; a script is compared by its source, params
    and lang (the port keeps it unparsed)."""
    if not dataclasses.is_dataclass(q):
        if hasattr(q, "source") and hasattr(q, "params"):
            return ("script", q.source, q.params, q.lang)
        return q
    out = {}
    for f in dataclasses.fields(q):
        v = getattr(q, f.name)
        if isinstance(v, list):
            v = [node_fields(x) for x in v]
        elif dataclasses.is_dataclass(v) or hasattr(v, "params"):
            v = node_fields(v)
        out[f.name] = v
    return (type(q).__name__, out)


@pytest.mark.parametrize("body", BODIES,
                         ids=[f"q{i}" for i in range(len(BODIES))])
def test_parse_matches_reference(body):
    assert outcome(dsl, body) == outcome(ref_dsl, body)


def test_every_reference_query_type_has_a_parser():
    assert sorted(dsl._PARSERS) == sorted(ref_dsl._PARSERS)
    assert len(dsl._PARSERS) == 21
