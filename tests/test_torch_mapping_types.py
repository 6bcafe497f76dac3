"""The port's number, date and boolean field types and its dynamic
mapping against the JAX package's.

Port copies of the number, date, boolean and dynamic-mapping cases of
``test_analysis_mapping.py``, each run through both packages: the same
parsed documents (postings terms, field lengths, positions, doc
values), the same mappings, and the same errors (type and text).
"""

import pytest

from elasticsearch_tpu.common.errors import EsException as RefEsException
from elasticsearch_tpu.common.settings import Settings as RefSettings
from elasticsearch_tpu.mapping import MapperService as RefMapper
from elasticsearch_tpu.mapping import parse_date_millis as ref_parse_date
from elasticsearch_tpu.mapping.types import field_type_for as ref_ft_for

from elasticsearch_tpu_torch.common.errors import (EsException,
                                                   MapperParsingException)
from elasticsearch_tpu_torch.mapping import (MapperService,
                                             parse_date_millis)
from elasticsearch_tpu_torch.mapping.types import field_type_for


def outcome(fn, *args):
    """fn(*args) → ("ok", value) or ("error", wire type, text)."""
    try:
        return ("ok", fn(*args))
    except (EsException, RefEsException) as e:
        return ("error", e.error_type, str(e))


@pytest.mark.parametrize("value", [
    1700000000000, "1700000000000", "-86400000", 12.7,
    "1970-01-01T00:00:00Z", "1970-01-02", "1970-01-01T01:00:00+01:00",
    "2024-05-05T10:00:00.123Z", "2021-03-04 05:06", "not a date", True])
def test_parse_date_millis_matches_jax(value):
    assert outcome(parse_date_millis, value) == \
        outcome(ref_parse_date, value)


def test_dates_as_the_reference_tests_them():
    assert parse_date_millis(1700000000000) == 1700000000000
    assert parse_date_millis("1970-01-01T00:00:00Z") == 0
    assert parse_date_millis("1970-01-02") == 86400000
    assert parse_date_millis("1970-01-01T01:00:00+01:00") == 0
    with pytest.raises(MapperParsingException):
        parse_date_millis("not a date")


TYPES = ["long", "integer", "short", "byte", "double", "float",
         "half_float", "date", "boolean", "scaled_float", "unsigned_long"]
VALUES = [7, -3, 2.5, 4.0, "12", "1.25", "x", True, False, "true",
          "false", "", None, "2024-01-01", 1e20]


@pytest.mark.parametrize("type_name", TYPES)
def test_field_type_methods_match_jax(type_name):
    """Every value through index_terms, doc_value, normalize_term and
    normalize_range_bound of both packages' field type: the same result
    or the same error (a type the reference does not map: the same
    mapper_parsing_exception)."""
    mapping = {"type": type_name}
    got_ft = outcome(field_type_for, "f", mapping)
    want_ft = outcome(ref_ft_for, "f", mapping)
    assert got_ft[0] == want_ft[0]
    if got_ft[0] == "error":
        assert got_ft == want_ft
        return
    ft, rft = got_ft[1], want_ft[1]
    assert (ft.type_name, ft.dv_kind, ft.has_doc_values, ft.is_indexed) \
        == (rft.type_name, rft.dv_kind, rft.has_doc_values, rft.is_indexed)
    assert ft.to_mapping() == rft.to_mapping()
    for method in ("index_terms", "doc_value", "normalize_term",
                   "normalize_range_bound"):
        for v in VALUES:
            assert outcome(getattr(ft, method), v) == \
                outcome(getattr(rft, method), v), (method, v)


def both(mapping=None):
    return MapperService(mapping), RefMapper(RefSettings.EMPTY, mapping)


def assert_same_parse(ms, rms, doc_id, source):
    got = outcome(ms.parse_document, doc_id, source)
    want = outcome(rms.parse_document, doc_id, source)
    assert got[0] == want[0]
    if got[0] == "error":
        assert got == want
        return None
    g, w = got[1], want[1]
    assert g.postings_terms == w.postings_terms
    assert g.field_lengths == w.field_lengths
    assert g.doc_values == w.doc_values
    assert g.positions == w.positions
    assert ms.to_mapping() == rms.to_mapping()
    return g


DOCUMENTS = {
    "explicit": ({"properties": {
        "title": {"type": "text"}, "tags": {"type": "keyword"},
        "views": {"type": "long"}, "published": {"type": "date"},
        "active": {"type": "boolean"}, "price": {"type": "double"}}},
        {"title": "Hello World hello", "tags": ["a", "b"], "views": 42,
         "published": "2024-01-01", "active": True, "price": 3}),
    "dynamic_string": (None, {"name": "Alice Smith"}),
    "dynamic_numbers_bools_dates": (None, {
        "n": 3, "f": 1.5, "b": False, "d": "2024-05-05T10:00:00Z",
        "s": "2024-13-99 is not a date"}),
    "objects_flatten": (None, {"user": {"name": "bob", "age": 7,
                                        "tags": {"x": True}}}),
    "arrays": (None, {"ns": [1, 2, 3], "ds": ["2020-01-01", "2021-01-01"],
                      "bs": [True, False], "t": ["one two", "three"]}),
    "array_of_objects": (None, {"o": [{"a": 1}, {"a": 2, "b": "x"}]}),
    "nulls": (None, {"n": None, "m": [None, 4]}),
    "long_rejects_text": ({"properties": {"n": {"type": "long"}}},
                          {"n": "not-a-number"}),
    "long_rejects_fraction": ({"properties": {"n": {"type": "long"}}},
                              {"n": 2.5}),
    "long_rejects_bool": ({"properties": {"n": {"type": "integer"}}},
                          {"n": True}),
    "boolean_rejects_text": ({"properties": {"b": {"type": "boolean"}}},
                             {"b": "yes"}),
    "date_rejects_text": ({"properties": {"d": {"type": "date"}}},
                          {"d": "soon"}),
    "metadata_field": (None, {"_id": "nope"}),
    "strict": ({"dynamic": "strict",
                "properties": {"a": {"type": "keyword"}}}, {"b": "nope"}),
    "dynamic_false": ({"dynamic": "false",
                       "properties": {"a": {"type": "keyword"}}},
                      {"a": "x", "b": 5}),
}


@pytest.mark.parametrize("name", sorted(DOCUMENTS))
def test_parse_document_matches_jax(name):
    mapping, source = DOCUMENTS[name]
    ms, rms = both(mapping)
    assert_same_parse(ms, rms, "1", source)


def test_dynamic_types_as_the_reference_tests_them():
    ms, rms = both()
    assert_same_parse(ms, rms, "1", {"n": 3, "f": 1.5, "b": False,
                                     "d": "2024-05-05T10:00:00Z"})
    assert [ms.field_type(f).type_name for f in "nfbd"] == \
        ["long", "double", "boolean", "date"]
    doc = assert_same_parse(ms, rms, "2", {"user": {"name": "bob",
                                                    "age": 7}})
    assert ms.field_type("user.name").type_name == "text"
    assert doc.doc_values["user.age"] == 7


def test_dynamic_field_then_conflicting_value_matches_jax():
    """A field mapped long by one document refuses a string in the next,
    with the reference's error."""
    ms, rms = both()
    assert_same_parse(ms, rms, "1", {"n": 5})
    assert_same_parse(ms, rms, "2", {"n": "five"})
    assert_same_parse(ms, rms, "3", {"n": "6"})


def test_array_text_position_gap():
    ms, rms = both({"properties": {"t": {"type": "text"}}})
    doc = assert_same_parse(ms, rms, "1", {"t": ["one two", "three"]})
    positions = dict(doc.positions["t"])
    assert positions == {"one": 0, "two": 1, "three": 102}


@pytest.mark.parametrize("old,new", [("keyword", "long"), ("long", "date"),
                                     ("boolean", "long"),
                                     ("double", "double")])
def test_merge_type_conflicts_match_jax(old, new):
    ms, rms = both({"properties": {"a": {"type": old}}})
    update = {"properties": {"a": {"type": new}}}
    assert outcome(ms.merge, update) == outcome(rms.merge, update)
    assert ms.to_mapping() == rms.to_mapping()


def test_dv_kinds_match_jax():
    mapping = DOCUMENTS["explicit"][0]
    ms, rms = both(mapping)
    assert ms.dv_kinds() == rms.dv_kinds()


# ---- the analyzers and the registry (test_analysis_mapping.py) ----

from elasticsearch_tpu.analysis import AnalysisRegistry as RefRegistry  # noqa: E402
from elasticsearch_tpu.analysis import analyzers as ref_an  # noqa: E402

from elasticsearch_tpu_torch.analysis import (  # noqa: E402
    AnalysisRegistry, KeywordAnalyzer, SimpleAnalyzer, StandardAnalyzer,
    StopAnalyzer, WhitespaceAnalyzer)
from elasticsearch_tpu_torch.common.settings import Settings  # noqa: E402

ANALYZER_TEXTS = ["The Quick-Brown FOX, jumped!", "O'Neil's 3.5 visits",
                  "abc123def 45", "Foo  BAR", "New York", "the quick fox",
                  "under_score __x__ ÉCOLE Straße", "a" * 300, ""]


@pytest.mark.parametrize("name", ["standard", "simple", "whitespace",
                                  "keyword", "stop"])
def test_builtin_analyzers_match_jax(name):
    port = {"standard": StandardAnalyzer, "simple": SimpleAnalyzer,
            "whitespace": WhitespaceAnalyzer, "keyword": KeywordAnalyzer,
            "stop": StopAnalyzer}[name]()
    ref = RefRegistry.BUILTIN[name]()
    for text in ANALYZER_TEXTS:
        assert port.terms(text) == ref.terms(text), text
        assert port.analyze_slots(text) == ref.analyze_slots(text), text


def test_analyzers_as_the_reference_tests_them():
    assert StandardAnalyzer().terms("The Quick-Brown FOX, jumped!") == [
        "the", "quick", "brown", "fox", "jumped"]
    assert StandardAnalyzer().terms("O'Neil's 3.5 visits") == \
        ["o'neil's", "3.5", "visits"]
    assert SimpleAnalyzer().terms("abc123def 45") == ["abc", "def"]
    assert WhitespaceAnalyzer().terms("Foo  BAR") == ["Foo", "BAR"]
    assert KeywordAnalyzer().terms("New York") == ["New York"]
    tokens = StopAnalyzer().analyze("the quick fox")
    assert [(t.term, t.position) for t in tokens] == \
        [("quick", 1), ("fox", 2)]
    assert StandardAnalyzer(max_token_length=5).terms("abcdefghij") == \
        ["abcde", "fghij"]


REGISTRY_SETTINGS = {
    "custom_whitespace_stop": {
        "index.analysis.analyzer.my.type": "custom",
        "index.analysis.analyzer.my.tokenizer": "whitespace",
        "index.analysis.analyzer.my.filter": ["lowercase", "stop"]},
    "standard_stopwords": {
        "index.analysis.analyzer.eng.type": "standard",
        "index.analysis.analyzer.eng.stopwords": "_english_"},
    "filter_string_and_lowercase_tokenizer": {
        "index.analysis.analyzer.a.tokenizer": "lowercase",
        "index.analysis.analyzer.a.filter": "asciifolding, porter_stem"},
    "custom_filters_and_tokenizers": {
        "index.analysis.filter.len.type": "length",
        "index.analysis.filter.len.min": 3,
        "index.analysis.filter.st.type": "stop",
        "index.analysis.filter.st.stopwords": ["quick", "fox"],
        "index.analysis.filter.stem.type": "stemmer",
        "index.analysis.filter.sh.type": "shingle",
        "index.analysis.filter.sh.output_unigrams": "false",
        "index.analysis.tokenizer.ng.type": "edge_ngram",
        "index.analysis.tokenizer.ng.max_gram": 4,
        "index.analysis.analyzer.x.tokenizer": "standard",
        "index.analysis.analyzer.x.filter": ["lowercase", "st", "len",
                                             "stem", "sh"],
        "index.analysis.analyzer.y.tokenizer": "ng",
        "index.analysis.analyzer.y.filter": ["lowercase"],
        "index.analysis.analyzer.z.type": "whitespace"},
    "unknown_filter": {
        "index.analysis.analyzer.a.filter": ["nosuch"]},
    "unknown_tokenizer": {
        "index.analysis.analyzer.a.tokenizer": "nosuch"},
    "unknown_type": {"index.analysis.analyzer.a.type": "fancy"},
    "filter_without_type": {"index.analysis.filter.f.min": 2},
}


@pytest.mark.parametrize("name", sorted(REGISTRY_SETTINGS))
def test_registry_builds_as_jax(name):
    """AnalysisRegistry.build over the same index settings: the same
    analyzers, or the same error."""
    flat = REGISTRY_SETTINGS[name]
    got = outcome(AnalysisRegistry().build, Settings(flat))
    want = outcome(RefRegistry().build, RefSettings(flat))
    assert got[0] == want[0]
    if got[0] == "error":
        assert got == want
        return
    assert sorted(got[1]) == sorted(want[1])
    for an in sorted(want[1]):
        for text in ANALYZER_TEXTS + ["The quick brown foxes jumped over"]:
            assert got[1][an].analyze_slots(text) == \
                want[1][an].analyze_slots(text), (an, text)


def test_registry_as_the_reference_tests_it():
    analyzers = AnalysisRegistry().build(Settings.of(
        REGISTRY_SETTINGS["custom_whitespace_stop"]))
    assert analyzers["my"].terms("The Quick FOX") == ["quick", "fox"]
    assert "standard" in analyzers
    analyzers = AnalysisRegistry().build(Settings.of(
        REGISTRY_SETTINGS["standard_stopwords"]))
    assert analyzers["eng"].terms("the fox and hound") == ["fox", "hound"]


def test_fast_tokenizer_only_for_the_reference_chains():
    """The C tokenizer serves a standard analyzer without stop words and
    nothing else: the mapper's flat path is taken for exactly those
    fields, as the reference's is."""
    settings = {"index.analysis.analyzer.eng.type": "standard",
                "index.analysis.analyzer.eng.stopwords": "_english_",
                "index.analysis.analyzer.c.tokenizer": "standard",
                "index.analysis.analyzer.c.filter": ["lowercase"]}
    mapping = {"properties": {
        "plain": {"type": "text"},
        "eng": {"type": "text", "analyzer": "eng"},
        "c": {"type": "text", "analyzer": "c"},
        "ws": {"type": "text", "analyzer": "whitespace"}}}
    ms = MapperService(mapping, Settings(settings))
    rms = RefMapper(RefSettings(settings), mapping)
    assert sorted(ms.mapper.fast_text_fields) == \
        sorted(rms.mapper.fast_text_fields) == ["plain"]
    assert ms.analyzers["eng"]._has_stop
    assert ref_an.StandardAnalyzer()._has_stop is False
    assert_same_parse(ms, rms, "1", {"plain": "The Fox", "eng": "the fox",
                                     "c": "The Fox", "ws": "The Fox"})


# ---- the rarer field types ----

RARE_TYPES = {
    "ip": {"type": "ip"},
    "integer_range": {"type": "integer_range"},
    "long_range": {"type": "long_range"},
    "float_range": {"type": "float_range"},
    "double_range": {"type": "double_range"},
    "date_range": {"type": "date_range"},
    "completion": {"type": "completion"},
    "rank_feature": {"type": "rank_feature"},
    "rank_feature_negative": {"type": "rank_feature",
                              "positive_score_impact": False},
    "geo_point": {"type": "geo_point"},
    "percolator": {"type": "percolator"},
    "dense_vector": {"type": "dense_vector", "dims": 3},
    "dense_vector_dot": {"type": "dense_vector", "dims": 2,
                         "similarity": "dot_product"},
    "dense_vector_no_dims": {"type": "dense_vector"},
    "dense_vector_bad_dims": {"type": "dense_vector", "dims": 5000},
    "dense_vector_bad_similarity": {"type": "dense_vector", "dims": 2,
                                    "similarity": "hamming"},
    "ip_range": {"type": "ip_range"},
}
RARE_VALUES = [7, -3, 2.5, "12", "10.0.0.1", "::ffff:1.2.3.4", "2001:db8::1",
               "10.0.0.0/8", "bad ip", {"gte": 1, "lte": 5}, {"gt": 1.5},
               {"lt": "2024-01-01"}, {"gte": 1, "nope": 2}, [1.0, 2.0, 3.0],
               [2.0, 1.0], {"lat": 1.5, "lon": 2.5}, "1.5,2.5", "u4pru",
               {"input": ["a", "b"], "weight": 3}, {"match": {"t": "x"}},
               {"bogus": {}}, True, None, 0, 1e-45]


@pytest.mark.parametrize("name", sorted(RARE_TYPES))
def test_rare_field_type_methods_match_jax(name):
    """Every value through the rarer types' methods of both packages:
    the same result or the same error."""
    mapping = RARE_TYPES[name]
    got_ft = outcome(field_type_for, "f", mapping)
    want_ft = outcome(ref_ft_for, "f", mapping)
    assert got_ft[0] == want_ft[0]
    if got_ft[0] == "error":
        assert got_ft == want_ft
        return
    ft, rft = got_ft[1], want_ft[1]
    assert (ft.type_name, ft.dv_kind, ft.has_doc_values, ft.is_indexed) \
        == (rft.type_name, rft.dv_kind, rft.has_doc_values, rft.is_indexed)
    assert ft.to_mapping() == rft.to_mapping()
    methods = ["index_terms", "doc_value", "normalize_term",
               "normalize_range_bound"]
    for extra in ("parse_ip", "canonical", "parse_range", "parse_bound",
                  "parse_point", "parse_inputs", "parse_vector"):
        if hasattr(rft, extra):
            methods.append(extra)
    for method in methods:
        for v in RARE_VALUES:
            try:
                g = outcome(getattr(ft, method), v)
            except Exception as e:  # noqa: BLE001 — a plain error
                g = ("raise", type(e).__name__, str(e))
            try:
                w = outcome(getattr(rft, method), v)
            except Exception as e:  # noqa: BLE001
                w = ("raise", type(e).__name__, str(e))
            assert g == w, (method, v)


RARE_MAPPING = {"properties": {
    "addr": {"type": "ip"}, "span": {"type": "integer_range"},
    "when": {"type": "date_range"}, "band": {"type": "double_range"},
    "sugg": {"type": "completion"}, "pr": {"type": "rank_feature"},
    "loc": {"type": "geo_point"}, "q": {"type": "percolator"},
    "vec": {"type": "dense_vector", "dims": 3},
    "title": {"type": "text"},
    "kids": {"type": "nested", "properties": {
        "name": {"type": "keyword"}, "age": {"type": "long"},
        "pets": {"type": "nested", "properties": {
            "kind": {"type": "keyword"}}}}},
}}

RARE_DOCUMENTS = {
    "all": {"addr": "::ffff:10.0.0.1", "span": {"gte": 1, "lt": 9},
            "when": {"gte": "2024-01-01"}, "band": {"gt": 0.5, "lte": 2},
            "sugg": {"input": ["Nirvana", "Nevermind"], "weight": 34},
            "pr": 3.5, "loc": [13.4, 52.5], "q": {"match": {"title": "x"}},
            "vec": [1, 2.5, -3], "title": "hello",
            "kids": [{"name": "a", "age": 3, "pets": [{"kind": "cat"}]},
                     {"name": "b", "age": None, "extra": {"x": 1}}]},
    "arrays": {"addr": ["1.2.3.4", "::1"], "loc": [[1, 2], "3,4"],
               "span": [{"gte": 1, "lte": 2}, {"gte": 5, "lte": 6}],
               "sugg": ["one", "two"], "kids": {"name": "solo"}},
    "bad_ip": {"addr": "300.1.1.1"},
    "bad_range_key": {"span": {"from": 1}},
    "bad_range_value": {"span": 5},
    "bad_point": {"loc": {"lat": 100, "lon": 0}},
    "bad_geohash": {"loc": "u4pr!"},
    "bad_feature": {"pr": -2.0},
    "bad_query": {"q": {"nosuch": {}}},
    "query_array": {"q": [{"match_all": {}}]},
    "bad_vector_dims": {"vec": [1, 2]},
    "bad_vector_entry": {"vec": [1, "x", 3]},
    "bad_completion": {"sugg": {"weight": 3}},
    "nested_not_object": {"kids": ["x"]},
    "nested_null": {"kids": None, "title": "t"},
}


@pytest.mark.parametrize("name", sorted(RARE_DOCUMENTS))
def test_rare_documents_parse_as_jax(name):
    ms, rms = both(RARE_MAPPING)
    doc = assert_same_parse(ms, rms, "1", RARE_DOCUMENTS[name])
    if doc is not None:
        want = rms.parse_document("1", RARE_DOCUMENTS[name])
        assert doc.nested == want.nested
    assert ms.dv_kinds() == rms.dv_kinds()
    assert sorted(ms.mapper.nested_roots) == ["kids", "kids.pets"]
