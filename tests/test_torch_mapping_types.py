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
