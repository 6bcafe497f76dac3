"""Field types: ``text``, ``keyword``, the numbers, ``date`` and
``boolean``.

Copy of the reference's ``mapping/types.py`` for the types the port
maps. A field type turns a source value into index terms (with the token
count that becomes the BM25 norm) and a doc value: an ordinal for
``keyword``, an i64 for the integer types, dates (epoch millis) and
booleans, an f64 for the floating types. On the query side
``normalize_term`` gives a term query's index term and
``normalize_range_bound`` a range bound's comparable value. The rarer
types of the reference (ip, the ranges, geo_point, rank_feature,
completion, percolator, dense_vector, nested) are refused by
``field_type_for`` with a ``mapper_parsing_exception`` naming the type;
they come with a later slice of the port.
"""

from __future__ import annotations

import datetime
from typing import Any, List, Optional, Tuple

from elasticsearch_tpu_torch.analysis import (ANALYZERS, KeywordAnalyzer,
                                              StandardAnalyzer)
from elasticsearch_tpu_torch.common.errors import (IllegalArgumentException,
                                                   MapperParsingException)

#: the types the reference maps and the port does not yet
UNPORTED_TYPES = frozenset({
    "ip", "integer_range", "long_range", "float_range", "double_range",
    "date_range", "ip_range", "completion", "dense_vector",
    "rank_feature", "percolator", "geo_point", "nested"})


def parse_date_millis(value: Any) -> int:
    """The default ``strict_date_optional_time||epoch_millis`` format."""
    if isinstance(value, bool):
        raise MapperParsingException(f"failed to parse date [{value!r}]")
    if isinstance(value, (int, float)):
        return int(value)
    s = str(value)
    if s.isdigit() or (s.startswith("-") and s[1:].isdigit()):
        return int(s)
    try:
        dt = datetime.datetime.fromisoformat(s.replace("Z", "+00:00"))
    except ValueError:
        try:
            dt = datetime.datetime.strptime(s, "%Y-%m-%d")
        except ValueError as e:
            raise MapperParsingException(
                f"failed to parse date [{value!r}]") from e
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=datetime.timezone.utc)
    return int(dt.timestamp() * 1000)


class FieldType:
    """Base field type. ``type_name`` matches the mapping JSON ``type``."""

    type_name = "base"
    has_doc_values = True
    is_indexed = True
    #: the doc-value column: "i64", "f64", "ord" (keyword ordinals) or
    #: "none"
    dv_kind = "i64"

    def __init__(self, name: str, params: Optional[dict] = None):
        self.name = name
        self.params = dict(params or {})
        if self.params.get("index") is False:
            self.is_indexed = False
        if self.params.get("doc_values") is False:
            self.has_doc_values = False

    def index_terms(self, value: Any) -> Tuple[List[str], int]:
        """→ (terms for postings, token count for norms)."""
        raise NotImplementedError

    def doc_value(self, value: Any):
        raise NotImplementedError

    def normalize_term(self, value: Any) -> str:
        raise NotImplementedError

    def normalize_range_bound(self, value: Any):
        raise IllegalArgumentException(
            f"field [{self.name}] of type [{self.type_name}] does not "
            f"support range queries")

    def to_mapping(self) -> dict:
        out = {"type": self.type_name}
        out.update(self.params)
        return out


class TextFieldType(FieldType):
    type_name = "text"
    has_doc_values = False  # like the reference: no doc_values on text
    dv_kind = "none"

    def __init__(self, name: str, params: Optional[dict] = None,
                 analyzer=None, search_analyzer=None):
        super().__init__(name, params)
        self.analyzer = analyzer or StandardAnalyzer()
        self.search_analyzer = search_analyzer or self.analyzer

    def index_terms(self, value: Any) -> Tuple[List[str], int]:
        terms = self.analyzer.terms(str(value))
        return terms, len(terms)

    def doc_value(self, value: Any):
        raise MapperParsingException(f"text field [{self.name}] has no doc_values")

    def normalize_term(self, value: Any) -> str:
        terms = self.search_analyzer.terms(str(value))
        return terms[0] if terms else ""

    def search_terms(self, value: Any) -> List[str]:
        return self.search_analyzer.terms(str(value))


class KeywordFieldType(FieldType):
    type_name = "keyword"
    dv_kind = "ord"

    def __init__(self, name: str, params: Optional[dict] = None):
        super().__init__(name, params)
        self.ignore_above = int(self.params.get("ignore_above", 2**31 - 1))
        self._analyzer = KeywordAnalyzer()

    def _norm(self, value: Any) -> str:
        if isinstance(value, bool):
            return "true" if value else "false"
        return str(value)

    def index_terms(self, value: Any) -> Tuple[List[str], int]:
        s = self._norm(value)
        if len(s) > self.ignore_above:
            return [], 0
        return [s], 1

    def doc_value(self, value: Any) -> str:
        return self._norm(value)

    def normalize_term(self, value: Any) -> str:
        return self._norm(value)


class NumberFieldType(FieldType):
    """long/integer/short/byte (an i64 column) and double/float/
    half_float (f64). Term and range queries compare numerically; the
    index term is the value's ``repr``."""

    INT_TYPES = {"long", "integer", "short", "byte"}
    FLOAT_TYPES = {"double", "float", "half_float"}

    def __init__(self, name: str, num_type: str,
                 params: Optional[dict] = None):
        if num_type not in self.INT_TYPES | self.FLOAT_TYPES:
            raise IllegalArgumentException(
                f"unknown number type [{num_type}]")
        self.type_name = num_type
        self.dv_kind = "i64" if num_type in self.INT_TYPES else "f64"
        super().__init__(name, params)

    def _parse(self, value: Any):
        if isinstance(value, bool):
            raise MapperParsingException(
                f"failed to parse field [{self.name}] of type "
                f"[{self.type_name}]: boolean")
        try:
            if self.dv_kind == "i64":
                f = float(value)
                i = int(f)
                if f != i:
                    raise ValueError(f"{value} is not an integer")
                return i
            return float(value)
        except (TypeError, ValueError) as e:
            raise MapperParsingException(
                f"failed to parse field [{self.name}] of type "
                f"[{self.type_name}]: {value!r}") from e

    def index_terms(self, value: Any) -> Tuple[List[str], int]:
        return [repr(self._parse(value))], 1

    def doc_value(self, value: Any):
        return self._parse(value)

    def normalize_term(self, value: Any) -> str:
        return repr(self._parse(value))

    def normalize_range_bound(self, value: Any):
        return self._parse(value)


class DateFieldType(FieldType):
    """Epoch millis in an i64 column."""

    type_name = "date"
    dv_kind = "i64"

    def index_terms(self, value: Any) -> Tuple[List[str], int]:
        return [repr(parse_date_millis(value))], 1

    def doc_value(self, value: Any) -> int:
        return parse_date_millis(value)

    def normalize_term(self, value: Any) -> str:
        return repr(parse_date_millis(value))

    def normalize_range_bound(self, value: Any) -> int:
        return parse_date_millis(value)


class BooleanFieldType(FieldType):
    """Index terms "T"/"F"; 1/0 in an i64 column."""

    type_name = "boolean"
    dv_kind = "i64"

    def _parse(self, value: Any) -> bool:
        if isinstance(value, bool):
            return value
        s = str(value).lower()
        if s == "true":
            return True
        if s in ("false", ""):
            return False
        raise MapperParsingException(
            f"failed to parse boolean [{value!r}] for [{self.name}]")

    def index_terms(self, value: Any) -> Tuple[List[str], int]:
        return ["T" if self._parse(value) else "F"], 1

    def doc_value(self, value: Any) -> int:
        return 1 if self._parse(value) else 0

    def normalize_term(self, value: Any) -> str:
        return "T" if self._parse(value) else "F"

    def normalize_range_bound(self, value: Any) -> int:
        return 1 if self._parse(value) else 0


def _analyzer(name: str, field: str):
    an = ANALYZERS.get(name)
    if an is None:
        raise MapperParsingException(
            f"analyzer [{name}] on field [{field}] is not ported yet: the "
            f"port has the [standard] and [keyword] analyzers")
    return an


def field_type_for(name: str, mapping: dict, analyzers=None) -> FieldType:
    """Build a FieldType from one field's mapping JSON."""
    t = mapping.get("type")
    params = {k: v for k, v in mapping.items() if k not in ("type", "fields")}
    if t == "text":
        an = _analyzer(mapping.get("analyzer", "standard"), name)
        san = _analyzer(mapping.get("search_analyzer",
                                    mapping.get("analyzer", "standard")),
                        name)
        return TextFieldType(name, params, analyzer=an, search_analyzer=san)
    if t == "keyword":
        return KeywordFieldType(name, params)
    if t in NumberFieldType.INT_TYPES | NumberFieldType.FLOAT_TYPES:
        return NumberFieldType(name, t, params)
    if t == "date":
        return DateFieldType(name, params)
    if t == "boolean":
        return BooleanFieldType(name, params)
    if t in UNPORTED_TYPES:
        raise MapperParsingException(
            f"field [{name}] of type [{t}]: the port maps [text], "
            f"[keyword], number, [date] and [boolean] fields so far")
    raise MapperParsingException(f"no handler for type [{t}] declared on field [{name}]")
