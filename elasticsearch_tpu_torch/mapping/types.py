"""Field types: ``text`` and ``keyword``.

Copy of the reference's ``mapping/types.py`` for the two string types the
slice serves. A field type turns a source value into index terms (with
the token count that becomes the BM25 norm) and, for ``keyword``, an
ordinal doc value. Every other type of the reference (numbers, dates,
booleans, ip, ranges, geo, vectors, ...) is refused by ``field_type_for``
with the reference's ``mapper_parsing_exception`` naming the type; those
come with later slices of the port.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

from elasticsearch_tpu_torch.analysis import (ANALYZERS, KeywordAnalyzer,
                                              StandardAnalyzer)
from elasticsearch_tpu_torch.common.errors import MapperParsingException

#: the types the reference maps and the port does not yet
UNPORTED_TYPES = frozenset({
    "long", "integer", "short", "byte", "double", "float", "half_float",
    "scaled_float", "unsigned_long", "date", "boolean", "ip",
    "integer_range", "long_range", "float_range", "double_range",
    "date_range", "ip_range", "completion", "dense_vector",
    "rank_feature", "percolator", "geo_point", "nested"})


class FieldType:
    """Base field type. ``type_name`` matches the mapping JSON ``type``."""

    type_name = "base"
    has_doc_values = True
    is_indexed = True

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

    def to_mapping(self) -> dict:
        out = {"type": self.type_name}
        out.update(self.params)
        return out


class TextFieldType(FieldType):
    type_name = "text"
    has_doc_values = False  # like the reference: no doc_values on text

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
    if t in UNPORTED_TYPES:
        raise MapperParsingException(
            f"field [{name}] of type [{t}]: the port maps [text] and "
            f"[keyword] fields so far")
    raise MapperParsingException(f"no handler for type [{t}] declared on field [{name}]")
