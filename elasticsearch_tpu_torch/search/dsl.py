"""Query DSL for the queries the slice lowers.

Counterpart of the reference's ``search/dsl.py`` for ``match``, ``term``,
``terms`` and ``bool`` (the node classes ``lower_query`` reads), with the
reference's JSON grammar. ``match_all`` and ``match_phrase`` parse too,
so that ``lower_query`` can reject them; any other query type raises
``NotLowerable`` (a valid query this slice does not serve), and a
malformed one ``ParsingException``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from elasticsearch_tpu_torch.errors import NotLowerable, ParsingException


@dataclasses.dataclass
class QueryNode:
    boost: float = 1.0

    def query_name(self) -> str:
        raise NotImplementedError


@dataclasses.dataclass
class MatchAllQuery(QueryNode):
    def query_name(self) -> str:
        return "match_all"


@dataclasses.dataclass
class MatchQuery(QueryNode):
    field: str = ""
    query: str = ""
    operator: str = "or"          # "or" | "and"
    minimum_should_match: Optional[int] = None

    def query_name(self) -> str:
        return "match"


@dataclasses.dataclass
class MatchPhraseQuery(QueryNode):
    field: str = ""
    query: str = ""
    slop: int = 0

    def query_name(self) -> str:
        return "match_phrase"


@dataclasses.dataclass
class TermQuery(QueryNode):
    field: str = ""
    value: Any = None

    def query_name(self) -> str:
        return "term"


@dataclasses.dataclass
class TermsQuery(QueryNode):
    field: str = ""
    values: List[Any] = dataclasses.field(default_factory=list)

    def query_name(self) -> str:
        return "terms"


@dataclasses.dataclass
class BoolQuery(QueryNode):
    must: List[QueryNode] = dataclasses.field(default_factory=list)
    should: List[QueryNode] = dataclasses.field(default_factory=list)
    must_not: List[QueryNode] = dataclasses.field(default_factory=list)
    filter: List[QueryNode] = dataclasses.field(default_factory=list)
    minimum_should_match: Optional[int] = None

    def query_name(self) -> str:
        return "bool"


def parse_query(obj: Dict[str, Any]) -> QueryNode:
    """One top-level key names the query."""
    if not isinstance(obj, dict):
        raise ParsingException(
            f"query must be an object, got {type(obj).__name__}")
    if len(obj) != 1:
        raise ParsingException(
            f"query object must have exactly one key, got {sorted(obj)}")
    name, body = next(iter(obj.items()))
    parser = _PARSERS.get(name)
    if parser is None:
        raise NotLowerable(
            f"query type [{name}] is not served by the device path")
    return parser(body)


def _field_and_params(name: str, body: Dict[str, Any], value_key: str):
    if not isinstance(body, dict) or len(body) != 1:
        raise ParsingException(f"[{name}] expects a single field")
    field, spec = next(iter(body.items()))
    if isinstance(spec, dict):
        if value_key not in spec:
            raise ParsingException(
                f"[{name}] on [{field}] requires [{value_key}]")
        return field, spec
    return field, {value_key: spec}


def _parse_match(body) -> MatchQuery:
    field, spec = _field_and_params("match", body, "query")
    op = str(spec.get("operator", "or")).lower()
    if op not in ("or", "and"):
        raise ParsingException(f"[match] unknown operator [{op}]")
    msm = spec.get("minimum_should_match")
    return MatchQuery(field=field, query=str(spec["query"]), operator=op,
                      minimum_should_match=None if msm is None else int(msm),
                      boost=float(spec.get("boost", 1.0)))


def _parse_match_phrase(body) -> MatchPhraseQuery:
    field, spec = _field_and_params("match_phrase", body, "query")
    return MatchPhraseQuery(field=field, query=str(spec["query"]),
                            slop=int(spec.get("slop", 0)),
                            boost=float(spec.get("boost", 1.0)))


def _parse_term(body) -> TermQuery:
    field, spec = _field_and_params("term", body, "value")
    return TermQuery(field=field, value=spec["value"],
                     boost=float(spec.get("boost", 1.0)))


def _parse_terms(body) -> TermsQuery:
    if not isinstance(body, dict):
        raise ParsingException("[terms] expects an object")
    boost = float(body.get("boost", 1.0))
    fields = {k: v for k, v in body.items() if k != "boost"}
    if len(fields) != 1:
        raise ParsingException("[terms] expects a single field")
    field, values = next(iter(fields.items()))
    if not isinstance(values, list):
        raise ParsingException(f"[terms] on [{field}] expects an array")
    return TermsQuery(field=field, values=values, boost=boost)


def _parse_bool(body) -> BoolQuery:
    if not isinstance(body, dict):
        raise ParsingException("[bool] expects an object")
    q = BoolQuery(boost=float(body.get("boost", 1.0)))
    for clause in ("must", "should", "must_not", "filter"):
        items = body.get(clause, [])
        if isinstance(items, dict):
            items = [items]
        if not isinstance(items, list):
            raise ParsingException(
                f"[bool] [{clause}] must be an array or object")
        setattr(q, clause, [parse_query(x) for x in items])
    msm = body.get("minimum_should_match")
    if msm is not None:
        q.minimum_should_match = int(msm)
    known = {"must", "should", "must_not", "filter", "minimum_should_match",
             "boost"}
    unknown = set(body) - known
    if unknown:
        raise ParsingException(f"[bool] unknown parameter {sorted(unknown)}")
    return q


def _parse_match_all(body) -> MatchAllQuery:
    body = body or {}
    return MatchAllQuery(boost=float(body.get("boost", 1.0)))


_PARSERS = {
    "match": _parse_match,
    "match_phrase": _parse_match_phrase,
    "term": _parse_term,
    "terms": _parse_terms,
    "bool": _parse_bool,
    "match_all": _parse_match_all,
}
