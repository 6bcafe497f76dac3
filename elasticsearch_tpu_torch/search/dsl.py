"""Query DSL: the JSON query AST.

Copy of the reference's ``search/dsl.py``: the same 21 parsers
(``_PARSERS``), node classes and ``ParsingException`` texts. A query the
grammar refuses is a ``parsing_exception``, an unknown query name
included; a well-formed query the kernel path does not serve is for
``lower_query`` (``search/gpu_service.py``) and the coordinator to refuse.

The geo queries parse their points with ``GeoPointFieldType.parse_point``
(``mapping/types.py``). ``script_score`` (the query, and the
``function_score`` function) compiles its script with the script module
at parse time, as the reference does: a script that does not compile is
a ``parsing_exception``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Tuple

from elasticsearch_tpu_torch.common.errors import ParsingException


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
class RangeQuery(QueryNode):
    field: str = ""
    gt: Any = None
    gte: Any = None
    lt: Any = None
    lte: Any = None
    # interval relation for RANGE FIELDS (reference: RangeFieldMapper);
    # ignored on plain numeric/date fields
    relation: Optional[str] = None

    def query_name(self) -> str:
        return "range"


@dataclasses.dataclass
class ExistsQuery(QueryNode):
    field: str = ""

    def query_name(self) -> str:
        return "exists"


@dataclasses.dataclass
class IdsQuery(QueryNode):
    values: List[str] = dataclasses.field(default_factory=list)

    def query_name(self) -> str:
        return "ids"


@dataclasses.dataclass
class MultiMatchQuery(QueryNode):
    """Reference: MultiMatchQueryBuilder — one text query over several
    fields with per-field boosts ("title^2")."""

    fields: List = dataclasses.field(default_factory=list)  # [(name, boost)]
    query: str = ""
    type: str = "best_fields"     # "best_fields" | "most_fields"
    operator: str = "or"
    minimum_should_match: Optional[int] = None
    tie_breaker: float = 0.0

    def query_name(self) -> str:
        return "multi_match"


@dataclasses.dataclass
class PrefixQuery(QueryNode):
    """Reference: PrefixQueryBuilder (constant-score rewrite)."""

    field: str = ""
    value: str = ""

    def query_name(self) -> str:
        return "prefix"


@dataclasses.dataclass
class WildcardQuery(QueryNode):
    """Reference: WildcardQueryBuilder — `*` any run, `?` one char
    (constant-score rewrite)."""

    field: str = ""
    value: str = ""
    case_insensitive: bool = False

    def query_name(self) -> str:
        return "wildcard"


@dataclasses.dataclass
class FuzzyQuery(QueryNode):
    """Reference: FuzzyQueryBuilder — terms within edit distance
    (Damerau-Levenshtein, transpositions count 1) of the value."""

    field: str = ""
    value: str = ""
    fuzziness: Any = "AUTO"       # "AUTO" | 0 | 1 | 2
    prefix_length: int = 0
    max_expansions: int = 50

    def query_name(self) -> str:
        return "fuzzy"


@dataclasses.dataclass
class ScoreFunction:
    """One entry of function_score.functions (reference:
    ScoreFunctionBuilder): optional filter + one scoring primitive."""

    filter_query: Optional[QueryNode] = None
    weight: Optional[float] = None
    field_value_factor: Optional[Dict[str, Any]] = None
    script_score: Optional[Any] = None  # CompiledScript


@dataclasses.dataclass
class ScriptScoreQuery(QueryNode):
    """{"script_score": {"query": ..., "script": ...}} — replace the
    base query's score with a script over doc values and `_score`
    (reference: ScriptScoreQueryBuilder; evaluated VECTORIZED here —
    one array program over all candidates, SURVEY.md §2.1#42)."""

    query: QueryNode = None  # type: ignore[assignment]
    script: Any = None       # CompiledScript
    min_score: Optional[float] = None

    def query_name(self) -> str:
        return "script_score"


@dataclasses.dataclass
class FunctionScoreQuery(QueryNode):
    """Reference: FunctionScoreQueryBuilder — combine the base query's
    score with per-doc function values."""

    query: QueryNode = None  # type: ignore[assignment]
    functions: List[ScoreFunction] = dataclasses.field(default_factory=list)
    score_mode: str = "multiply"  # multiply|sum|avg|max|min
    boost_mode: str = "multiply"  # multiply|sum|replace|avg|max|min
    max_boost: Optional[float] = None

    def query_name(self) -> str:
        return "function_score"


@dataclasses.dataclass
class RankFeatureQuery(QueryNode):
    """{"rank_feature": {"field": f, "saturation"|"log"|"sigmoid"|
    "linear": {...}}} — score docs by a stored feature value
    (reference: mapper-extras RankFeatureQueryBuilder; SURVEY.md
    §2.1#54). Default function: saturation with an index-derived
    pivot."""

    field: str = ""
    function: str = "saturation"   # saturation | log | sigmoid | linear
    pivot: Optional[float] = None  # saturation/sigmoid
    scaling_factor: Optional[float] = None  # log
    exponent: Optional[float] = None        # sigmoid

    def query_name(self) -> str:
        return "rank_feature"


@dataclasses.dataclass
class GeoDistanceQuery(QueryNode):
    """{"geo_distance": {"distance": "12km", "<field>": point}} —
    haversine radius filter on a geo_point column (reference:
    GeoDistanceQueryBuilder; SURVEY.md §2.1#55)."""

    field: str = ""
    lat: float = 0.0
    lon: float = 0.0
    distance_m: float = 0.0

    def query_name(self) -> str:
        return "geo_distance"


@dataclasses.dataclass
class GeoBoundingBoxQuery(QueryNode):
    """{"geo_bounding_box": {"<field>": {"top_left": ..,
    "bottom_right": ..}}} (reference: GeoBoundingBoxQueryBuilder)."""

    field: str = ""
    top: float = 0.0
    left: float = 0.0
    bottom: float = 0.0
    right: float = 0.0

    def query_name(self) -> str:
        return "geo_bounding_box"


@dataclasses.dataclass
class PercolateQuery(QueryNode):
    """{"percolate": {"field": f, "document": {...}}} — match the
    stored-query docs whose query matches the document(s) (reference:
    modules/percolator PercolateQueryBuilder; SURVEY.md §2.1#52)."""

    field: str = ""
    documents: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)

    def query_name(self) -> str:
        return "percolate"


@dataclasses.dataclass
class KnnScoreDocQuery(QueryNode):
    """The coordinator-rewritten form of a `knn` search clause
    (reference: KnnScoreDocQueryBuilder): the GLOBAL top-k winners of
    the candidate phase, pinned to exact (segment, ord, score) triples
    for ONE shard. Unioned with the text query: matching docs score
    query_score + Σ knn_score·boost (the reference's hybrid rule).
    Never parsed from JSON — built by search/knn.py."""

    query: Optional[QueryNode] = None
    # one {segment_name: (ords i64[], scores f32[])} map per knn clause
    doc_sets: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)
    boosts: List[float] = dataclasses.field(default_factory=list)

    def query_name(self) -> str:
        return "knn_score_doc"


@dataclasses.dataclass
class BoolQuery(QueryNode):
    must: List[QueryNode] = dataclasses.field(default_factory=list)
    should: List[QueryNode] = dataclasses.field(default_factory=list)
    must_not: List[QueryNode] = dataclasses.field(default_factory=list)
    filter: List[QueryNode] = dataclasses.field(default_factory=list)
    minimum_should_match: Optional[int] = None

    def query_name(self) -> str:
        return "bool"


@dataclasses.dataclass
class ConstantScoreQuery(QueryNode):
    filter_query: QueryNode = None  # type: ignore[assignment]

    def query_name(self) -> str:
        return "constant_score"


@dataclasses.dataclass
class NestedQuery(QueryNode):
    """{"nested": {"path": p, "query": {...}, "score_mode": m}} —
    per-OBJECT matching against a nested field's objects (reference:
    NestedQueryBuilder; SURVEY.md §2.1#29)."""

    path: str = ""
    query: QueryNode = None  # type: ignore[assignment]
    score_mode: str = "avg"  # avg | sum | min | max | none

    def query_name(self) -> str:
        return "nested"


def parse_query(obj: Dict[str, Any]) -> QueryNode:
    """The parseInnerQueryBuilder analog: one top-level key names the query."""
    if not isinstance(obj, dict):
        raise ParsingException(f"query must be an object, got {type(obj).__name__}")
    if len(obj) != 1:
        raise ParsingException(
            f"query object must have exactly one key, got {sorted(obj.keys())}")
    name, body = next(iter(obj.items()))
    parser = _PARSERS.get(name)
    if parser is None:
        raise ParsingException(f"unknown query type [{name}]")
    return parser(body)


def _field_and_params(name: str, body: Dict[str, Any], value_key: str):
    if not isinstance(body, dict) or len(body) != 1:
        raise ParsingException(f"[{name}] expects a single field")
    field, spec = next(iter(body.items()))
    if isinstance(spec, dict):
        if value_key not in spec:
            raise ParsingException(f"[{name}] on [{field}] requires [{value_key}]")
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


def _parse_range(body) -> RangeQuery:
    if not isinstance(body, dict) or len(body) != 1:
        raise ParsingException("[range] expects a single field")
    field, spec = next(iter(body.items()))
    if not isinstance(spec, dict):
        raise ParsingException(f"[range] on [{field}] expects an object")
    known = {"gt", "gte", "lt", "lte", "boost", "format", "time_zone",
             "relation"}
    unknown = set(spec) - known
    if unknown:
        raise ParsingException(f"[range] unknown parameter {sorted(unknown)}")
    relation = spec.get("relation")
    if relation is not None and str(relation).lower() not in (
            "intersects", "within", "contains"):
        raise ParsingException(f"[range] unknown relation [{relation}]")
    return RangeQuery(field=field, gt=spec.get("gt"), gte=spec.get("gte"),
                      lt=spec.get("lt"), lte=spec.get("lte"),
                      relation=None if relation is None
                      else str(relation).lower(),
                      boost=float(spec.get("boost", 1.0)))


def _parse_bool(body) -> BoolQuery:
    if not isinstance(body, dict):
        raise ParsingException("[bool] expects an object")
    q = BoolQuery(boost=float(body.get("boost", 1.0)))
    for clause in ("must", "should", "must_not", "filter"):
        items = body.get(clause, [])
        if isinstance(items, dict):
            items = [items]
        if not isinstance(items, list):
            raise ParsingException(f"[bool] [{clause}] must be an array or object")
        setattr(q, "filter" if clause == "filter" else clause,
                [parse_query(x) for x in items])
    msm = body.get("minimum_should_match")
    if msm is not None:
        q.minimum_should_match = int(msm)
    known = {"must", "should", "must_not", "filter", "minimum_should_match", "boost"}
    unknown = set(body) - known
    if unknown:
        raise ParsingException(f"[bool] unknown parameter {sorted(unknown)}")
    return q


def _parse_match_all(body) -> MatchAllQuery:
    body = body or {}
    return MatchAllQuery(boost=float(body.get("boost", 1.0)))


def _parse_exists(body) -> ExistsQuery:
    if not isinstance(body, dict) or "field" not in body:
        raise ParsingException("[exists] requires [field]")
    return ExistsQuery(field=str(body["field"]))


def _parse_ids(body) -> IdsQuery:
    if not isinstance(body, dict) or "values" not in body:
        raise ParsingException("[ids] requires [values]")
    return IdsQuery(values=[str(v) for v in body["values"]])


def _parse_constant_score(body) -> ConstantScoreQuery:
    if not isinstance(body, dict) or "filter" not in body:
        raise ParsingException("[constant_score] requires [filter]")
    return ConstantScoreQuery(filter_query=parse_query(body["filter"]),
                              boost=float(body.get("boost", 1.0)))


def _parse_nested(body) -> NestedQuery:
    if not isinstance(body, dict) or "path" not in body \
            or "query" not in body:
        raise ParsingException("[nested] requires [path] and [query]")
    mode = str(body.get("score_mode", "avg")).lower()
    if mode not in ("avg", "sum", "min", "max", "none"):
        raise ParsingException(f"[nested] unknown score_mode [{mode}]")
    return NestedQuery(path=str(body["path"]),
                       query=parse_query(body["query"]),
                       score_mode=mode,
                       boost=float(body.get("boost", 1.0)))


def _parse_multi_match(body) -> MultiMatchQuery:
    if not isinstance(body, dict) or "query" not in body:
        raise ParsingException("[multi_match] requires [query]")
    raw_fields = body.get("fields")
    if not raw_fields or not isinstance(raw_fields, list):
        raise ParsingException("[multi_match] requires [fields]")
    fields = []
    for f in raw_fields:
        name, _, boost = str(f).partition("^")
        try:
            fields.append((name, float(boost) if boost else 1.0))
        except ValueError:
            raise ParsingException(
                f"[multi_match] bad field boost in [{f}]") from None
    mm_type = str(body.get("type", "best_fields"))
    if mm_type not in ("best_fields", "most_fields"):
        raise ParsingException(
            f"[multi_match] unsupported type [{mm_type}] (best_fields and "
            f"most_fields are available)")
    op = str(body.get("operator", "or")).lower()
    if op not in ("or", "and"):
        raise ParsingException(f"[multi_match] unknown operator [{op}]")
    msm = body.get("minimum_should_match")
    known = {"query", "fields", "type", "operator", "minimum_should_match",
             "tie_breaker", "boost"}
    unknown = set(body) - known
    if unknown:
        raise ParsingException(
            f"[multi_match] unknown parameter {sorted(unknown)}")
    return MultiMatchQuery(
        fields=fields, query=str(body["query"]), type=mm_type, operator=op,
        minimum_should_match=None if msm is None else int(msm),
        tie_breaker=float(body.get("tie_breaker", 0.0)),
        boost=float(body.get("boost", 1.0)))


def _parse_prefix(body) -> PrefixQuery:
    field, spec = _field_and_params("prefix", body, "value")
    return PrefixQuery(field=field, value=str(spec["value"]),
                       boost=float(spec.get("boost", 1.0)))


def _parse_wildcard(body) -> WildcardQuery:
    if not isinstance(body, dict) or len(body) != 1:
        raise ParsingException("[wildcard] expects a single field")
    field, spec = next(iter(body.items()))
    if not isinstance(spec, dict):
        spec = {"value": spec}
    value = spec.get("value", spec.get("wildcard"))
    if value is None:
        raise ParsingException(f"[wildcard] on [{field}] requires [value]")
    return WildcardQuery(field=field, value=str(value),
                         case_insensitive=bool(
                             spec.get("case_insensitive", False)),
                         boost=float(spec.get("boost", 1.0)))


def _parse_fuzzy(body) -> FuzzyQuery:
    field, spec = _field_and_params("fuzzy", body, "value")
    fuzziness = spec.get("fuzziness", "AUTO")
    if isinstance(fuzziness, str) and fuzziness.upper() != "AUTO":
        try:
            fuzziness = int(fuzziness)
        except ValueError:
            raise ParsingException(
                f"[fuzzy] bad fuzziness [{fuzziness}]") from None
    if isinstance(fuzziness, int) and fuzziness not in (0, 1, 2):
        raise ParsingException("[fuzzy] fuzziness must be AUTO, 0, 1 or 2")
    return FuzzyQuery(field=field, value=str(spec["value"]),
                      fuzziness=fuzziness,
                      prefix_length=int(spec.get("prefix_length", 0)),
                      max_expansions=int(spec.get("max_expansions", 50)),
                      boost=float(spec.get("boost", 1.0)))


def _parse_function_score(body) -> FunctionScoreQuery:
    if not isinstance(body, dict):
        raise ParsingException("[function_score] expects an object")
    base = parse_query(body["query"]) if "query" in body \
        else MatchAllQuery()

    def parse_fn(obj) -> ScoreFunction:
        known = {"filter", "weight", "field_value_factor",
                 "script_score"}
        unknown = set(obj) - known
        if unknown:
            raise ParsingException(
                f"[function_score] unsupported function parameter "
                f"{sorted(unknown)} (filter/weight/field_value_factor/"
                f"script_score are available)")
        script = None
        if obj.get("script_score") is not None:
            spec = obj["script_score"]
            if not isinstance(spec, dict) or "script" not in spec:
                raise ParsingException(
                    "[script_score] requires a [script]")
            script = _parse_script(spec["script"])
        fvf = obj.get("field_value_factor")
        if fvf is not None:
            if "field" not in fvf:
                raise ParsingException(
                    "[field_value_factor] requires [field]")
            mod = str(fvf.get("modifier", "none"))
            if mod not in ("none", "log", "log1p", "log2p", "ln", "ln1p",
                           "ln2p", "square", "sqrt", "reciprocal"):
                raise ParsingException(
                    f"[field_value_factor] unknown modifier [{mod}]")
            for num_key in ("factor", "missing"):
                if fvf.get(num_key) is not None:
                    try:
                        float(fvf[num_key])
                    except (TypeError, ValueError):
                        raise ParsingException(
                            f"[field_value_factor] [{num_key}] must be "
                            f"numeric, got [{fvf[num_key]}]") from None
        if obj.get("weight") is None and fvf is None and script is None:
            raise ParsingException(
                "[function_score] function needs [weight], "
                "[field_value_factor], or [script_score]")
        return ScoreFunction(
            filter_query=(parse_query(obj["filter"])
                          if "filter" in obj else None),
            weight=(None if obj.get("weight") is None
                    else float(obj["weight"])),
            field_value_factor=fvf,
            script_score=script)

    functions: List[ScoreFunction] = []
    if "functions" in body:
        if not isinstance(body["functions"], list):
            raise ParsingException("[function_score] [functions] must be "
                                   "an array")
        functions = [parse_fn(f) for f in body["functions"]]
    else:
        shorthand = {k: body[k] for k in ("weight", "field_value_factor",
                                          "script_score")
                     if k in body}
        if shorthand:
            functions = [parse_fn(shorthand)]
    for mode_key, default in (("score_mode", "multiply"),
                              ("boost_mode", "multiply")):
        mode = str(body.get(mode_key, default))
        allowed = {"multiply", "sum", "avg", "max", "min"}
        if mode_key == "boost_mode":
            allowed = allowed | {"replace"}
        if mode not in allowed:
            raise ParsingException(
                f"[function_score] unknown {mode_key} [{mode}]")
    known = {"query", "functions", "weight", "field_value_factor",
             "script_score", "score_mode", "boost_mode", "max_boost",
             "boost"}
    unknown = set(body) - known
    if unknown:
        raise ParsingException(
            f"[function_score] unknown parameter {sorted(unknown)}")
    return FunctionScoreQuery(
        query=base, functions=functions,
        score_mode=str(body.get("score_mode", "multiply")),
        boost_mode=str(body.get("boost_mode", "multiply")),
        max_boost=(None if body.get("max_boost") is None
                   else float(body["max_boost"])),
        boost=float(body.get("boost", 1.0)))


DISTANCE_UNITS_M = {
    "mm": 0.001, "cm": 0.01, "m": 1.0, "km": 1000.0,
    "in": 0.0254, "ft": 0.3048, "yd": 0.9144,
    "mi": 1609.344, "miles": 1609.344, "nmi": 1852.0, "NM": 1852.0,
}


def parse_distance_m(spec: Any) -> float:
    """Distance grammar "12km"/"5mi"/number-of-meters (reference:
    DistanceUnit#parse)."""
    if isinstance(spec, (int, float)) and not isinstance(spec, bool):
        return float(spec)
    s = str(spec).strip()
    m = re.fullmatch(r"([\d.]+)\s*([a-zA-Z]*)", s)
    if not m:
        raise ParsingException(f"failed to parse distance [{spec}]")
    value = float(m.group(1))
    unit = m.group(2) or "m"
    factor = DISTANCE_UNITS_M.get(unit)
    if factor is None:
        raise ParsingException(f"unknown distance unit [{unit}]")
    return value * factor


def _parse_rank_feature(body) -> RankFeatureQuery:
    if not isinstance(body, dict) or "field" not in body:
        raise ParsingException("[rank_feature] requires [field]")
    fns = [k for k in ("saturation", "log", "sigmoid", "linear")
           if k in body]
    if len(fns) > 1:
        raise ParsingException(
            f"[rank_feature] can only have one function, got {fns}")
    unknown = set(body) - {"field", "boost", "saturation", "log",
                           "sigmoid", "linear"}
    if unknown:
        raise ParsingException(
            f"[rank_feature] unknown parameter {sorted(unknown)}")
    fn = fns[0] if fns else "saturation"
    spec = body.get(fn) or {}
    q = RankFeatureQuery(field=str(body["field"]), function=fn,
                         boost=float(body.get("boost", 1.0)))
    if fn == "saturation" and spec.get("pivot") is not None:
        q.pivot = float(spec["pivot"])
    if fn == "log":
        if spec.get("scaling_factor") is None:
            raise ParsingException(
                "[rank_feature] [log] requires [scaling_factor]")
        q.scaling_factor = float(spec["scaling_factor"])
    if fn == "sigmoid":
        if spec.get("pivot") is None or spec.get("exponent") is None:
            raise ParsingException(
                "[rank_feature] [sigmoid] requires [pivot] and "
                "[exponent]")
        q.pivot = float(spec["pivot"])
        q.exponent = float(spec["exponent"])
    return q


def _parse_geo_distance(body) -> GeoDistanceQuery:
    if not isinstance(body, dict) or "distance" not in body:
        raise ParsingException("[geo_distance] requires [distance]")
    dist = parse_distance_m(body["distance"])
    field = None
    point = None
    for k, v in body.items():
        if k in ("distance", "distance_type", "validation_method",
                 "boost", "_name"):
            continue
        if field is not None:
            raise ParsingException(
                f"[geo_distance] only one field allowed, got "
                f"[{field}] and [{k}]")
        field, point = k, v
    if field is None:
        raise ParsingException("[geo_distance] requires a field point")
    lat, lon = _parse_point(point)
    return GeoDistanceQuery(field=field, lat=lat, lon=lon,
                            distance_m=dist,
                            boost=float(body.get("boost", 1.0)))


def _parse_geo_bounding_box(body) -> GeoBoundingBoxQuery:
    if not isinstance(body, dict):
        raise ParsingException("[geo_bounding_box] expects an object")
    field = None
    spec = None
    for k, v in body.items():
        if k in ("validation_method", "type", "boost", "_name"):
            continue
        if field is not None:
            raise ParsingException(
                "[geo_bounding_box] only one field allowed")
        field, spec = k, v
    if field is None or not isinstance(spec, dict):
        raise ParsingException(
            "[geo_bounding_box] requires a field with corner points")
    from elasticsearch_tpu_torch.mapping.types import GeoPointFieldType
    try:
        if "top_left" in spec and "bottom_right" in spec:
            # a mapper error stays itself here (it is a ParsingException)
            top, left = GeoPointFieldType.parse_point(spec["top_left"])
            bottom, right = GeoPointFieldType.parse_point(
                spec["bottom_right"])
        elif all(k in spec for k in ("top", "left", "bottom", "right")):
            top, left = float(spec["top"]), float(spec["left"])
            bottom, right = float(spec["bottom"]), float(spec["right"])
        else:
            raise ParsingException(
                "[geo_bounding_box] requires [top_left]+[bottom_right] "
                "or [top]/[left]/[bottom]/[right]")
    except ParsingException:
        raise
    except Exception as e:  # noqa: BLE001
        raise ParsingException(str(e)) from None
    if bottom > top:
        raise ParsingException(
            f"[geo_bounding_box] top [{top}] must be >= bottom "
            f"[{bottom}]")
    return GeoBoundingBoxQuery(field=field, top=top, left=left,
                               bottom=bottom, right=right,
                               boost=float(body.get("boost", 1.0)))


def _parse_percolate(body) -> PercolateQuery:
    if not isinstance(body, dict) or not body.get("field"):
        raise ParsingException("[percolate] requires [field]")
    unknown = set(body) - {"field", "document", "documents", "boost",
                           "_name"}
    if unknown:
        raise ParsingException(
            f"[percolate] unknown parameter {sorted(unknown)}")
    if ("document" in body) == ("documents" in body):
        raise ParsingException(
            "[percolate] requires exactly one of [document] or "
            "[documents]")
    docs = body.get("documents", [body.get("document")])
    if not isinstance(docs, list) or not docs or not all(
            isinstance(d, dict) for d in docs):
        raise ParsingException(
            "[percolate] [documents] must be a non-empty array of "
            "objects")
    return PercolateQuery(field=str(body["field"]), documents=docs,
                          boost=float(body.get("boost", 1.0)))


def _parse_script_score(body) -> ScriptScoreQuery:
    if not isinstance(body, dict):
        raise ParsingException("[script_score] expects an object")
    if "query" not in body:
        raise ParsingException("[script_score] requires a [query]")
    if "script" not in body:
        raise ParsingException("[script_score] requires a [script]")
    unknown = set(body) - {"query", "script", "min_score", "boost"}
    if unknown:
        raise ParsingException(
            f"[script_score] unknown parameter {sorted(unknown)}")
    script = _parse_script(body["script"])
    return ScriptScoreQuery(
        query=parse_query(body["query"]), script=script,
        min_score=(None if body.get("min_score") is None
                   else float(body["min_score"])),
        boost=float(body.get("boost", 1.0)))


_PARSERS = {
    "match": _parse_match,
    "match_phrase": _parse_match_phrase,
    "term": _parse_term,
    "terms": _parse_terms,
    "range": _parse_range,
    "bool": _parse_bool,
    "match_all": _parse_match_all,
    "exists": _parse_exists,
    "ids": _parse_ids,
    "nested": _parse_nested,
    "constant_score": _parse_constant_score,
    "multi_match": _parse_multi_match,
    "prefix": _parse_prefix,
    "wildcard": _parse_wildcard,
    "fuzzy": _parse_fuzzy,
    "function_score": _parse_function_score,
    "script_score": _parse_script_score,
    "rank_feature": _parse_rank_feature,
    "geo_distance": _parse_geo_distance,
    "geo_bounding_box": _parse_geo_bounding_box,
    "percolate": _parse_percolate,
}


# ---------------------------------------------------------------------------
# what the script and geo parsers need from other modules
# ---------------------------------------------------------------------------

def _parse_script(spec: Any):
    """The REST script grammar compiled by the script module; its
    errors are the parsers' ParsingException, as in the reference."""
    from elasticsearch_tpu_torch.script import (ScriptException,
                                                compile_script)
    try:
        return compile_script(spec)
    except ScriptException as e:
        raise ParsingException(str(e)) from None


def _parse_point(value: Any) -> Tuple[float, float]:
    """GeoPointFieldType.parse_point, its errors as a ParsingException
    with their text (the reference's parsers do the same)."""
    from elasticsearch_tpu_torch.mapping.types import GeoPointFieldType
    try:
        return GeoPointFieldType.parse_point(value)
    except Exception as e:  # noqa: BLE001 — mapper error → parse error
        raise ParsingException(str(e)) from None
