"""Field types.

Copy of the reference's ``mapping/types.py``. A field type turns a
source value into index terms (with the token count that becomes the
BM25 norm) and a doc value: an ordinal for ``keyword`` and
``completion``, an i64 for the integer types, dates (epoch millis) and
booleans, an f64 for the floating types and ``rank_feature``, an f32
row for ``dense_vector``. ``ip``, the six range types and ``geo_point``
keep theirs in synthetic column pairs (``<f>._ip_hi``/``._ip_lo``,
``<f>._gte``/``._lte``, ``<f>._lat``/``._lon``) that the mapper fills.
On the query side ``normalize_term`` gives a term query's index term
and ``normalize_range_bound`` a range bound's comparable value. A text
field's analyzers come from the index's registry
(``analysis.AnalysisRegistry``); an analyzer name the registry does not
hold falls back to ``standard``, as in the reference.
"""

from __future__ import annotations

import datetime
import ipaddress
from typing import Any, List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.analysis import (KeywordAnalyzer,
                                              StandardAnalyzer)
from elasticsearch_tpu_torch.common.errors import (IllegalArgumentException,
                                                   MapperParsingException)

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


class IpFieldType(FieldType):
    """`ip` — IPv4 + IPv6 (reference: IpFieldMapper, which stores the
    16-byte canonical form). Exact terms index the canonical compressed
    string; ranges/CIDR compare on the 128-bit address value, carried in
    two synthetic signed-offset i64 doc-value columns (`<f>._ip_hi`,
    `<f>._ip_lo`) so the vectorized column path handles full IPv6."""

    type_name = "ip"
    dv_kind = "none"
    has_doc_values = False  # columns are the synthetic pair below

    HI_SUFFIX = "._ip_hi"
    LO_SUFFIX = "._ip_lo"

    @staticmethod
    def parse_ip(value: Any) -> int:
        """→ the 128-bit integer of the address (IPv4 as v4-mapped v6,
        the reference's canonical 16-byte ordering)."""
        try:
            addr = ipaddress.ip_address(str(value))
        except ValueError as e:
            raise MapperParsingException(
                f"failed to parse IP [{value!r}]") from e
        if addr.version == 4:
            return 0xFFFF00000000 | int(addr)
        return int(addr)

    @staticmethod
    def split128(v128: int) -> Tuple[int, int]:
        """128-bit value → (hi, lo) signed-offset i64s whose SIGNED
        lexicographic order equals the unsigned 128-bit order."""
        return ((v128 >> 64) - 2**63, (v128 & (2**64 - 1)) - 2**63)

    @staticmethod
    def cidr_bounds(value: str) -> Tuple[int, int]:
        net = ipaddress.ip_network(str(value), strict=False)
        lo = int(net.network_address)
        hi = int(net.broadcast_address)
        if net.version == 4:
            lo |= 0xFFFF00000000
            hi |= 0xFFFF00000000
        return lo, hi

    @staticmethod
    def canonical(value: Any) -> str:
        """Canonical exact-match term: v4-mapped v6 spellings collapse to
        the dotted-quad, like the reference's 16-byte canonical form
        (::ffff:1.2.3.4 ≡ 1.2.3.4 for term queries too)."""
        addr = ipaddress.ip_address(str(value))
        mapped = getattr(addr, "ipv4_mapped", None)
        if mapped is not None:
            return str(mapped)
        return addr.compressed

    def index_terms(self, value: Any) -> Tuple[List[str], int]:
        self.parse_ip(value)  # validate
        return [self.canonical(value)], 1

    def doc_value(self, value: Any):
        raise MapperParsingException(
            f"ip field [{self.name}] doc-values live in synthetic columns")

    def normalize_term(self, value: Any) -> str:
        return self.canonical(value)

    def normalize_range_bound(self, value: Any) -> int:
        return self.parse_ip(value)


class RangeFieldType(FieldType):
    """integer_range/long_range/float_range/double_range/date_range —
    each doc stores an interval {gt|gte, lt|lte}; queries match by
    interval relation (reference: RangeFieldMapper, default relation
    INTERSECTS). Bounds live in synthetic `<f>._gte` / `<f>._lte`
    doc-value columns."""

    RANGE_TYPES = {"integer_range": "i64", "long_range": "i64",
                   "float_range": "f64", "double_range": "f64",
                   "date_range": "i64"}
    GTE_SUFFIX = "._gte"
    LTE_SUFFIX = "._lte"
    dv_kind = "none"
    has_doc_values = False
    is_indexed = False  # no postings: matching is columnar

    def __init__(self, name: str, range_type: str,
                 params: Optional[dict] = None):
        if range_type not in self.RANGE_TYPES:
            raise IllegalArgumentException(
                f"unknown range type [{range_type}]")
        self.type_name = range_type
        self.bound_kind = self.RANGE_TYPES[range_type]
        super().__init__(name, params)
        self.is_indexed = False

    def parse_bound(self, value: Any):
        if self.type_name == "date_range":
            return parse_date_millis(value)
        if self.bound_kind == "i64":
            return int(value)
        return float(value)

    def parse_range(self, value: Any) -> Tuple[Any, Any]:
        """Source {gte/gt/lte/lt} → (gte, lte) closed bounds."""
        if not isinstance(value, dict):
            raise MapperParsingException(
                f"range field [{self.name}] expects an object with "
                f"gt/gte/lt/lte, got [{value!r}]")
        unknown = set(value) - {"gt", "gte", "lt", "lte"}
        if unknown:
            raise MapperParsingException(
                f"invalid range keys {sorted(unknown)} on [{self.name}]")
        step = 1 if self.bound_kind == "i64" else 0.0
        lo = hi = None
        if "gte" in value:
            lo = self.parse_bound(value["gte"])
        elif "gt" in value:
            lo = self.parse_bound(value["gt"]) + step
        if "lte" in value:
            hi = self.parse_bound(value["lte"])
        elif "lt" in value:
            hi = self.parse_bound(value["lt"]) - step
        if lo is None:
            lo = -(2**62) if self.bound_kind == "i64" else float("-inf")
        if hi is None:
            hi = 2**62 if self.bound_kind == "i64" else float("inf")
        return lo, hi

    def index_terms(self, value: Any) -> Tuple[List[str], int]:
        return [], 0

    def doc_value(self, value: Any):
        raise MapperParsingException(
            f"range field [{self.name}] doc-values live in synthetic "
            f"columns")

    def normalize_term(self, value: Any) -> str:
        raise IllegalArgumentException(
            f"term query value on range field [{self.name}] is matched "
            f"columnar")

    def normalize_range_bound(self, value: Any):
        return self.parse_bound(value)


class CompletionFieldType(FieldType):
    """`completion` — suggestion inputs stored as an ordinal column
    (sorted unique strings per segment), so prefix lookup is a binary
    search over the ord table (reference: CompletionFieldMapper's FST,
    same observable contract: inputs + optional weight). Weight lives in
    the synthetic `<f>._weight` i64 column."""

    type_name = "completion"
    dv_kind = "ord"
    is_indexed = False
    WEIGHT_SUFFIX = "._weight"

    @staticmethod
    def parse_inputs(value: Any) -> Tuple[List[str], int]:
        """value (str | [str] | {"input": ..., "weight": w}) →
        (input strings, weight)."""
        weight = 1
        if isinstance(value, dict):
            weight = int(value.get("weight", 1))
            value = value.get("input")
            if value is None:
                raise MapperParsingException(
                    "completion object requires [input]")
        inputs = value if isinstance(value, list) else [value]
        out = []
        for v in inputs:
            if not isinstance(v, str):
                raise MapperParsingException(
                    f"completion input must be a string, got [{v!r}]")
            out.append(v)
        return out, weight

    def index_terms(self, value: Any) -> Tuple[List[str], int]:
        return [], 0

    def doc_value(self, value: Any):
        inputs, _ = self.parse_inputs(value)
        return inputs if len(inputs) > 1 else inputs[0]

    def normalize_term(self, value: Any) -> str:
        return str(value)


class RankFeatureFieldType(FieldType):
    """`rank_feature` — a positive per-doc float scored through
    saturation/log/sigmoid at query time (reference: mapper-extras
    RankFeatureFieldMapper + RankFeatureQuery). The value lives in an
    f64 doc-values column; the rank_feature query is column math on the
    device."""

    type_name = "rank_feature"
    dv_kind = "f64"
    is_indexed = False

    def __init__(self, name: str, params: Optional[dict] = None):
        super().__init__(name, params)
        self.positive_score_impact = bool(
            (params or {}).get("positive_score_impact", True))

    def index_terms(self, value: Any) -> Tuple[List[str], int]:
        return [], 0

    def doc_value(self, value: Any):
        try:
            v = float(value)
        except (TypeError, ValueError):
            raise MapperParsingException(
                f"[rank_feature] field [{self.name}] expects a number, "
                f"got [{value!r}]") from None
        if not v > 0 or v != v or v == float("inf"):
            raise MapperParsingException(
                f"[rank_feature] field [{self.name}] must be a finite "
                f"positive normal float, got [{value}]")
        return v

    def normalize_term(self, value: Any) -> str:
        raise MapperParsingException(
            f"[rank_feature] field [{self.name}] does not support term "
            f"queries (use the rank_feature query)")

    def to_mapping(self) -> dict:
        out = {"type": "rank_feature"}
        if not self.positive_score_impact:
            out["positive_score_impact"] = False
        return out


class GeoPointFieldType(FieldType):
    """`geo_point` — lat/lon pairs in two synthetic f64 doc-value
    columns (`<f>._lat`, `<f>._lon`), the same split-column trick as
    `ip` (reference: GeoPointFieldMapper). Distance and bounding-box
    queries are elementwise column math over a whole segment, no BKD
    tree."""

    type_name = "geo_point"
    dv_kind = "none"
    has_doc_values = False  # columns are the synthetic pair below
    is_indexed = False

    LAT_SUFFIX = "._lat"
    LON_SUFFIX = "._lon"

    _GEOHASH32 = "0123456789bcdefghjkmnpqrstuvwxyz"

    @classmethod
    def parse_point(cls, value: Any) -> Tuple[float, float]:
        """Accepts {"lat","lon"}, "lat,lon", [lon, lat] (GeoJSON
        order!), or a geohash string → (lat, lon)."""
        if isinstance(value, dict):
            if "lat" not in value or "lon" not in value:
                raise MapperParsingException(
                    "geo_point object must have [lat] and [lon]")
            lat, lon = float(value["lat"]), float(value["lon"])
        elif isinstance(value, (list, tuple)):
            if len(value) != 2:
                raise MapperParsingException(
                    "geo_point array must be [lon, lat]")
            lon, lat = float(value[0]), float(value[1])
        elif isinstance(value, str):
            if "," in value:
                parts = value.split(",")
                if len(parts) != 2:
                    raise MapperParsingException(
                        f"failed to parse geo_point [{value}]")
                try:
                    lat, lon = float(parts[0]), float(parts[1])
                except ValueError:
                    raise MapperParsingException(
                        f"failed to parse geo_point [{value}]") from None
            else:
                lat, lon = cls.geohash_decode(value)
        else:
            raise MapperParsingException(
                f"failed to parse geo_point [{value!r}]")
        if not -90.0 <= lat <= 90.0:
            raise MapperParsingException(
                f"latitude [{lat}] out of range [-90, 90]")
        if not -180.0 <= lon <= 180.0:
            raise MapperParsingException(
                f"longitude [{lon}] out of range [-180, 180]")
        return lat, lon

    @classmethod
    def geohash_decode(cls, gh: str) -> Tuple[float, float]:
        lat_lo, lat_hi = -90.0, 90.0
        lon_lo, lon_hi = -180.0, 180.0
        even = True
        for c in gh.lower():
            idx = cls._GEOHASH32.find(c)
            if idx < 0:
                raise MapperParsingException(
                    f"invalid geohash character [{c}]")
            for bit in (16, 8, 4, 2, 1):
                if even:
                    mid = (lon_lo + lon_hi) / 2
                    if idx & bit:
                        lon_lo = mid
                    else:
                        lon_hi = mid
                else:
                    mid = (lat_lo + lat_hi) / 2
                    if idx & bit:
                        lat_lo = mid
                    else:
                        lat_hi = mid
                even = not even
        return (lat_lo + lat_hi) / 2, (lon_lo + lon_hi) / 2

    @classmethod
    def geohash_encode(cls, lat: float, lon: float,
                       precision: int = 5) -> str:
        lat_lo, lat_hi = -90.0, 90.0
        lon_lo, lon_hi = -180.0, 180.0
        even = True
        out = []
        idx = 0
        nbits = 0
        while len(out) < precision:
            if even:
                mid = (lon_lo + lon_hi) / 2
                if lon >= mid:
                    idx = idx * 2 + 1
                    lon_lo = mid
                else:
                    idx = idx * 2
                    lon_hi = mid
            else:
                mid = (lat_lo + lat_hi) / 2
                if lat >= mid:
                    idx = idx * 2 + 1
                    lat_lo = mid
                else:
                    idx = idx * 2
                    lat_hi = mid
            even = not even
            nbits += 1
            if nbits == 5:
                out.append(cls._GEOHASH32[idx])
                idx = 0
                nbits = 0
        return "".join(out)

    @classmethod
    def geohash_encode_batch(cls, lats: np.ndarray, lons: np.ndarray,
                             precision: int) -> List[str]:
        """geohash_encode over arrays: the reference's vectorized form
        (``search/aggregations/bucket.geohash_encode_batch``), the
        lon/lat bisection bits of every point interleaved at once."""
        n = len(lats)
        nbits = 5 * precision
        lat_lo = np.full(n, -90.0)
        lat_hi = np.full(n, 90.0)
        lon_lo = np.full(n, -180.0)
        lon_hi = np.full(n, 180.0)
        bits = np.zeros((nbits, n), dtype=np.int8)
        for b in range(nbits):
            if b % 2 == 0:  # even bit: longitude
                mid = (lon_lo + lon_hi) / 2
                hi = lons >= mid
                bits[b] = hi
                lon_lo = np.where(hi, mid, lon_lo)
                lon_hi = np.where(hi, lon_hi, mid)
            else:
                mid = (lat_lo + lat_hi) / 2
                hi = lats >= mid
                bits[b] = hi
                lat_lo = np.where(hi, mid, lat_lo)
                lat_hi = np.where(hi, lat_hi, mid)
        chars = np.zeros((precision, n), dtype=np.int8)
        for c in range(precision):
            for k in range(5):
                chars[c] = chars[c] * 2 + bits[c * 5 + k]
        return ["".join(cls._GEOHASH32[chars[c, i]] for c in range(precision))
                for i in range(n)]

    def index_terms(self, value: Any) -> Tuple[List[str], int]:
        return [], 0

    def doc_value(self, value: Any):
        return self.parse_point(value)

    def normalize_term(self, value: Any) -> str:
        raise MapperParsingException(
            f"[geo_point] field [{self.name}] does not support term "
            f"queries")

    def to_mapping(self) -> dict:
        return {"type": "geo_point"}


class PercolatorFieldType(FieldType):
    """`percolator` — the field VALUE is a query (reference:
    modules/percolator PercolatorFieldMapper).
    Validated at index time (a bad query is a 400 on the write, never
    a silent no-match later); the query itself lives in _source and is
    parsed on demand by search/percolator.py."""

    type_name = "percolator"
    dv_kind = "none"
    has_doc_values = False
    is_indexed = False

    def index_terms(self, value: Any) -> Tuple[List[str], int]:
        return [], 0

    def doc_value(self, value: Any):
        return None

    def validate(self, value: Any) -> None:
        from elasticsearch_tpu_torch.search import dsl
        if not isinstance(value, dict):
            raise MapperParsingException(
                f"[percolator] field [{self.name}] expects a query "
                f"object")
        try:
            dsl.parse_query(value)
        except Exception as e:  # noqa: BLE001 — surface as mapping err
            raise MapperParsingException(
                f"[percolator] field [{self.name}] holds an invalid "
                f"query: {e}") from None

    def normalize_term(self, value: Any) -> str:
        raise MapperParsingException(
            f"[percolator] field [{self.name}] does not support term "
            f"queries (use the percolate query)")

    def to_mapping(self) -> dict:
        return {"type": "percolator"}


class DenseVectorFieldType(FieldType):
    """`dense_vector` — fixed-dim float vectors stored as one dense
    [docs, dims] f32 matrix per segment (reference:
    DenseVectorFieldMapper). Indexed and returned in _source; the kNN
    search over the matrix comes with its own module."""

    type_name = "dense_vector"
    dv_kind = "vec"
    is_indexed = False
    SIMILARITIES = ("cosine", "dot_product", "l2_norm")
    MAX_DIMS = 4096

    def __init__(self, name: str, params: Optional[dict] = None):
        super().__init__(name, params)
        dims = (params or {}).get("dims")
        if dims is None:
            raise MapperParsingException(
                f"[dense_vector] field [{name}] requires [dims]")
        self.dims = int(dims)
        if not 1 <= self.dims <= self.MAX_DIMS:
            raise MapperParsingException(
                f"[dense_vector] [dims] must be in [1, {self.MAX_DIMS}], "
                f"got {self.dims}")
        self.similarity = str((params or {}).get("similarity", "cosine"))
        if self.similarity not in self.SIMILARITIES:
            raise MapperParsingException(
                f"[dense_vector] unknown similarity "
                f"[{self.similarity}]; one of {self.SIMILARITIES}")

    def parse_vector(self, value: Any) -> List[float]:
        if not isinstance(value, list):
            raise MapperParsingException(
                f"field [{self.name}] of type [dense_vector] expects an "
                f"array of numbers")
        if len(value) != self.dims:
            raise MapperParsingException(
                f"field [{self.name}] has [dims={self.dims}] but a "
                f"vector of length [{len(value)}] was provided")
        out = []
        for v in value:
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise MapperParsingException(
                    f"field [{self.name}] vector entries must be "
                    f"numbers, got [{v!r}]")
            out.append(float(v))
        return out

    def index_terms(self, value: Any) -> Tuple[List[str], int]:
        return [], 0

    def doc_value(self, value: Any):
        return self.parse_vector(value)

    def normalize_term(self, value: Any) -> str:
        raise MapperParsingException(
            f"field [{self.name}] of type [dense_vector] does not "
            f"support term queries")

    def to_mapping(self) -> dict:
        return {"type": "dense_vector", "dims": self.dims,
                "similarity": self.similarity}


def field_type_for(name: str, mapping: dict, analyzers=None) -> FieldType:
    """Build a FieldType from one field's mapping JSON."""
    t = mapping.get("type")
    params = {k: v for k, v in mapping.items() if k not in ("type", "fields")}
    analyzers = analyzers or {}
    if t == "text":
        an = analyzers.get(mapping.get("analyzer", "standard"))
        san = analyzers.get(mapping.get("search_analyzer", mapping.get("analyzer", "standard")))
        return TextFieldType(name, params, analyzer=an, search_analyzer=san)
    if t == "keyword":
        return KeywordFieldType(name, params)
    if t in NumberFieldType.INT_TYPES | NumberFieldType.FLOAT_TYPES:
        return NumberFieldType(name, t, params)
    if t == "date":
        return DateFieldType(name, params)
    if t == "boolean":
        return BooleanFieldType(name, params)
    if t == "ip":
        return IpFieldType(name, params)
    if t in RangeFieldType.RANGE_TYPES:
        return RangeFieldType(name, t, params)
    if t == "completion":
        return CompletionFieldType(name, params)
    if t == "dense_vector":
        return DenseVectorFieldType(name, params)
    if t == "rank_feature":
        return RankFeatureFieldType(name, params)
    if t == "percolator":
        return PercolatorFieldType(name, params)
    if t == "geo_point":
        return GeoPointFieldType(name, params)
    raise MapperParsingException(f"no handler for type [{t}] declared on field [{name}]")
