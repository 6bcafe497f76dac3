"""MapperService + DocumentParser.

Copy of the reference's ``mapping/mapper.py``: MapperService#merge with
its type-conflict check, the MapperService building its analyzers from
the index settings (``index.analysis.*``), DocumentParser with dynamic
mapping, plain objects flattened to dotted paths, and ``nested`` roots:
each object of a nested field goes to the document's nested store
({subfield path: [raw values]} per object) instead of the parent's
postings, and is matched object by object at query time. Dynamic
mapping is the reference's: a string becomes ``date`` when it looks
like an ISO date and ``text`` with a ``.keyword`` multi-field
(ignore_above 256) otherwise, an integer ``long``, a float ``double``
and a boolean ``boolean``.

ParsedDocument carries what the segment builder needs: postings terms
(duplicates give term frequency), field lengths (BM25 norms, counting
stacked terms and not holes, as Lucene counts emitted tokens), the text
fields' term slots (positions, for phrase queries), doc values (the ip,
range, geo_point and completion fields' synthetic columns among them)
and the nested objects.
"""

from __future__ import annotations

import dataclasses
import re
import threading
from typing import Any, Dict, List, Optional, Tuple

from elasticsearch_tpu_torch.analysis import AnalysisRegistry
from elasticsearch_tpu_torch.analysis.filters import flatten_slots
from elasticsearch_tpu_torch.common.errors import MapperParsingException
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.mapping.types import (
    CompletionFieldType,
    DenseVectorFieldType,
    FieldType,
    GeoPointFieldType,
    IpFieldType,
    PercolatorFieldType,
    RangeFieldType,
    TextFieldType,
    field_type_for,
)

_DATE_DETECT_RE = re.compile(r"^\d{4}-\d{2}-\d{2}([T ]\d{2}:\d{2}(:\d{2}(\.\d+)?)?(Z|[+-]\d{2}:?\d{2})?)?$")

METADATA_FIELDS = ("_id", "_routing", "_source", "_seq_no", "_index", "_version")


@dataclasses.dataclass
class ParsedDocument:
    doc_id: str
    routing: Optional[str]
    source: Dict[str, Any]
    postings_terms: Dict[str, List[str]]
    field_lengths: Dict[str, int]
    # text fields: one slots list (term-or-None per position) PER VALUE of
    # the field — positions derive from slot indices + the 100-position
    # array gap (slots_to_positions)
    term_slots: Dict[str, List[List[Optional[str]]]] = dataclasses.field(
        default_factory=dict)
    doc_values: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # nested root path → one flat {abs subfield path: [raw values]} dict
    # PER OBJECT (reference: each nested object is its own hidden
    # sub-document; per-object matching happens against this store)
    nested: Dict[str, List[Dict[str, List[Any]]]] = dataclasses.field(
        default_factory=dict)

    @property
    def positions(self) -> Dict[str, List[Tuple[str, int]]]:
        """{field: [(term, position), ...]} with Lucene's
        position_increment_gap=100 between array values."""
        return {field: slots_to_positions(slot_lists)
                for field, slot_lists in self.term_slots.items()}


def slots_to_positions(slot_lists: List[List[Optional[str]]]
                       ) -> List[Tuple[str, int]]:
    """Per-value slot lists → [(term, absolute position)], reproducing the
    write-path gap rule: value j starts at (tokens so far) + 100·(values
    so far with tokens before them). A list slot entry stacks several
    terms at ONE position (synonyms/ngram filters — Lucene's
    posIncrement=0)."""
    out: List[Tuple[str, int]] = []
    base = 0
    for slots in slot_lists:
        gap = 100 if base else 0
        n = 0
        for si, entry in enumerate(slots):
            if not entry:
                continue
            if isinstance(entry, list):
                for term in entry:
                    if term:
                        out.append((term, si + base + gap))
                        n += 1
            else:
                out.append((entry, si + base + gap))
                n += 1
        base = base + gap + n
    return out


class DocumentMapper:
    """An immutable compiled mapping: field path → FieldType."""

    def __init__(self, fields: Dict[str, FieldType], meta: Optional[dict] = None,
                 dynamic: str = "true", nested_roots: Optional[set] = None):
        self.fields = dict(fields)
        self.meta = meta or {}
        self.dynamic = dynamic  # "true" | "false" | "strict"
        self.nested_roots = set(nested_roots or ())
        fast = {}
        for path, ft in self.fields.items():
            if ("." in path or not isinstance(ft, TextFieldType)
                    or path in METADATA_FIELDS
                    or getattr(ft.analyzer, "_has_stop", True)):
                continue
            prefix = path + "."
            if any(p.startswith(prefix) for p in self.fields):
                continue  # has multi-fields
            fast[path] = ft
        #: top-level text fields with no multi-fields and a standard
        #: analyzer without stop words: documents touching only these
        #: take the flat parse path
        self.fast_text_fields = fast
        #: field → doc-value column kind, for SegmentWriter.add_document;
        #: ip/range/geo_point/completion fields contribute their
        #: synthetic columns
        kinds = {f: t.dv_kind for f, t in self.fields.items()
                 if t.dv_kind != "none"}
        for f, t in self.fields.items():
            if isinstance(t, IpFieldType):
                kinds[f + IpFieldType.HI_SUFFIX] = "i64"
                kinds[f + IpFieldType.LO_SUFFIX] = "i64"
            elif isinstance(t, RangeFieldType):
                kinds[f + RangeFieldType.GTE_SUFFIX] = t.bound_kind
                kinds[f + RangeFieldType.LTE_SUFFIX] = t.bound_kind
            elif isinstance(t, CompletionFieldType):
                kinds[f + CompletionFieldType.WEIGHT_SUFFIX] = "i64"
            elif isinstance(t, GeoPointFieldType):
                kinds[f + GeoPointFieldType.LAT_SUFFIX] = "f64"
                kinds[f + GeoPointFieldType.LON_SUFFIX] = "f64"
        self.dv_kinds = kinds
        self._subfields: Dict[str, List[Tuple[str, FieldType]]] = {}

    def subfields(self, path: str) -> List[Tuple[str, FieldType]]:
        """The multi-fields directly under `path` (e.g. title.keyword),
        found once a path."""
        subs = self._subfields.get(path)
        if subs is None:
            prefix = path + "."
            subs = self._subfields[path] = [
                (p, ft) for p, ft in self.fields.items()
                if p.startswith(prefix) and "." not in p[len(prefix):]]
        return subs

    def to_mapping(self) -> dict:
        props: Dict[str, Any] = {}
        for path in sorted(self.fields):
            if "." in path and path.rsplit(".", 1)[0] in self.fields:
                # multi-field (e.g. title.keyword) renders under parent "fields"
                parent, sub = path.rsplit(".", 1)
                pnode = _walk_props(props, parent)
                pnode.setdefault("fields", {})[sub] = self.fields[path].to_mapping()
            else:
                node = _walk_props(props, path)
                node.update(self.fields[path].to_mapping())
        for root in sorted(self.nested_roots):
            _walk_props(props, root)["type"] = "nested"
        out: Dict[str, Any] = {"properties": props}
        if self.dynamic != "true":
            out["dynamic"] = self.dynamic
        if self.meta:
            out["_meta"] = self.meta
        return out


def _append_dv(parsed: ParsedDocument, path: str, dv: Any) -> None:
    existing = parsed.doc_values.get(path)
    if existing is None:
        parsed.doc_values[path] = dv
    elif isinstance(existing, list):
        existing.append(dv)
    else:
        parsed.doc_values[path] = [existing, dv]


def _flatten_nested_object(obj: Dict[str, Any], prefix: str,
                           out: Dict[str, List[Any]]) -> None:
    """One nested object → {absolute subfield path: [raw values]}
    (inner plain objects flatten with dot-paths, like ObjectMapper)."""
    for name, value in obj.items():
        path = f"{prefix}{name}"
        if isinstance(value, dict):
            _flatten_nested_object(value, path + ".", out)
            continue
        values = value if isinstance(value, list) else [value]
        flat = [v for v in values if v is not None
                and not isinstance(v, dict)]
        for v in values:
            if isinstance(v, dict):
                _flatten_nested_object(v, path + ".", out)
        if flat:
            out.setdefault(path, []).extend(flat)


def _walk_props(props: Dict[str, Any], path: str) -> Dict[str, Any]:
    """Descend/create the properties tree node for a dotted path."""
    parts = path.split(".")
    node = props
    for i, p in enumerate(parts):
        entry = node.setdefault(p, {})
        if i < len(parts) - 1:
            node = entry.setdefault("properties", {})
        else:
            return entry
    return node


def parse_properties(properties: dict, analyzers, prefix: str = "",
                     nested_roots: Optional[set] = None
                     ) -> Dict[str, FieldType]:
    """nested_roots (out-param): collects paths mapped `"type": "nested"`
    (reference: NestedObjectMapper) — their subfields get field types for
    query-side normalization but index through the nested store, not the
    parent's postings."""
    fields: Dict[str, FieldType] = {}
    for name, spec in properties.items():
        if not isinstance(spec, dict):
            raise MapperParsingException(f"mapping for [{prefix}{name}] must be an object")
        path = f"{prefix}{name}"
        if spec.get("type") == "nested":
            if nested_roots is not None:
                nested_roots.add(path)
            fields.update(parse_properties(spec.get("properties") or {},
                                           analyzers, path + ".",
                                           nested_roots))
            continue
        if "properties" in spec and "type" not in spec:
            fields.update(parse_properties(spec["properties"], analyzers,
                                           path + ".", nested_roots))
            continue
        fields[path] = field_type_for(path, spec, analyzers)
        for sub, subspec in (spec.get("fields") or {}).items():
            fields[f"{path}.{sub}"] = field_type_for(f"{path}.{sub}", subspec, analyzers)
    return fields


class MapperService:
    """Holds the live DocumentMapper for one index; thread-safe merge.

    Reference: MapperService#merge — merging an incoming mapping into the
    current one fails on type conflicts (can't change a field's type);
    adding new fields is fine."""

    def __init__(self, mapping: Optional[dict] = None,
                 index_settings: Optional[Settings] = None):
        self._lock = threading.Lock()
        self.index_settings = index_settings or Settings.EMPTY
        self.analyzers = AnalysisRegistry().build(self.index_settings)
        fields = {}
        dynamic = "true"
        meta = {}
        nested_roots: set = set()
        if mapping:
            fields = parse_properties(mapping.get("properties", {}),
                                      self.analyzers,
                                      nested_roots=nested_roots)
            dynamic = str(mapping.get("dynamic", "true")).lower()
            meta = mapping.get("_meta", {})
        self.mapper = DocumentMapper(fields, meta, dynamic,
                                     nested_roots=nested_roots)
        # bumps on every live-mapping swap
        self.generation = 0

    def merge(self, mapping_update: dict) -> None:
        """Merge a mapping fragment (properties tree) into the live mapping."""
        with self._lock:
            nested_roots = set(self.mapper.nested_roots)
            new_fields = parse_properties(mapping_update.get("properties", {}),
                                          self.analyzers,
                                          nested_roots=nested_roots)
            merged = dict(self.mapper.fields)
            for path, ft in new_fields.items():
                existing = merged.get(path)
                if existing is not None and existing.type_name != ft.type_name:
                    raise MapperParsingException(
                        f"mapper [{path}] cannot be changed from type "
                        f"[{existing.type_name}] to [{ft.type_name}]"
                    )
                merged[path] = ft
            dynamic = str(mapping_update.get("dynamic", self.mapper.dynamic)).lower()
            self.mapper = DocumentMapper(merged, self.mapper.meta, dynamic,
                                         nested_roots=nested_roots)
            self.generation += 1

    def field_type(self, path: str) -> Optional[FieldType]:
        return self.mapper.fields.get(path)

    def dv_kinds(self) -> Dict[str, str]:
        """field → doc-value column kind of the live mapping."""
        return self.mapper.dv_kinds

    def to_mapping(self) -> dict:
        return self.mapper.to_mapping()

    # ---------------- document parsing ----------------

    def parse_document(self, doc_id: str, source: Dict[str, Any],
                       routing: Optional[str] = None) -> ParsedDocument:
        """Parse one source document, applying dynamic mapping as needed.
        Mutates the live mapping via merge() when new fields appear (the
        engine calls this under its write path; distributed callers route
        the update through cluster metadata first)."""
        # flat fast path (the bulk-indexing common case): every field a
        # plain string mapped to a no-multi-field text type — one
        # analyzer call per field, none of the generic walk
        mapper = self.mapper
        fast = mapper.fast_text_fields
        if fast and not mapper.nested_roots:
            postings: Dict[str, List[str]] = {}
            lengths: Dict[str, int] = {}
            slots_map: Dict[str, List[List[Optional[str]]]] = {}
            for name, value in source.items():
                ft = fast.get(name)
                if ft is None or type(value) is not str:
                    break
                slots = ft.analyzer.analyze_slots(value)
                postings[name] = slots  # no stop filter ⇒ no holes
                lengths[name] = len(slots)
                slots_map[name] = [slots]
            else:
                return ParsedDocument(doc_id, routing, source, postings,
                                      lengths, slots_map, {})
        parsed = ParsedDocument(doc_id, routing, source, {}, {}, {}, {})
        update_props: Dict[str, Any] = {}
        self._parse_object(source, "", parsed, update_props)
        if update_props:
            self.merge({"properties": update_props})
        return parsed

    def _parse_object(self, obj: Dict[str, Any], prefix: str,
                      parsed: ParsedDocument, update_props: Dict[str, Any]) -> None:
        for name, value in obj.items():
            if prefix == "" and name in METADATA_FIELDS:
                raise MapperParsingException(
                    f"field [{name}] is a metadata field and cannot be added inside a document"
                )
            path = f"{prefix}{name}"
            if path in self.mapper.nested_roots:
                objs = value if isinstance(value, list) else [value]
                out = parsed.nested.setdefault(path, [])
                for obj in objs:
                    if obj is None:
                        continue
                    if not isinstance(obj, dict):
                        raise MapperParsingException(
                            f"object mapping for [{path}] tried to parse "
                            f"field as object, got [{obj!r}]")
                    flat: Dict[str, List[Any]] = {}
                    _flatten_nested_object(obj, path + ".", flat)
                    out.append(flat)
                continue
            # range/completion field VALUES are objects ({gte/lte},
            # {input/weight}) — everything else dict-shaped descends as
            # a plain object
            known_ft = self.mapper.fields.get(path)
            value_is_object_field = isinstance(
                known_ft,
                (RangeFieldType, CompletionFieldType,
                 GeoPointFieldType, PercolatorFieldType))
            if isinstance(value, dict) and not value_is_object_field:
                self._parse_object(value, path + ".", parsed,
                                   update_props)
                continue
            if isinstance(known_ft, PercolatorFieldType) and \
                    isinstance(value, list):
                raise MapperParsingException(
                    f"[percolator] field [{path}] holds ONE query; "
                    f"arrays of queries are not supported")
            if isinstance(known_ft, DenseVectorFieldType):
                # the ARRAY is the value — never flattened per element
                self._index_values(known_ft, path, [value], parsed)
                continue
            if isinstance(known_ft, GeoPointFieldType) and \
                    isinstance(value, list) and value and \
                    isinstance(value[0], (int, float)):
                # [lon, lat] is ONE point (GeoJSON order), not a
                # multi-value array (reference disambiguation rule)
                self._index_values(known_ft, path, [value], parsed)
                continue
            values = value if isinstance(value, list) else [value]
            flat_values = []
            for v in values:
                if isinstance(v, dict) and not value_is_object_field:
                    self._parse_object(v, path + ".", parsed, update_props)
                else:
                    flat_values.append(v)
            non_null = [v for v in flat_values if v is not None]
            if not non_null:
                continue
            ft = self.mapper.fields.get(path)
            if ft is None:
                ft = self._dynamic_field(path, non_null[0], update_props)
                if ft is None:
                    continue  # dynamic=false: unmapped fields stored in _source only
            self._index_values(ft, path, non_null, parsed)
            # multi-fields (e.g. .keyword) index the same values
            for sub_path, sub_ft in self._subfields(path):
                self._index_values(sub_ft, sub_path, non_null, parsed)

    def _subfields(self, path: str):
        return self.mapper.subfields(path)

    def _index_values(self, ft: FieldType, path: str, values: List[Any],
                      parsed: ParsedDocument) -> None:
        for v in values:
            if ft.is_indexed:
                if isinstance(ft, TextFieldType):
                    # slots carry the positions implicitly (index = slot,
                    # holes = None, list = stacked terms at one position);
                    # the +100 array-value gap is applied lazily by
                    # slots_to_positions — no per-token work here
                    slots = ft.analyzer.analyze_slots(str(v))
                    if None in slots or any(
                            isinstance(s, list) for s in slots):
                        terms = flatten_slots(slots)
                    else:
                        terms = slots
                    base = parsed.field_lengths.get(path, 0)
                    parsed.field_lengths[path] = \
                        base + (100 if base else 0) + len(terms)
                    parsed.term_slots.setdefault(path, []).append(slots)
                    parsed.postings_terms.setdefault(path, []).extend(terms)
                else:
                    terms, length = ft.index_terms(v)
                    parsed.postings_terms.setdefault(path, []).extend(terms)
                    if length:
                        parsed.field_lengths[path] = parsed.field_lengths.get(path, 0) + length
            if isinstance(ft, CompletionFieldType):
                inputs, weight = CompletionFieldType.parse_inputs(v)
                for inp in inputs:
                    _append_dv(parsed, path, inp)
                _append_dv(parsed, path + CompletionFieldType.WEIGHT_SUFFIX,
                           weight)
                continue
            if isinstance(ft, IpFieldType):
                # 128-bit address split into two signed-offset i64
                # synthetic columns — the vectorized range path then
                # covers full IPv6 (IpFieldType docstring)
                hi, lo = IpFieldType.split128(ft.parse_ip(v))
                _append_dv(parsed, path + IpFieldType.HI_SUFFIX, hi)
                _append_dv(parsed, path + IpFieldType.LO_SUFFIX, lo)
                continue
            if isinstance(ft, GeoPointFieldType):
                lat, lon = ft.parse_point(v)
                _append_dv(parsed, path + GeoPointFieldType.LAT_SUFFIX,
                           lat)
                _append_dv(parsed, path + GeoPointFieldType.LON_SUFFIX,
                           lon)
                continue
            if isinstance(ft, PercolatorFieldType):
                ft.validate(v)  # bad query = 400 at WRITE time
                continue
            if isinstance(ft, RangeFieldType):
                glo, ghi = ft.parse_range(v)
                _append_dv(parsed, path + RangeFieldType.GTE_SUFFIX, glo)
                _append_dv(parsed, path + RangeFieldType.LTE_SUFFIX, ghi)
                continue
            if ft.has_doc_values:
                _append_dv(parsed, path, ft.doc_value(v))

    def _dynamic_field(self, path: str, sample: Any,
                       update_props: Dict[str, Any]) -> Optional[FieldType]:
        if self.mapper.dynamic == "strict":
            raise MapperParsingException(
                f"mapping set to strict, dynamic introduction of [{path}] is not allowed"
            )
        if self.mapper.dynamic == "false":
            return None
        spec = self._infer(sample)
        if spec is None:
            return None
        node = update_props
        parts = path.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {}).setdefault("properties", {})
        node[parts[-1]] = spec
        # register immediately so subsequent docs in the same batch see it
        fields = {path: field_type_for(path, spec, self.analyzers)}
        for sub, subspec in (spec.get("fields") or {}).items():
            fields[f"{path}.{sub}"] = field_type_for(f"{path}.{sub}", subspec, self.analyzers)
        with self._lock:
            merged = dict(self.mapper.fields)
            merged.update(fields)
            self.mapper = DocumentMapper(
                merged, self.mapper.meta, self.mapper.dynamic,
                nested_roots=self.mapper.nested_roots)
            self.generation += 1
        return fields[path]

    @staticmethod
    def _infer(value: Any) -> Optional[dict]:
        if isinstance(value, bool):
            return {"type": "boolean"}
        if isinstance(value, int):
            return {"type": "long"}
        if isinstance(value, float):
            return {"type": "double"}
        if isinstance(value, str):
            if _DATE_DETECT_RE.match(value):
                return {"type": "date"}
            return {"type": "text",
                    "fields": {"keyword": {"type": "keyword", "ignore_above": 256}}}
        return None
