"""MapperService + DocumentParser for ``text`` and ``keyword`` fields.

Copy of the reference's ``mapping/mapper.py`` (MapperService#merge with
its type-conflict check, DocumentParser with dynamic mapping, object
flattening to dotted paths), trimmed to the field types of
``mapping/types.py``. Dynamic mapping is the reference's: a string
becomes ``text`` with a ``.keyword`` multi-field (ignore_above 256); a
value that the reference maps to another type (a number, a boolean, an
ISO date string) is refused with ``mapper_parsing_exception`` naming the
type. Nested objects and positions (phrase queries) are left out.

ParsedDocument carries what the segment builder needs: postings terms
(duplicates give term frequency), field lengths (BM25 norms) and doc
values.
"""

from __future__ import annotations

import dataclasses
import re
import threading
from typing import Any, Dict, List, Optional

from elasticsearch_tpu_torch.common.errors import MapperParsingException
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.mapping.types import (FieldType, TextFieldType,
                                                   field_type_for)

_DATE_DETECT_RE = re.compile(r"^\d{4}-\d{2}-\d{2}([T ]\d{2}:\d{2}(:\d{2}(\.\d+)?)?(Z|[+-]\d{2}:?\d{2})?)?$")

METADATA_FIELDS = ("_id", "_routing", "_source", "_seq_no", "_index", "_version")


@dataclasses.dataclass
class ParsedDocument:
    doc_id: str
    routing: Optional[str]
    source: Dict[str, Any]
    postings_terms: Dict[str, List[str]]  # duplicates give term frequency
    field_lengths: Dict[str, int]         # BM25 norm source per field
    doc_values: Dict[str, Any] = dataclasses.field(default_factory=dict)


class DocumentMapper:
    """An immutable compiled mapping: field path → FieldType."""

    def __init__(self, fields: Dict[str, FieldType], meta: Optional[dict] = None,
                 dynamic: str = "true"):
        self.fields = dict(fields)
        self.meta = meta or {}
        self.dynamic = dynamic  # "true" | "false" | "strict"
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
        #: top-level text fields with no multi-fields: documents touching
        #: only these take the flat parse path
        self.fast_text_fields = fast

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


def parse_properties(properties: dict, prefix: str = "") -> Dict[str, FieldType]:
    fields: Dict[str, FieldType] = {}
    for name, spec in properties.items():
        if not isinstance(spec, dict):
            raise MapperParsingException(f"mapping for [{prefix}{name}] must be an object")
        path = f"{prefix}{name}"
        if "properties" in spec and "type" not in spec:
            fields.update(parse_properties(spec["properties"], path + "."))
            continue
        fields[path] = field_type_for(path, spec)
        for sub, subspec in (spec.get("fields") or {}).items():
            fields[f"{path}.{sub}"] = field_type_for(f"{path}.{sub}", subspec)
    return fields


class MapperService:
    """Holds the live DocumentMapper for one index; thread-safe merge.
    Merging fails on a type change of an existing field; adding fields
    is fine."""

    def __init__(self, mapping: Optional[dict] = None,
                 index_settings: Optional[Settings] = None):
        self._lock = threading.Lock()
        self.index_settings = index_settings or Settings.EMPTY
        fields = {}
        dynamic = "true"
        meta = {}
        if mapping:
            fields = parse_properties(mapping.get("properties", {}))
            dynamic = str(mapping.get("dynamic", "true")).lower()
            meta = mapping.get("_meta", {})
        self.mapper = DocumentMapper(fields, meta, dynamic)
        # bumps on every live-mapping swap
        self.generation = 0

    def merge(self, mapping_update: dict) -> None:
        """Merge a mapping fragment (properties tree) into the live mapping."""
        with self._lock:
            new_fields = parse_properties(mapping_update.get("properties", {}))
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
            self.mapper = DocumentMapper(merged, self.mapper.meta, dynamic)
            self.generation += 1

    def field_type(self, path: str) -> Optional[FieldType]:
        return self.mapper.fields.get(path)

    def to_mapping(self) -> dict:
        return self.mapper.to_mapping()

    # ---------------- document parsing ----------------

    def parse_document(self, doc_id: str, source: Dict[str, Any],
                       routing: Optional[str] = None) -> ParsedDocument:
        """Parse one source document, applying dynamic mapping as needed
        (new fields are merged into the live mapping)."""
        mapper = self.mapper
        fast = mapper.fast_text_fields
        if fast:
            postings: Dict[str, List[str]] = {}
            lengths: Dict[str, int] = {}
            for name, value in source.items():
                ft = fast.get(name)
                if ft is None or type(value) is not str:
                    break
                slots = ft.analyzer.analyze_slots(value)
                postings[name] = slots
                lengths[name] = len(slots)
            else:
                return ParsedDocument(doc_id, routing, source, postings,
                                      lengths)
        parsed = ParsedDocument(doc_id, routing, source, {}, {})
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
            if isinstance(value, dict):
                self._parse_object(value, path + ".", parsed, update_props)
                continue
            values = value if isinstance(value, list) else [value]
            flat_values = []
            for v in values:
                if isinstance(v, dict):
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
        prefix = path + "."
        for p, ft in self.mapper.fields.items():
            if p.startswith(prefix) and "." not in p[len(prefix):]:
                yield p, ft

    def _index_values(self, ft: FieldType, path: str, values: List[Any],
                      parsed: ParsedDocument) -> None:
        for v in values:
            if ft.is_indexed:
                if isinstance(ft, TextFieldType):
                    terms = ft.analyzer.analyze_slots(str(v))
                    base = parsed.field_lengths.get(path, 0)
                    parsed.field_lengths[path] = \
                        base + (100 if base else 0) + len(terms)
                    parsed.postings_terms.setdefault(path, []).extend(terms)
                else:
                    terms, length = ft.index_terms(v)
                    parsed.postings_terms.setdefault(path, []).extend(terms)
                    if length:
                        parsed.field_lengths[path] = parsed.field_lengths.get(path, 0) + length
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
        # refuses a type the port does not map before anything changes
        fields = {path: field_type_for(path, spec)}
        for sub, subspec in (spec.get("fields") or {}).items():
            fields[f"{path}.{sub}"] = field_type_for(f"{path}.{sub}", subspec)
        node = update_props
        parts = path.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {}).setdefault("properties", {})
        node[parts[-1]] = spec
        # register immediately so subsequent docs in the same batch see it
        with self._lock:
            merged = dict(self.mapper.fields)
            merged.update(fields)
            self.mapper = DocumentMapper(merged, self.mapper.meta,
                                         self.mapper.dynamic)
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
