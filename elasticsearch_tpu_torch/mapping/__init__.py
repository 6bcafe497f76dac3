"""The part of the mapper that the search slice needs: ``text`` fields.

Counterpart of the reference's ``mapping/`` for the subset that
``lower_query`` and the segment writer call: ``TextFieldType`` with
``search_terms``, ``ParsedDocument`` and a ``MapperService`` that parses
documents into postings terms and field lengths. Only ``text`` fields are
mapped in this slice; other fields of a document stay in its stored
``_source`` and index nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from elasticsearch_tpu_torch.analysis import StandardAnalyzer
from elasticsearch_tpu_torch.errors import MapperParsingException


class TextFieldType:
    type_name = "text"

    def __init__(self, name: str, params: Optional[dict] = None):
        self.name = name
        self.params = dict(params or {})
        self.analyzer = StandardAnalyzer()

    def search_terms(self, value: Any) -> List[str]:
        return self.analyzer.terms(str(value))


@dataclasses.dataclass
class ParsedDocument:
    doc_id: str
    source: Dict[str, Any]
    postings_terms: Dict[str, List[str]]  # duplicates give term frequency
    field_lengths: Dict[str, int]         # BM25 norm source per field


class MapperService:
    """Field path → field type for one index."""

    def __init__(self, mapping: Optional[dict] = None):
        self.fields: Dict[str, TextFieldType] = {}
        for name, spec in ((mapping or {}).get("properties") or {}).items():
            if not isinstance(spec, dict):
                raise MapperParsingException(
                    f"mapping for [{name}] must be an object")
            kind = spec.get("type")
            if kind != "text":
                raise MapperParsingException(
                    f"field [{name}]: only [text] fields are mapped by this "
                    f"slice, got [{kind}]")
            self.fields[name] = TextFieldType(name, spec)
        self.generation = 0

    def field_type(self, path: str) -> Optional[TextFieldType]:
        return self.fields.get(path)

    def parse_document(self, doc_id: str,
                       source: Dict[str, Any]) -> ParsedDocument:
        """Analyze every mapped text field of `source`. An array of
        strings indexes each value, with the reference's 100-position gap
        counted into the field length."""
        postings: Dict[str, List[str]] = {}
        lengths: Dict[str, int] = {}
        for name, value in source.items():
            ft = self.fields.get(name)
            if ft is None:
                continue
            values = value if isinstance(value, list) else [value]
            for v in values:
                if v is None:
                    continue
                if isinstance(v, (dict, list)):
                    raise MapperParsingException(
                        f"text field [{name}] takes strings, got "
                        f"{type(v).__name__}")
                terms = ft.analyzer.terms(str(v))
                base = lengths.get(name, 0)
                lengths[name] = base + (100 if base else 0) + len(terms)
                postings.setdefault(name, []).extend(terms)
        return ParsedDocument(doc_id, source, postings, lengths)
