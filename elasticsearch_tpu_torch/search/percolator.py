"""Percolator: index queries as documents, then ask which stored queries
match a given document.

Copy of the reference's ``search/percolator.py``. The ``percolator``
mapping type validates and stores a query; {"percolate": {"field": f,
"document": {...}}} matches the docs whose stored query matches the
document, and ``documents`` (plural) matches when any of them does.
Every live stored query of a segment is evaluated against the
percolated documents (the reference's build has no term-extraction
pre-filter either); the parsed queries are cached per segment, and a
stored query that raises is skipped, not fatal.
"""

from __future__ import annotations

from typing import Any, Dict, List

from elasticsearch_tpu_torch.common.errors import IllegalArgumentException


def build_doc_reader(mapper, documents: List[Dict[str, Any]]):
    """The percolated documents as a one-segment in-memory index, parsed
    by a clone of the index's mapper (the same analyzers and field types
    as if indexed). A clone, because parse_document applies dynamic
    mapping: a search must never change the live index mapping, and the
    doc-value kinds must include the document's dynamic fields."""
    from elasticsearch_tpu_torch.index.reader import ShardReader
    from elasticsearch_tpu_torch.index.segment import SegmentWriter
    from elasticsearch_tpu_torch.mapping.mapper import MapperService
    clone = MapperService(mapper.to_mapping(), mapper.index_settings)
    writer = SegmentWriter("_percolate_docs")
    for slot, document in enumerate(documents):
        if not isinstance(document, dict):
            raise IllegalArgumentException(
                "[percolate] [document] must be an object")
        parsed = clone.parse_document(f"_slot_{slot}", document)
        # kinds re-read per doc: dynamic mapping may have added fields
        writer.add_document(parsed, clone.dv_kinds())
    segment = writer.freeze()
    return ShardReader([(segment, None)], clone)


def _get_field(doc: Dict[str, Any], path: str):
    """The value at a dotted path through nested dicts, or None."""
    parts = path.split(".")
    node = doc
    for p in parts[:-1]:
        node = node.get(p)
        if not isinstance(node, dict):
            return None
    return node.get(parts[-1])


def segment_parsed_queries(segment, field: str):
    """{doc ord: parsed stored query} of one (segment, field), parsed
    once: stored queries are immutable once a segment freezes."""
    cache = getattr(segment, "_percolator_cache", None)
    if cache is None:
        cache = {}
        segment._percolator_cache = cache
    entry = cache.get(field)
    if entry is None:
        from elasticsearch_tpu_torch.search import dsl
        entry = {}
        for ord_ in range(segment.num_docs):
            src = segment.stored_source[ord_] or {}
            # the literal dotted key first (the flat {"a.b": ...} source
            # form), then the dotted traversal (the object form)
            spec = src.get(field)
            if spec is None:
                spec = _get_field(src, field)
            if spec is None:
                continue
            try:
                entry[ord_] = dsl.parse_query(spec)
            except Exception:  # noqa: BLE001 — validated at index time;
                continue  # an unparsable survivor just matches nothing
        cache[field] = entry
    return entry
