"""Introspection REST actions: ``_field_caps``, ``_validate/query``,
``_explain`` and ``_termvectors``.

Copy of the reference's ``rest/actions/introspect.py`` for those routes.
``_explain`` scores the one document through the planner's
``SegmentQueryExecutor`` on the node's first device (the reference's
explanation is a summary too: a score from one fused evaluation, not a
per-clause tree). ``_termvectors`` re-derives a document's terms from
its ``_source`` through each text field's analyzer. Hot threads,
allocation explain, the ``_tpu/*`` routes and ``_prometheus`` belong to
the observability and cluster modules, which are not ported yet.
"""

from __future__ import annotations

import fnmatch
from typing import Any, Dict, Optional

from elasticsearch_tpu_torch.common.errors import (DocumentMissingException,
                                                   IllegalArgumentException)
from elasticsearch_tpu_torch.mapping.types import TextFieldType
from elasticsearch_tpu_torch.rest.controller import RestController, RestRequest
from elasticsearch_tpu_torch.search import dsl
from elasticsearch_tpu_torch.search.coordinator import resolve_targets
from elasticsearch_tpu_torch.search.planner import SegmentQueryExecutor

# field types that aggregate through doc-value columns
_AGGREGATABLE = {"keyword", "long", "integer", "short", "byte", "double",
                 "float", "half_float", "date", "boolean", "ip",
                 "rank_feature", "geo_point"}
_SEARCHABLE_EXTRA = {"dense_vector", "rank_feature", "geo_point"}


def get_field(doc: Dict[str, Any], path: str, default=None):
    """The value at dotted `path` of a nested source document (the
    reference's ``ingest.get_field``)."""
    parts = path.split(".")
    node = doc
    for p in parts[:-1]:
        node = node.get(p)
        if not isinstance(node, dict):
            return default
    return node.get(parts[-1], default)


def field_caps(node, index_expr: Optional[str],
               fields_param: Optional[str]) -> Dict[str, Any]:
    """Per field, per type: searchable, aggregatable, and the indices
    that have it when not every target index does."""
    names, _ = resolve_targets(node.indices, index_expr)
    patterns = [p.strip() for p in (fields_param or "*").split(",")
                if p.strip()]
    per_field: Dict[str, Dict[str, Dict[str, Any]]] = {}
    for name in names:
        svc = node.indices.index(name)
        for path, ft in svc.mapper.mapper.fields.items():
            if not any(fnmatch.fnmatchcase(path, p) for p in patterns):
                continue
            t = ft.type_name
            entry = per_field.setdefault(path, {}).setdefault(t, {
                "type": t,
                "metadata_field": False,
                "searchable": bool(getattr(ft, "is_indexed", True))
                or t in _SEARCHABLE_EXTRA,
                "aggregatable": t in _AGGREGATABLE,
                "indices": []})
            entry["indices"].append(name)
    out_fields: Dict[str, Any] = {}
    for path, types in per_field.items():
        out: Dict[str, Any] = {}
        for t, entry in types.items():
            if len(entry["indices"]) == len(names):
                entry = {k: v for k, v in entry.items() if k != "indices"}
            out[t] = entry
        out_fields[path] = out
    return {"indices": sorted(names), "fields": out_fields}


def validate_query(node, index_expr: Optional[str],
                   body: Optional[Dict[str, Any]],
                   explain: bool) -> Dict[str, Any]:
    names, _ = resolve_targets(node.indices, index_expr)
    spec = (body or {}).get("query") or {"match_all": {}}
    shards = {"total": 1, "successful": 1, "failed": 0}
    try:
        parsed = dsl.parse_query(spec)
    except Exception as exc:  # noqa: BLE001 — the point is to report it
        out = {"valid": False, "_shards": shards}
        if explain:
            out["error"] = str(exc)
        return out
    out = {"valid": True, "_shards": shards}
    if explain:
        out["explanations"] = [
            {"index": name, "valid": True,
             "explanation": parsed.query_name()} for name in names]
    return out


def explain_doc(node, index: str, doc_id: str,
                body: Optional[Dict[str, Any]],
                params: Dict[str, str]) -> Dict[str, Any]:
    """Does the query match this document, and with what score."""
    spec = (body or {}).get("query")
    if spec is None:
        raise IllegalArgumentException("[_explain] requires a [query]")
    query = dsl.parse_query(spec)
    svc = node.indices.index(index)
    shard_num = svc.shard_for_id(doc_id, params.get("routing"))
    reader = svc.shard(shard_num).acquire_searcher()
    for view_idx, view in enumerate(reader.views):
        ord_ = view.segment.id_to_ord.get(doc_id)
        if ord_ is None or not view.live_mask[ord_]:
            continue
        mask, score = SegmentQueryExecutor(
            reader, view_idx, node.gpu_search.mesh.grid[0][0]).execute(query)
        matched = bool(mask[ord_])
        value = float(score[ord_]) if matched else 0.0
        desc = (f"score({query.query_name()})" if matched
                else "no matching clause")
        return {"_index": index, "_id": doc_id, "matched": matched,
                "explanation": {"value": value, "description": desc,
                                "details": []}}
    raise DocumentMissingException(f"[{doc_id}]: document missing")


def termvectors(node, index: str, doc_id: str,
                body: Optional[Dict[str, Any]],
                params: Dict[str, str]) -> Dict[str, Any]:
    """Per text field, the document's terms with their frequencies and
    positions, from its _source through the field's analyzer."""
    body = body or {}
    svc = node.indices.index(index)
    shard = svc.shard(svc.shard_for_id(doc_id, params.get("routing")))
    doc = shard.get(doc_id)
    if doc is None:
        return {"_index": index, "_id": doc_id, "found": False}
    source = doc.get("_source") or {}
    want = body.get("fields") or params.get("fields")
    if isinstance(want, str):
        want = [f.strip() for f in want.split(",") if f.strip()]
    want_stats = str(params.get("term_statistics",
                                body.get("term_statistics", "false"))
                     ).lower() == "true"
    reader = shard.acquire_searcher()
    tv: Dict[str, Any] = {}
    for path, ft in svc.mapper.mapper.fields.items():
        if not isinstance(ft, TextFieldType) or (want and path not in want):
            continue
        # object fields live nested in _source; a multi-field (title.en)
        # reads its parent's value
        value = get_field(source, path)
        if value is None and "." in path:
            value = get_field(source, path.rsplit(".", 1)[0])
        if value is None:
            continue
        term_stats: Dict[str, Dict[str, Any]] = {}
        pos_base = 0
        for v in value if isinstance(value, list) else [value]:
            tokens = ft.analyzer.analyze(str(v))
            for tok in tokens:
                entry = term_stats.setdefault(
                    tok.term, {"term_freq": 0, "tokens": []})
                entry["term_freq"] += 1
                entry["tokens"].append({"position": pos_base + tok.position})
            pos_base += 100 + len(tokens)
        if not term_stats:
            continue
        doc_count, avgdl = reader.field_stats(path)
        block: Dict[str, Any] = {
            "field_statistics": {
                "sum_doc_freq": sum(reader.doc_freq(path, t)
                                    for t in term_stats),
                "doc_count": doc_count,
                "sum_ttf": int(avgdl * doc_count)},
            "terms": {}}
        for term in sorted(term_stats):
            entry = dict(term_stats[term])
            if want_stats:
                entry["doc_freq"] = reader.doc_freq(path, term)
            block["terms"][term] = entry
        tv[path] = block
    return {"_index": index, "_id": doc_id, "found": True,
            "took": 0, "term_vectors": tv}


def register(controller: RestController, node) -> None:

    def do_field_caps(req: RestRequest):
        fields = req.params.get("fields")
        if fields is None and isinstance(req.body, dict):
            f = req.body.get("fields")
            fields = ",".join(f) if isinstance(f, list) else f
        return 200, field_caps(node, req.param("index"), fields)

    def do_validate(req: RestRequest):
        explain = str(req.params.get("explain", "false")).lower() == "true"
        return 200, validate_query(node, req.param("index"),
                                   req.body or {}, explain)

    def do_explain(req: RestRequest):
        return 200, explain_doc(node, req.param("index"), req.param("id"),
                                req.body or {}, req.params)

    def do_termvectors(req: RestRequest):
        return 200, termvectors(node, req.param("index"), req.param("id"),
                                req.body or {}, req.params)

    for method in ("GET", "POST"):
        controller.register(method, "/_field_caps", do_field_caps)
        controller.register(method, "/{index}/_field_caps", do_field_caps)
        controller.register(method, "/_validate/query", do_validate)
        controller.register(method, "/{index}/_validate/query", do_validate)
        controller.register(method, "/{index}/_explain/{id}", do_explain)
        controller.register(method, "/{index}/_termvectors/{id}",
                            do_termvectors)
