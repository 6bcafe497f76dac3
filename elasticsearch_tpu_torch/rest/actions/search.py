"""Search, count, multi-search and analyze REST actions.

Copy of the reference's ``rest/actions/search.py`` for one node:
``_search`` (the coordinator picks the kernel path or the planner; a
``pit`` body searches that context, ``?scroll=`` opens a scroll),
``_search/scroll`` (the next page, or a clear with DELETE), ``_pit``
(open with POST, close with DELETE), ``_count`` (the query phase at
size 0 on the node's first device), ``_msearch`` (NDJSON header/body
pairs, each item through the same search function as ``_search``, one
after another as in the reference; a failed item is its own error body
with its status), ``_rank_eval`` (each rated request through the
coordinator) and ``_analyze`` (the built-in analyzers, an index's own
registry, a field's analyzer).
"""

from __future__ import annotations

import json

from elasticsearch_tpu_torch.analysis import AnalysisRegistry
from elasticsearch_tpu_torch.common.errors import IllegalArgumentException
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.rest.controller import (RestController,
                                                     RestRequest, error_body,
                                                     error_status)
from elasticsearch_tpu_torch.search import coordinator, rank_eval
from elasticsearch_tpu_torch.search import scroll as scroll_mod


def register(controller: RestController, node) -> None:
    indices = node.indices

    def execute_search(index, body, params):
        """One search request, shared by _search and _msearch so that an
        item's body never drops a key."""
        if "_knn_docs" in body:
            raise IllegalArgumentException(
                "unknown search body keys ['_knn_docs']")
        if "pit" in body:
            if not isinstance(body["pit"], dict):
                raise IllegalArgumentException(
                    "[pit] must be an object with an [id]")
            return scroll_mod.search_pit(node, body, params)
        return coordinator.search(indices, index, body, params,
                                  node.gpu_search)

    def do_search(req: RestRequest):
        body = req.body or {}
        if not isinstance(body, dict):
            raise IllegalArgumentException("request body must be an object")
        if req.params.get("scroll"):
            return 200, scroll_mod.start_scroll(node, req.param("index"),
                                                body, req.params)
        return 200, execute_search(req.param("index"), body, req.params)

    def scroll_page(req: RestRequest):
        body = req.body or {}
        scroll_id = (req.param("scroll_id") or body.get("scroll_id")
                     or req.params.get("scroll_id"))
        if not scroll_id:
            raise IllegalArgumentException("[scroll_id] is required")
        keep = body.get("scroll") or req.params.get("scroll")
        return 200, scroll_mod.next_page(node, scroll_id, keep)

    def clear_scroll(req: RestRequest):
        body = req.body or {}
        ids = req.param("scroll_id") or body.get("scroll_id")
        if isinstance(ids, str):
            ids = [ids]
        return 200, scroll_mod.clear(node, ids)

    def open_pit(req: RestRequest):
        keep = req.params.get("keep_alive")
        if not keep:
            raise IllegalArgumentException(
                "[open_point_in_time] requires [keep_alive]")
        return 200, scroll_mod.open_pit(node, req.param("index"), keep)

    def close_pit(req: RestRequest):
        pit_id = (req.body or {}).get("id")
        if not pit_id:
            raise IllegalArgumentException(
                "[close_point_in_time] requires [id]")
        return 200, scroll_mod.close_pit(node, pit_id)

    def do_rank_eval(req: RestRequest):
        index_expr = req.param("index")

        def run(search_body):
            return coordinator.search(indices, index_expr, search_body, {},
                                      node.gpu_search)

        return 200, rank_eval.evaluate(run, req.body or {})

    def do_count(req: RestRequest):
        return 200, coordinator.count(indices, req.param("index"),
                                      req.body or {},
                                      node.gpu_search.mesh.grid[0][0])

    def do_analyze(req: RestRequest):
        body = req.body or {}
        text = body.get("text")
        if text is None:
            raise IllegalArgumentException("[_analyze] requires text")
        texts = text if isinstance(text, list) else [text]
        index = req.param("index")
        analyzer_name = body.get("analyzer", "standard")
        if index and body.get("field"):
            ft = indices.index(index).mapper.field_type(body["field"])
            analyzer = getattr(ft, "analyzer", None)
        elif index:
            # the index's own registry: its index.analysis.* analyzers
            analyzer = indices.index(index).mapper.analyzers.get(
                analyzer_name)
        else:
            analyzer = AnalysisRegistry().build(Settings.EMPTY).get(
                analyzer_name)
        if analyzer is None:
            raise IllegalArgumentException(
                f"failed to find analyzer [{analyzer_name}]")
        tokens = []
        for t in texts:
            # analyze() keeps stacked positions (synonyms, ngrams) and
            # the holes stop words leave
            for tok in analyzer.analyze(str(t)):
                tokens.append({"token": tok.term, "position": tok.position,
                               "type": "<ALPHANUM>"})
        return 200, {"tokens": tokens}

    def do_msearch(req: RestRequest):
        raw = req.raw_body.decode("utf-8", errors="replace") \
            if req.raw_body else (
                req.body if isinstance(req.body, str) else "")
        lines = [ln for ln in raw.split("\n") if ln.strip()]
        if not lines:
            raise IllegalArgumentException(
                "[_msearch] request body or source parameter is "
                "required")
        if len(lines) % 2 != 0:
            raise IllegalArgumentException(
                "[_msearch] expects header/body line pairs")
        responses = []
        default_index = req.param("index")
        for i in range(0, len(lines), 2):
            try:
                header = json.loads(lines[i])
                body = json.loads(lines[i + 1])
                index = header.get("index", default_index)
                if isinstance(index, list):
                    index = ",".join(index)
                item = execute_search(index, body, {})
                item["status"] = 200
            except Exception as exc:  # noqa: BLE001 — per item
                status = error_status(exc)
                item = error_body(exc, status)
                item["status"] = status
            responses.append(item)
        return 200, {"took": sum(r.get("took", 0) for r in responses),
                     "responses": responses}

    for method in ("GET", "POST"):
        controller.register(method, "/_search", do_search)
        controller.register(method, "/{index}/_search", do_search)
        controller.register(method, "/_msearch", do_msearch)
        controller.register(method, "/{index}/_msearch", do_msearch)
        controller.register(method, "/_count", do_count)
        controller.register(method, "/{index}/_count", do_count)
        controller.register(method, "/_analyze", do_analyze)
        controller.register(method, "/{index}/_analyze", do_analyze)
        for path in ("/_search/scroll", "/_search/scroll/{scroll_id}"):
            controller.register(method, path, scroll_page)
        controller.register(method, "/_rank_eval", do_rank_eval)
        controller.register(method, "/{index}/_rank_eval", do_rank_eval)
    for path in ("/_search/scroll", "/_search/scroll/{scroll_id}"):
        controller.register("DELETE", path, clear_scroll)
    controller.register("POST", "/{index}/_pit", open_pit)
    controller.register("DELETE", "/_pit", close_pit)
