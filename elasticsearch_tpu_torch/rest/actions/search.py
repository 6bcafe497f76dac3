"""Search, count, multi-search and analyze REST actions.

Copy of the reference's ``rest/actions/search.py`` for one node:
``_search`` (the coordinator picks the kernel path or the planner),
``_count`` (the query phase at size 0 on the node's first device),
``_msearch`` (NDJSON header/body pairs, each item through the same
search function as ``_search``, one after another as in the reference;
a failed item is its own error body with its status) and ``_analyze``
(the built-in analyzers, an index's own registry, a field's analyzer).
Scroll, PIT and ``_rank_eval`` need the reader contexts and the ranking
evaluation, which are not ported yet: they are refused typed
(``NotLowerable``), as the coordinator refuses the other planner
features it lacks.
"""

from __future__ import annotations

import json

from elasticsearch_tpu_torch.analysis import AnalysisRegistry
from elasticsearch_tpu_torch.common.errors import (IllegalArgumentException,
                                                   NotLowerable)
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.rest.controller import (RestController,
                                                     RestRequest, error_body,
                                                     error_status)
from elasticsearch_tpu_torch.search import coordinator


def register(controller: RestController, node) -> None:
    indices = node.indices

    def execute_search(index, body, params):
        """One search request, shared by _search and _msearch so that an
        item's body never drops a key."""
        if "_knn_docs" in body:
            raise IllegalArgumentException(
                "unknown search body keys ['_knn_docs']")
        if "pit" in body:
            raise NotLowerable("a point-in-time search")
        return coordinator.search(indices, index, body, params,
                                  node.gpu_search)

    def do_search(req: RestRequest):
        body = req.body or {}
        if not isinstance(body, dict):
            raise IllegalArgumentException("request body must be an object")
        if req.params.get("scroll"):
            raise NotLowerable("a scroll search")
        return 200, execute_search(req.param("index"), body, req.params)

    def refuse(what):
        def handler(req: RestRequest):
            raise NotLowerable(what)
        return handler

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
            controller.register(method, path, refuse("a scroll search"))
        for path in ("/_rank_eval", "/{index}/_rank_eval"):
            controller.register(method, path,
                                refuse("the ranking evaluation API"))
    for path in ("/_search/scroll", "/_search/scroll/{scroll_id}"):
        controller.register("DELETE", path, refuse("a scroll search"))
    controller.register("POST", "/{index}/_pit",
                        refuse("a point-in-time search"))
    controller.register("DELETE", "/_pit", refuse("a point-in-time search"))
