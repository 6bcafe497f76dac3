"""The ``_search`` REST action.

Copy of the reference's ``rest/actions/search.py`` for ``GET``/``POST
/_search`` and ``/{index}/_search`` on the kernel path. Scroll and PIT
pin readers that the reference serves on its planner path: they are
refused typed (``NotLowerable``), as the coordinator refuses the other
planner-bound requests.
"""

from __future__ import annotations

from elasticsearch_tpu_torch.common.errors import (IllegalArgumentException,
                                                   NotLowerable)
from elasticsearch_tpu_torch.rest.controller import RestController, RestRequest
from elasticsearch_tpu_torch.search import coordinator


def register(controller: RestController, node) -> None:
    indices = node.indices

    def do_search(req: RestRequest):
        body = req.body or {}
        if not isinstance(body, dict):
            raise IllegalArgumentException("request body must be an object")
        if req.params.get("scroll"):
            raise NotLowerable("a scroll search")
        if "pit" in body:
            raise NotLowerable("a point-in-time search")
        return 200, coordinator.search(indices, req.param("index"), body,
                                       req.params, node.gpu_search)

    controller.register("GET", "/_search", do_search)
    controller.register("POST", "/_search", do_search)
    controller.register("GET", "/{index}/_search", do_search)
    controller.register("POST", "/{index}/_search", do_search)
