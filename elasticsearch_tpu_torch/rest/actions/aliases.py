"""Alias REST actions: put, delete, the ``_aliases`` actions, get and
head.

Copy of the reference's ``rest/actions/aliases.py`` for one node. An
alias maps to indices, each with optional props: a ``filter`` (a query
that joins every search through the alias as a filter clause) and
``is_write_index`` (where writes through a multi-index alias land).
"""

from __future__ import annotations

import fnmatch
from typing import Any, Dict, List

from elasticsearch_tpu_torch.common.errors import (IllegalArgumentException,
                                                   ResourceNotFoundException)
from elasticsearch_tpu_torch.indices.service import parse_alias_action
from elasticsearch_tpu_torch.rest.controller import RestController, RestRequest


def apply_actions(node, actions: List[dict]) -> None:
    """Apply `_aliases` actions in order; an index expression with a
    wildcard expands over the node's indices."""
    for action in actions:
        kind, idx_expr, alias, props = parse_alias_action(action)
        matched = ([n for n in node.indices.indices
                    if fnmatch.fnmatchcase(n, idx_expr)]
                   if ("*" in idx_expr or "?" in idx_expr)
                   else [idx_expr])
        for name in matched:
            if kind == "add":
                node.indices.put_alias(name, alias, props)
            else:
                node.indices.delete_alias(name, alias)


def register(controller: RestController, node) -> None:

    def put_alias(req: RestRequest):
        body = req.body or {}
        spec = {"index": req.param("index"), "alias": req.param("name")}
        if body.get("filter") is not None:
            spec["filter"] = body["filter"]
        if body.get("is_write_index"):
            spec["is_write_index"] = True
        apply_actions(node, [{"add": spec}])
        return 200, {"acknowledged": True}

    def delete_alias(req: RestRequest):
        apply_actions(node, [{"remove": {"index": req.param("index"),
                                         "alias": req.param("name")}}])
        return 200, {"acknowledged": True}

    def update_aliases(req: RestRequest):
        actions = (req.body or {}).get("actions")
        if not isinstance(actions, list) or not actions:
            raise IllegalArgumentException("[aliases] requires [actions]")
        apply_actions(node, actions)
        return 200, {"acknowledged": True}

    def get_aliases(req: RestRequest):
        want_alias = req.param("name")
        want_index = req.param("index")
        out: Dict[str, Dict[str, Any]] = {}
        for alias, targets in node.indices.aliases.items():
            if want_alias and not fnmatch.fnmatchcase(alias, want_alias):
                continue
            for index, props in targets.items():
                if want_index and index != want_index:
                    continue
                out.setdefault(index, {"aliases": {}})["aliases"][
                    alias] = props
        if want_alias and not out and "*" not in want_alias:
            raise ResourceNotFoundException(
                f"alias [{want_alias}] missing")
        if not want_alias:
            # every index appears, aliased or not
            for n in sorted(node.indices.indices):
                if not want_index or n == want_index:
                    out.setdefault(n, {"aliases": {}})
        return 200, out

    def head_alias(req: RestRequest):
        found = any(fnmatch.fnmatchcase(a, req.param("name"))
                    for a in node.indices.aliases)
        return (200, {}) if found else (404, {})

    for method in ("PUT", "POST"):
        controller.register(method, "/{index}/_alias/{name}", put_alias)
    controller.register("PUT", "/{index}/_aliases/{name}", put_alias)
    controller.register("DELETE", "/{index}/_alias/{name}", delete_alias)
    controller.register("DELETE", "/{index}/_aliases/{name}", delete_alias)
    controller.register("POST", "/_aliases", update_aliases)
    controller.register("GET", "/_alias", get_aliases)
    controller.register("GET", "/_alias/{name}", get_aliases)
    controller.register("GET", "/{index}/_alias", get_aliases)
    controller.register("GET", "/{index}/_alias/{name}", get_aliases)
    controller.register("HEAD", "/_alias/{name}", head_alias)
