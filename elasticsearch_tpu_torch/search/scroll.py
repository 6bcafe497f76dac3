"""Scroll and point-in-time searches over pinned contexts.

Copy of the reference's ``search/scroll.py`` (RestSearchScrollAction,
RestClearScrollAction, RestOpenPointInTimeAction) for one node:
`_scroll_id` in every scroll response, pages that end with an empty
hits array, `num_freed` from a clear, PIT bodies naming the context
(`"pit": {"id"}`) with `pit_id` echoed, and a context a stable
snapshot, so that writes after it opened never change what it returns.
Every page is the planner path over the pinned readers
(``coordinator.search(..., pinned=...)``) on the device the caller
names. A sorted scroll pages by an internal search_after cursor with
`_doc` appended as its tiebreak; an unsorted one by from/size.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from elasticsearch_tpu_torch.common.errors import IllegalArgumentException
from elasticsearch_tpu_torch.search import coordinator
from elasticsearch_tpu_torch.search.contexts import parse_keep_alive


# ----------------------------------------------------------------------
# scroll
# ----------------------------------------------------------------------

def start_scroll(node, index_expr: Optional[str], body: Dict[str, Any],
                 params: Dict[str, str]) -> Dict[str, Any]:
    keep_alive = parse_keep_alive(params["scroll"], "scroll")
    names = coordinator.resolve_indices(node.indices, index_expr)
    size = int(params.get("size", (body or {}).get("size", 10)))
    ctx = node.search_contexts.create(
        node.indices, index_expr, keep_alive, names=names,
        scroll_state={"body": dict(body or {}), "params": dict(params),
                      "offset": 0, "size": size, "cursor": None})
    return _scroll_execute(node, ctx)


def next_page(node, scroll_id: str,
              keep_alive: Optional[str] = None) -> Dict[str, Any]:
    ctx = node.search_contexts.get(scroll_id)
    if ctx.scroll_state is None:
        raise IllegalArgumentException(
            f"context [{scroll_id}] is a point-in-time, not a scroll")
    ctx.touch(parse_keep_alive(keep_alive, "scroll")
              if keep_alive else None)
    return _scroll_execute(node, ctx)


def _scroll_execute(node, ctx) -> Dict[str, Any]:
    state = ctx.scroll_state
    body = dict(state["body"])
    size = state["size"]
    body["size"] = size
    sorted_scroll = bool(body.get("sort"))
    appended_tiebreak = False
    if sorted_scroll:
        # sorted scrolls page via an internal search_after cursor over
        # the pinned snapshot: each page is O(size) per shard, not
        # O(offset+size) — sort by _doc for the cheapest deep scroll,
        # exactly the reference's guidance.
        # The cursor needs a per-doc tiebreaker or boundary TIES would
        # be skipped (strictly-after semantics): append an internal
        # _doc spec (shard-unique global ordinal) unless one is present,
        # and strip its value from the response hits.
        sort_spec = body["sort"]
        if not isinstance(sort_spec, list):
            sort_spec = [sort_spec]
        def _field_of(entry):
            return entry if isinstance(entry, str) \
                else next(iter(entry), None)
        if all(_field_of(e) != "_doc" for e in sort_spec):
            sort_spec = list(sort_spec) + ["_doc"]
            appended_tiebreak = True
        body["sort"] = sort_spec
        body["from"] = 0
        if state.get("cursor") is not None:
            body["search_after"] = state["cursor"]
    else:
        # score-ordered scroll (no sort): from/size re-pagination over
        # the snapshot — correct, but deep scrolls re-collect the
        # consumed prefix; sort by _doc to avoid that
        body["from"] = state["offset"]
    params = {k: v for k, v in state["params"].items()
              if k not in ("scroll", "size", "from")}
    out = coordinator.search(node.indices, None, body, params,
                             node.gpu_search, pinned=ctx.readers,
                             names_override=ctx.names)
    hits = out["hits"]["hits"]
    if out.get("timed_out"):
        # a partial page must not consume the cursor: the client retries
        # the same window instead of silently skipping unvisited shards
        pass
    elif sorted_scroll:
        if hits:
            state["cursor"] = hits[-1].get("sort")
    else:
        state["offset"] = state["offset"] + len(hits)
    if appended_tiebreak:
        # the internal tiebreaker is not part of the user's sort — keep
        # the response shape reference-faithful
        for h in hits:
            if isinstance(h.get("sort"), list) and h["sort"]:
                h["sort"] = h["sort"][:-1]
    out["_scroll_id"] = ctx.id
    return out


def clear(node, ids: Optional[List[str]]) -> Dict[str, Any]:
    if not ids or ids == ["_all"]:
        freed = node.search_contexts.free_all(scroll_only=True)
    else:
        freed = sum(1 for i in ids
                    if node.search_contexts.free(i, kind="scroll"))
    return {"succeeded": True, "num_freed": freed}


# ----------------------------------------------------------------------
# point-in-time
# ----------------------------------------------------------------------

def open_pit(node, index_expr: Optional[str],
             keep_alive: str) -> Dict[str, Any]:
    seconds = parse_keep_alive(keep_alive, "open_point_in_time")
    names = coordinator.resolve_indices(node.indices, index_expr)
    ctx = node.search_contexts.create(node.indices, index_expr, seconds,
                                      names=names)
    return {"id": ctx.id}


def search_pit(node, body: Dict[str, Any],
               params: Dict[str, str]) -> Dict[str, Any]:
    pit = body.get("pit") or {}
    pit_id = pit.get("id")
    if not pit_id:
        raise IllegalArgumentException("[pit] requires [id]")
    ctx = node.search_contexts.get(pit_id)
    if ctx.scroll_state is not None:
        raise IllegalArgumentException(
            f"context [{pit_id}] is a scroll, not a point-in-time")
    if pit.get("keep_alive"):
        ctx.touch(parse_keep_alive(pit["keep_alive"], "pit"))
    else:
        ctx.touch()
    body = {k: v for k, v in body.items() if k != "pit"}
    out = coordinator.search(node.indices, None, body, params,
                             node.gpu_search, pinned=ctx.readers,
                             names_override=ctx.names)
    out["pit_id"] = ctx.id
    return out


def close_pit(node, pit_id: str) -> Dict[str, Any]:
    freed = node.search_contexts.free(pit_id, kind="pit")
    return {"succeeded": freed, "num_freed": 1 if freed else 0}
