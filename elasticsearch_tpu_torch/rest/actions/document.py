"""Document CRUD + bulk REST actions.

Copy of the reference's ``rest/actions/document.py`` for ``PUT``/``POST
/{index}/_doc/{id}``, ``POST /{index}/_doc``, ``GET`` and ``DELETE
/{index}/_doc/{id}``, ``_create/{id}`` (a 409 on an existing id),
``_update/{id}`` (the doc merge, ``doc_as_upsert``, ``upsert``, and a
script: ``ctx._source`` mutation, ``ctx.op`` noop or delete,
``scripted_upsert``), ``_mget`` and ``_bulk`` with index, create, delete
and update ops (an update merges its ``doc`` into the stored source,
upserts it with ``doc_as_upsert``, or runs its script). Scripts run on
the script module's scalar interpreter (``script/__init__.py``). The
bulk body is NDJSON action/metadata lines as in the
reference; maximal runs of plain index ops group per shard and apply
through the engine's batched path, the shards of a run on a thread pool
(each shard's ops stay in request order, so doc ordinals — and with them
the tie order of equal scores — are the reference's). Left out: cluster
routing, indexing pressure, ingest pipelines, ``_reindex`` and the
by-query APIs.
"""

from __future__ import annotations

import copy
import json
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from elasticsearch_tpu_torch.common.errors import (DocumentMissingException,
                                                   EsException,
                                                   IllegalArgumentException)
from elasticsearch_tpu_torch.rest.controller import (RestController,
                                                     RestRequest,
                                                     error_status)
from elasticsearch_tpu_torch.script import ScriptException, compile_script


def _auto_id() -> str:
    return uuid.uuid4().hex[:20]


def _refuse_pipeline(pipeline: Optional[str]) -> None:
    if pipeline:
        raise IllegalArgumentException(
            f"ingest pipeline [{pipeline}]: ingest pipelines are not "
            f"ported yet")


def _apply_refresh(node, shard, params, seq_no: int) -> None:
    """refresh= on a single-doc write: searchable when the call returns.
    ``wait_for`` waits on the shard's visibility checkpoint while the
    node's refresh cycle runs, and refreshes itself when none runs or
    the wait times out; ``true`` (or a bare ``refresh``) refreshes."""
    refresh = params.get("refresh")
    if refresh not in ("", "true", "wait_for"):
        return
    if refresh == "wait_for" and getattr(node, "refresher_active", False):
        if shard.wait_for_visible(seq_no):
            return
    shard.refresh()


def exec_index_doc(node, index: str, doc_id: Optional[str], body, params,
                   op_type: str = "index") -> Tuple[int, Dict]:
    if not isinstance(body, dict):
        raise IllegalArgumentException("request body is required")
    _refuse_pipeline(params.get("pipeline"))
    index = node.indices.resolve_write_index(index)
    svc = node.get_or_autocreate_index(index)
    svc.check_write_block()
    created_id = doc_id or _auto_id()
    shard = svc.shard(svc.shard_for_id(created_id, params.get("routing")))
    kwargs = {"op_type": op_type} if op_type != "index" else {}
    if params.get("if_seq_no") is not None:
        kwargs["if_seq_no"] = int(params["if_seq_no"])
    if params.get("if_primary_term") is not None:
        kwargs["if_primary_term"] = int(params["if_primary_term"])
    if params.get("version") is not None:
        kwargs["version"] = int(params["version"])
        kwargs["version_type"] = params.get("version_type", "internal")
    result = shard.apply_index_on_primary(created_id, body, **kwargs)
    _apply_refresh(node, shard, params, result.seq_no)
    status = 201 if result.created else 200
    return status, {
        "_index": index, "_id": result.doc_id,
        "_version": result.version, "result": result.result,
        "_seq_no": result.seq_no, "_primary_term": result.primary_term,
        "_shards": {"total": 1, "successful": 1, "failed": 0},
    }


def exec_get_doc(node, index: str, doc_id: str, params) -> Tuple[int, Dict]:
    index = node.indices.resolve_write_index(index)
    svc = node.indices.index(index)
    shard = svc.shard(svc.shard_for_id(doc_id, params.get("routing")))
    got = shard.get(doc_id)
    if got is None:
        return 404, {"_index": index, "_id": doc_id, "found": False}
    got["_index"] = index
    return 200, got


def exec_delete_doc(node, index: str, doc_id: str, params
                    ) -> Tuple[int, Dict]:
    index = node.indices.resolve_write_index(index)
    svc = node.indices.index(index)
    svc.check_write_block()
    shard = svc.shard(svc.shard_for_id(doc_id, params.get("routing")))
    result = shard.apply_delete_on_primary(doc_id)
    _apply_refresh(node, shard, params, result.seq_no)
    if not result.found:
        return 404, {"_index": index, "_id": doc_id,
                     "result": "not_found", "_version": result.version,
                     "_seq_no": result.seq_no,
                     "_primary_term": result.primary_term}
    return 200, {"_index": index, "_id": doc_id,
                 "result": "deleted", "_version": result.version,
                 "_seq_no": result.seq_no,
                 "_primary_term": result.primary_term,
                 "_shards": {"total": 1, "successful": 1, "failed": 0}}


def run_update_script(script, source: Dict[str, Any],
                      *, op: str = "index") -> Tuple[str, Dict[str, Any]]:
    """Run an update script on a `ctx` holding a copy of `_source` and
    `op` (the reference's UpdateHelper) → (op, new source), op one of
    index, none, delete, create."""
    ctx = {"_source": copy.deepcopy(source), "op": op,
           "_now": int(time.time() * 1000)}
    try:
        script.execute({"ctx": ctx})
    except ScriptException as e:
        raise IllegalArgumentException(
            f"failed to execute script: "
            f"{e.args[0] if e.args else e}") from None
    out_op = ctx.get("op", "index")
    if out_op in ("noop", "none"):
        out_op = "none"
    elif out_op not in ("index", "delete", "create"):
        raise IllegalArgumentException(
            f"Operation type [{out_op}] not allowed, only "
            f"[create, index, noop, delete] are allowed")
    new_source = ctx.get("_source")
    if not isinstance(new_source, dict):
        raise IllegalArgumentException(
            "update script removed [ctx._source]")
    return out_op, new_source


def _compile_update_script(body: Dict[str, Any]):
    """The body's script compiled, or None without one; a script beside
    a doc, or one that does not compile, is a 400."""
    if "script" not in body:
        return None
    if body.get("doc") is not None:
        raise IllegalArgumentException(
            "Validation Failed: can't provide both script and doc")
    try:
        return compile_script(body["script"])
    except ScriptException as e:
        raise IllegalArgumentException(
            str(e.args[0] if e.args else e)) from None


def exec_update_doc(node, index: str, doc_id: str, body, params
                    ) -> Tuple[int, Dict]:
    """_update: the doc merge (a merge that changes nothing is a noop,
    detect_noop being on by default), doc_as_upsert, upsert, and a
    script (ctx._source mutation, ctx.op noop or delete,
    scripted_upsert)."""
    index = node.indices.resolve_write_index(index)
    svc = node.indices.index(index)
    svc.check_write_block()
    shard = svc.shard(svc.shard_for_id(doc_id, params.get("routing")))
    body = body or {}
    partial = body.get("doc")
    script = _compile_update_script(body)
    if partial is None and script is None:
        raise IllegalArgumentException(
            "Validation Failed: script or doc is missing")
    existing = shard.get(doc_id)
    if existing is None:
        if script is not None:
            if "upsert" not in body:
                raise DocumentMissingException(
                    f"[{doc_id}]: document missing")
            base = body["upsert"]
            if body.get("scripted_upsert"):
                op, merged = run_update_script(script, base, op="create")
                if op == "delete":   # deleting a doc that never existed
                    op = "none"
            else:
                op, merged = "index", base
        elif body.get("doc_as_upsert"):
            op, merged = "index", partial
        elif "upsert" in body:
            op, merged = "index", body["upsert"]
        else:
            raise DocumentMissingException(f"[{doc_id}]: document missing")
    else:
        base = dict(existing["_source"] or {})
        if script is not None:
            op, merged = run_update_script(script, base)
        else:
            merged = _deep_merge(base, partial)
            op = "none" if (body.get("detect_noop", True)
                            and merged == base) else "index"
    if op == "none":
        return 200, {"_index": index, "_id": doc_id,
                     "_version": (existing or {}).get("_version", 1),
                     "result": "noop",
                     "_shards": {"total": 0, "successful": 0,
                                 "failed": 0}}
    if op == "delete":
        result = shard.apply_delete_on_primary(doc_id)
        _apply_refresh(node, shard, params, result.seq_no)
        return 200, {"_index": index, "_id": doc_id,
                     "_version": result.version, "result": "deleted",
                     "_seq_no": result.seq_no,
                     "_primary_term": result.primary_term}
    result = shard.apply_index_on_primary(doc_id, merged)
    _apply_refresh(node, shard, params, result.seq_no)
    return 200, {"_index": index, "_id": doc_id,
                 "_version": result.version, "result": result.result,
                 "_seq_no": result.seq_no,
                 "_primary_term": result.primary_term}


# ----------------------------------------------------------------------
# bulk: parse NDJSON → op list; apply list locally; REST reassembles
# ----------------------------------------------------------------------

def parse_bulk_body(raw: str, default_index: Optional[str]
                    ) -> List[Dict[str, Any]]:
    """NDJSON → [{op, index, id, routing, source}] with the reference's
    validation errors."""
    lines = [ln for ln in raw.split("\n") if ln.strip()]
    ops: List[Dict[str, Any]] = []
    i = 0
    while i < len(lines):
        try:
            action_line = json.loads(lines[i])
        except json.JSONDecodeError as e:
            raise IllegalArgumentException(
                f"Malformed action/metadata line [{i + 1}]: {e}")
        if len(action_line) != 1:
            raise IllegalArgumentException(
                f"Malformed action/metadata line [{i + 1}]")
        op, meta = next(iter(action_line.items()))
        if op not in ("index", "create", "delete", "update"):
            raise IllegalArgumentException(f"Unknown bulk action [{op}]")
        _refuse_pipeline(meta.get("pipeline"))
        index = meta.get("_index", default_index)
        doc_id = meta.get("_id")
        i += 1
        source = None
        if op != "delete":
            if i >= len(lines):
                raise IllegalArgumentException(
                    "Validation Failed: bulk source line missing")
            source = json.loads(lines[i])
            i += 1
        ops.append({"op": op, "index": index,
                    "id": doc_id or _auto_id(),
                    "routing": meta.get("routing"), "source": source})
    return ops


def apply_bulk_ops(node, ops: List[Dict[str, Any]], *,
                   refresh: bool = False,
                   wait_for: bool = False) -> List[Dict[str, Any]]:
    """Apply parsed bulk ops against the node's shards; returns response
    items in op order. Per-op failures become error items, never
    exceptions. Maximal runs of plain index ops group per shard and apply
    through the engine's batched path (one lock + one translog append per
    (shard, run), analysis outside the lock); runs keep the total op
    order, so mixed sequences on one _id keep their semantics. With
    `refresh`, each written shard is searchable on return: under
    `wait_for` (and a running refresh cycle) by waiting until its
    visibility checkpoint covers its local checkpoint."""
    items: List[Optional[Dict[str, Any]]] = [None] * len(ops)
    refresh_shards = set()
    i = 0
    while i < len(ops):
        if ops[i]["op"] == "index":
            j = i
            while j < len(ops) and ops[j]["op"] == "index":
                j += 1
            _apply_index_run(node, ops, range(i, j), items, refresh_shards)
            i = j
        else:
            items[i] = _apply_one_op(node, ops[i], refresh_shards)
            i += 1
    if refresh:
        for shard in refresh_shards:
            if wait_for and getattr(node, "refresher_active", False):
                if shard.wait_for_visible(shard.local_checkpoint):
                    continue
            shard.refresh()
    return items  # type: ignore[return-value]


def _resolve_target(node, entry: Dict[str, Any]):
    """(concrete index, IndexService, shard number) of one bulk op."""
    index = entry["index"]
    if index is None:
        raise IllegalArgumentException("_index is missing")
    index = node.indices.resolve_write_index(index)
    svc = node.get_or_autocreate_index(index)
    svc.check_write_block()
    return index, svc, svc.shard_for_id(entry["id"], entry.get("routing"))


def _apply_index_run(node, ops, positions, items, refresh_shards) -> None:
    """Apply a run of plain index ops grouped per (index, shard) through
    the engine bulk path; fill `items` at each op's position."""
    groups: Dict[Any, List[int]] = {}
    for pos in positions:
        entry = ops[pos]
        try:
            index, svc, shard_num = _resolve_target(node, entry)
            groups.setdefault((index, shard_num), []).append(pos)
        except EsException as exc:
            items[pos] = _bulk_error_item("index", entry["index"],
                                          entry["id"], exc)

    # shard bulks apply concurrently (engine locks are per shard; the
    # tokenizer runs C code that releases the interpreter lock)
    def run_group(item):
        (index, shard_num), poss = item
        try:
            shard = node.indices.index(index).shard(shard_num)
            docs = [(ops[p]["id"], ops[p]["source"]) for p in poss]
            return shard, shard.apply_bulk_index_on_primary(docs)
        except EsException as exc:
            return None, exc

    group_items = list(groups.items())
    if len(group_items) > 1:
        outs = list(node.bulk_executor().map(run_group, group_items))
    else:
        outs = [run_group(g) for g in group_items]
    for ((index, shard_num), poss), (shard, results) in zip(group_items,
                                                            outs):
        if shard is None:
            for p in poss:
                items[p] = _bulk_error_item("index", index, ops[p]["id"],
                                            results)
            continue
        refresh_shards.add(shard)
        for p, r in zip(poss, results):
            the_id = ops[p]["id"]
            if isinstance(r, Exception):
                if not isinstance(r, EsException):
                    raise r
                items[p] = _bulk_error_item("index", index, the_id, r)
                continue
            items[p] = {"index": {
                "_index": index, "_id": the_id, "_version": r.version,
                "result": r.result, "_seq_no": r.seq_no,
                "_primary_term": r.primary_term,
                "status": 201 if r.created else 200}}


def _bulk_error_item(op, index, the_id, exc) -> Dict[str, Any]:
    return {op: {
        "_index": index, "_id": the_id, "status": error_status(exc),
        "error": {"type": type(exc).__name__, "reason": str(exc)}}}


def _apply_one_op(node, entry: Dict[str, Any],
                  refresh_shards) -> Dict[str, Any]:
    """Apply one delete, update or create op."""
    op, index, the_id = entry["op"], entry["index"], entry["id"]
    try:
        index, svc, shard_num = _resolve_target(node, entry)
        shard = svc.shard(shard_num)
        if op == "delete":
            r = shard.apply_delete_on_primary(the_id)
            refresh_shards.add(shard)
            return {"delete": {
                "_index": index, "_id": the_id, "_version": r.version,
                "result": "deleted" if r.found else "not_found",
                "_seq_no": r.seq_no, "_primary_term": r.primary_term,
                "status": 200 if r.found else 404}}
        if op == "update":
            body = entry["source"] or {}
            script = _compile_update_script(body)
            existing = shard.get(the_id)
            if existing is None and not body.get("doc_as_upsert"):
                raise DocumentMissingException(
                    f"[{the_id}]: document missing")
            base = dict((existing or {}).get("_source") or {})
            if script is not None:
                upd_op, merged = run_update_script(script, base)
            else:
                upd_op, merged = "index", _deep_merge(base,
                                                      body.get("doc") or {})
            if upd_op == "none":
                return {"update": {
                    "_index": index, "_id": the_id,
                    "_version": (existing or {}).get("_version", 1),
                    "result": "noop", "status": 200}}
            if upd_op == "delete":
                r = shard.apply_delete_on_primary(the_id)
                refresh_shards.add(shard)
                return {"update": {
                    "_index": index, "_id": the_id,
                    "_version": r.version, "result": "deleted",
                    "_seq_no": r.seq_no,
                    "_primary_term": r.primary_term, "status": 200}}
            r = shard.apply_index_on_primary(the_id, merged)
            refresh_shards.add(shard)
            return {"update": {
                "_index": index, "_id": the_id, "_version": r.version,
                "result": r.result, "_seq_no": r.seq_no,
                "_primary_term": r.primary_term, "status": 200}}
        r = shard.apply_index_on_primary(the_id, entry["source"],
                                         op_type="create")
        refresh_shards.add(shard)
        return {op: {
            "_index": index, "_id": the_id, "_version": r.version,
            "result": r.result, "_seq_no": r.seq_no,
            "_primary_term": r.primary_term,
            "status": 201 if r.created else 200}}
    except EsException as exc:
        return _bulk_error_item(op, index, the_id, exc)


def _deep_merge(base: dict, update: dict) -> dict:
    """`update` merged into `base`: objects on both sides merge key by
    key, any other value replaces."""
    out = dict(base)
    for k, v in update.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def bulk_has_errors(items: List[Dict[str, Any]]) -> bool:
    return any("error" in next(iter(it.values())) for it in items)


def register(controller: RestController, node) -> None:

    def put_doc(req: RestRequest):
        op_type = ("create" if req.params.get("op_type") == "create"
                   else "index")
        return exec_index_doc(node, req.param("index"), req.param("id"),
                              req.body, req.params, op_type=op_type)

    def create_doc(req: RestRequest):
        """op_type=create: a 409 if the doc exists, decided inside the
        engine's write lock so that concurrent creates serialize."""
        return exec_index_doc(node, req.param("index"), req.param("id"),
                              req.body, req.params, op_type="create")

    def update_doc(req: RestRequest):
        return exec_update_doc(node, req.param("index"), req.param("id"),
                               req.body, req.params)

    def mget(req: RestRequest):
        body = req.body or {}
        docs_spec = body.get("docs")
        default_index = req.param("index")
        if docs_spec is None and "ids" in body:
            docs_spec = [{"_id": i} for i in body["ids"]]
        if docs_spec is None:
            raise IllegalArgumentException("[_mget] requires docs or ids")
        out = []
        for spec in docs_spec:
            index = spec.get("_index", default_index)
            doc_id = spec["_id"]
            try:
                svc = node.indices.index(index)
                got = svc.shard(svc.shard_for_id(doc_id)).get(doc_id)
                if got is not None:
                    got["_index"] = index
            except EsException:
                got = None
            out.append(got if got is not None else
                       {"_index": index, "_id": doc_id, "found": False})
        return 200, {"docs": out}

    def post_doc(req: RestRequest):
        return exec_index_doc(node, req.param("index"), None, req.body,
                              req.params)

    def get_doc(req: RestRequest):
        return exec_get_doc(node, req.param("index"), req.param("id"),
                            req.params)

    def delete_doc(req: RestRequest):
        return exec_delete_doc(node, req.param("index"), req.param("id"),
                               req.params)

    def bulk(req: RestRequest):
        t0 = time.perf_counter()
        raw = req.raw_body.decode("utf-8") if req.raw_body else (
            req.body if isinstance(req.body, str) else "")
        _refuse_pipeline(req.params.get("pipeline"))
        ops = parse_bulk_body(raw, req.param("index"))
        refresh = req.param("refresh") in ("", "true", "wait_for")
        items = apply_bulk_ops(node, ops, refresh=refresh,
                               wait_for=req.param("refresh") == "wait_for")
        return 200, {"took": int((time.perf_counter() - t0) * 1000),
                     "errors": bulk_has_errors(items), "items": items}

    controller.register("PUT", "/{index}/_doc/{id}", put_doc)
    controller.register("POST", "/{index}/_doc/{id}", put_doc)
    controller.register("PUT", "/{index}/_create/{id}", create_doc)
    controller.register("POST", "/{index}/_create/{id}", create_doc)
    controller.register("POST", "/{index}/_doc", post_doc)
    controller.register("GET", "/{index}/_doc/{id}", get_doc)
    controller.register("DELETE", "/{index}/_doc/{id}", delete_doc)
    controller.register("POST", "/{index}/_update/{id}", update_doc)
    controller.register("POST", "/_bulk", bulk)
    controller.register("PUT", "/_bulk", bulk)
    controller.register("POST", "/{index}/_bulk", bulk)
    for method in ("GET", "POST"):
        controller.register(method, "/_mget", mget)
        controller.register(method, "/{index}/_mget", mget)
