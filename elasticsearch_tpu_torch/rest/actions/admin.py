"""Index administration REST actions: create, delete, get and head an
index, close and open, rollover, shrink and split, mappings, settings,
refresh, flush, force merge and ``_stats``.

Copy of the reference's ``rest/actions/admin.py`` for one node (no
cluster mode). Deleting or closing an index drops its resident packs,
their ``hbm`` breaker charge and their batcher queues; opening it builds
a pack from the new readers at its first search.
"""

from __future__ import annotations

from elasticsearch_tpu_torch import lifecycle
from elasticsearch_tpu_torch.common.errors import IndexNotFoundException
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.indices.service import IndexService
from elasticsearch_tpu_torch.rest.controller import RestController, RestRequest
from elasticsearch_tpu_torch.search.coordinator import (
    resolve_concrete_indices, resolve_indices)


def register(controller: RestController, node) -> None:
    indices = node.indices

    def create_index(req: RestRequest):
        body = req.body or {}
        mappings = body.get("mappings")
        name = req.param("index")
        node.create_index(name, Settings(
            Settings.normalize_index_settings(body.get("settings"))),
            mappings)
        return 200, {"acknowledged": True, "shards_acknowledged": True,
                     "index": name}

    def delete_index(req: RestRequest):
        for name in resolve_concrete_indices(indices, req.param("index")):
            indices.delete_index(name)
            node.gpu_search.invalidate_index(name)
        return 200, {"acknowledged": True}

    def close_index(req: RestRequest):
        closed = {}
        for name in resolve_concrete_indices(indices, req.param("index")):
            indices.close_index(name)
            closed[name] = {"closed": True}
            node.gpu_search.invalidate_index(name)
        return 200, {"acknowledged": True, "shards_acknowledged": True,
                     "indices": closed}

    def open_index(req: RestRequest):
        for name in resolve_concrete_indices(indices, req.param("index")):
            indices.open_index(name)
        return 200, {"acknowledged": True, "shards_acknowledged": True}

    def rollover(req: RestRequest):
        return 200, lifecycle.rollover(
            node, req.param("index"), req.body,
            new_index=req.param("new_index") or None,
            dry_run=req.param("dry_run") in ("", "true"))

    def shrink_index(req: RestRequest):
        return 200, lifecycle.shrink(node, req.param("index"),
                                     req.param("target"), req.body)

    def split_index(req: RestRequest):
        return 200, lifecycle.split(node, req.param("index"),
                                    req.param("target"), req.body)

    def get_index(req: RestRequest):
        out = {}
        for name in resolve_indices(indices, req.param("index")):
            svc = indices.index(name)
            out[name] = {
                "aliases": {a: p for a, tgts in indices.aliases.items()
                            for i, p in tgts.items() if i == name},
                "mappings": svc.mapper.to_mapping(),
                "settings": {"index": {
                    "number_of_shards": str(svc.num_shards),
                    "number_of_replicas": str(svc.num_replicas),
                    "uuid": svc.index_uuid,
                    **{k[len("index."):]: v for k, v in
                       svc.settings.get_as_dict().items()
                       if k.startswith("index.") and k not in
                       ("index.number_of_shards", "index.number_of_replicas")},
                }},
            }
        if not out:
            raise IndexNotFoundException(
                f"no such index [{req.param('index')}]")
        return 200, out

    def head_index(req: RestRequest):
        names = resolve_indices(indices, req.param("index"))
        return (200, {}) if names else (404, {})

    def put_mapping(req: RestRequest):
        for name in resolve_indices(indices, req.param("index")):
            indices.index(name).mapper.merge(req.body or {})
            # lowered plans key on the mapping generation: purge the
            # entries it made unreachable (a new field's first search
            # builds its own (index, field) pack)
            node.gpu_search.invalidate_plans(name)
        indices.persist_metadata()
        return 200, {"acknowledged": True}

    def get_mapping(req: RestRequest):
        return 200, {name: {"mappings": indices.index(name).mapper
                            .to_mapping()}
                     for name in resolve_indices(indices,
                                                 req.param("index"))}

    def put_settings(req: RestRequest):
        body = req.body or {}
        # {"index": {...}}, {"settings": {...}} and flat dotted keys
        changes = Settings.normalize_index_settings(
            body.get("settings", body))
        IndexService.validate_dynamic_settings(changes)
        for name in resolve_indices(indices, req.param("index")):
            indices.index(name).apply_dynamic_settings(changes)
        indices.persist_metadata()
        return 200, {"acknowledged": True}

    def get_settings(req: RestRequest):
        out = {}
        for name in resolve_indices(indices, req.param("index")):
            svc = indices.index(name)
            out[name] = {"settings": {"index": {
                "number_of_shards": str(svc.num_shards),
                "number_of_replicas": str(svc.num_replicas),
                "uuid": svc.index_uuid}}}
        return 200, out

    def broadcast(op):
        def handler(req: RestRequest):
            n = 0
            for name in resolve_indices(indices, req.param("index")):
                svc = indices.index(name)
                getattr(svc, op)()
                n += svc.num_shards
            return 200, {"_shards": {"total": n, "successful": n,
                                     "failed": 0}}
        return handler

    def forcemerge(req: RestRequest):
        n = 0
        for name in resolve_indices(indices, req.param("index")):
            svc = indices.index(name)
            for shard in svc.shards.values():
                shard.engine.force_merge()
                n += 1
        return 200, {"_shards": {"total": n, "successful": n, "failed": 0}}

    def index_stats(req: RestRequest):
        names = resolve_indices(indices, req.param("index"))
        out_indices = {}
        total_docs = 0
        total_segments = 0
        for name in names:
            st = indices.index(name).stats()
            total_docs += st["docs"]["count"]
            segs = sum(p["segments"] for p in st["per_shard"])
            total_segments += segs
            out_indices[name] = {
                "primaries": {"docs": {"count": st["docs"]["count"]},
                              "segments": {"count": segs}},
                "total": {"docs": {"count": st["docs"]["count"]},
                          "segments": {"count": segs}},
            }
        return 200, {
            "_shards": {"total": sum(indices.index(n).num_shards
                                     for n in names)},
            "_all": {"primaries": {"docs": {"count": total_docs},
                                   "segments": {"count": total_segments}}},
            "indices": out_indices,
        }

    refresh, flush = broadcast("refresh"), broadcast("flush")
    controller.register("PUT", "/{index}", create_index)
    controller.register("DELETE", "/{index}", delete_index)
    controller.register("GET", "/{index}", get_index)
    controller.register("HEAD", "/{index}", head_index)
    controller.register("POST", "/{index}/_close", close_index)
    controller.register("POST", "/{index}/_open", open_index)
    controller.register("POST", "/{index}/_rollover", rollover)
    controller.register("POST", "/{index}/_rollover/{new_index}", rollover)
    for method in ("PUT", "POST"):
        controller.register(method, "/{index}/_shrink/{target}",
                            shrink_index)
        controller.register(method, "/{index}/_split/{target}", split_index)
    controller.register("PUT", "/{index}/_mapping", put_mapping)
    controller.register("GET", "/{index}/_mapping", get_mapping)
    controller.register("GET", "/_mapping", get_mapping)
    controller.register("GET", "/{index}/_settings", get_settings)
    controller.register("GET", "/_settings", get_settings)
    controller.register("PUT", "/{index}/_settings", put_settings)
    controller.register("POST", "/{index}/_refresh", refresh)
    controller.register("POST", "/_refresh", refresh)
    controller.register("GET", "/{index}/_refresh", refresh)
    controller.register("POST", "/{index}/_flush", flush)
    controller.register("POST", "/_flush", flush)
    controller.register("POST", "/{index}/_forcemerge", forcemerge)
    controller.register("GET", "/{index}/_stats", index_stats)
    controller.register("GET", "/_stats", index_stats)
