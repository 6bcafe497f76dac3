"""Index administration REST actions: create, delete and head an index,
refresh and force merge.

Copy of the reference's ``rest/actions/admin.py`` for those routes (no
cluster mode). Deleting an index drops its resident packs, their ``hbm``
breaker charge and their batcher queues.
"""

from __future__ import annotations

from elasticsearch_tpu_torch.common.settings import Settings
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

    def head_index(req: RestRequest):
        names = resolve_indices(indices, req.param("index"))
        return (200, {}) if names else (404, {})

    def refresh(req: RestRequest):
        n = 0
        for name in resolve_indices(indices, req.param("index")):
            indices.index(name).refresh()
            n += indices.index(name).num_shards
        return 200, {"_shards": {"total": n, "successful": n, "failed": 0}}

    def forcemerge(req: RestRequest):
        n = 0
        for name in resolve_indices(indices, req.param("index")):
            svc = indices.index(name)
            for shard in svc.shards.values():
                shard.engine.force_merge()
                n += 1
        return 200, {"_shards": {"total": n, "successful": n, "failed": 0}}

    controller.register("PUT", "/{index}", create_index)
    controller.register("DELETE", "/{index}", delete_index)
    controller.register("HEAD", "/{index}", head_index)
    controller.register("POST", "/{index}/_refresh", refresh)
    controller.register("POST", "/_refresh", refresh)
    controller.register("GET", "/{index}/_refresh", refresh)
    controller.register("POST", "/{index}/_forcemerge", forcemerge)
