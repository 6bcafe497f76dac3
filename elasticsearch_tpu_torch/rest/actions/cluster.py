"""Cluster-level and ``_cat`` REST actions of one node.

Copy of the single-node branch of the reference's
``rest/actions/cluster.py``: ``_cluster/health`` (green: every shard of
one node is assigned), ``_cluster/stats``, ``_nodes/stats`` (the device
block is ``GpuSearchService.stats()`` under the reference's
``tpu_search`` key, the breakers as the reference places them),
``_cluster/settings``, ``_cluster/state`` and the ``_cat`` tables, which
answer as text. ``_cat/plugins`` and ``_cat/tasks`` wait for the plugin
and task modules and are not registered; the ``_cat`` index lists the
tables this node serves. The node's identity (``GET /``) is in
``root.py``.
"""

from __future__ import annotations

import resource
import time
from typing import Any, List

from elasticsearch_tpu_torch.common.errors import IllegalArgumentException
from elasticsearch_tpu_torch.rest.controller import RestController, RestRequest
from elasticsearch_tpu_torch.search import coordinator
from elasticsearch_tpu_torch.search.coordinator import resolve_indices

#: the tables GET /_cat lists, in the reference's order
CAT_PATHS = ("/_cat/aliases", "/_cat/allocation", "/_cat/count",
             "/_cat/health", "/_cat/indices", "/_cat/master",
             "/_cat/nodes", "/_cat/recovery", "/_cat/shards")


def cat_table(req: RestRequest, headers: List[str], rows: List[List[Any]]):
    """The _cat text table: columns padded to their widest cell, the
    header row with ``v``."""
    if req.param_bool("v"):
        all_rows = [headers] + [[str(c) for c in r] for r in rows]
    else:
        all_rows = [[str(c) for c in r] for r in rows]
    widths = [max((len(r[i]) for r in all_rows), default=0)
              for i in range(len(headers))]
    lines = [" ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
             for r in all_rows]
    return 200, {"_cat": "\n".join(lines) + "\n"}


def register(controller: RestController, node) -> None:
    indices = node.indices

    def n_shards() -> int:
        return sum(svc.num_shards for svc in indices.indices.values())

    def health(req: RestRequest):
        # one node holds every shard: green at once, so wait_for_status
        # has nothing to wait for
        return 200, {
            "cluster_name": node.cluster_name,
            "status": "green",
            "timed_out": False,
            "number_of_nodes": 1,
            "number_of_data_nodes": 1,
            "active_primary_shards": n_shards(),
            "active_shards": n_shards(),
            "relocating_shards": 0,
            "initializing_shards": 0,
            "unassigned_shards": 0,
            "delayed_unassigned_shards": 0,
            "number_of_pending_tasks": 0,
            "number_of_in_flight_fetch": 0,
            "task_max_waiting_in_queue_millis": 0,
            "active_shards_percent_as_number": 100.0,
        }

    def cluster_stats(req: RestRequest):
        total_docs = sum(svc.stats()["docs"]["count"]
                         for svc in indices.indices.values())
        return 200, {
            "cluster_name": node.cluster_name,
            "status": "green",
            "indices": {"count": len(indices.indices),
                        "docs": {"count": total_docs}},
            "nodes": {"count": {"total": 1, "data": 1, "master": 1}},
        }

    def nodes_stats(req: RestRequest):
        ru = resource.getrusage(resource.RUSAGE_SELF)
        return 200, {"_nodes": {"total": 1, "successful": 1},
                     "cluster_name": node.cluster_name,
                     "nodes": {node.node_id: {
                         "name": node.node_name,
                         "indices": indices.stats(),
                         "process": {"max_rss_bytes": ru.ru_maxrss * 1024},
                         "jvm": None,
                         "tpu_search": node.gpu_search.stats(),
                         "breakers": node.breakers.stats(),
                         "allocations": {"failed_allocations": 0,
                                         "failed_streaks": {}},
                     }}}

    def get_cluster_settings(req: RestRequest):
        return 200, {"persistent": dict(node.persistent_settings),
                     "transient": dict(node.transient_settings)}

    def put_cluster_settings(req: RestRequest):
        body = req.body or {}
        persistent = body.get("persistent") or {}
        transient = body.get("transient") or {}
        if not persistent and not transient:
            raise IllegalArgumentException(
                "no settings to update: provide [persistent] and/or "
                "[transient]")
        return 200, node.update_cluster_settings_local(persistent,
                                                       transient)

    def cluster_state(req: RestRequest):
        return 200, {"cluster_name": node.cluster_name,
                     "cluster_uuid": node.cluster_uuid,
                     "master_node": node.node_id,
                     "nodes": {node.node_id: {"name": node.node_name}}}

    def cat_root(req: RestRequest):
        return 200, {"_cat": "=^.^=\n" + "\n".join(CAT_PATHS) + "\n"}

    def cat_indices(req: RestRequest):
        rows = []
        for name in resolve_indices(indices, req.param("index")):
            svc = indices.index(name)
            rows.append(["green", "open", name, svc.index_uuid,
                         svc.num_shards, svc.num_replicas,
                         svc.stats()["docs"]["count"], 0])
        return cat_table(req, ["health", "status", "index", "uuid", "pri",
                               "rep", "docs.count", "docs.deleted"], rows)

    def cat_health(req: RestRequest):
        return cat_table(req, ["epoch", "timestamp", "cluster", "status",
                               "node.total", "shards"],
                         [[int(time.time()), time.strftime("%H:%M:%S"),
                           node.cluster_name, "green", 1, n_shards()]])

    def cat_count(req: RestRequest):
        c = coordinator.count(indices, req.param("index"), None,
                              node.gpu_search.mesh.grid[0][0])
        return cat_table(req, ["epoch", "timestamp", "count"],
                         [[int(time.time()), time.strftime("%H:%M:%S"),
                           c["count"]]])

    def cat_shards(req: RestRequest):
        rows = []
        for name in resolve_indices(indices, req.param("index")):
            for num, shard in sorted(indices.index(name).shards.items()):
                rows.append([name, num, "p" if shard.primary else "r",
                             "STARTED", shard.engine.num_docs(),
                             node.node_name])
        return cat_table(req, ["index", "shard", "prirep", "state", "docs",
                               "node"], rows)

    def cat_nodes(req: RestRequest):
        return cat_table(req, ["host", "port", "master", "name"],
                         [["127.0.0.1", 9200, "m", node.node_name]])

    def cat_aliases(req: RestRequest):
        rows = []
        for alias, targets in sorted(indices.aliases.items()):
            for index, props in sorted(targets.items()):
                rows.append([alias, index,
                             "*" if props.get("filter") else "-",
                             "true" if props.get("is_write_index")
                             else "-"])
        return cat_table(req, ["alias", "index", "filter",
                               "is_write_index"], rows)

    def cat_master(req: RestRequest):
        return cat_table(req, ["id", "host", "node"],
                         [[node.node_id, "127.0.0.1", node.node_name]])

    def cat_allocation(req: RestRequest):
        total = sum(len(svc.shards) for svc in indices.indices.values())
        return cat_table(req, ["shards", "host", "node"],
                         [[total, "127.0.0.1", node.node_name]])

    def cat_recovery(req: RestRequest):
        rows = []
        for name in resolve_indices(indices, req.param("index")):
            for num, shard in sorted(indices.index(name).shards.items()):
                rows.append([name, num, "done",
                             "existing_store" if shard.primary else "peer",
                             node.node_name])
        return cat_table(req, ["index", "shard", "stage", "type", "node"],
                         rows)

    controller.register("GET", "/_cluster/health", health)
    controller.register("GET", "/_cluster/stats", cluster_stats)
    controller.register("GET", "/_nodes/stats", nodes_stats)
    controller.register("GET", "/_cluster/settings", get_cluster_settings)
    controller.register("PUT", "/_cluster/settings", put_cluster_settings)
    controller.register("GET", "/_cluster/state", cluster_state)
    controller.register("GET", "/_cat", cat_root)
    controller.register("GET", "/_cat/aliases", cat_aliases)
    controller.register("GET", "/_cat/master", cat_master)
    controller.register("GET", "/_cat/allocation", cat_allocation)
    controller.register("GET", "/_cat/nodes", cat_nodes)
    controller.register("GET", "/_cat/health", cat_health)
    for table, handler in (("recovery", cat_recovery),
                           ("indices", cat_indices),
                           ("count", cat_count), ("shards", cat_shards)):
        controller.register("GET", f"/_cat/{table}", handler)
        controller.register("GET", f"/_cat/{table}/{{index}}", handler)
