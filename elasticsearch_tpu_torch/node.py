"""Node — the composition root + HTTP server of the port.

Counterpart of the reference's ``node.py``: constructs the indices
service, the circuit breakers and the GPU search service, wires the REST
controller, and serves JSON over a stdlib ThreadingHTTPServer (the heavy
work is on the device; the host's HTTP layer parses and routes). A node
lays its packs over a mesh of every visible GPU on the shards axis
(``make_mesh()``, the reference's ``(1, n_local_devices)``) unless it is
given a mesh (``mesh=``, ``--mesh-shape D,S``) or one device (``device=``,
a (1, 1) mesh; ``--device cpu`` runs the plain torch path on the CPU,
and with ``--mesh-shape`` a CPU mesh of D×S entries); without a GPU and
without the CPU asked for it raises.

The node reads the reference's setting names, so a node configuration
moves across unchanged:

  search.tpu_serving.batch_window_seconds   0.01
  search.tpu_serving.max_batch              128
  search.tpu_serving.batch_timeout_seconds  30
  search.tpu_serving.delta.enabled          true
  search.tpu_serving.delta.max_packs        4
  search.tpu_serving.delta.max_docs         50,000
  indices.breaker.total.limit_bytes         8 GiB

With the delta settings on (the default, as in the reference), an
append-only refresh of a resident index rides a small delta pack chained
on the base pack, and a background thread folds the chain back into one
base pack (``search/gpu_service.py``).

Dynamic cluster settings (``PUT /_cluster/settings``) are persistent or
transient; the node's live settings are its base configuration with the
persistent ones over it and the transient ones over those, and the
persistent ones are written atomically under ``_state/`` and read back
after a restart. Of the reference's dynamic cluster settings the node
takes ``action.auto_create_index`` and ``logger.*`` (per-logger levels,
``common/logging.configure``, applied at construction and on every
change); ``cluster.remote.*`` waits for the cross-cluster module.

The HTTP layer answers JSON, or text/plain for a ``_cat`` table.

Run: python -m elasticsearch_tpu_torch.node --port 9200 --data-path ./data
     [--device cpu] [--mesh-shape D,S]
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib.parse import parse_qs, urlparse

from elasticsearch_tpu_torch.common.breaker import \
    HierarchyCircuitBreakerService
from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentException, IndexAlreadyExistsException,
    IndexNotFoundException)
from elasticsearch_tpu_torch.common.logging import configure, level_of
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index.translog import write_atomic
from elasticsearch_tpu_torch.indices.service import (IndexService,
                                                     IndicesService)
from elasticsearch_tpu_torch.parallel.device import resolve_device
from elasticsearch_tpu_torch.parallel.mesh import (Mesh, make_mesh,
                                                   resolve_mesh)
from elasticsearch_tpu_torch.rest.controller import RestController
from elasticsearch_tpu_torch.search.contexts import SearchContextManager
from elasticsearch_tpu_torch.search.gpu_service import GpuSearchService
from elasticsearch_tpu_torch.search.serializer import dumps_response

#: the dynamic cluster settings the node takes, by name and by prefix
DYNAMIC_CLUSTER_SETTINGS = ("action.auto_create_index",)
DYNAMIC_CLUSTER_PREFIXES = ("logger.",)
#: dynamic in the reference, refused here with the module they wait for
UNPORTED_CLUSTER_PREFIXES = (("cluster.remote.", "cross-cluster search"),)


class Node:
    def __init__(self, data_path: str, *,
                 node_name: str = "node-1",
                 cluster_name: str = "elasticsearch-tpu",
                 settings: Optional[Settings] = None,
                 device=None, mesh: Optional[Mesh] = None):
        self.settings = Settings((settings or Settings.EMPTY)
                                 .get_as_dict())
        self._base_settings = self.settings.get_as_dict()
        self.mesh = resolve_mesh(device, mesh)
        self.node_name = node_name
        self.node_id = _load_or_create_node_id(data_path, node_name)
        self.cluster_name = cluster_name
        self.cluster_uuid = uuid.uuid4().hex[:20]
        self.indices = IndicesService(data_path)
        self.transient_settings: Dict[str, Any] = {}
        self.persistent_settings: Dict[str, Any] = \
            self._load_persistent_settings()
        # logging is part of the node's construction (owner-scoped, so
        # two nodes of one process keep their own overrides)
        self.recompute_settings()
        self.breakers = HierarchyCircuitBreakerService(
            total_limit_bytes=self.settings.get_int(
                "indices.breaker.total.limit_bytes", 8 << 30))
        self.gpu_search = GpuSearchService(
            mesh=self.mesh,
            breaker=self.breakers.breakers["hbm"],
            window_s=self.settings.get_float(
                "search.tpu_serving.batch_window_seconds", 0.01),
            max_batch=self.settings.get_int(
                "search.tpu_serving.max_batch", 128),
            batch_timeout_s=self.settings.get_float(
                "search.tpu_serving.batch_timeout_seconds", 30.0),
            packed_sort=self.settings.get_bool(
                "search.tpu_serving.kernel.packed_sort", True),
            compressed_pack=self.settings.get_bool(
                "search.tpu_serving.kernel.compressed_pack", True),
            prewarm_concurrency=self.settings.get_int(
                "search.tpu_serving.prewarm_concurrency", 4),
            delta={
                "enabled": self.settings.get_bool(
                    "search.tpu_serving.delta.enabled", True),
                "max_packs": self.settings.get_int(
                    "search.tpu_serving.delta.max_packs", 4),
                "max_docs": self.settings.get_int(
                    "search.tpu_serving.delta.max_docs", 50_000),
            })
        # scroll and PIT contexts (their pinned readers), swept on the
        # refresh cycle
        self.search_contexts = SearchContextManager()
        self.controller = RestController()
        from elasticsearch_tpu_torch.rest.actions import (admin, aliases,
                                                          cluster, document,
                                                          introspect, root,
                                                          search)
        for module in (document, search, admin, aliases, cluster,
                       introspect, root):
            module.register(self.controller, self)
        self._bulk_pool: Optional[ThreadPoolExecutor] = None
        self._pool_lock = threading.Lock()
        self._refresh_interval = self.settings.get_float(
            "index.refresh_interval_seconds", 1.0)
        self._sync_interval = self.settings.get_float(
            "index.translog.sync_interval_seconds", 5.0)
        self._refresher: Optional[threading.Timer] = None
        self._syncer: Optional[threading.Timer] = None
        # refresh=wait_for waits on the visibility checkpoint only while
        # the refresh cycle runs (else the handler refreshes itself)
        self.refresher_active = False
        self._closed = False

    # ---------------- index helpers ----------------

    def create_index(self, name: str, settings: Settings,
                     mappings: Optional[dict]) -> IndexService:
        return self.indices.create_index(name, settings, mappings)

    def get_or_autocreate_index(self, name: str) -> IndexService:
        """Auto-create on first doc (action.auto_create_index, default
        on)."""
        if not self.indices.has_index(name):
            if not self.settings.get_bool("action.auto_create_index", True):
                raise IndexNotFoundException(f"no such index [{name}] and "
                                             f"auto-create is disabled")
            try:
                return self.create_index(name, Settings.EMPTY, None)
            except IndexAlreadyExistsException:
                # concurrent first writes raced; the other one won
                return self.indices.index(name)
        return self.indices.index(name)

    def bulk_executor(self) -> ThreadPoolExecutor:
        """The pool that applies a bulk's shard groups concurrently."""
        with self._pool_lock:
            if self._bulk_pool is None:
                self._bulk_pool = ThreadPoolExecutor(
                    max_workers=min(8, max(4, os.cpu_count() or 1)),
                    thread_name_prefix="shard-bulk")
            return self._bulk_pool

    # ---------------- dynamic cluster settings ----------------

    def _cluster_settings_path(self) -> str:
        return os.path.join(self.indices.data_path, "_state",
                            "cluster_settings.json")

    def _load_persistent_settings(self) -> Dict[str, Any]:
        try:
            with open(self._cluster_settings_path(), "rb") as f:
                return json.loads(f.read().decode("utf-8"))
        except (OSError, json.JSONDecodeError):
            return {}

    def recompute_settings(self) -> None:
        """settings := base config + persistent + transient, in place
        (a cleared key reverts to its base value)."""
        target = dict(self._base_settings)
        target.update(self.persistent_settings)
        target.update(self.transient_settings)
        self.settings.replace_all(target)
        configure(self.settings, owner=id(self))

    def update_cluster_settings_local(self, persistent: dict,
                                      transient: dict) -> dict:
        """PUT /_cluster/settings on one node: validate every key, apply
        (a None value clears), persist the persistent ones atomically."""
        flat_p = Settings._flatten(persistent)
        flat_t = Settings._flatten(transient)
        for key in list(flat_p) + list(flat_t):
            for prefix, module in UNPORTED_CLUSTER_PREFIXES:
                if key.startswith(prefix):
                    raise IllegalArgumentException(
                        f"setting [{key}]: {module} is not ported yet")
            if any(key.startswith(p) for p in DYNAMIC_CLUSTER_PREFIXES):
                value = flat_p.get(key, flat_t.get(key))
                if value is not None:
                    level_of(value)  # an unknown level is a 400
                continue
            if key not in DYNAMIC_CLUSTER_SETTINGS:
                raise IllegalArgumentException(
                    f"setting [{key}] is not dynamically updateable")
        for store, changes in ((self.persistent_settings, flat_p),
                               (self.transient_settings, flat_t)):
            for k, v in changes.items():
                if v is None:
                    store.pop(k, None)
                else:
                    store[k] = v
        self.recompute_settings()
        p = self._cluster_settings_path()
        os.makedirs(os.path.dirname(p), exist_ok=True)
        write_atomic(p, json.dumps(self.persistent_settings,
                                   sort_keys=True).encode("utf-8"))
        return {"acknowledged": True,
                "persistent": dict(self.persistent_settings),
                "transient": dict(self.transient_settings)}

    # ---------------- background refresh + translog sync ----------------

    def start_refresher(self) -> None:
        """The refresh cycle (every index.refresh_interval_seconds), and
        the fsync of async-durability translogs: each index every
        index.translog.sync_interval_seconds (its own, or the node's)."""
        self.refresher_active = True

        def tick():
            if self._closed:
                return
            for svc in list(self.indices.indices.values()):
                for shard in list(svc.shards.values()):
                    try:
                        shard.refresh()
                    except Exception:  # noqa: BLE001 — background task
                        pass
            try:  # expired contexts must not pin readers on an idle node
                self.search_contexts.reap()
            except Exception:  # noqa: BLE001 — background task
                pass
            self._refresher = threading.Timer(self._refresh_interval, tick)
            self._refresher.daemon = True
            self._refresher.start()
        self._refresher = threading.Timer(self._refresh_interval, tick)
        self._refresher.daemon = True
        self._refresher.start()

        last_sync: Dict[str, float] = {}

        def sync_delay() -> float:
            # the finest configured cadence, so that an index's interval
            # shorter than the node's is honored too
            delay = self._sync_interval
            for svc in list(self.indices.indices.values()):
                if svc.sync_interval_s > 0:
                    delay = min(delay, svc.sync_interval_s)
            return max(0.05, delay)

        def sync_tick():
            if self._closed:
                return
            try:
                now = time.monotonic()
                for svc in list(self.indices.indices.values()):
                    interval = (svc.sync_interval_s
                                if svc.sync_interval_s > 0
                                else self._sync_interval)
                    if now - last_sync.get(svc.name, 0.0) < interval - 1e-3:
                        continue
                    last_sync[svc.name] = now
                    for shard in list(svc.shards.values()):
                        try:
                            shard.engine.sync_translog()
                        except Exception:  # noqa: BLE001 — background
                            pass
            finally:  # the cycle survives any error
                self._syncer = threading.Timer(sync_delay(), sync_tick)
                self._syncer.daemon = True
                self._syncer.start()
        self._syncer = threading.Timer(sync_delay(), sync_tick)
        self._syncer.daemon = True
        self._syncer.start()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.refresher_active = False
        if self._refresher:
            self._refresher.cancel()
        if self._syncer:
            self._syncer.cancel()
        self.gpu_search.close()
        if self._bulk_pool is not None:
            self._bulk_pool.shutdown(wait=True)
        self.indices.close()

    # ---------------- in-process dispatch (tests + http) ----------------

    def handle(self, method: str, path: str,
               params: Optional[Dict[str, str]] = None,
               body: Any = None, raw_body: bytes = b""):
        if body is None and raw_body:
            text = raw_body.decode("utf-8", errors="replace")
            if path.endswith(("/_bulk", "/_msearch")):
                body = text  # NDJSON bodies parse per line downstream
            elif text.strip():
                try:
                    body = json.loads(text)
                except json.JSONDecodeError as e:
                    return 400, {"error": {"type": "parsing_exception",
                                           "reason": str(e)}, "status": 400}
        return self.controller.dispatch(method, path, params, body,
                                        raw_body)


class _Handler(BaseHTTPRequestHandler):
    node: Node = None  # set by serve()
    protocol_version = "HTTP/1.1"

    def _do(self):
        parsed = urlparse(self.path)
        params = {k: v[0] if v else "" for k, v in
                  parse_qs(parsed.query, keep_blank_values=True).items()}
        length = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(length) if length else b""
        status, payload = self.node.handle(self.command, parsed.path, params,
                                           None, raw)
        extra_headers = (payload.pop("_headers", None)
                         if isinstance(payload, dict) else None)
        if isinstance(payload, dict) and "_cat" in payload \
                and len(payload) == 1:
            data = payload["_cat"].encode("utf-8")
            ctype = "text/plain; charset=UTF-8"
        else:
            # dumps_response renders embedded ColumnarHits blocks from
            # their result columns in one pass (no per-hit dicts for
            # metadata-only hits); plain payloads serialize as json.dumps
            t0 = time.perf_counter()
            data = dumps_response(payload).encode("utf-8")
            self.node.gpu_search.stages.add("serialize",
                                            time.perf_counter() - t0)
            ctype = "application/json; charset=UTF-8"
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.send_header("X-elastic-product", "Elasticsearch-TPU")
        for name, value in (extra_headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        if self.command != "HEAD":
            self.wfile.write(data)

    do_GET = do_POST = do_PUT = do_DELETE = do_HEAD = _do

    def log_message(self, fmt, *args):  # quiet by default
        pass


class _Server(ThreadingHTTPServer):
    """One thread a connection. The listen backlog holds a burst of
    clients that connect at once (socketserver's default of 5 overflows
    under 128, and the kernel may then reset connections it could not
    queue)."""

    daemon_threads = True
    request_queue_size = 1024


def serve(node: Node, host: str = "127.0.0.1", port: int = 9200
          ) -> ThreadingHTTPServer:
    """Serve `node` over HTTP on a daemon thread (port 0: an ephemeral
    port, read back from ``server.server_address``)."""
    handler = type("BoundHandler", (_Handler,), {"node": node})
    server = _Server((host, port), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server


def _load_or_create_node_id(data_path: str, node_name: str) -> str:
    """A node's identity survives restarts."""
    p = os.path.join(data_path, "_state", "node_id")
    try:
        with open(p, "r", encoding="utf-8") as f:
            return f.read().strip()
    except OSError:
        pass
    nid = uuid.uuid4().hex[:20]
    try:
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "w", encoding="utf-8") as f:
            f.write(nid)
    except OSError:
        pass
    return nid


def main() -> None:
    parser = argparse.ArgumentParser(
        description="elasticsearch-tpu node on a GPU (PyTorch + CUDA)")
    parser.add_argument("--port", type=int, default=9200)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--data-path", default="./data")
    parser.add_argument("--node-name", default="node-1")
    parser.add_argument("--device", default=None,
                        help="torch device: one card, or 'cpu' for the "
                             "plain torch path (default: every visible "
                             "GPU on the shards axis, a (1, n) mesh)")
    parser.add_argument("--mesh-shape", default=None, metavar="D,S",
                        help="a (data, shards) mesh of D*S visible GPUs, "
                             "or with --device cpu of D*S CPU entries "
                             "(default: every GPU on the shards axis)")
    parser.add_argument("-E", action="append", default=[], metavar="K=V",
                        dest="settings", help="node setting override")
    args = parser.parse_args()
    overrides = dict(kv.split("=", 1) for kv in args.settings)
    device, mesh = args.device, None
    if args.mesh_shape:
        shape = tuple(int(x) for x in args.mesh_shape.split(","))
        if len(shape) != 2:
            parser.error("--mesh-shape takes D,S")
        if device is not None and resolve_device(device).type != "cpu":
            parser.error("--mesh-shape takes the visible GPUs, or with "
                         "--device cpu CPU entries")
        mesh = make_mesh(["cpu"] * (shape[0] * shape[1]) if device
                         else None, shape)
        device = None
    node = Node(args.data_path, node_name=args.node_name,
                settings=Settings.of(overrides), device=device, mesh=mesh)
    node.start_refresher()
    server = serve(node, args.host, args.port)
    print(f"[{args.node_name}] listening on http://{args.host}:{args.port} "
          f"({node.mesh})", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        node.close()


if __name__ == "__main__":
    main()
