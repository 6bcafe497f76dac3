"""Node — the composition root + HTTP server of the port.

Counterpart of the reference's ``node.py``: constructs the indices
service, the circuit breakers and the GPU search service, wires the REST
controller, and serves JSON over a stdlib ThreadingHTTPServer (the heavy
work is on the device; the host's HTTP layer parses and routes). A node
runs on ``cuda:0`` unless ``device="cpu"`` is asked for
(``--device cpu``); without a GPU and without that request it raises.

The node reads the reference's setting names, so a node configuration
moves across unchanged:

  search.tpu_serving.batch_window_seconds   0.01
  search.tpu_serving.max_batch              128
  search.tpu_serving.batch_timeout_seconds  30
  indices.breaker.total.limit_bytes         8 GiB

Run: python -m elasticsearch_tpu_torch.node --port 9200 --data-path ./data
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
    IndexAlreadyExistsException, IndexNotFoundException)
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.indices.service import (IndexService,
                                                     IndicesService)
from elasticsearch_tpu_torch.parallel.device import resolve_device
from elasticsearch_tpu_torch.rest.controller import RestController
from elasticsearch_tpu_torch.search.gpu_service import GpuSearchService
from elasticsearch_tpu_torch.search.serializer import dumps_response


class Node:
    def __init__(self, data_path: str, *,
                 node_name: str = "node-1",
                 cluster_name: str = "elasticsearch-tpu",
                 settings: Optional[Settings] = None,
                 device=None):
        self.settings = Settings((settings or Settings.EMPTY)
                                 .get_as_dict())
        self.device = resolve_device(device)
        self.node_name = node_name
        self.node_id = _load_or_create_node_id(data_path, node_name)
        self.cluster_name = cluster_name
        self.cluster_uuid = uuid.uuid4().hex[:20]
        self.indices = IndicesService(data_path)
        self.breakers = HierarchyCircuitBreakerService(
            total_limit_bytes=self.settings.get_int(
                "indices.breaker.total.limit_bytes", 8 << 30))
        self.gpu_search = GpuSearchService(
            device=self.device,
            breaker=self.breakers.breakers["hbm"],
            window_s=self.settings.get_float(
                "search.tpu_serving.batch_window_seconds", 0.01),
            max_batch=self.settings.get_int(
                "search.tpu_serving.max_batch", 128),
            batch_timeout_s=self.settings.get_float(
                "search.tpu_serving.batch_timeout_seconds", 30.0))
        self.controller = RestController()
        from elasticsearch_tpu_torch.rest.actions import (admin, document,
                                                          root, search)
        for module in (document, search, admin, root):
            module.register(self.controller, self)
        self._bulk_pool: Optional[ThreadPoolExecutor] = None
        self._pool_lock = threading.Lock()
        self._refresh_interval = self.settings.get_float(
            "index.refresh_interval_seconds", 1.0)
        self._sync_interval = self.settings.get_float(
            "index.translog.sync_interval_seconds", 5.0)
        self._refresher: Optional[threading.Timer] = None
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

    # ---------------- background refresh + translog sync ----------------

    def start_refresher(self) -> None:
        """The 1 s refresh cycle, and the fsync of async-durability
        translogs every index.translog.sync_interval_seconds."""
        last_sync = [time.monotonic()]

        def tick():
            if self._closed:
                return
            for svc in list(self.indices.indices.values()):
                for shard in list(svc.shards.values()):
                    try:
                        shard.refresh()
                        if (time.monotonic() - last_sync[0]
                                >= self._sync_interval):
                            shard.engine.sync_translog()
                    except Exception:  # noqa: BLE001 — background task
                        pass
            if time.monotonic() - last_sync[0] >= self._sync_interval:
                last_sync[0] = time.monotonic()
            self._refresher = threading.Timer(self._refresh_interval, tick)
            self._refresher.daemon = True
            self._refresher.start()
        self._refresher = threading.Timer(self._refresh_interval, tick)
        self._refresher.daemon = True
        self._refresher.start()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._refresher:
            self._refresher.cancel()
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
            if path.endswith("/_bulk"):
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
        # dumps_response renders embedded ColumnarHits blocks from their
        # result columns in one pass (no per-hit dicts for metadata-only
        # hits); plain payloads serialize as json.dumps
        t0 = time.perf_counter()
        data = dumps_response(payload).encode("utf-8")
        self.node.gpu_search.stages.add("serialize",
                                        time.perf_counter() - t0)
        self.send_response(status)
        self.send_header("Content-Type", "application/json; charset=UTF-8")
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


def serve(node: Node, host: str = "127.0.0.1", port: int = 9200
          ) -> ThreadingHTTPServer:
    """Serve `node` over HTTP on a daemon thread (port 0: an ephemeral
    port, read back from ``server.server_address``)."""
    handler = type("BoundHandler", (_Handler,), {"node": node})
    server = ThreadingHTTPServer((host, port), handler)
    server.daemon_threads = True
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
                        help="torch device (default cuda:0; 'cpu' runs "
                             "the plain torch path)")
    parser.add_argument("-E", action="append", default=[], metavar="K=V",
                        dest="settings", help="node setting override")
    args = parser.parse_args()
    overrides = dict(kv.split("=", 1) for kv in args.settings)
    node = Node(args.data_path, node_name=args.node_name,
                settings=Settings.of(overrides), device=args.device)
    node.start_refresher()
    server = serve(node, args.host, args.port)
    print(f"[{args.node_name}] listening on http://{args.host}:{args.port} "
          f"({node.device})", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        node.close()


if __name__ == "__main__":
    main()
