"""RestController — path-trie routing of REST requests to handlers.

Copy of the reference's ``rest/controller.py`` without tracing, tenancy,
the profiler's thread tags and thread-pool admission: a path trie with
literal and ``{param}`` wildcard nodes, and the reference's error shape,
``{"error": {"root_cause": [...], "type", "reason", ...}, "status": N}``.
"""

from __future__ import annotations

import dataclasses
import re
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

from elasticsearch_tpu_torch.common import errors as es_errors


@dataclasses.dataclass
class RestRequest:
    method: str
    path: str
    params: Dict[str, str]          # query-string + path params
    body: Any                        # parsed JSON (dict) | raw str for NDJSON
    raw_body: bytes = b""

    def param(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self.params.get(key, default)

    def param_bool(self, key: str, default: bool = False) -> bool:
        v = self.params.get(key)
        if v is None:
            return default
        return v in ("", "true", "1")


Handler = Callable[[RestRequest], Tuple[int, Dict[str, Any]]]


class _TrieNode:
    __slots__ = ("children", "wildcard", "wildcard_name", "handlers")

    def __init__(self):
        self.children: Dict[str, "_TrieNode"] = {}
        self.wildcard: Optional["_TrieNode"] = None
        self.wildcard_name: Optional[str] = None
        self.handlers: Dict[str, Handler] = {}


STATUS_BY_EXC = [
    (es_errors.ResourceNotFoundException, 404),
    (es_errors.ResourceAlreadyExistsException, 400),
    (es_errors.VersionConflictEngineException, 409),
    (es_errors.IllegalArgumentException, 400),
    (es_errors.ParsingException, 400),
    (es_errors.CircuitBreakingException, 429),
    (es_errors.IndexBlockException, 403),
    (es_errors.ClusterBlockException, 503),
]


def error_status(exc: Exception) -> int:
    for klass, status in STATUS_BY_EXC:
        if isinstance(exc, klass):
            return status
    # any other EsException carries its own status
    if isinstance(exc, es_errors.EsException):
        return int(getattr(exc, "status", 500))
    return 500


def error_body(exc: Exception, status: int) -> Dict[str, Any]:
    if isinstance(exc, es_errors.EsException):
        body = exc.to_xcontent()
        cause = {"type": body["type"], "reason": body["reason"]}
        return {"error": {"root_cause": [cause], **body}, "status": status}
    t = type(exc).__name__
    # CamelCase → snake_case exception type names like the reference
    snake = re.sub(r"(?<!^)(?=[A-Z])", "_", t).lower()
    cause = {"type": snake, "reason": str(exc)}
    return {"error": {"root_cause": [cause], **cause}, "status": status}


def rejection_headers(exc: Exception, status: int
                      ) -> Optional[Dict[str, str]]:
    """Every 429/503 carries ``Retry-After``. Rides the payload as a
    reserved ``_headers`` key, which the HTTP layer pops and emits."""
    if status not in (429, 503):
        return None
    retry_after = getattr(exc, "retry_after_s", 1.0)
    try:
        retry_after = max(1, int(round(float(retry_after))))
    except (TypeError, ValueError):
        retry_after = 1
    return {"Retry-After": str(retry_after)}


class RestController:
    def __init__(self):
        self._root = _TrieNode()

    def register(self, method: str, template: str, handler: Handler) -> None:
        node = self._root
        for part in template.strip("/").split("/"):
            if not part:
                continue
            if part.startswith("{") and part.endswith("}"):
                if node.wildcard is None:
                    node.wildcard = _TrieNode()
                    node.wildcard_name = part[1:-1]
                node = node.wildcard
            else:
                node = node.children.setdefault(part, _TrieNode())
        node.handlers[method.upper()] = handler

    def _resolve(self, path: str) -> Tuple[Optional[_TrieNode], Dict[str, str]]:
        node = self._root
        params: Dict[str, str] = {}
        for part in path.strip("/").split("/"):
            if not part:
                continue
            nxt = node.children.get(part)
            if nxt is None and node.wildcard is not None:
                params[node.wildcard_name] = part
                nxt = node.wildcard
            if nxt is None:
                return None, {}
            node = nxt
        return node, params

    def dispatch(self, method: str, path: str,
                 query_params: Optional[Dict[str, str]] = None,
                 body: Any = None,
                 raw_body: bytes = b"") -> Tuple[int, Dict[str, Any]]:
        node, path_params = self._resolve(path)
        if node is None or not node.handlers:
            return 400, error_body(
                es_errors.IllegalArgumentException(
                    f"no handler found for uri [{path}] and method [{method}]"),
                400)
        handler = node.handlers.get(method.upper())
        if handler is None:
            if method.upper() == "HEAD" and "GET" in node.handlers:
                handler = node.handlers["GET"]
            else:
                return 405, error_body(
                    es_errors.IllegalArgumentException(
                        f"incorrect HTTP method for uri [{path}]: allowed "
                        f"{sorted(node.handlers)}"), 405)
        params = dict(query_params or {})
        params.update(path_params)
        req = RestRequest(method.upper(), path, params, body, raw_body)
        try:
            return handler(req)
        except Exception as exc:  # noqa: BLE001 — REST boundary
            status = error_status(exc)
            if status == 500:
                traceback.print_exc()
            payload = error_body(exc, status)
            headers = rejection_headers(exc, status)
            if headers:
                payload["_headers"] = headers
            return status, payload
