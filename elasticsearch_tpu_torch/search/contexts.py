"""Search contexts: scroll cursors and points in time over pinned readers.

Copy of the reference's ``search/contexts.py`` (ReaderContext,
LegacyReaderContext): a context pins each target shard's ShardReader,
an immutable snapshot (live masks are copied per reader, so later
deletes and refreshes never show), under a keep-alive lease; a scroll
also carries its paging cursor. A pinned reader holds host arrays only:
the planner copies what a query touches to the device for that request
and drops it after. Contexts are node-local, and freed by a clear, a
close, or the expiry sweep of the node's refresh cycle (``reap``).
"""

from __future__ import annotations

import base64
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from elasticsearch_tpu_torch.common.errors import (EsException,
                                                   IllegalArgumentException)
from elasticsearch_tpu_torch.common.units import parse_seconds


class SearchContextMissingException(EsException):
    status = 404


MAX_KEEP_ALIVE_S = 24 * 3600.0


def parse_keep_alive(value: Any, what: str) -> float:
    seconds = parse_seconds(value)
    if seconds <= 0 or seconds > MAX_KEEP_ALIVE_S:
        raise IllegalArgumentException(
            f"[{what}] keep_alive must be positive and at most 24h, "
            f"got [{value}]")
    return seconds


class PinnedContext:
    def __init__(self, ctx_id: str, names: List[str],
                 readers: Dict[Tuple[str, int], Any],
                 keep_alive_s: float,
                 scroll_state: Optional[Dict[str, Any]] = None):
        self.id = ctx_id
        self.names = names
        self.readers = readers
        self.keep_alive_s = keep_alive_s
        self.expires = time.monotonic() + keep_alive_s
        # scroll only: {"body": ..., "params": ..., "offset": int}
        self.scroll_state = scroll_state

    def touch(self, keep_alive_s: Optional[float] = None) -> None:
        if keep_alive_s is not None:
            self.keep_alive_s = keep_alive_s
        self.expires = time.monotonic() + self.keep_alive_s


class SearchContextManager:
    """Node-level registry of pinned contexts with keepalive reaping."""

    def __init__(self):
        self._lock = threading.Lock()
        self._contexts: Dict[str, PinnedContext] = {}

    # ---------------- lifecycle ----------------

    def create(self, indices_service, index_expr: Optional[str],
               keep_alive_s: float,
               scroll_state: Optional[Dict[str, Any]] = None,
               names: Optional[List[str]] = None) -> PinnedContext:
        if names is None:
            from elasticsearch_tpu_torch.search.coordinator import \
                resolve_indices
            names = resolve_indices(indices_service, index_expr)
        readers: Dict[Tuple[str, int], Any] = {}
        for name in names:
            svc = indices_service.index(name)
            for shard_num, shard in sorted(svc.shards.items()):
                readers[(name, shard_num)] = shard.acquire_searcher()
        ctx_id = base64.urlsafe_b64encode(
            uuid.uuid4().bytes).decode("ascii").rstrip("=")
        ctx = PinnedContext(ctx_id, names, readers, keep_alive_s,
                            scroll_state)
        with self._lock:
            self._reap_locked()
            self._contexts[ctx_id] = ctx
        return ctx

    def get(self, ctx_id: str) -> PinnedContext:
        with self._lock:
            self._reap_locked()
            ctx = self._contexts.get(ctx_id)
        if ctx is None:
            raise SearchContextMissingException(
                f"No search context found for id [{ctx_id}]")
        return ctx

    def free(self, ctx_id: str, kind: Optional[str] = None) -> bool:
        """kind="scroll"/"pit" frees only that context type — scroll and
        PIT ids share a namespace, and clearing the wrong kind must not
        silently kill a live context of the other."""
        with self._lock:
            ctx = self._contexts.get(ctx_id)
            if ctx is None:
                return False
            if kind == "scroll" and ctx.scroll_state is None:
                return False
            if kind == "pit" and ctx.scroll_state is not None:
                return False
            del self._contexts[ctx_id]
            return True

    def free_all(self, scroll_only: bool = False) -> int:
        with self._lock:
            if not scroll_only:
                n = len(self._contexts)
                self._contexts.clear()
                return n
            victims = [c for c, ctx in self._contexts.items()
                       if ctx.scroll_state is not None]
            for c in victims:
                del self._contexts[c]
            return len(victims)

    def reap(self) -> None:
        """Periodic expiry sweep (called from the node's background
        cycle) — without it, expired contexts would pin segment readers
        on an idle node until the next API call."""
        with self._lock:
            self._reap_locked()

    def _reap_locked(self) -> None:
        now = time.monotonic()
        for cid in [c for c, ctx in self._contexts.items()
                    if ctx.expires < now]:
            del self._contexts[cid]

    def active_count(self) -> int:
        with self._lock:
            self._reap_locked()
            return len(self._contexts)
