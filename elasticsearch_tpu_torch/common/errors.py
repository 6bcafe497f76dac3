"""Error taxonomy.

Copy of the reference's ``common/errors.py`` for the exceptions the node,
the engine and the search path raise. Every exception carries an HTTP
status for the REST layer and renders a structured body (``type``,
``reason``, metadata, nested ``caused_by``) through ``to_xcontent``.

The port adds ``NotLowerable``: a valid search the port does not serve
yet. It renders as a 400 whose reason names the missing path.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class EsException(Exception):
    """Base exception; carries an HTTP status and structured metadata."""

    status = 500

    def __init__(self, reason: str, **metadata: Any):
        super().__init__(reason)
        self.reason = reason
        self.metadata: Dict[str, Any] = metadata

    @property
    def error_type(self) -> str:
        # e.g. VersionConflictEngineException -> version_conflict_engine_exception
        name = type(self).__name__
        out = []
        for i, ch in enumerate(name):
            if ch.isupper() and i > 0:
                out.append("_")
            out.append(ch.lower())
        return "".join(out)

    def to_xcontent(self) -> Dict[str, Any]:
        body: Dict[str, Any] = {"type": self.error_type, "reason": self.reason}
        if self.metadata:
            body.update(self.metadata)
        cause = self.__cause__
        if isinstance(cause, EsException):
            body["caused_by"] = cause.to_xcontent()
        elif cause is not None:
            body["caused_by"] = {"type": type(cause).__name__, "reason": str(cause)}
        return body


class ResourceNotFoundException(EsException):
    status = 404


class ResourceAlreadyExistsException(EsException):
    status = 400


class IndexNotFoundException(ResourceNotFoundException):
    def __init__(self, index: str):
        super().__init__(f"no such index [{index}]", index=index)


class IndexAlreadyExistsException(ResourceAlreadyExistsException):
    def __init__(self, index: str):
        super().__init__(f"index [{index}] already exists", index=index)


class ShardNotFoundException(ResourceNotFoundException):
    pass


class DocumentMissingException(ResourceNotFoundException):
    status = 404


class ParsingException(EsException, ValueError):
    """A malformed query or search body."""

    status = 400


class IllegalArgumentException(EsException, ValueError):
    status = 400


class MapperParsingException(ParsingException):
    """A mapping or document the mapper cannot take."""

    status = 400


class QueryShardException(EsException):
    """A query a shard cannot evaluate (a range on a text field, a
    multi-term expansion past the clause limit)."""

    status = 400


class VersionConflictEngineException(EsException):
    """Optimistic concurrency failure on versioned/if_seq_no writes."""

    status = 409


class EngineClosedException(EsException):
    status = 503


class TranslogDurabilityException(EsException):
    """An OSError (ENOSPC/EIO) while appending or fsyncing the translog:
    the durability policy cannot be honored for this operation, so it is
    never acked. 503 + Retry-After."""

    status = 503

    def __init__(self, reason: str, *, retry_after_s: float = 5.0,
                 **md: Any):
        super().__init__(reason, **md)
        self.retry_after_s = retry_after_s


class TranslogCorruptedException(EsException):
    status = 500


class CircuitBreakingException(EsException):
    """Request rejected by memory accounting before OOM."""

    status = 429

    def __init__(self, reason: str, bytes_wanted: int = 0, byte_limit: int = 0, **md: Any):
        super().__init__(reason, bytes_wanted=bytes_wanted, bytes_limit=byte_limit, **md)


class ClusterBlockException(EsException):
    status = 503


class IndexClosedException(EsException):
    """Operation on a closed index (a 400, as in the reference)."""
    status = 400


class IndexBlockException(ClusterBlockException):
    status = 403


class SettingsException(IllegalArgumentException):
    pass


class NotLowerable(IllegalArgumentException):
    """A valid search that the port does not serve yet. With
    ``planner=True`` it is one the reference answers on its planner path
    (``search/planner.py`` + ``search/query_phase.py``): the kernel path
    raises it for a query outside its lowering subset, and the
    coordinator then runs the port's planner; what reaches the client is
    a planner feature the port has not got yet (the query types of field
    types it does not map). With
    ``planner=False`` it is one the reference serves on its kernel path
    and the port's kernel path does not take yet: more slots per row
    than the merge kernels hold. The REST
    layer answers a 400 whose reason names the missing path."""

    def __init__(self, reason: str, planner: bool = True, **metadata: Any):
        path = ("the reference answers this on its planner path, where "
                "the port does not serve it yet" if planner else
                "the reference serves this on its kernel path, whose "
                "support for it is not ported yet")
        super().__init__(f"{reason}; {path}", **metadata)
        self.planner = planner


class IndexNotFound(IndexNotFoundException, KeyError):
    """No index of that name (the reference's IndexNotFoundException)."""

    error_type = "index_not_found_exception"

    def __str__(self) -> str:
        return self.reason


def exception_type_name(exc: BaseException) -> str:
    """Snake-case wire name of any exception class (the ``reason.type``
    of a shard failure raised by code outside this taxonomy)."""
    if isinstance(exc, EsException):
        return exc.error_type
    name = type(exc).__name__
    out = []
    for i, ch in enumerate(name):
        if ch.isupper() and i > 0:
            out.append("_")
        out.append(ch.lower())
    return "".join(out)


def shard_failure_entry(index: str, shard: int, exc: BaseException,
                        node: Optional[str] = None) -> Dict[str, Any]:
    """One ``_shards.failures[]`` element: shard, index, optional node,
    nested reason and status."""
    reason = (exc.to_xcontent() if isinstance(exc, EsException)
              else {"type": exception_type_name(exc), "reason": str(exc)})
    entry: Dict[str, Any] = {"shard": shard, "index": index,
                             "reason": reason,
                             "status": (int(getattr(exc, "status", 503))
                                        if isinstance(exc, EsException)
                                        else 503)}
    if node is not None:
        entry["node"] = node
    return entry


class SearchPhaseExecutionException(EsException):
    """Every shard failed a search phase, or one did while partial
    results are disallowed. Its status derives from the shard failures:
    a client error that hit every shard stays that 4xx; any 5xx-class
    failure makes it a 503."""

    status = 503

    def __init__(self, phase: str, reason: str,
                 shard_failures: Optional[list] = None):
        super().__init__(reason, phase=phase, grouped=True)
        self.shard_failures = shard_failures or []
        statuses = [f.get("status", 503) for f in self.shard_failures
                    if isinstance(f, dict)]
        if statuses:
            self.status = (503 if any(s >= 500 for s in statuses)
                           else statuses[0])

    def to_xcontent(self) -> Dict[str, Any]:
        body = super().to_xcontent()
        body["failed_shards"] = [
            f.to_xcontent() if isinstance(f, EsException) else f
            for f in self.shard_failures]
        return body
