"""Error taxonomy.

Copy of the reference's ``common/errors.py`` for the exceptions the node,
the engine and the search path raise. Every exception carries an HTTP
status for the REST layer and renders a structured body (``type``,
``reason``, metadata, nested ``caused_by``) through ``to_xcontent``.

The port adds ``NotLowerable``: a valid search the port does not serve
yet (most of them the reference hands to its planner). It renders as a
400 whose reason names the missing path.
"""

from __future__ import annotations

from typing import Any, Dict


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


class IndexBlockException(ClusterBlockException):
    status = 403


class SettingsException(IllegalArgumentException):
    pass


class NotLowerable(IllegalArgumentException):
    """A valid search that the port does not serve yet. Most are what the
    reference answers on its planner path (``search/planner.py`` +
    ``search/query_phase.py``): a well-formed query outside the lowering
    subset (match or/and/msm, term, terms, or a bool of should-terms on
    one text field), ``min_score``, from + size of 0 or above 10,000,
    sort, aggregations, a filtered alias, knn, scroll or PIT. With
    ``planner=False`` it is one the reference serves on its kernel path
    and the port's kernel path does not take yet: a raw (incompressible)
    pack, or more slots per row than the merge kernel holds. The REST
    layer answers a 400 whose reason names the missing path."""

    def __init__(self, reason: str, planner: bool = True, **metadata: Any):
        path = ("the reference answers this on its planner path, which is "
                "not ported yet" if planner else
                "the reference serves this on its kernel path, whose "
                "support for it is not ported yet")
        super().__init__(f"{reason}; {path}", **metadata)


class IndexNotFound(IndexNotFoundException, KeyError):
    """No index of that name (the reference's IndexNotFoundException)."""

    error_type = "index_not_found_exception"

    def __str__(self) -> str:
        return self.reason
