"""Logging: the node-wide configuration and the search slow log.

Copy of the reference's ``common/logging.py``: one process-wide
configuration from node settings (``logger.<name>: LEVEL`` overrides,
the ES level names, TRACE as DEBUG), owner-scoped so that two nodes of
one process do not reset each other's overrides, and the slow log: a
per-index ``SlowLog`` whose threshold tiers (warn, info, debug, trace,
from ``index.search.slowlog.threshold.query.*``; -1 disables a tier)
pick the record's level by the search's elapsed time. The port has no
tracing yet, so a record's ``trace_id`` is always ``-``.
"""

from __future__ import annotations

import json
import logging
import sys
from typing import Any, Dict, Optional

from elasticsearch_tpu_torch.common.errors import IllegalArgumentException
from elasticsearch_tpu_torch.common.units import parse_seconds

ROOT = "elasticsearch_tpu_torch"
SEARCH_SLOWLOG = "elasticsearch_tpu_torch.index.search.slowlog"

_FORMAT = "[%(asctime)s][%(levelname)-5s][%(name)s] %(message)s"

# logger name → owner token of the configure() call that set it; resets
# apply only to the same owner
_configured_loggers: Dict[str, Any] = {}


def configure(settings=None, owner: Any = None) -> None:
    """Install the node's logging configuration. ``logger.<name>``
    settings set per-logger levels. A call with the same `owner` (the
    dynamic-settings path) resets the overrides that owner removed;
    other owners' overrides are left alone."""
    root = logging.getLogger(ROOT)
    if not any(isinstance(h, logging.StreamHandler)
               for h in root.handlers):
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(handler)
    if root.level == logging.NOTSET:
        root.setLevel(logging.INFO)
    wanted: Dict[str, int] = {}
    if settings is not None:
        for key, value in settings.get_as_dict().items():
            if key.startswith("logger."):
                wanted[key[len("logger."):]] = level_of(value)
    for name, level in wanted.items():
        logging.getLogger(name).setLevel(level)
        _configured_loggers[name] = owner
    if owner is None:
        return  # an ad-hoc call resets nothing
    # this owner's removed overrides revert to inheritance
    for name, owned_by in list(_configured_loggers.items()):
        if owned_by == owner and name not in wanted:
            logging.getLogger(name).setLevel(
                logging.INFO if name == ROOT else logging.NOTSET)
            del _configured_loggers[name]


def level_of(value: Any) -> int:
    """An ES level name → the Python level (TRACE has no Python level:
    it is DEBUG). An unknown name is a 400."""
    name = str(value).upper()
    mapping = {"TRACE": logging.DEBUG, "DEBUG": logging.DEBUG,
               "INFO": logging.INFO, "WARN": logging.WARNING,
               "WARNING": logging.WARNING, "ERROR": logging.ERROR,
               "FATAL": logging.CRITICAL, "CRITICAL": logging.CRITICAL}
    level = mapping.get(name)
    if level is None:
        raise IllegalArgumentException(
            f"unknown log level [{value}] (use trace|debug|info|warn|"
            f"error|fatal)")
    return level


class SlowLog:
    """Threshold-tiered slow logging for one index (the thresholds are
    the index's settings; -1 disables a tier)."""

    LEVELS = ("warn", "info", "debug", "trace")
    _LOG_FN = {"warn": "warning", "info": "info", "debug": "debug",
               "trace": "debug"}

    def __init__(self, index_name: str, settings, phase: str = "query",
                 prefix: str = "index.search.slowlog.threshold",
                 channel: str = SEARCH_SLOWLOG):
        self.index_name = index_name
        self.logger = logging.getLogger(channel)
        self.phase = phase
        self.thresholds: Dict[str, float] = {}
        for level in self.LEVELS:
            raw = settings.get(f"{prefix}.{self.phase}.{level}")
            if raw is None:
                continue
            seconds = parse_seconds(raw)
            if seconds >= 0:
                self.thresholds[level] = seconds
        # a configured debug or trace tier must emit: the channel inherits
        # the package's INFO unless it is opened up here (a logger.*
        # setting still overrides it afterwards)
        if any(lvl in self.thresholds for lvl in ("debug", "trace")) \
                and self.logger.level == logging.NOTSET:
            self.logger.setLevel(logging.DEBUG)

    @property
    def enabled(self) -> bool:
        return bool(self.thresholds)

    def maybe_log(self, took_s: float, shard: Any,
                  source: Optional[Dict[str, Any]] = None,
                  total_hits: Optional[int] = None) -> Optional[str]:
        """Log at the most severe tier whose threshold `took_s` reaches →
        that tier, or None. `shard` is the shard number, or "kernel" for
        the kernel path (one train covers every shard of the index)."""
        hit_level = None
        for level in self.LEVELS:  # warn first: the most severe
            t = self.thresholds.get(level)
            if t is not None and took_s >= t:
                hit_level = level
                break
        if hit_level is None:
            return None
        hits = total_hits if total_hits is not None else "-"
        msg = (f"[{self.index_name}][{shard}] took[{took_s * 1000:.1f}ms]"
               f", took_millis[{int(took_s * 1000)}]"
               f", total_hits[{hits}]"
               f", search_type[QUERY_THEN_FETCH]"
               f", trace_id[-]"
               f", source[{json.dumps(source or {}, sort_keys=True)[:1000]}]")
        getattr(self.logger, self._LOG_FN[hit_level])(msg)
        return hit_level
