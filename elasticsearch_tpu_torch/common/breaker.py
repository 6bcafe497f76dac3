"""Hierarchical circuit breakers: memory admission control.

Copy of the reference's ``common/breaker.py`` without its flight-recorder
events. Child breakers (request, fielddata, in-flight, accounting and
``hbm``) account their own reservations; the parent enforces a limit over
their sum. Resident packs charge the ``hbm`` child with their device
bytes before the upload and release the same number when they go.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from elasticsearch_tpu_torch.common.errors import CircuitBreakingException


class CircuitBreaker:
    def __init__(self, name: str, limit_bytes: int, overhead: float = 1.0,
                 parent: Optional["HierarchyCircuitBreakerService"] = None):
        self.name = name
        self.limit = limit_bytes
        self.overhead = overhead
        self._used = 0
        self._trips = 0
        self._lock = threading.Lock()
        self._parent = parent

    @property
    def used(self) -> int:
        return self._used

    @property
    def trip_count(self) -> int:
        return self._trips

    def add_estimate_bytes_and_maybe_break(self, bytes_wanted: int, label: str = "") -> None:
        with self._lock:
            new_used = self._used + bytes_wanted
            if bytes_wanted > 0 and new_used * self.overhead > self.limit:
                self._trips += 1
                raise CircuitBreakingException(
                    f"[{self.name}] data for [{label}] would be [{new_used}/"
                    f"{self.limit}] bytes, which is larger than the limit",
                    bytes_wanted=bytes_wanted, byte_limit=self.limit,
                )
            self._used = new_used
        if self._parent is not None and bytes_wanted > 0:
            try:
                self._parent.check_parent_limit(label)
            except CircuitBreakingException:
                with self._lock:
                    self._used -= bytes_wanted
                raise

    def add_without_breaking(self, bytes_delta: int) -> None:
        with self._lock:
            self._used += bytes_delta

    def release(self, nbytes: int) -> None:
        self.add_without_breaking(-nbytes)

    def stats(self) -> Dict:
        return {
            "limit_size_in_bytes": self.limit,
            "estimated_size_in_bytes": self._used,
            "overhead": self.overhead,
            "tripped": self._trips,
        }


class HierarchyCircuitBreakerService:
    """Parent limit over the sum of child breakers; the children are the
    reference's (request/fielddata/in_flight/accounting) plus ``hbm``,
    which guards device residency."""

    DEFAULT_CHILDREN = {
        "request": 0.6,
        "fielddata": 0.4,
        "in_flight_requests": 1.0,
        "accounting": 1.0,
        "hbm": 0.9,
    }

    def __init__(self, total_limit_bytes: int,
                 child_limits: Optional[Dict[str, int]] = None):
        self.total_limit = total_limit_bytes
        self._parent_trips = 0
        self._parent_lock = threading.Lock()
        self.breakers: Dict[str, CircuitBreaker] = {}
        child_limits = child_limits or {
            name: int(total_limit_bytes * frac)
            for name, frac in self.DEFAULT_CHILDREN.items()
        }
        for name, limit in child_limits.items():
            self.breakers[name] = CircuitBreaker(name, limit, parent=self)

    def get_breaker(self, name: str) -> CircuitBreaker:
        return self.breakers[name]

    def check_parent_limit(self, label: str = "") -> None:
        total = sum(b.used for b in self.breakers.values())
        if total > self.total_limit:
            with self._parent_lock:
                self._parent_trips += 1
            raise CircuitBreakingException(
                f"[parent] data for [{label}] would be [{total}/{self.total_limit}]"
                " bytes, which is larger than the limit",
                bytes_wanted=0, byte_limit=self.total_limit,
            )

    def stats(self) -> Dict:
        out = {name: b.stats() for name, b in self.breakers.items()}
        out["parent"] = {
            "limit_size_in_bytes": self.total_limit,
            "estimated_size_in_bytes": sum(b.used for b in self.breakers.values()),
            "tripped": self._parent_trips,
        }
        return out
