"""Sequence numbers and checkpoints.

Copy of the reference's ``index/seqno.py`` without retention leases:
``LocalCheckpointTracker`` issues seqnos on the primary and tracks the
largest contiguous processed and persisted seqno; ``ReplicationTracker``
keeps each in-sync copy's local checkpoint and the global checkpoint (the
minimum over the in-sync set).
"""

from __future__ import annotations

import threading
from typing import Dict

NO_OPS_PERFORMED = -1


class LocalCheckpointTracker:
    def __init__(self, max_seq_no: int = NO_OPS_PERFORMED,
                 local_checkpoint: int = NO_OPS_PERFORMED):
        self._lock = threading.Lock()
        self._next_seq_no = max_seq_no + 1
        self._processed = local_checkpoint
        self._persisted = local_checkpoint
        self._pending_processed: set = set()
        self._pending_persisted: set = set()

    def generate_seq_no(self) -> int:
        with self._lock:
            n = self._next_seq_no
            self._next_seq_no += 1
            return n

    def advance_max_seq_no(self, seq_no: int) -> None:
        """Replay path: seqnos arrive pre-assigned."""
        with self._lock:
            if seq_no >= self._next_seq_no:
                self._next_seq_no = seq_no + 1

    @property
    def max_seq_no(self) -> int:
        with self._lock:
            return self._next_seq_no - 1

    def mark_processed(self, seq_no: int) -> None:
        with self._lock:
            self._processed = _advance(self._processed, seq_no,
                                       self._pending_processed)

    def mark_persisted(self, seq_no: int) -> None:
        with self._lock:
            self._persisted = _advance(self._persisted, seq_no,
                                       self._pending_persisted)

    @property
    def processed_checkpoint(self) -> int:
        with self._lock:
            return self._processed

    @property
    def persisted_checkpoint(self) -> int:
        with self._lock:
            return self._persisted


def _advance(checkpoint: int, seq_no: int, pending: set) -> int:
    if seq_no <= checkpoint:
        return checkpoint
    pending.add(seq_no)
    while checkpoint + 1 in pending:
        checkpoint += 1
        pending.discard(checkpoint)
    return checkpoint


class ReplicationTracker:
    """Primary-side view of the replication group: each in-sync copy's
    local checkpoint, and the global checkpoint over them."""

    def __init__(self, shard_allocation_id: str):
        self._lock = threading.Lock()
        self.shard_allocation_id = shard_allocation_id
        self._local_checkpoints: Dict[str, int] = {
            shard_allocation_id: NO_OPS_PERFORMED}
        self._in_sync: set = {shard_allocation_id}
        self._global_checkpoint = NO_OPS_PERFORMED

    def update_local_checkpoint(self, allocation_id: str, checkpoint: int) -> None:
        with self._lock:
            prev = self._local_checkpoints.get(allocation_id, NO_OPS_PERFORMED)
            if checkpoint > prev:
                self._local_checkpoints[allocation_id] = checkpoint
                self._recompute()

    def _recompute(self) -> None:
        cps = [self._local_checkpoints[a] for a in self._in_sync
               if a in self._local_checkpoints]
        if cps:
            gcp = min(cps)
            if gcp > self._global_checkpoint:
                self._global_checkpoint = gcp

    @property
    def global_checkpoint(self) -> int:
        with self._lock:
            return self._global_checkpoint
