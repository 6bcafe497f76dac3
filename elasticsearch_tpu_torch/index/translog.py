"""Translog — the per-shard write-ahead log.

Copy of the reference's ``index/translog.py`` (without its flight-recorder
events, fault-injection hooks and retention locks): an append-only op log in
generations, fsync'd per the durability policy (`request` = fsync before
ack, `async` = timer), with an atomically-replaced checkpoint file; on
recovery the safe commit is loaded and the translog tail replayed.
Rollover starts a new generation; trimming deletes
generations wholly below the committed seqno horizon.

File format (one file per generation, `translog-N.tlog`):
  header: 8-byte magic "ESTPUTL1"
  record: [len u32 LE][crc32 u32 LE of payload][payload utf-8 JSON]
Corruption (bad magic, short read, CRC mismatch) raises
TranslogCorruptedException; a torn tail (partial final record) is
truncated silently on read like the reference's Checkpoint-guarded reads.

checkpoint.json (atomic tmp+rename+fsync): {generation, max_seq_no,
min_translog_generation} — read first on open to know which generations
are live.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import threading
import zlib
from typing import Dict, Iterator, List, Optional

from elasticsearch_tpu_torch.common.errors import (
    TranslogCorruptedException, TranslogDurabilityException)

MAGIC = b"ESTPUTL1"
_HDR = struct.Struct("<II")  # len, crc


@dataclasses.dataclass
class TranslogOp:
    """One logged operation: index | delete | no_op."""

    op_type: str               # "index" | "delete" | "no_op"
    seq_no: int
    primary_term: int
    doc_id: Optional[str] = None
    source: Optional[dict] = None
    version: int = 1
    reason: Optional[str] = None  # no_op

    def to_dict(self) -> dict:
        d = {"op": self.op_type, "seq_no": self.seq_no,
             "primary_term": self.primary_term, "version": self.version}
        if self.doc_id is not None:
            d["id"] = self.doc_id
        if self.source is not None:
            d["source"] = self.source
        if self.reason is not None:
            d["reason"] = self.reason
        return d

    @staticmethod
    def from_dict(d: dict) -> "TranslogOp":
        return TranslogOp(d["op"], d["seq_no"], d["primary_term"],
                          d.get("id"), d.get("source"), d.get("version", 1),
                          d.get("reason"))


@dataclasses.dataclass
class Checkpoint:
    generation: int
    max_seq_no: int
    min_translog_generation: int

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_atomic(path: str, data: bytes) -> None:
    """CRC'd atomic file replace (reference: common/io atomic writes +
    Translog.Checkpoint): tmp file, fsync, rename, fsync dir."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")


class Translog:
    DURABILITY_REQUEST = "request"
    DURABILITY_ASYNC = "async"

    def __init__(self, path: str, durability: str = DURABILITY_REQUEST):
        self.path = path
        self.durability = durability
        self._lock = threading.Lock()
        os.makedirs(path, exist_ok=True)
        ckp_path = self._checkpoint_path()
        if os.path.exists(ckp_path):
            ckp = self._read_checkpoint()
        else:
            ckp = Checkpoint(generation=1, max_seq_no=-1,
                             min_translog_generation=1)
            self._write_checkpoint(ckp)
        self.checkpoint = ckp
        self._open_writer(ckp.generation)
        self._unsynced = 0

    # ---------------- paths ----------------

    def _checkpoint_path(self) -> str:
        return os.path.join(self.path, "checkpoint.json")

    def _gen_path(self, gen: int) -> str:
        return os.path.join(self.path, f"translog-{gen}.tlog")

    # ---------------- checkpoint ----------------

    def _read_checkpoint(self) -> Checkpoint:
        with open(self._checkpoint_path(), "rb") as f:
            d = json.loads(f.read().decode("utf-8"))
        return Checkpoint(d["generation"], d["max_seq_no"],
                          d["min_translog_generation"])

    def _write_checkpoint(self, ckp: Checkpoint) -> None:
        write_atomic(self._checkpoint_path(),
                     json.dumps(ckp.to_dict()).encode("utf-8"))

    # ---------------- writer ----------------

    def _open_writer(self, gen: int) -> None:
        p = self._gen_path(gen)
        new = not os.path.exists(p)
        self._file = open(p, "ab")
        if new:
            self._file.write(MAGIC)
            self._file.flush()
            os.fsync(self._file.fileno())

    def add(self, op: TranslogOp) -> None:
        payload = json.dumps(op.to_dict(), separators=(",", ":")).encode("utf-8")
        rec = _HDR.pack(len(payload), zlib.crc32(payload)) + payload
        with self._lock:
            try:
                self._file.write(rec)
                if op.seq_no > self.checkpoint.max_seq_no:
                    self.checkpoint.max_seq_no = op.seq_no
                if self.durability == self.DURABILITY_REQUEST:
                    self._file.flush()
                    os.fsync(self._file.fileno())
                    self._write_checkpoint(self.checkpoint)
                else:
                    self._unsynced += 1
            except OSError as e:
                raise TranslogDurabilityException(
                    f"translog append failed ({e}): durability cannot be "
                    f"honored, operation not acknowledged") from e

    def add_batch(self, ops) -> None:
        """Append a whole bulk's ops with ONE write and (under
        durability=request) ONE fsync — the reference's per-bulk-request
        fsync granularity, not per-op."""
        if not ops:
            return
        # the whole batch serializes as ONE json array record (one
        # dumps, one crc) — snapshot() fans it back out. Ops may be
        # TranslogOp objects or pre-built wire dicts (the engine bulk
        # path skips the intermediate objects entirely).
        dicts = [op.to_dict() if isinstance(op, TranslogOp) else op
                 for op in ops]
        payload = json.dumps(dicts, separators=(",", ":")).encode("utf-8")
        rec = _HDR.pack(len(payload), zlib.crc32(payload)) + payload
        with self._lock:
            try:
                self._file.write(rec)
                mx = max(d["seq_no"] for d in dicts)
                if mx > self.checkpoint.max_seq_no:
                    self.checkpoint.max_seq_no = mx
                if self.durability == self.DURABILITY_REQUEST:
                    self._file.flush()
                    os.fsync(self._file.fileno())
                    self._write_checkpoint(self.checkpoint)
                else:
                    self._unsynced += len(ops)
            except OSError as e:
                raise TranslogDurabilityException(
                    f"translog batch append failed ({e}): durability "
                    f"cannot be honored, bulk not acknowledged") from e

    def sync(self) -> None:
        """Flush+fsync pending ops (async durability timer / pre-commit)."""
        with self._lock:
            try:
                self._file.flush()
                os.fsync(self._file.fileno())
                self._write_checkpoint(self.checkpoint)
                self._unsynced = 0
            except OSError as e:
                raise TranslogDurabilityException(
                    f"translog sync failed ({e}): durability cannot be "
                    f"honored") from e

    def rollover(self) -> int:
        """Start a new generation (reference: Translog#rollGeneration —
        called at flush time so committed ops live in older generations)."""
        with self._lock:
            self._file.flush()
            os.fsync(self._file.fileno())
            self._file.close()
            self.checkpoint.generation += 1
            self._write_checkpoint(self.checkpoint)
            self._open_writer(self.checkpoint.generation)
            return self.checkpoint.generation

    def trim(self, min_required_gen: int) -> None:
        """Delete generations < min_required_gen (reference:
        TranslogDeletionPolicy after a safe commit)."""
        with self._lock:
            min_gen = max(self.checkpoint.min_translog_generation, 1)
            if min_required_gen <= min_gen:
                return
            for gen in range(min_gen, min_required_gen):
                p = self._gen_path(gen)
                if os.path.exists(p):
                    os.remove(p)
            self.checkpoint.min_translog_generation = min_required_gen
            self._write_checkpoint(self.checkpoint)

    def close(self) -> None:
        with self._lock:
            if self._file.closed:
                return
            try:
                self._file.flush()
                os.fsync(self._file.fileno())
            finally:
                self._file.close()

    # ---------------- reads ----------------

    def generations(self) -> List[int]:
        out = []
        for name in os.listdir(self.path):
            if name.startswith("translog-") and name.endswith(".tlog"):
                out.append(int(name[len("translog-"):-len(".tlog")]))
        return sorted(g for g in out
                      if g >= self.checkpoint.min_translog_generation)

    def snapshot(self, from_seq_no: int = 0) -> Iterator[TranslogOp]:
        """All ops with seq_no >= from_seq_no, oldest generation first.
        ."""
        for gen in self.generations():
            yield from self._read_gen(gen, from_seq_no)

    def _read_gen(self, gen: int, from_seq_no: int) -> Iterator[TranslogOp]:
        p = self._gen_path(gen)
        if not os.path.exists(p):
            return
        with open(p, "rb") as f:
            magic = f.read(len(MAGIC))
            if magic != MAGIC:
                raise TranslogCorruptedException(
                    f"translog [{p}] bad header {magic!r}")
            while True:
                hdr = f.read(_HDR.size)
                if len(hdr) == 0:
                    return
                if len(hdr) < _HDR.size:
                    return  # torn tail: partial header past last fsync
                ln, crc = _HDR.unpack(hdr)
                if ln > 1 << 30:
                    raise TranslogCorruptedException(
                        f"translog [{p}] absurd record length {ln}")
                payload = f.read(ln)
                if len(payload) < ln:
                    return  # torn tail
                if zlib.crc32(payload) != crc:
                    raise TranslogCorruptedException(
                        f"translog [{p}] checksum mismatch")
                decoded = json.loads(payload.decode("utf-8"))
                # a record is one op dict, or a LIST of op dicts (the
                # bulk path writes whole batches as one record)
                for d in (decoded if isinstance(decoded, list)
                          else (decoded,)):
                    op = TranslogOp.from_dict(d)
                    if op.seq_no >= from_seq_no:
                        yield op

    def stats(self) -> Dict[str, int]:
        ops = 0
        size = 0
        for gen in self.generations():
            p = self._gen_path(gen)
            if os.path.exists(p):
                size += os.path.getsize(p)
        for _ in self.snapshot():
            ops += 1
        return {"operations": ops, "size_in_bytes": size,
                "generation": self.checkpoint.generation,
                "uncommitted_operations": self._unsynced}
