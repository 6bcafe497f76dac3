"""InternalEngine — versioned upserts over immutable segments + WAL.

Copy of the reference's ``index/engine.py`` (the per-shard write machine,
after Elasticsearch's InternalEngine) without its flight-recorder events,
the recovery audit (``replay_tail``), replica no-ops and the per-segment
device pack cache. Kept behaviors:

  - LiveVersionMap: uid → (seq_no, term, version, deleted) for realtime
    version conflict checks and realtime GET before refresh.
  - refresh: in-memory buffer freezes into an immutable segment and a new
    point-in-time reader swaps in (NRT semantics); updates/deletes of
    already-committed docs become tombstones applied to the new reader's
    live bitmaps (soft deletes).
  - flush: refresh + write segments & manifest (safe commit) + translog
    rollover/trim (resume = load commit + replay translog tail).
  - versioning: internal (monotonic per doc) with optional compare-and-set
    via if_seq_no/if_primary_term, and external version mode.
  - merges: a host job re-packing segments in order, purging tombstones.

A refresh that changes anything swaps in a new ShardReader object; the
search service's pack cache keys on those reader identities.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.common.errors import (
    EngineClosedException,
    TranslogDurabilityException,
    VersionConflictEngineException,
)
from elasticsearch_tpu_torch.index import store as seg_store
from elasticsearch_tpu_torch.index.reader import ShardReader
from elasticsearch_tpu_torch.index.segment import (Segment, SegmentWriter,
                                                   merge_segments)
from elasticsearch_tpu_torch.index.seqno import (NO_OPS_PERFORMED,
                                                 LocalCheckpointTracker)
from elasticsearch_tpu_torch.index.translog import Translog, TranslogOp
from elasticsearch_tpu_torch.mapping import MapperService


@dataclasses.dataclass
class VersionValue:
    seq_no: int
    primary_term: int
    version: int
    deleted: bool
    # where the live copy is: ("buffer", ord) | ("segment", name, ord) | None
    location: Optional[Tuple] = None


@dataclasses.dataclass
class EngineConfig:
    path: str
    mapper: MapperService
    primary_term: int = 1
    durability: str = Translog.DURABILITY_REQUEST
    k1: float = 1.2
    b: float = 0.75


@dataclasses.dataclass
class IndexResult:
    doc_id: str
    seq_no: int
    primary_term: int
    version: int
    created: bool
    result: str  # "created" | "updated"


@dataclasses.dataclass
class DeleteResult:
    doc_id: str
    seq_no: int
    primary_term: int
    version: int
    found: bool


class InternalEngine:
    """One shard's write path. Thread-safe via a single write lock (the
    reference serializes per-uid; a shard-level lock is the simple correct
    choice for a host-side control path whose heavy work is on device)."""

    def __init__(self, config: EngineConfig):
        self.config = config
        self._lock = threading.RLock()
        self._closed = False
        self._gen = 0
        os.makedirs(config.path, exist_ok=True)

        self._segments: List[Segment] = []
        self._live: Dict[str, np.ndarray] = {}      # segment name -> bool[num_docs]
        self._version_map: Dict[str, VersionValue] = {}
        self._pending_seg_deletes: List[Tuple[str, int]] = []
        self._buffer_tombstones: set = set()
        self._writer = SegmentWriter(self._next_seg_name())
        self.history_uuid = str(uuid.uuid4())
        self._committed_segment_names: List[str] = []
        self._commit_file_crcs: Dict[str, int] = {}
        self._unpersisted_seq_nos: List[int] = []
        # the max seqno whose op is searchable, stamped at refresh
        self.refresh_checkpoint = NO_OPS_PERFORMED
        self.replayed_ops = 0  # translog ops scanned by replay (monotonic)

        commit = seg_store.read_commit(config.path)
        self.translog = Translog(os.path.join(config.path, "translog"),
                                 config.durability)
        if commit is not None:
            self._recover_from_commit(commit)
        else:
            self.tracker = LocalCheckpointTracker()
            # replay a translog that survived without a commit (all ops)
            self._replay_translog(from_seq_no=0)
        self._reader: Optional[ShardReader] = None
        self.refresh()

    # ------------------------------------------------------------------
    # lifecycle / recovery
    # ------------------------------------------------------------------

    def _next_seg_name(self) -> str:
        self._gen += 1
        return f"_{self._gen}"

    def _recover_from_commit(self, commit: dict) -> None:
        """Load the safe commit, replay the translog tail."""
        # restore dynamically-mapped fields: the commit carries the mapping
        # as of flush time (reference: mappings live in IndexMetadata; here
        # the shard commit is the durable copy). Translog replay below
        # re-derives any dynamic mappings from post-flush ops.
        committed_mapping = commit.get("mapping")
        if committed_mapping:
            self.config.mapper.merge(committed_mapping)
        names = commit["segments"]
        crcs = commit.get("file_crcs", {})
        for name in names:
            seg = seg_store.load_segment(self.config.path, name, crcs)
            self._segments.append(seg)
            live = np.ones(seg.num_docs, dtype=bool)
            for ord_ in commit.get("tombstones", {}).get(name, []):
                live[ord_] = False
            self._live[seg.name] = live
            gen_num = int(name[1:]) if name[1:].isdigit() else 0
            self._gen = max(self._gen, gen_num)
        self._committed_segment_names = list(names)
        self._commit_file_crcs = dict(crcs)
        self.history_uuid = commit.get("history_uuid", self.history_uuid)
        self._writer = SegmentWriter(self._next_seg_name())
        lcp = commit["local_checkpoint"]
        self.tracker = LocalCheckpointTracker(
            max_seq_no=commit["max_seq_no"], local_checkpoint=lcp)
        # rebuild the version map for committed docs lazily: committed
        # segments resolve versions via _resolve_committed on demand
        self._replay_translog(from_seq_no=lcp + 1)

    def _replay_translog(self, from_seq_no: int) -> int:
        count = 0
        for op in self.translog.snapshot(from_seq_no):
            if op.op_type == "index":
                self._apply_index(op.doc_id, op.source, seq_no=op.seq_no,
                                  primary_term=op.primary_term,
                                  version=op.version, log=False)
            elif op.op_type == "delete":
                self._apply_delete(op.doc_id, seq_no=op.seq_no,
                                   primary_term=op.primary_term,
                                   version=op.version, log=False)
            self.tracker.advance_max_seq_no(op.seq_no)
            self.tracker.mark_processed(op.seq_no)
            self.tracker.mark_persisted(op.seq_no)
            count += 1
        self.replayed_ops += count
        return count

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self.translog.close()

    def _ensure_open(self) -> None:
        if self._closed:
            raise EngineClosedException("engine is closed")

    # ------------------------------------------------------------------
    # version resolution
    # ------------------------------------------------------------------

    def _resolve_version(self, doc_id: str) -> Optional[VersionValue]:
        vv = self._version_map.get(doc_id)
        if vv is not None:
            return vv
        return self._resolve_committed(doc_id)

    def _resolve_committed(self, doc_id: str) -> Optional[VersionValue]:
        # newest segment wins (a doc lives in exactly one live location:
        # updates tombstone the old copy). Per-doc seq_no/primary_term/
        # version are persisted in the segment (reference: _seq_no/_version
        # doc values), so CAS and external versioning survive a restart.
        for seg in reversed(self._segments):
            ord_ = seg.id_to_ord.get(doc_id)
            if ord_ is not None and self._live[seg.name][ord_]:
                return VersionValue(int(seg.seq_nos[ord_]),
                                    int(seg.primary_terms[ord_]),
                                    int(seg.doc_versions[ord_]), False,
                                    ("segment", seg.name, ord_))
        return None

    # ------------------------------------------------------------------
    # write ops
    # ------------------------------------------------------------------

    def index(self, doc_id: str, source: dict, *,
              seq_no: Optional[int] = None, primary_term: Optional[int] = None,
              if_seq_no: Optional[int] = None,
              if_primary_term: Optional[int] = None,
              version: Optional[int] = None,
              version_type: str = "internal",
              op_type: str = "index") -> IndexResult:
        """Primary path when seq_no is None (assigns one); replica/replay
        path otherwise (applyIndexOperationOnPrimary/Replica).
        op_type="create" fails with a version conflict if the doc exists —
        checked inside the engine lock so concurrent creates serialize
        (reference: Engine.Index op type CREATE).
        """
        with self._lock:
            self._ensure_open()
            existing = self._resolve_version(doc_id)
            is_update = existing is not None and not existing.deleted

            if seq_no is None:  # primary: run version checks
                if op_type == "create" and is_update:
                    raise VersionConflictEngineException(
                        f"[{doc_id}]: version conflict, document already "
                        f"exists (current version [{existing.version}])")
                if if_seq_no is not None or if_primary_term is not None:
                    if existing is None or existing.deleted:
                        raise VersionConflictEngineException(
                            f"[{doc_id}]: required seqNo [{if_seq_no}], "
                            f"but no document was found")
                    if (existing.seq_no != if_seq_no
                            or (if_primary_term is not None
                                and existing.primary_term != if_primary_term)):
                        raise VersionConflictEngineException(
                            f"[{doc_id}]: version conflict, required seqNo "
                            f"[{if_seq_no}], current [{existing.seq_no}]")
                if version_type == "external":
                    cur = existing.version if is_update else 0
                    if version is None or version <= cur:
                        raise VersionConflictEngineException(
                            f"[{doc_id}]: external version [{version}] <= "
                            f"current [{cur}]")
                    new_version = version
                else:
                    # version continues across a delete tombstone while it
                    # is retained (reference: PUT v1, DELETE v2, PUT → v3)
                    new_version = (existing.version + 1) \
                        if existing is not None else 1
                seq_no = self.tracker.generate_seq_no()
                primary_term = self.config.primary_term
            else:
                new_version = version if version is not None else 1
                self.tracker.advance_max_seq_no(seq_no)
                # replica/replay idempotency: an op at or below the doc's
                # current seq_no is a duplicate or arrived out of order —
                # drop it, but record a translog no-op so this copy's
                # history stays gapless for future recoveries it sources
                # (reference: compareOpToLuceneDocBasedOnSeqNo + NoOp)
                if existing is not None and existing.seq_no >= seq_no:
                    self.translog.add(TranslogOp(
                        "no_op", seq_no, primary_term, reason="stale op"))
                    self.tracker.mark_processed(seq_no)
                    self._mark_durable(seq_no)
                    return IndexResult(doc_id, seq_no, primary_term,
                                       existing.version, created=False,
                                       result="noop")

            try:
                self._apply_index(doc_id, source, seq_no=seq_no,
                                  primary_term=primary_term,
                                  version=new_version, log=True)
            except TranslogDurabilityException:
                self._close_refused_gap(seq_no)
                raise
            self.tracker.mark_processed(seq_no)
            self._mark_durable(seq_no)
            return IndexResult(doc_id, seq_no, primary_term, new_version,
                               created=not is_update,
                               result="updated" if is_update else "created")

    def _apply_index(self, doc_id: str, source: dict, *, seq_no: int,
                     primary_term: int, version: int, log: bool) -> None:
        # WAL ordering: parse (can refuse — nothing mutated), then log
        # (can refuse — nothing mutated), then apply. A translog write
        # fault must leave NO trace of the unacked op in the engine —
        # the refused doc is neither gettable nor searchable, exactly
        # as after a crash-and-replay (which never saw the op either).
        parsed = self.config.mapper.parse_document(doc_id, source)
        if log:
            self.translog.add(TranslogOp("index", seq_no, primary_term,
                                         doc_id, source, version))
        existing = self._resolve_version(doc_id)
        if existing is not None and existing.location is not None:
            self._tombstone_location(existing.location)
        ord_ = self._writer.add_document(parsed, seq_no=seq_no,
                                         primary_term=primary_term,
                                         version=version)
        self._version_map[doc_id] = VersionValue(
            seq_no, primary_term, version, False, ("buffer", ord_))

    def bulk_index(self, docs: List[Tuple[str, dict]]) -> List[Any]:
        """Primary-path bulk upsert (plain index ops — create/CAS/external
        versioning take the per-op path). Parses documents OUTSIDE the
        engine lock (analysis is the indexing hot loop), then applies the
        whole batch under one lock acquisition with one translog append +
        fsync (reference: TransportShardBulkAction applies a shard bulk as
        one unit)."""
        mapper = self.config.mapper
        parsed_docs: List[Any] = []  # ParsedDocument | Exception, per op
        for d, s in docs:
            try:
                parsed_docs.append(mapper.parse_document(d, s))
            except Exception as exc:  # per-item failure, like _bulk items
                parsed_docs.append(exc)
        results: List[Any] = [None] * len(parsed_docs)
        tl_ops: List[TranslogOp] = []
        with self._lock:
            self._ensure_open()
            # WAL ordering, batch form: plan every op (versions resolved
            # against the live map plus the batch's own earlier ops),
            # append the whole batch to the translog, and only then
            # mutate the engine — a refused batch leaves no trace beyond
            # its consumed seqnos, which are closed as gaps.
            plan: List[Tuple[int, Any, int, int, int, bool]] = []
            overlay: Dict[str, int] = {}  # doc_id -> version within batch
            for i, parsed in enumerate(parsed_docs):
                if isinstance(parsed, Exception):
                    results[i] = parsed
                    continue
                doc_id = parsed.doc_id
                if doc_id in overlay:
                    is_update = True
                    new_version = overlay[doc_id] + 1
                else:
                    existing = self._resolve_version(doc_id)
                    is_update = existing is not None and not existing.deleted
                    new_version = (existing.version + 1) \
                        if existing is not None else 1
                overlay[doc_id] = new_version
                seq_no = self.tracker.generate_seq_no()
                primary_term = self.config.primary_term
                tl_ops.append({"op": "index", "seq_no": seq_no,
                               "primary_term": primary_term,
                               "version": new_version, "id": doc_id,
                               "source": parsed.source})
                plan.append((i, parsed, seq_no, primary_term,
                             new_version, is_update))
            try:
                self.translog.add_batch(tl_ops)
            except TranslogDurabilityException:
                for _i, _p, seq_no, _pt, _v, _u in plan:
                    self._close_refused_gap(seq_no)
                raise
            for i, parsed, seq_no, primary_term, new_version, is_update \
                    in plan:
                doc_id = parsed.doc_id
                existing = self._resolve_version(doc_id)
                if existing is not None and existing.location is not None:
                    self._tombstone_location(existing.location)
                ord_ = self._writer.add_document(
                    parsed, seq_no=seq_no,
                    primary_term=primary_term, version=new_version)
                self._version_map[doc_id] = VersionValue(
                    seq_no, primary_term, new_version, False,
                    ("buffer", ord_))
                results[i] = IndexResult(
                    doc_id, seq_no, primary_term, new_version,
                    created=not is_update,
                    result="updated" if is_update else "created")
                self.tracker.mark_processed(seq_no)
                self._mark_durable(seq_no)
        return results

    def delete(self, doc_id: str, *,
               seq_no: Optional[int] = None, primary_term: Optional[int] = None,
               if_seq_no: Optional[int] = None,
               if_primary_term: Optional[int] = None) -> DeleteResult:
        with self._lock:
            self._ensure_open()
            existing = self._resolve_version(doc_id)
            found = existing is not None and not existing.deleted
            if seq_no is None:
                if if_seq_no is not None and (
                        not found or existing.seq_no != if_seq_no
                        or (if_primary_term is not None
                            and existing.primary_term != if_primary_term)):
                    raise VersionConflictEngineException(
                        f"[{doc_id}]: version conflict on delete")
                seq_no = self.tracker.generate_seq_no()
                primary_term = self.config.primary_term
            else:
                self.tracker.advance_max_seq_no(seq_no)
                # same replica-path staleness rule as index()
                if existing is not None and existing.seq_no >= seq_no:
                    self.translog.add(TranslogOp(
                        "no_op", seq_no, primary_term, reason="stale op"))
                    self.tracker.mark_processed(seq_no)
                    self._mark_durable(seq_no)
                    return DeleteResult(doc_id, seq_no, primary_term,
                                        existing.version, found=False)
            # version stays monotonic across repeated deletes while the
            # tombstone is retained (same continuity rule as index())
            version = (existing.version + 1) if existing is not None else 1
            try:
                self._apply_delete(doc_id, seq_no=seq_no,
                                   primary_term=primary_term,
                                   version=version, log=True)
            except TranslogDurabilityException:
                self._close_refused_gap(seq_no)
                raise
            self.tracker.mark_processed(seq_no)
            self._mark_durable(seq_no)
            return DeleteResult(doc_id, seq_no, primary_term, version, found)

    def _apply_delete(self, doc_id: str, *, seq_no: int, primary_term: int,
                      version: int, log: bool) -> None:
        # same WAL ordering as _apply_index: log before apply so a
        # refused translog write leaves the tombstone un-applied
        if log:
            self.translog.add(TranslogOp("delete", seq_no, primary_term,
                                         doc_id, None, version))
        existing = self._resolve_version(doc_id)
        if existing is not None and existing.location is not None:
            self._tombstone_location(existing.location)
        self._version_map[doc_id] = VersionValue(
            seq_no, primary_term, version, True, None)

    def _close_refused_gap(self, seq_no: int) -> None:
        """A write fault refused the op AFTER its seqno was issued: that
        number now maps to no operation, ever (a crash-and-replay never
        sees it either — WAL ordering kept it out of the translog). Mark
        it processed+persisted so the contiguous checkpoints — and
        everything gated on them: refresh visibility, wait_for_visible,
        the async fsync cycle — don't wedge on the hole."""
        self.tracker.mark_processed(seq_no)
        self.tracker.mark_persisted(seq_no)

    def _mark_durable(self, seq_no: int) -> None:
        """Advance the persisted checkpoint only when the op is actually
        fsync'd: immediately under durability=request (translog.add fsyncs
        per-op), else deferred to the next sync (the
        reference keeps processed vs persisted distinct)."""
        if self.config.durability == Translog.DURABILITY_REQUEST:
            self.tracker.mark_persisted(seq_no)
        else:
            self._unpersisted_seq_nos.append(seq_no)

    def sync_translog(self) -> None:
        """Fsync pending translog ops and advance the persisted checkpoint
        (reference: the async-durability fsync timer)."""
        with self._lock:
            self._ensure_open()
            self.translog.sync()
            for s in self._unpersisted_seq_nos:
                self.tracker.mark_persisted(s)
            self._unpersisted_seq_nos = []

    def _tombstone_location(self, location: Tuple) -> None:
        if location[0] == "buffer":
            self._buffer_tombstones.add(location[1])
        else:
            _, seg_name, ord_ = location
            self._pending_seg_deletes.append((seg_name, ord_))

    # ------------------------------------------------------------------
    # reads
    # ------------------------------------------------------------------

    def get(self, doc_id: str) -> Optional[Dict[str, Any]]:
        """Realtime get (reference: ShardGetService via LiveVersionMap →
        translog/buffer): sees un-refreshed writes."""
        with self._lock:
            self._ensure_open()
            vv = self._resolve_version(doc_id)
            if vv is None or vv.deleted:
                return None
            if vv.location is None:
                return None
            if vv.location[0] == "buffer":
                source = self._writer._stored[vv.location[1]]
            else:
                _, seg_name, ord_ = vv.location
                seg = next(s for s in self._segments if s.name == seg_name)
                source = seg.stored_source[ord_]
            return {"_id": doc_id, "_version": vv.version,
                    "_seq_no": vv.seq_no, "_primary_term": vv.primary_term,
                    "_source": source, "found": True}

    def acquire_reader(self) -> ShardReader:
        with self._lock:
            self._ensure_open()
            assert self._reader is not None
            return self._reader

    # ------------------------------------------------------------------
    # refresh / flush / merge
    # ------------------------------------------------------------------

    def refresh(self) -> bool:
        """Make buffered ops searchable (reference: InternalEngine#refresh,
        the 1s NRT cycle). Returns True if anything changed."""
        with self._lock:
            self._ensure_open()
            changed = False
            if self._writer.num_docs > 0:
                seg = self._writer.freeze()
                live = np.ones(seg.num_docs, dtype=bool)
                for ord_ in self._buffer_tombstones:
                    live[ord_] = False
                self._segments.append(seg)
                self._live[seg.name] = live
                # relocate version-map buffer pointers to the new segment
                for doc_id, vv in self._version_map.items():
                    if vv.location is not None and vv.location[0] == "buffer":
                        vv.location = ("segment", seg.name, vv.location[1])
                self._buffer_tombstones = set()
                self._writer = SegmentWriter(self._next_seg_name())
                changed = True
            if self._pending_seg_deletes:
                for seg_name, ord_ in self._pending_seg_deletes:
                    if seg_name in self._live:
                        self._live[seg_name][ord_] = False
                self._pending_seg_deletes = []
                changed = True
            if changed or self._reader is None:
                self._reader = ShardReader(
                    [(s, self._live[s.name]) for s in self._segments],
                    self.config.mapper, self.config.k1, self.config.b)
            self.refresh_checkpoint = max(self.refresh_checkpoint,
                                          self.tracker.processed_checkpoint)
            return changed

    def flush(self) -> None:
        """Commit: refresh + persist segments + manifest, then roll/trim
        the translog (reference: InternalEngine#flush = lucene commit +
        translog trim)."""
        with self._lock:
            self._ensure_open()
            self.refresh()
            self.sync_translog()
            crcs = dict(self._commit_file_crcs)
            committed = set(self._committed_segment_names)
            for seg in self._segments:
                if seg.name not in committed:
                    crcs.update(seg_store.save_segment(self.config.path, seg))
            names = [s.name for s in self._segments]
            crcs = {fn: c for fn, c in crcs.items()
                    if fn.split(".")[0] in {n for n in names}}
            tombstones = {
                s.name: np.nonzero(~self._live[s.name])[0].tolist()
                for s in self._segments if not self._live[s.name].all()}
            gen = self.translog.rollover()
            seg_store.write_commit(
                self.config.path, segments=names, tombstones=tombstones,
                local_checkpoint=self.tracker.processed_checkpoint,
                max_seq_no=self.tracker.max_seq_no,
                primary_term=self.config.primary_term,
                translog_generation=gen,
                mapping=self.config.mapper.to_mapping(),
                file_crcs=crcs, history_uuid=self.history_uuid)
            self._committed_segment_names = names
            self._commit_file_crcs = crcs
            self.translog.trim(gen)
            seg_store.cleanup_unreferenced(self.config.path, names)

    def force_merge(self) -> bool:
        with self._lock:
            self._ensure_open()
            self.refresh()
            if len(self._segments) <= 1 and all(
                    self._live[s.name].all() for s in self._segments):
                return False
            merged = merge_segments(self._next_seg_name(), self._segments,
                                    [self._live[s.name] for s in self._segments])
            self._segments = [merged]
            self._live = {merged.name: np.ones(merged.num_docs, dtype=bool)}
            # re-point version map at the merged segment
            for doc_id, vv in self._version_map.items():
                if vv.location is not None and vv.location[0] == "segment":
                    ord_ = merged.id_to_ord.get(doc_id)
                    if ord_ is not None:
                        vv.location = ("segment", merged.name, ord_)
            self._reader = ShardReader(
                [(merged, self._live[merged.name])], self.config.mapper,
                self.config.k1, self.config.b)
            return True

    # ------------------------------------------------------------------
    # stats / introspection
    # ------------------------------------------------------------------

    def num_docs(self) -> int:
        with self._lock:
            committed = sum(int(self._live[s.name].sum())
                            for s in self._segments)
            # pending-but-unapplied segment deletes (a buffered update of a
            # committed doc leaves the old copy live until refresh): don't
            # double-count those docs
            pending = {(seg_name, ord_)
                       for seg_name, ord_ in self._pending_seg_deletes
                       if seg_name in self._live
                       and self._live[seg_name][ord_]}
            committed -= len(pending)
            buffered = len({d for d, vv in self._version_map.items()
                            if vv.location is not None
                            and vv.location[0] == "buffer"
                            and not vv.deleted})
            return committed + buffered

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "num_docs": self.num_docs(),
                "segments": len(self._segments),
                "max_seq_no": self.tracker.max_seq_no,
                "local_checkpoint": self.tracker.processed_checkpoint,
                "persisted_checkpoint": self.tracker.persisted_checkpoint,
                "refresh_checkpoint": self.refresh_checkpoint,
                "replayed_ops": self.replayed_ops,
                "translog": self.translog.stats(),
            }
