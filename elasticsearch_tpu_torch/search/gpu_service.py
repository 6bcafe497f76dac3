"""GPU serving path for ``_search``: resident compressed packs + a
micro-batched kernel.

Counterpart of the reference's ``search/tpu_service.py`` for the main
path on one card. A ``_search`` body goes:

  parse_query → lower_query → MicroBatcher (8 / 64 / 128 query buckets)
  → prepare_query_batch → sorted_merge_topk (the Hopper merge kernel for
  packable weights) → cross-shard top-k → decode → hits response.

  ResidentPack — one (index, field) StackedShardPack in the compressed
    format, placed on the device (one pack row per segment, one
    statistics group per index shard: the reference's query_then_fetch
    scope), with the tables that resolve kernel hits to ``_id``s.
  IndexPackCache — the node's resident packs, keyed on the identities of
    the shard readers they were built from (a refresh or merge swaps a
    reader, so the key changes exactly when the segments or live docs
    do). Each pack charges the ``hbm`` breaker with its device bytes
    before the upload and releases them on a rebuild, an invalidate or a
    failed upload; a lookup during another thread's rebuild serves the
    old pack.
  MicroBatcher — coalesces concurrent queries per pack for a short
    window (or until the batch cap) and runs them as one launch.
  StageTimes — per-stage wall time of the serving path.
  GpuSearchService — ``try_search`` over a node's IndexService (the
    reference's TpuSearchService.try_search), and a bare service of its
    own: create_index / index / refresh / search.

A query outside the lowering subset raises ``NotLowerable``; the planner
path that answers it in the reference comes with a later slice. Nothing
here falls back: a fault of the kernel path reaches the caller.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.common.errors import IndexNotFound, NotLowerable
from elasticsearch_tpu_torch.index.segment import Segment, SegmentWriter
from elasticsearch_tpu_torch.indices.routing import shard_for
from elasticsearch_tpu_torch.mapping import MapperService, TextFieldType
from elasticsearch_tpu_torch.ops import merge_kernel
from elasticsearch_tpu_torch.parallel import distributed as dist
from elasticsearch_tpu_torch.parallel.device import resolve_device
from elasticsearch_tpu_torch.search import dsl
from elasticsearch_tpu_torch.search.planner import choose_kernel_variant

#: window floor of the exact kernel (the reference's _PRUNE_WINDOW)
MIN_T_WINDOW = 8


class StageTimes:
    """Per-stage wall time on the serving path (the reference's
    StageTimes, without its trace exemplars). Stages: ``lower`` (parse,
    lowering and the resident-pack lookup), ``batch_wait`` (submit to
    result: the batching window, the queue and the train), ``train``
    (one launch + finish, per train) and ``assemble`` (the coordinator's
    hits block). Each stage keeps its running totals and a bounded ring
    of recent samples for percentiles."""

    RING_SIZE = 4096

    def __init__(self):
        self._lock = threading.Lock()
        self.seconds: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._rings: Dict[str, collections.deque] = {}

    def add(self, stage: str, dt: float, n: int = 1) -> None:
        with self._lock:
            self.seconds[stage] = self.seconds.get(stage, 0.0) + dt
            self.counts[stage] = self.counts.get(stage, 0) + n
            ring = self._rings.get(stage)
            if ring is None:
                ring = self._rings[stage] = collections.deque(
                    maxlen=self.RING_SIZE)
            ring.append(dt / n if n > 1 else dt)

    def reset(self) -> None:
        with self._lock:
            self.seconds.clear()
            self.counts.clear()
            self._rings.clear()

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """{stage: {seconds, count, mean_ms, p50_ms, p99_ms, max_ms}};
        the percentiles are over the ring's recent samples."""
        with self._lock:
            rows = {s: (self.seconds[s], self.counts[s],
                        sorted(self._rings[s])) for s in sorted(self.seconds)}
        out = {}
        for s, (sec, count, ring) in rows.items():
            out[s] = {"seconds": sec, "count": count,
                      "mean_ms": sec / count * 1e3 if count else 0.0}
            if ring:
                out[s]["p50_ms"] = ring[len(ring) // 2] * 1e3
                out[s]["p99_ms"] = ring[min(len(ring) - 1,
                                            int(len(ring) * 0.99))] * 1e3
                out[s]["max_ms"] = ring[-1] * 1e3
        return out


# ---------------------------------------------------------------------------
# DSL lowering
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FlatQuery:
    """A query the kernel serves directly: weighted OR over one text
    field's terms with a minimum-match count (1 = OR, len(terms) = AND)."""

    field: str
    terms: List[str]
    boost: float
    min_count: int


def lower_query(query: dsl.QueryNode, mapper) -> Optional[FlatQuery]:
    """QueryNode → FlatQuery, or None when the kernel cannot serve it."""
    if isinstance(query, dsl.MatchQuery):
        ft = mapper.field_type(query.field)
        if not isinstance(ft, TextFieldType):
            return None
        terms = ft.search_terms(query.query)
        if not terms:
            return None
        msm = len(terms) if query.operator == "and" else 1
        if query.minimum_should_match is not None and query.operator == "or":
            # unclamped: msm > len(terms) matches nothing
            msm = query.minimum_should_match
        return FlatQuery(query.field, terms, query.boost, msm)
    if isinstance(query, dsl.TermQuery):
        ft = mapper.field_type(query.field)
        if not isinstance(ft, TextFieldType):
            return None
        return FlatQuery(query.field, [str(query.value)], query.boost, 1)
    if isinstance(query, dsl.TermsQuery):
        ft = mapper.field_type(query.field)
        if not isinstance(ft, TextFieldType):
            return None
        terms = [str(v) for v in query.values]
        if not terms:
            return None
        return FlatQuery(query.field, terms, query.boost, 1)
    if isinstance(query, dsl.BoolQuery):
        # single-field should-only bool of term/match clauses = weighted OR
        if query.must or query.must_not or query.filter:
            return None
        subs = [lower_query(q, mapper) for q in query.should]
        if not subs or any(s is None for s in subs):
            return None
        fields = {s.field for s in subs}
        if len(fields) != 1:
            return None
        if any(s.min_count != 1 for s in subs):
            return None  # nested AND semantics ≠ flat msm
        if len({s.boost for s in subs}) != 1:
            return None  # per-clause boosts need per-slot weights
        msm = query.minimum_should_match or 1
        if msm > 1 and any(len(s.terms) != 1 for s in subs):
            # msm counts CLAUSES, min_count counts TERMS
            return None
        terms: List[str] = []
        for s in subs:
            terms.extend(s.terms)
        return FlatQuery(fields.pop(), terms, query.boost * subs[0].boost,
                         msm)
    return None


# ---------------------------------------------------------------------------
# pack residency
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ResidentPack:
    """One (index, field) compressed pack on the device + provenance."""

    pack: dist.StackedShardPack
    streams: dist.CompressedStreams
    device_arrays: Tuple[torch.Tensor, ...]
    row_origin: List[Tuple[int, str]]   # pack row → (shard, segment name)
    row_segments: List[Segment]         # pack row → segment (for _source)
    row_offset: np.ndarray              # int64[S] into id_cat
    id_cat: np.ndarray                  # object[total docs] external ids
    #: the identities of the shard readers it was built from, and the
    #: readers themselves: holding them keeps a freed reader's id from
    #: being reused by a new reader while this pack serves
    reader_key: Tuple[int, ...] = ()
    readers: Dict[int, Any] = dataclasses.field(default_factory=dict)
    hbm_bytes: int = 0                  # the breaker charge it holds
    #: set when the pack leaves its cache; the batcher then takes no
    #: more work for it, so nothing new holds its device arrays
    retired: bool = False

    def nbytes_device(self) -> int:
        """Bytes of the resident device image."""
        return int(sum(t.numel() * t.element_size()
                       for t in self.device_arrays))

    def resolve_ids(self, rows: np.ndarray, ords: np.ndarray) -> np.ndarray:
        """(pack row, local ordinal) → external _id, vectorized."""
        if len(rows) == 0:
            return np.empty(0, dtype=object)
        return self.id_cat[self.row_offset[rows] + ords]


def place_pack(pack: dist.StackedShardPack, device: torch.device,
               row_origin: List[Tuple[int, str]],
               row_segments: List[Segment], breaker=None,
               reader_key: Tuple[int, ...] = (),
               readers: Optional[Dict[int, Any]] = None) -> ResidentPack:
    """Compress `pack` and place it on `device`. With a breaker, the
    streams' device bytes are charged before the upload and refunded if
    it raises. Raw (incompressible) packs and their pruned tiers come
    with a later slice."""
    reason = dist.compress_pack_reason(pack)
    if reason is not None:
        raise NotLowerable(f"pack [{pack.field}] is not compressible "
                           f"({reason}); raw packs are not served yet")
    streams = dist.build_compressed_streams(pack)
    hbm = streams.nbytes_device()
    if breaker is not None:
        breaker.add_estimate_bytes_and_maybe_break(
            hbm, label=f"pack[{pack.field}]")
    try:
        arrays = dist.device_put_compressed(streams, device)
    except Exception:
        if breaker is not None:
            breaker.release(hbm)
        raise
    sizes = [len(ids) for ids in pack.shard_doc_ids]
    row_offset = np.zeros(pack.num_shards, dtype=np.int64)
    np.cumsum(sizes[:-1], out=row_offset[1:len(sizes)])
    id_cat = np.empty(int(sum(sizes)), dtype=object)
    off = 0
    for ids in pack.shard_doc_ids:
        id_cat[off: off + len(ids)] = ids
        off += len(ids)
    return ResidentPack(pack, streams, arrays, row_origin, row_segments,
                        row_offset, id_cat, reader_key=tuple(reader_key),
                        readers=dict(readers or {}), hbm_bytes=hbm)


class IndexPackCache:
    """The node's resident packs, one per (index, field), keyed on the
    tuple of the index's shard-reader identities (the reference's
    IndexPackCache without its delta chains, placement groups and heat
    tracking). Charges the ``hbm`` breaker before each upload; releases
    a pack's charge when a rebuild replaces it and on invalidate.
    ``on_evict(resident)`` runs for every pack that goes (the service
    retires its batcher queue, whose reference would otherwise keep the
    device arrays alive)."""

    def __init__(self, device: torch.device, breaker=None):
        self.device = device
        self._breaker = breaker
        self._lock = threading.Lock()
        self._cache: Dict[Tuple[str, str], ResidentPack] = {}
        # per-key build serialization: a rebuild of one pack never
        # blocks lookups of the others
        self._build_locks: Dict[Tuple[str, str], threading.Lock] = {}
        self.on_evict = None
        # index name → deletions so far: a build that began before its
        # index was invalidated is not cached
        self._epochs: Dict[str, int] = {}
        self.hits = 0          # lookups served by the current pack
        self.misses = 0        # lookups that (re)built a pack
        self.stale_served = 0  # lookups served stale during a rebuild

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            packs = {f"{idx}/{field}": {"hbm_bytes": int(e.hbm_bytes),
                                        "resident_bytes": e.nbytes_device()}
                     for (idx, field), e in self._cache.items()}
            return {"resident": len(self._cache), "hits": self.hits,
                    "misses": self.misses,
                    "stale_served": self.stale_served, "packs": packs}

    def residents(self) -> List[ResidentPack]:
        with self._lock:
            return list(self._cache.values())

    def get(self, index_service, field: str) -> Optional[ResidentPack]:
        readers = []
        for shard_num, shard in sorted(index_service.shards.items()):
            readers.append((shard_num, shard.acquire_searcher()))
        reader_key = tuple(id(r) for _, r in readers)
        key = (index_service.name, field)
        with self._lock:
            epoch = self._epochs.get(key[0], 0)
            entry = self._cache.get(key)
            if entry is not None and entry.reader_key == reader_key:
                self.hits += 1
                return entry
            build_lock = self._build_locks.setdefault(key,
                                                      threading.Lock())
        # stale-while-rebuild: while another thread rebuilds this key,
        # serve the previous pack (staleness bounded by one refresh)
        if not build_lock.acquire(blocking=False):
            with self._lock:
                entry = self._cache.get(key)
                if entry is not None:
                    self.stale_served += 1
            if entry is not None:
                return entry
            build_lock.acquire()  # no old pack: wait for the build
        try:
            with self._lock:
                entry = self._cache.get(key)
                if entry is not None and entry.reader_key == reader_key:
                    self.hits += 1
                    return entry
                self.misses += 1
            entry = self._build(readers, field, reader_key)
            old = None
            with self._lock:
                deleted = self._epochs.get(key[0], 0) != epoch
                if entry is not None:
                    old = entry if deleted else self._cache.get(key)
                    if old is not None and self._breaker is not None:
                        self._breaker.release(old.hbm_bytes)
                    if not deleted:
                        self._cache[key] = entry
            if old is not None and self.on_evict is not None:
                self.on_evict(old)
            if deleted:
                raise IndexNotFound(f"no such index [{key[0]}]")
            return entry
        finally:
            build_lock.release()

    def _build(self, readers, field: str,
               reader_key: Tuple[int, ...]) -> Optional[ResidentPack]:
        segments, live, groups = [], [], []
        row_origin: List[Tuple[int, str]] = []
        for group_idx, (shard_num, reader) in enumerate(readers):
            for view in reader.views:
                if field not in view.segment.postings:
                    continue
                segments.append(view.segment)
                live.append(view.live_mask[:view.segment.num_docs].copy())
                groups.append(group_idx)
                row_origin.append((shard_num, view.segment.name))
        if not segments:
            return None
        reader = readers[0][1]
        pack = dist.build_stacked_pack(segments, field, live_docs=live,
                                       k1=reader.k1, b=reader.b,
                                       row_groups=groups)
        return place_pack(pack, self.device, row_origin, segments,
                          breaker=self._breaker, reader_key=reader_key,
                          readers=dict(readers))

    def invalidate(self, index_name: str) -> None:
        """Drop every pack of `index_name` and release its charge."""
        evicted = []
        with self._lock:
            for key in [k for k in self._cache if k[0] == index_name]:
                entry = self._cache.pop(key)
                if self._breaker is not None:
                    self._breaker.release(entry.hbm_bytes)
                evicted.append(entry)
                self._build_locks.pop(key, None)
            self._epochs[index_name] = self._epochs.get(index_name, 0) + 1
        if self.on_evict is not None:
            for entry in evicted:
                self.on_evict(entry)

    def invalidate_all(self) -> None:
        with self._lock:
            names = sorted({k[0] for k in self._cache})
        for name in names:
            self.invalidate(name)


# ---------------------------------------------------------------------------
# the exact kernel launch
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FlatQueryResult:
    """Per-query kernel result, columnar and best-first: scores f32[n],
    pack rows int32[n], local ordinals int32[n]."""

    scores: np.ndarray
    rows: np.ndarray
    ords: np.ndarray
    total_hits: int
    max_score: Optional[float]
    resident: Optional[ResidentPack] = None
    total_relation: str = "eq"

    @classmethod
    def empty(cls) -> "FlatQueryResult":
        z = np.empty(0, dtype=np.int32)
        return cls(np.empty(0, dtype=np.float32), z, z, 0, None)


def _batch_bucket(n: int, cap: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


def _serving_bucket(n: int, cap: int = 128) -> int:
    """Three batch buckets (8 / 64 / 128), powers of two past the cap."""
    if n <= 8:
        return 8
    if n <= 64:
        return 64
    if n <= cap:
        return cap
    return _batch_bucket(n, 1024)


#: the largest from + size the device path serves (the reference's bound,
#: search/tpu_service.py try_search); its kernel k bucket is 16,384
MAX_K = 10_000


def _kernel_k(k: int) -> int:
    """k buckets of the exact kernel: 128, 1024, then powers of two."""
    return 128 if k <= 128 else (1024 if k <= 1024
                                 else _batch_bucket(k, 16384))


def _launch_exact(resident: ResidentPack, flats: Sequence[FlatQuery],
                  k: int) -> Dict[str, Any]:
    """Host prep + device dispatch of one micro-batch: bucketed batch
    (8/64/pow2), kernel k (128/1024/pow2), slot count (pow2 ≥ 8), window
    (≥ 8) and chunk length (pinned CHUNK_CAP), as the reference pins
    them. Returns the launch state for _finish_exact."""
    pack = resident.pack
    batch = dist.prepare_query_batch(
        pack, [f.terms for f in flats],
        boosts=[f.boost for f in flats],
        min_counts=[f.min_count for f in flats],
        pad_batch_to=_serving_bucket(len(flats)),
        pad_max_len=dist.CHUNK_CAP,
        compressed=resident.streams)
    t_pin = 8
    while t_pin < batch.t_slots:
        t_pin *= 2
    if t_pin > merge_kernel.T_LIMIT:
        raise NotLowerable(f"{batch.t_slots} posting slots per row exceed "
                           f"the merge kernel's {merge_kernel.T_LIMIT}")
    if t_pin > batch.t_slots:
        pad = ((0, 0), (0, 0), (0, t_pin - batch.t_slots))
        # zero-padded slots: length 0 ⇒ inert in grouping and rescore
        batch = dataclasses.replace(
            batch, starts=np.pad(batch.starts, pad),
            lengths=np.pad(batch.lengths, pad),
            weights=np.pad(batch.weights, pad), t_slots=t_pin,
            res_starts=np.pad(batch.res_starts, pad),
            res_lens=np.pad(batch.res_lens, pad),
            slot_terms=np.pad(batch.slot_terms, pad))
    variant = choose_kernel_variant(pack.d_pad, batch.weights)
    vals, gids, totals = dist.distributed_search_raw(
        pack, batch, _kernel_k(k), resident.device_arrays,
        t_window=max(MIN_T_WINDOW, batch.window), materialize=False,
        variant=variant)
    return {"resident": resident, "n": len(flats), "k": k, "vals": vals,
            "gids": gids, "totals": totals, "variant": variant,
            "bucket": batch.starts.shape[1], "t_slots": batch.t_slots}


def _columnar_results(resident: ResidentPack, vals: np.ndarray,
                      gids: np.ndarray, totals: np.ndarray,
                      n_queries: int, k_cap: int) -> List[FlatQueryResult]:
    """Decode a batch's [B, k'] output into columnar per-query results.
    Sentinel lanes (-inf score, ordinal d_pad, padding rows) sort to the
    tail, so each query's valid hits are a prefix."""
    pack = resident.pack
    d1 = pack.d_pad + 1
    rows = (gids // d1).astype(np.int32)
    ords = (gids - rows.astype(np.int64) * d1).astype(np.int32)
    valid = ((vals > dist.NEG_INF) & (ords < pack.d_pad)
             & (rows < len(resident.row_origin)))
    n_valid = np.where(valid.all(axis=1), valid.shape[1],
                       valid.argmin(axis=1))
    out = []
    for qi in range(n_queries):
        m = min(int(n_valid[qi]), k_cap)
        sc = vals[qi, :m]
        out.append(FlatQueryResult(
            sc, rows[qi, :m], ords[qi, :m], int(totals[qi]),
            float(sc[0]) if m else None, resident=resident))
    return out


def _finish_exact(launch: Dict[str, Any]) -> List[FlatQueryResult]:
    vals = launch["vals"].cpu().numpy()
    gids = launch["gids"].cpu().numpy()
    totals = launch["totals"].cpu().numpy()
    return _columnar_results(launch["resident"], vals, gids, totals,
                             launch["n"], launch["k"])


# ---------------------------------------------------------------------------
# micro-batching
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Pending:
    flat: FlatQuery
    k: int
    future: Future


class _PackQueue:
    """One pack's pending queries and the worker thread that launches
    them in trains."""

    def __init__(self, batcher: "MicroBatcher", resident: ResidentPack):
        self.batcher = batcher
        self.resident = resident
        self.cv = threading.Condition()
        self.pendings: List[_Pending] = []
        self.closed = False
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="gpu-micro-batcher")
        self.thread.start()

    def submit(self, pending: _Pending) -> bool:
        with self.cv:
            if self.closed:
                return False
            self.pendings.append(pending)
            self.cv.notify_all()
            return True

    def close(self) -> None:
        with self.cv:
            self.closed = True
            self.cv.notify_all()

    def _run(self) -> None:
        batcher = self.batcher
        while True:
            with self.cv:
                while not self.pendings and not self.closed:
                    self.cv.wait()
                if self.closed and not self.pendings:
                    return
                deadline = time.monotonic() + batcher.window_s
                while len(self.pendings) < batcher.max_batch:
                    left = deadline - time.monotonic()
                    if left <= 0 or self.closed:
                        break
                    self.cv.wait(timeout=left)
                taken = self.pendings[:batcher.max_batch]
                self.pendings = self.pendings[batcher.max_batch:]
            self._launch(taken)

    def _launch(self, taken: List[_Pending]) -> None:
        """Run one train. When it fails, run each of its queries alone,
        so that a fault of one request reaches no other client."""
        batcher = self.batcher
        try:
            results = batcher.execute(self.resident,
                                      [p.flat for p in taken],
                                      max(p.k for p in taken))
        except Exception as exc:  # noqa: BLE001 — handed to the futures
            if len(taken) == 1:
                taken[0].future.set_exception(exc)
            else:
                for p in taken:
                    self._launch([p])
            return
        batcher.record(len(taken))
        for p, res in zip(taken, results):
            p.future.set_result(res)


class MicroBatcher:
    """Coalesces concurrent queries per resident pack into single
    launches: queries arriving within window_s (or until max_batch) share
    one; k pads to the max requested."""

    def __init__(self, execute, window_s: float = 0.005,
                 max_batch: int = 128):
        self.execute = execute
        self.window_s = window_s
        self.max_batch = max_batch
        self._lock = threading.Lock()
        self._queues: Dict[int, _PackQueue] = {}
        self._closed = False
        self.batch_sizes: Dict[int, int] = {}  # queries per train → trains

    def record(self, n: int) -> None:
        with self._lock:
            self.batch_sizes[n] = self.batch_sizes.get(n, 0) + 1

    def submit(self, resident: ResidentPack, flat: FlatQuery,
               k: int) -> Optional[Future]:
        """The future of `flat`'s result, or None when `resident` was
        retired: the caller looks its pack up again."""
        pending = _Pending(flat, k, Future())
        while True:
            with self._lock:
                if self._closed:
                    raise RuntimeError("micro-batcher is closed")
                if resident.retired:
                    return None
                queue = self._queues.get(id(resident))
                if queue is None:
                    queue = self._queues[id(resident)] = _PackQueue(
                        self, resident)
            if queue.submit(pending):
                return pending.future

    def retire(self, resident: ResidentPack) -> None:
        """Refuse new work for `resident`; its queue drains what it holds
        and its thread ends."""
        with self._lock:
            resident.retired = True
            queue = self._queues.pop(id(resident), None)
        if queue is not None:
            queue.close()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            queues = list(self._queues.values())
            self._queues.clear()
        for q in queues:
            q.close()
        for q in queues:
            q.thread.join(timeout=30.0)


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------

class _Index:
    def __init__(self, name: str, number_of_shards: int,
                 mapping: Optional[dict]):
        self.name = name
        self.num_shards = number_of_shards
        self.mapper = MapperService(mapping)
        self.writers: Dict[int, SegmentWriter] = {}
        self.segments: Dict[int, List[Segment]] = {
            s: [] for s in range(number_of_shards)}
        self.ids: set = set()
        self.generation = 0
        self.packs: Dict[str, ResidentPack] = {}
        self.lock = threading.Lock()


class GpuSearchService:
    """The kernel path of ``_search`` on one device (``cuda:0`` unless
    ``device="cpu"``): ``try_search`` over a node's IndexService, through
    the IndexPackCache (charged to `breaker`, the node's ``hbm``
    breaker) and the micro-batcher; and create_index / index / refresh /
    search over indices of its own."""

    def __init__(self, device=None, window_s: float = 0.005,
                 max_batch: int = 128, batch_timeout_s: float = 300.0,
                 breaker=None):
        self.device = resolve_device(device)
        self.batch_timeout_s = batch_timeout_s
        self._indices: Dict[str, _Index] = {}
        self._lock = threading.Lock()
        self.batcher = MicroBatcher(self._execute, window_s=window_s,
                                    max_batch=max_batch)
        self.packs = IndexPackCache(self.device, breaker)
        self.packs.on_evict = self.batcher.retire
        self.stages = StageTimes()
        self.served = 0
        #: kernel variant → exact launches (compressed_exact is torch ops,
        #: counted apart from the kernel)
        self.variant_launches: Dict[str, int] = {}
        self.launch_shapes: Dict[Tuple[int, int, int], int] = {}

    # -- indices -----------------------------------------------------------

    def _index(self, name: str) -> _Index:
        idx = self._indices.get(name)
        if idx is None:
            raise IndexNotFound(name)
        return idx

    def create_index(self, name: str, number_of_shards: int = 1,
                     mapping: Optional[dict] = None) -> None:
        with self._lock:
            if name in self._indices:
                raise ValueError(f"index [{name}] already exists")
            self._indices[name] = _Index(name, number_of_shards, mapping)

    def index(self, name: str, docs: Iterable[Tuple[str, dict]]) -> int:
        """Buffer (id, source) documents, routed to shards by the
        reference's murmur3 of the id; visible after refresh(). Updates
        of an existing id come with a later slice."""
        idx = self._index(name)
        n = 0
        with idx.lock:
            for doc_id, source in docs:
                doc_id = str(doc_id)
                if doc_id in idx.ids:
                    raise ValueError(f"document [{doc_id}] exists; updates "
                                     f"are not supported")
                idx.ids.add(doc_id)
                shard = shard_for(doc_id, idx.num_shards)
                writer = idx.writers.get(shard)
                if writer is None:
                    writer = idx.writers[shard] = SegmentWriter(
                        f"s{shard}_g{idx.generation}")
                writer.add_document(idx.mapper.parse_document(doc_id,
                                                              source))
                n += 1
        return n

    def add_segment(self, name: str, shard: int, segment: Segment) -> None:
        """Make a built segment searchable on `shard` (bulk loading)."""
        idx = self._index(name)
        with idx.lock:
            idx.ids.update(segment.doc_ids)
            idx.segments[shard].append(segment)
            self._drop_packs(idx)

    def refresh(self, name: str) -> None:
        """Freeze every shard's buffered documents into one new segment
        per shard and drop the resident packs (rebuilt on next search)."""
        idx = self._index(name)
        with idx.lock:
            for shard, writer in sorted(idx.writers.items()):
                if writer.num_docs:
                    idx.segments[shard].append(writer.freeze())
            idx.writers.clear()
            idx.generation += 1
            self._drop_packs(idx)

    def _drop_packs(self, idx: _Index) -> None:
        for resident in idx.packs.values():
            self.batcher.retire(resident)
        idx.packs.clear()

    def resident(self, name: str, field: str) -> Optional[ResidentPack]:
        """The field's resident pack, built and placed on first use; None
        when no segment holds postings of the field."""
        idx = self._index(name)
        with idx.lock:
            entry = idx.packs.get(field)
            if entry is not None:
                return entry
            segments, groups, origin = [], [], []
            for shard in range(idx.num_shards):
                for seg in idx.segments[shard]:
                    if field not in seg.postings:
                        continue
                    segments.append(seg)
                    groups.append(shard)
                    origin.append((shard, seg.name))
            if not segments:
                return None
            pack = dist.build_stacked_pack(segments, field,
                                           row_groups=groups)
            entry = place_pack(pack, self.device, origin, segments)
            idx.packs[field] = entry
            return entry

    # -- search ------------------------------------------------------------

    def _execute(self, resident: ResidentPack, flats: Sequence[FlatQuery],
                 k: int) -> List[FlatQueryResult]:
        t0 = time.perf_counter()
        launch = _launch_exact(resident, flats, k)
        with self._lock:
            v = launch["variant"]
            self.variant_launches[v] = self.variant_launches.get(v, 0) + 1
            shape = (launch["bucket"], launch["t_slots"], _kernel_k(k))
            self.launch_shapes[shape] = self.launch_shapes.get(shape, 0) + 1
        out = _finish_exact(launch)
        self.stages.add("train", time.perf_counter() - t0)
        return out

    # -- the node's path (the reference's TpuSearchService.try_search) -----

    def try_search(self, index_service, query: dsl.QueryNode, *,
                   k: int) -> FlatQueryResult:
        """The kernel result of `query` over `index_service` (k = from +
        size, the window the coordinator needs). Raises NotLowerable where
        the reference hands the query to its planner; a fault of the
        kernel path (or a batch that outlives the wait) reaches the
        caller."""
        if k <= 0 or k > MAX_K:
            raise NotLowerable(f"from + size = {k} is outside (0, "
                               f"{MAX_K}], the kernel path's window")
        t0 = time.perf_counter()
        flat = lower_query(query, index_service.mapper)
        if flat is None:
            self.stages.add("lower", time.perf_counter() - t0)
            raise NotLowerable(f"[{query.query_name()}] query does not "
                               f"lower to the merge kernel")
        while True:
            resident = self.packs.get(index_service, flat.field)
            t1 = time.perf_counter()
            if resident is None:
                # the field has postings nowhere: zero hits, kernel-free
                self.stages.add("lower", t1 - t0)
                with self._lock:
                    self.served += 1
                return FlatQueryResult.empty()
            future = self.batcher.submit(resident, flat, k)
            if future is not None:
                break
            # a refresh or delete retired the pack after the lookup
        self.stages.add("lower", t1 - t0)
        result = future.result(timeout=self.batch_timeout_s)
        self.stages.add("batch_wait", time.perf_counter() - t1)
        with self._lock:
            self.served += 1
        return result

    def invalidate_index(self, name: str) -> None:
        """Drop the index's resident packs, their breaker charge and
        their batcher queues (index delete)."""
        self.packs.invalidate(name)

    def search(self, name: str, body: Optional[dict] = None) -> dict:
        """``_search`` over one index → {"took", "timed_out", "_shards",
        "hits": {"total": {"value", "relation"}, "max_score", "hits":
        [{"_index", "_id", "_score", "_source"}]}}. Raises NotLowerable
        for a query or body outside the device path's subset."""
        t0 = time.perf_counter()
        idx = self._index(name)
        body = dict(body or {})
        allowed = {"query", "size", "from", "_source"}
        extra = sorted(set(body) - allowed)
        if extra:
            raise NotLowerable(f"search options {extra} are not served by "
                               f"the device path")
        query = dsl.parse_query(body.get("query", {"match_all": {}}))
        size = int(body.get("size", 10))
        from_ = int(body.get("from", 0))
        source = body.get("_source", True)
        if not isinstance(source, bool):
            raise NotLowerable("_source filtering is not served by the "
                               "device path")
        k = from_ + size
        if k <= 0 or k > MAX_K:
            # refused on every device alike, before it joins a train (the
            # reference hands such a request to its planner)
            raise NotLowerable(f"from + size = {k} is outside (0, "
                               f"{MAX_K}], the device path's window")
        flat = lower_query(query, idx.mapper)
        if flat is None:
            raise NotLowerable(f"[{query.query_name()}] query does not "
                               f"lower to the merge kernel")
        while True:
            resident = self.resident(name, flat.field)
            if resident is None:
                res = FlatQueryResult.empty()
                break
            future = self.batcher.submit(resident, flat, k)
            if future is not None:
                res = future.result(timeout=self.batch_timeout_s)
                break
            # a refresh retired the pack after the lookup
        scores = res.scores[from_: from_ + size]
        rows = res.rows[from_: from_ + size]
        ords = res.ords[from_: from_ + size]
        hits: List[Dict[str, Any]] = []
        if res.resident is not None and len(scores):
            ids = res.resident.resolve_ids(rows, ords).tolist()
            segs = res.resident.row_segments
            for i, s, row, o in zip(ids, scores.tolist(), rows.tolist(),
                                    ords.tolist()):
                hit: Dict[str, Any] = {"_index": name, "_id": i,
                                       "_score": s}
                if source:
                    hit["_source"] = segs[row].stored_source[o]
                hits.append(hit)
        n_shards = idx.num_shards
        return {
            "took": int((time.perf_counter() - t0) * 1000),
            "timed_out": False,
            "_shards": {"total": n_shards, "successful": n_shards,
                        "skipped": 0, "failed": 0},
            "hits": {"total": {"value": res.total_hits, "relation": "eq"},
                     "max_score": (float(res.scores[0]) if len(res.scores)
                                   else None),
                     "hits": hits},
        }

    def close(self) -> None:
        self.batcher.close()
        self.packs.invalidate_all()
