"""GPU serving path for ``_search``: resident packs + a micro-batched
kernel.

Counterpart of the reference's ``search/tpu_service.py`` for the main
path. A ``_search`` body goes:

  parse_query → the plan cache (or lower_query) → MicroBatcher (8 / 64 /
  128 query buckets; a pack's trains pipelined: launch_flat_batch on a
  launch worker, finish_flat_batch on a completion thread) → the train's
  routing → prepare_query_batch → the kernels on every device of the
  mesh → all-gather, totals sum and cross-shard top-k (shard_topk) →
  decode → hits response.

A pack is resident in the compressed format (the default) when every
shard's flats compress (``sparse.compress_reason``), else in the RAW
format: int32 docs and f32 impacts, doc-sorted and impact-sorted (a
segment above 65,408 documents, d_pad ≥ 2**16, is raw). A compressed pack
serves every query through the exact launch (the Hopper merge kernel for
packable weights, the exact merge for the others). A raw pack routes as
the reference's r5 routing: an OR query of at most PRUNE_MAX_TERMS terms
with k ≤ PRUNE_MAX_K goes to the smallest full-postings tier of
FULL_SLOT_BUCKETS that holds all its postings (no rescore, exact
totals), a hotter one to the prefix tier at PREFIX_CAP2 (the phase-B
rescore, the WAND validity check on the host, escalating to PREFIX_CAP3,
then to the exact launch); msm/AND, k > 1000 or more terms take the
exact launch (the raw merge, variant "ref" or "packed"). A pruned
result's total is "gte" when some term's postings were cut.

The service runs on a mesh (``parallel/mesh.py``): by default every
visible GPU on the shards axis, the reference's ``(1, n_local_devices)``;
``device=`` makes it a (1, 1) mesh of that device (the tests'
``device="cpu"``).

  ResidentPack — one (index, field) StackedShardPack in the compressed
    format, laid over the mesh (one pack row per segment, padded to a
    multiple of the shards axis; one statistics group per index shard:
    the reference's query_then_fetch scope), with the tables that
    resolve kernel hits to ``_id``s.
  IndexPackCache — the node's resident packs, keyed on the identities of
    the shard readers they were built from (a refresh or merge swaps a
    reader, so the key changes exactly when the segments or live docs
    do). Each pack charges the ``hbm`` breaker with its device bytes
    before the upload and releases them on a rebuild, an invalidate or a
    failed upload; a lookup during another thread's rebuild serves the
    old pack. With the delta chain on (``delta=``; the node's default),
    a refresh that only appends segments builds a raw delta pack of the
    new segments, which bakes the statistics of its own rows; the base
    keeps its own until a background compaction folds the chain into a
    fresh base. A search runs the same lowered query on the base and on
    every delta and merges their top-k on the host (``union_topk``).
  PlanCache — the lowering memoized per (index, mapping generation,
    query), revalidated against the pack chain's reader key.
  MicroBatcher — coalesces concurrent queries per pack for a short
    window (or until the batch cap) and runs them as trains, up to
    PIPELINE_DEPTH in flight a pack.
  StageTimes — per-stage wall time of the serving path.
  GpuSearchService — ``try_search`` over a node's IndexService (the
    reference's TpuSearchService.try_search, with ``timeout`` and
    ``profile``), ``prewarm``, and a bare service of its own:
    create_index / index / refresh / search, through the same
    ``try_search``.

A query outside the lowering subset raises ``NotLowerable`` (the
coordinator's planner answers it); the prewarm's grace and an expired
request deadline return None (the planner answers too). Nothing else
falls back: a fault of the kernel path reaches the caller.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import queue
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.common.errors import IndexNotFound, NotLowerable
from elasticsearch_tpu_torch.index.reader import ShardReader
from elasticsearch_tpu_torch.index.segment import Segment, SegmentWriter
from elasticsearch_tpu_torch.indices.routing import shard_for
from elasticsearch_tpu_torch.mapping import MapperService, TextFieldType
from elasticsearch_tpu_torch.ops import merge_kernel, sparse
from elasticsearch_tpu_torch.parallel import distributed as dist
from elasticsearch_tpu_torch.parallel.mesh import (DATA_AXIS, SHARD_AXIS,
                                                   Mesh, resolve_mesh)
from elasticsearch_tpu_torch.search import dsl
from elasticsearch_tpu_torch.search.query_phase import filter_source
from elasticsearch_tpu_torch.search.planner import choose_kernel_variant

logger = logging.getLogger("elasticsearch_tpu_torch.search.gpu_service")

#: window floor of the exact and pruned kernels
_PRUNE_WINDOW = 8

# the pruned tiers of a raw pack (the reference's r5 routing): the
# full-postings sort widths in slots of CHUNK_CAP lanes, the prefixes of
# the hot tier and of its escalation, and the queries they take
FULL_SLOT_BUCKETS = (32, 128)
PREFIX_CAP = 4096    # a prefix launch's default cap
PREFIX_CAP2 = 16384  # the hot tier
PREFIX_CAP3 = 65536  # its escalation
PRUNE_MAX_K = 1000
PRUNE_MAX_TERMS = 8  # more terms → the exact launch


class StageTimes:
    """Per-stage wall time on the serving path (the reference's
    StageTimes, without its trace exemplars). Stages: ``lower`` (the
    plan-cache lookup or the lowering), ``pack_get`` (the resident-pack
    lookup), ``batch_wait`` (submit to result: the batching window, the
    queue and the train) and its split ``batch_wait.{queue, window,
    dispatch, completion}`` (each also under ``.<variant>``, the
    reference's names), ``train`` (a train's launch to its finish),
    ``assemble`` (the coordinator's hits block) and the launches' own,
    the reference's: ``exact_prep``, ``exact_dispatch.{variant}``,
    ``exact_device_wait.{variant}``, ``batch_prep``,
    ``batch_dispatch[.{variant}]``, ``batch_device_wait[.{variant}]``,
    ``batch_decode`` and ``exact_batch``. Each stage keeps its
    running totals and a bounded ring of recent samples for
    percentiles."""

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
        """{stage: {seconds, count, mean_ms, p50_ms, p95_ms, p99_ms,
        max_ms}}; the percentiles are over the ring's recent samples."""
        with self._lock:
            rows = {s: (self.seconds[s], self.counts[s],
                        sorted(self._rings[s])) for s in sorted(self.seconds)}
        out = {}
        for s, (sec, count, ring) in rows.items():
            out[s] = {"seconds": sec, "count": count,
                      "mean_ms": sec / count * 1e3 if count else 0.0}
            if ring:
                out[s]["p50_ms"] = ring[len(ring) // 2] * 1e3
                out[s]["p95_ms"] = ring[min(len(ring) - 1,
                                            int(len(ring) * 0.95))] * 1e3
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


def lower_query(query: dsl.QueryNode, mapper) -> FlatQuery:
    """QueryNode → FlatQuery. Raises NotLowerable for a query the merge
    kernel does not serve (the reference hands it to its planner)."""
    flat = _lower(query, mapper)
    if flat is None:
        raise _not_lowerable(query)
    return flat


def _not_lowerable(query: dsl.QueryNode) -> NotLowerable:
    return NotLowerable(f"[{query.query_name()}] query does not lower to "
                        f"the merge kernel")


def _lower(query: dsl.QueryNode, mapper) -> Optional[FlatQuery]:
    """lower_query's rules: a FlatQuery, or None."""
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
        subs = [_lower(q, mapper) for q in query.should]
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
# the lowered-plan cache
# ---------------------------------------------------------------------------

def plan_key(query: dsl.QueryNode) -> Optional[Tuple]:
    """A canonical hashable key of a parsed query tree, or None when the
    tree holds something unhashable (such a query is not cached). Equal
    bodies parse to equal trees, so the key is "same shape, same
    values"; traffic repeats shapes, which is what makes memoizing the
    lowering pay."""
    try:
        key = _plan_key_node(query)
        hash(key)
        return key
    except TypeError:
        return None


def _plan_key_node(value: Any) -> Any:
    if isinstance(value, dsl.QueryNode):
        parts = [type(value).__name__]
        for f in dataclasses.fields(value):
            parts.append(_plan_key_node(getattr(value, f.name)))
        return tuple(parts)
    if isinstance(value, (list, tuple)):
        return tuple(_plan_key_node(v) for v in value)
    if isinstance(value, dict):
        return tuple(sorted((k, _plan_key_node(v))
                            for k, v in value.items()))
    return value


#: the cached "does not lower": the negative is cached as the positive is
NOT_LOWERABLE = object()


class PlanCache:
    """LRU memo of the lowering, keyed on (index, mapping generation,
    plan key) (the reference's PlanCache). An entry remembers the reader
    key of the pack chain it was validated against, so a rebuilt pack
    (a refresh or merge mid-traffic) lowers again; a mapping update
    changes the generation, which makes every old entry unreachable (the
    invalidation seams also purge them)."""

    def __init__(self, max_entries: int = 2048):
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[Tuple, Any]" = \
            collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0

    def get(self, key: Tuple) -> Any:
        """→ (FlatQuery, reader key) | NOT_LOWERABLE | None (a miss)."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return entry

    def put(self, key: Tuple, value: Any) -> None:
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.evictions += 1

    def invalidate_index(self, index_name: str) -> None:
        with self._lock:
            stale = [k for k in self._entries if k[0] == index_name]
            for k in stale:
                del self._entries[k]
            self.invalidations += len(stale)

    def clear(self) -> None:
        with self._lock:
            self.invalidations += len(self._entries)
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"size": len(self._entries),
                    "max_entries": self.max_entries,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "invalidations": self.invalidations}


# ---------------------------------------------------------------------------
# pack residency
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ResidentPack:
    """One (index, field) pack on the mesh's devices + provenance: the
    compressed streams, or (streams None) a raw image with its host
    impact-sorted copy (imp_host: docs, impacts), which the pruned tiers
    read."""

    pack: dist.StackedShardPack
    streams: Optional[dist.CompressedStreams]
    image: dist.MeshImage
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
    imp_host: Optional[Tuple[np.ndarray, np.ndarray]] = None
    #: query terms → the slots a full-postings launch of them needs
    slots_memo: Dict[Tuple[str, ...], int] = dataclasses.field(
        default_factory=dict)

    @property
    def n_docs(self) -> int:
        """Documents in the pack's rows, tombstoned ones included."""
        return int(sum(self.pack.shard_num_docs))

    @property
    def device_arrays(self) -> Tuple[torch.Tensor, ...]:
        """The tensors of the image, once (one data row of the mesh)."""
        return self.image.row_arrays()

    def nbytes_device(self) -> int:
        """Bytes of the resident device image (a data axis's replicas
        counted once, as the breaker charges them)."""
        return int(sum(t.numel() * t.element_size()
                       for t in self.device_arrays))

    def resolve_ids(self, rows: np.ndarray, ords: np.ndarray) -> np.ndarray:
        """(pack row, local ordinal) → external _id, vectorized."""
        if len(rows) == 0:
            return np.empty(0, dtype=object)
        return self.id_cat[self.row_offset[rows] + ords]


def place_pack(pack: dist.StackedShardPack, mesh: Mesh,
               row_origin: List[Tuple[int, str]],
               row_segments: List[Segment], breaker=None,
               reader_key: Tuple[int, ...] = (),
               readers: Optional[Dict[int, Any]] = None,
               compressed_pack: bool = True) -> ResidentPack:
    """Place `pack` over `mesh`: compressed when `compressed_pack` (the
    setting) and every shard's flats compress, else raw (the doc-sorted
    pack and its impact-sorted copy: a segment above 65,408 documents,
    say). With a breaker, the image's device bytes (once, as the
    reference's cache charges them: for a raw pack the doc-sorted arrays
    with their live masks plus the impact-sorted copy) are charged before
    the upload and refunded if it raises."""
    streams = imp_host = None
    if compressed_pack and dist.compress_pack_reason(pack) is None:
        streams = dist.build_compressed_streams(pack)
        hbm = streams.nbytes_device()
    else:
        imp_host = dist.build_impact_sorted(pack)
        hbm = dist.raw_image_nbytes(pack, *imp_host)
    if breaker is not None:
        breaker.add_estimate_bytes_and_maybe_break(
            hbm, label=f"pack[{pack.field}]")
    try:
        if streams is not None:
            image = dist.device_put_compressed(streams, mesh)
        else:
            image = dist.device_put_pack(pack, mesh, *imp_host)
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
    return ResidentPack(pack, streams, image, row_origin, row_segments,
                        row_offset, id_cat, reader_key=tuple(reader_key),
                        readers=dict(readers or {}), hbm_bytes=hbm,
                        imp_host=imp_host)


# -- the streaming delta chain ------------------------------------------------
#
# An append-only refresh builds a small delta pack over the new segments
# only, instead of placing the whole (index, field) image again; a search
# runs the kernels on the base and on each delta and unions their top-k
# columns on the host (sparse.union_topk). A background compactor folds
# the chain back into one base pack. A doc lives in exactly one pack: an
# update or delete of a committed doc changes a live mask, which bumps
# the engine's live_version and forces a full rebuild, so the chain is
# append-only by construction.

#: test seam: each hook is called with the (index, field) key at the top
#: of every compaction and may block or raise
COMPACTION_FAULT_HOOKS: List[Any] = []


@dataclasses.dataclass
class DeltaStats:
    """The service's delta lifecycle counters."""

    appends: int = 0              # delta packs built and placed
    compactions: int = 0
    compaction_failures: int = 0
    compact_seconds: float = 0.0  # wall time folding chains, summed


@dataclasses.dataclass
class _ChainMeta:
    """What the chain covers, per shard: it serves exactly `reader_key`.
    A new reader extends it only when every shard's covered segments are
    a prefix of its segments and its live_version is unchanged."""

    reader_key: Tuple
    covered: Dict[int, Tuple[str, ...]]
    live_versions: Dict[int, int]
    union: Optional["_UnionView"] = None


@dataclasses.dataclass
class PackChain:
    """One (index, field)'s residency: the base pack, the delta packs
    chained on it, and the row space its results resolve against (the
    base itself when the chain is bare)."""

    base: ResidentPack
    deltas: Tuple[ResidentPack, ...]
    view: Any
    reader_key: Tuple

    @property
    def parts(self) -> Tuple[ResidentPack, ...]:
        return (self.base,) + self.deltas


class _UnionView:
    """Base and delta packs as ONE concatenated row and id space, for the
    fetch: pack i's rows start at ``offsets[i]`` (the padded row counts
    before it) and its ordinals index the concatenated ``row_offset`` /
    ``id_cat`` tables. Exposes what the serializer reads of a resident
    (``resolve_ids``, ``row_segments``) and the rest of its resolution
    tables (``row_origin``, ``row_offset``, ``id_cat``, ``readers``)."""

    def __init__(self, packs: Sequence[ResidentPack], readers):
        offsets: List[int] = []
        row_origin: List[Tuple[int, str]] = []
        row_segments: List[Optional[Segment]] = []
        off_parts, id_parts = [], []
        off = id_off = 0
        for p in packs:
            s_pad = p.pack.num_shards
            offsets.append(off)
            row_origin += list(p.row_origin) + [(-1, "")] * (
                s_pad - len(p.row_origin))
            row_segments += list(p.row_segments) + [None] * (
                s_pad - len(p.row_segments))
            off_parts.append(p.row_offset + id_off)
            id_parts.append(p.id_cat)
            id_off += len(p.id_cat)
            off += s_pad
        self.offsets = tuple(offsets)
        self.row_origin = row_origin
        self.row_segments = row_segments
        self.row_offset = np.concatenate(off_parts)
        self.id_cat = np.concatenate(id_parts)
        self.readers = dict(readers)

    def resolve_ids(self, rows: np.ndarray, ords: np.ndarray) -> np.ndarray:
        if len(rows) == 0:
            return np.empty(0, dtype=object)
        return self.id_cat[self.row_offset[rows] + ords]


class IndexPackCache:
    """The node's resident packs, one per (index, field), keyed on the
    tuple of the index's shard-reader identities (the reference's
    IndexPackCache without its placement groups and heat tracking).
    Charges the ``hbm`` breaker before each upload; releases a pack's
    charge when a rebuild or a compaction replaces it and on invalidate.
    ``on_evict(resident)`` runs for every pack that goes (the service
    retires its batcher queue, whose reference would otherwise keep the
    device arrays alive). kernel_config["compressed_pack"] decides the
    format of the base packs built from then on.

    With ``delta_enabled`` (``get_chain``), a refresh that only appends
    segments builds a raw delta pack over the new segments and chains it
    on the base; a chain of more than ``delta_max_packs`` deltas or
    ``delta_max_docs`` delta docs calls ``on_compact_needed(key)``, and
    ``compact(key)`` folds it into a fresh base."""

    def __init__(self, mesh: Mesh, breaker=None,
                 kernel_config: Optional[Dict[str, bool]] = None):
        self.mesh = mesh
        self._breaker = breaker
        self.kernel_config = (kernel_config if kernel_config is not None
                              else {"compressed_pack": True})
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
        # -- the delta chain ---------------------------------------------
        self.delta_enabled = False
        self.delta_max_packs = 4       # deltas past this request a fold
        self.delta_max_docs = 50_000   # delta docs past this request one
        self.delta_stats = DeltaStats()
        self.on_compact_needed = None  # callable(key), set by the service
        self._deltas: Dict[Tuple[str, str], List[ResidentPack]] = {}
        self._chain_meta: Dict[Tuple[str, str], _ChainMeta] = {}
        self._services: Dict[Tuple[str, str], Any] = {}  # for compact()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            packs = {f"{idx}/{field}": {"hbm_bytes": int(e.hbm_bytes),
                                        "resident_bytes": e.nbytes_device(),
                                        "compressed": e.streams is not None}
                     for (idx, field), e in self._cache.items()}
            deltas = {f"{idx}/{field}": {
                "packs": len(lst),
                "bytes": sum(int(p.hbm_bytes) for p in lst),
                "docs": sum(p.n_docs for p in lst)}
                for (idx, field), lst in self._deltas.items() if lst}
            return {"resident": len(self._cache), "hits": self.hits,
                    "misses": self.misses,
                    "stale_served": self.stale_served, "packs": packs,
                    "deltas": deltas}

    def residents(self) -> List[ResidentPack]:
        """The base packs (a chain's deltas are in ``stats()``)."""
        with self._lock:
            return list(self._cache.values())

    @staticmethod
    def _readers(index_service) -> Tuple[List[Tuple[int, Any]], Tuple]:
        readers = [(num, shard.acquire_searcher())
                   for num, shard in sorted(index_service.shards.items())]
        return readers, tuple(id(r) for _, r in readers)

    def get(self, index_service, field: str) -> Optional[ResidentPack]:
        readers, reader_key = self._readers(index_service)
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
            return self._build_and_swap(key, readers, field, reader_key,
                                        epoch)
        finally:
            build_lock.release()

    def _build_and_swap(self, key, readers, field: str, reader_key,
                        epoch: int) -> Optional[ResidentPack]:
        """A full build swapped in as the key's base, the chain reset.
        The caller holds the key's build lock."""
        with self._lock:
            self.misses += 1
        entry = self._build(readers, field, reader_key)
        if self._swap_base(key, entry, readers, reader_key, epoch):
            raise IndexNotFound(f"no such index [{key[0]}]")
        return entry

    def _swap_base(self, key, entry, readers, reader_key,
                   epoch: int) -> bool:
        """Make `entry` (a full build, or None) the key's base: the old
        base and every delta are released and evicted (a full build
        covers all the chain did: the deltas drain to exactly zero).
        When the index was deleted since `epoch`, `entry` itself goes
        instead → whether it was."""
        evicted: List[ResidentPack] = []
        with self._lock:
            deleted = self._epochs.get(key[0], 0) != epoch
            if entry is not None:
                old = entry if deleted else self._cache.get(key)
                if old is not None:
                    evicted.append(old)
                    if self._breaker is not None:
                        self._breaker.release(old.hbm_bytes)
                if not deleted:
                    self._cache[key] = entry
                    evicted += self._drop_deltas_locked(key)
                    self._set_chain_meta_locked(key, readers, reader_key)
        self._evict(evicted)
        return deleted

    def _evict(self, packs: Iterable[ResidentPack]) -> None:
        if self.on_evict is not None:
            for p in packs:
                self.on_evict(p)

    def _build(self, readers, field: str, reader_key: Tuple[int, ...],
               fresh: Optional[Dict[int, List[Any]]] = None
               ) -> Optional[ResidentPack]:
        """A pack placed on the mesh, one row a segment with postings of
        `field`, one statistics group an index shard: of every segment
        of `readers`, in the configured format; or, with `fresh` ({shard:
        [SegmentView]}), a raw delta pack of those segments only
        (``build_delta_pack``'s bucketed shapes)."""
        delta = fresh is not None
        views = fresh if delta else {num: r.views for num, r in readers}
        segments, live, groups = [], [], []
        row_origin: List[Tuple[int, str]] = []
        for group_idx, (shard_num, _reader) in enumerate(readers):
            for view in views.get(shard_num, ()):
                if field not in view.segment.postings:
                    continue
                segments.append(view.segment)
                live.append(view.live_mask[:view.segment.num_docs].copy())
                groups.append(group_idx)
                row_origin.append((shard_num, view.segment.name))
        if not segments:
            return None
        reader = readers[0][1]
        build = dist.build_delta_pack if delta else dist.build_stacked_pack
        pack = build(segments, field, live_docs=live, k1=reader.k1,
                     b=reader.b, row_groups=groups,
                     pad_shards_to=_pad_rows(len(segments), self.mesh))
        return place_pack(pack, self.mesh, row_origin, segments,
                          breaker=self._breaker, reader_key=reader_key,
                          readers=dict(readers),
                          compressed_pack=(not delta and self.kernel_config[
                              "compressed_pack"]))

    # -- the streaming delta chain -------------------------------------

    def _drop_deltas_locked(self, key) -> List[ResidentPack]:
        """Release every delta chained on `key` (the caller holds _lock
        and evicts them after it lets go)."""
        dropped = self._deltas.pop(key, [])
        if self._breaker is not None:
            for p in dropped:
                self._breaker.release(p.hbm_bytes)
        meta = self._chain_meta.get(key)
        if meta is not None:
            meta.union = None
        return dropped

    def _set_chain_meta_locked(self, key, readers, reader_key) -> None:
        if not self.delta_enabled:
            return
        self._chain_meta[key] = _ChainMeta(
            reader_key=tuple(reader_key),
            covered={num: tuple(v.segment.name for v in r.views)
                     for num, r in readers},
            live_versions={num: r.live_version for num, r in readers})

    def _chain_locked(self, key) -> Optional[PackChain]:
        base = self._cache.get(key)
        meta = self._chain_meta.get(key)
        if base is None or meta is None:
            return None
        deltas = tuple(self._deltas.get(key, ()))
        return PackChain(base, deltas, meta.union if deltas else base,
                         meta.reader_key)

    @staticmethod
    def _delta_eligible(meta: _ChainMeta, readers
                        ) -> Optional[Dict[int, List[Any]]]:
        """The append-only check, per shard: the chain's covered
        segments are a prefix of the new reader's and its live_version
        is unchanged. → {shard: [the uncovered SegmentViews]}, or None
        for a full rebuild."""
        new = dict(readers)
        if set(new) != set(meta.covered):
            return None
        fresh: Dict[int, List[Any]] = {}
        for num, r in new.items():
            names = tuple(v.segment.name for v in r.views)
            old = meta.covered[num]
            if names[:len(old)] != old:
                return None
            if r.live_version != meta.live_versions.get(num, 0):
                return None
            fresh[num] = list(r.views[len(old):])
        return fresh

    def get_chain(self, index_service, field: str) -> Optional[PackChain]:
        """Chain-aware residency: like get(), but a refresh that only
        appended segments builds a small delta pack over the new ones
        instead of placing the whole image again. A bare chain without
        delta_enabled."""
        if not self.delta_enabled:
            entry = self.get(index_service, field)
            return None if entry is None else PackChain(
                entry, (), entry, entry.reader_key)
        readers, reader_key = self._readers(index_service)
        key = (index_service.name, field)
        with self._lock:
            epoch = self._epochs.get(key[0], 0)
            self._services[key] = index_service
            chain = self._chain_locked(key)
            if chain is None:
                # a base resident but never chained (built by get())
                entry = self._cache.get(key)
                if entry is not None and entry.reader_key == reader_key:
                    self._set_chain_meta_locked(key, readers, reader_key)
                    chain = self._chain_locked(key)
            if chain is not None and chain.reader_key == reader_key:
                self.hits += 1
                return chain
            build_lock = self._build_locks.setdefault(key,
                                                      threading.Lock())
        # stale-while-rebuild holds for the chain as for get()
        if not build_lock.acquire(blocking=False):
            with self._lock:
                chain = self._chain_locked(key)
                if chain is not None:
                    self.stale_served += 1
            if chain is not None:
                return chain
            build_lock.acquire()
        try:
            with self._lock:
                chain = self._chain_locked(key)
                if chain is not None and chain.reader_key == reader_key:
                    self.hits += 1
                    return chain
                meta = self._chain_meta.get(key)
            fresh = (None if chain is None
                     else self._delta_eligible(meta, readers))
            if fresh is None:
                entry = self._build_and_swap(key, readers, field,
                                             reader_key, epoch)
                return None if entry is None else PackChain(
                    entry, (), entry, tuple(reader_key))
            return self._append_delta(key, fresh, readers, field,
                                      reader_key, epoch)
        finally:
            build_lock.release()

    def _append_delta(self, key, fresh, readers, field: str, reader_key,
                      epoch: int) -> PackChain:
        """Build one delta pack of the uncovered segments and chain it on
        the base. The caller holds the key's build lock."""
        delta = self._build(readers, field, reader_key, fresh)
        want_compact = False
        evicted: List[ResidentPack] = []
        with self._lock:
            deleted = self._epochs.get(key[0], 0) != epoch
            if deleted:
                if delta is not None:
                    evicted.append(delta)
                    if self._breaker is not None:
                        self._breaker.release(delta.hbm_bytes)
            else:
                if delta is not None:
                    self._deltas.setdefault(key, []).append(delta)
                    self.delta_stats.appends += 1
                # even a delta without the field advances the coverage:
                # the chain now answers for this reader set
                self._set_chain_meta_locked(key, readers, reader_key)
                deltas = self._deltas.get(key, [])
                if deltas:
                    self._chain_meta[key].union = _UnionView(
                        [self._cache[key]] + deltas, readers)
                    want_compact = (
                        len(deltas) > self.delta_max_packs
                        or sum(p.n_docs for p in deltas)
                        > self.delta_max_docs)
                chain = self._chain_locked(key)
        self._evict(evicted)
        if deleted:
            raise IndexNotFound(f"no such index [{key[0]}]")
        if want_compact and self.on_compact_needed is not None:
            self.on_compact_needed(key)
        return chain

    def compact(self, key) -> bool:
        """Fold the key's delta chain into a fresh full base pack. The
        old base and every delta are released exactly; on a failure the
        chain keeps serving and ``compaction_failures`` counts it.
        → whether a fold was swapped in."""
        key = tuple(key)
        with self._lock:
            index_service = self._services.get(key)
            if index_service is None:
                return False
            epoch = self._epochs.get(key[0], 0)
            build_lock = self._build_locks.setdefault(key,
                                                      threading.Lock())
        with build_lock:
            with self._lock:
                if not self._deltas.get(key):
                    return False
            t0 = time.monotonic()
            try:
                for hook in list(COMPACTION_FAULT_HOOKS):
                    hook(key)
                readers, reader_key = self._readers(index_service)
                entry = self._build(readers, key[1], reader_key)
            except Exception:  # noqa: BLE001 — the chain keeps serving
                logger.exception("delta compaction of %s failed", key)
                with self._lock:
                    self.delta_stats.compaction_failures += 1
                return False
            deleted = self._swap_base(key, entry, readers, reader_key,
                                      epoch)
            with self._lock:
                self.delta_stats.compactions += 1
                self.delta_stats.compact_seconds += time.monotonic() - t0
            return entry is not None and not deleted

    def invalidate(self, index_name: str, deleted: bool = True) -> None:
        """Drop every pack of `index_name`, its deltas included, and
        release their charge. deleted=False (its segments changed, the
        index stays): a build in flight is still cached, and rebuilt at
        the next lookup, whose readers differ."""
        evicted: List[ResidentPack] = []
        with self._lock:
            keys = {k for k in list(self._cache) + list(self._deltas)
                    + list(self._chain_meta) if k[0] == index_name}
            for key in keys:
                entry = self._cache.pop(key, None)
                if entry is not None:
                    if self._breaker is not None:
                        self._breaker.release(entry.hbm_bytes)
                    evicted.append(entry)
                evicted += self._drop_deltas_locked(key)
                self._chain_meta.pop(key, None)
                self._services.pop(key, None)
                if deleted:
                    self._build_locks.pop(key, None)
            if deleted:
                self._epochs[index_name] = \
                    self._epochs.get(index_name, 0) + 1
        self._evict(evicted)

    def invalidate_all(self) -> None:
        with self._lock:
            names = sorted({k[0] for k in list(self._cache)
                            + list(self._deltas)})
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
    #: the kernel variant of the launch that scored it
    variant: Optional[str] = None

    @classmethod
    def empty(cls) -> "FlatQueryResult":
        z = np.empty(0, dtype=np.int32)
        return cls(np.empty(0, dtype=np.float32), z, z, 0, None)


def _pad_rows(n: int, mesh: Mesh) -> int:
    """Pack rows padded to a multiple of the mesh's shards axis."""
    n_sh = mesh.shape[SHARD_AXIS]
    return (n + n_sh - 1) // n_sh * n_sh


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


def _data_bucket(resident: ResidentPack, n: int) -> int:
    """The serving bucket of n queries, a multiple of the data axis."""
    n_data = resident.image.mesh.shape[DATA_AXIS]
    return (_serving_bucket(n) + n_data - 1) // n_data * n_data


def _launch_exact(resident: ResidentPack, flats: Sequence[FlatQuery],
                  k: int, packed_sort: bool = True,
                  variant: Optional[str] = None,
                  stages: Optional["StageTimes"] = None) -> Dict[str, Any]:
    """Host prep + device dispatch of one micro-batch through the exact
    variants: bucketed batch (8/64/pow2), kernel k (128/1024/pow2), slot
    count (pow2 ≥ 8, up to T_LIMIT: a row of more slots is the typed
    400), window (≥ 8) and chunk length (pinned CHUNK_CAP), as the
    reference pins them. A compressed pack takes "compressed" or
    "compressed_exact", a raw one "packed" or "ref" (the raw merge);
    `variant` forces one (the prewarm's signatures). `stages` records
    the reference's ``exact_prep`` and ``exact_dispatch.{variant}``.
    Returns the launch state for _finish_exact."""
    t_prep = time.perf_counter()
    pack = resident.pack
    compressed = resident.streams is not None
    batch = dist.prepare_query_batch(
        pack, [f.terms for f in flats],
        boosts=[f.boost for f in flats],
        min_counts=[f.min_count for f in flats],
        pad_batch_to=_data_bucket(resident, len(flats)),
        pad_max_len=dist.CHUNK_CAP,
        compressed=resident.streams)
    t_pin = 8
    while t_pin < batch.t_slots:
        t_pin *= 2
    limit = merge_kernel.T_LIMIT if compressed else merge_kernel.RAW_T_LIMIT
    if t_pin > limit:
        raise NotLowerable(f"{batch.t_slots} posting slots per row exceed "
                           f"the {'merge' if compressed else 'raw merge'} "
                           f"kernel's {limit}", planner=False)
    if t_pin > batch.t_slots:
        pad = ((0, 0), (0, 0), (0, t_pin - batch.t_slots))
        extra = {}
        if compressed:
            # zero-padded slots: length 0 ⇒ inert in grouping and rescore
            extra = dict(res_starts=np.pad(batch.res_starts, pad),
                         res_lens=np.pad(batch.res_lens, pad),
                         slot_terms=np.pad(batch.slot_terms, pad))
        batch = dataclasses.replace(
            batch, starts=np.pad(batch.starts, pad),
            lengths=np.pad(batch.lengths, pad),
            weights=np.pad(batch.weights, pad), t_slots=t_pin, **extra)
    if variant is None:
        variant = choose_kernel_variant(pack.d_pad, batch.weights,
                                        enabled=packed_sort,
                                        compressed=compressed)
    t_disp = time.perf_counter()
    vals, gids, totals = dist.distributed_search_raw(
        pack, batch, _kernel_k(k), resident.image.mesh,
        device_arrays=resident.image,
        t_window=max(_PRUNE_WINDOW, batch.window), materialize=False,
        variant=variant)
    if stages is not None:
        stages.add("exact_prep", t_disp - t_prep)
        stages.add(f"exact_dispatch.{variant}", time.perf_counter() - t_disp)
    return {"resident": resident, "n": len(flats), "k": k, "vals": vals,
            "gids": gids, "totals": totals, "variant": variant,
            "bucket": batch.starts.shape[1], "t_slots": batch.t_slots,
            "window": batch.window}


def _execute_exact(resident: ResidentPack, flats: Sequence[FlatQuery],
                   k: int, variant: Optional[str] = None
                   ) -> List[FlatQueryResult]:
    return _finish_exact(_launch_exact(resident, flats, k, variant=variant))


def _columnar_results(resident: ResidentPack, vals: np.ndarray,
                      gids: np.ndarray, totals: np.ndarray,
                      n_queries: int, relation_fn,
                      k_cap: Optional[int] = None,
                      variant: Optional[str] = None
                      ) -> List[FlatQueryResult]:
    """Decode a batch's [B, k'] output into columnar per-query results,
    each with its total's relation, relation_fn(query index). Sentinel
    lanes (-inf score, ordinal d_pad, padding rows) sort to the tail, so
    each query's valid hits are a prefix."""
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
        m = int(n_valid[qi])
        if k_cap is not None:
            m = min(m, k_cap)
        sc = vals[qi, :m]
        out.append(FlatQueryResult(
            sc, rows[qi, :m], ords[qi, :m], int(totals[qi]),
            float(sc[0]) if m else None, resident=resident,
            total_relation=relation_fn(qi), variant=variant))
    return out


def _union_results(parts: Sequence[FlatQueryResult], chain: PackChain,
                   k: int) -> FlatQueryResult:
    """The base's and the deltas' results as one top-k over the chain's
    concatenated row space. The parts score disjoint docs, so totals
    add; ties go to the earlier pack, then to the in-pack rank; the
    total is ``gte`` when any part's is; max_score is the parts' max."""
    scores, rows, ords = sparse.union_topk(
        [p.scores for p in parts], [p.rows for p in parts],
        [p.ords for p in parts], chain.view.offsets, k)
    maxes = [p.max_score for p in parts if p.max_score is not None]
    return FlatQueryResult(
        scores, rows, ords, sum(int(p.total_hits) for p in parts),
        float(max(maxes)) if maxes else None, resident=chain.view,
        total_relation=("gte" if any(p.total_relation == "gte"
                                     for p in parts) else "eq"),
        variant=parts[0].variant)


#: each thread's copy stream of a device (the completion threads')
_COPY_STREAMS = threading.local()


def _ready_events(tensors: Iterable[torch.Tensor]) -> Dict[Any, Any]:
    """An event on the current stream of every CUDA device `tensors` lie
    on, recorded after a train's last launch: what that train's copies
    wait for."""
    out: Dict[Any, Any] = {}
    for t in tensors:
        if t.device.type == "cuda" and t.device not in out:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(t.device))
            out[t.device] = ev
    return out


def _to_host(tensors: Sequence[torch.Tensor],
             ready: Optional[Dict[Any, Any]] = None) -> List[np.ndarray]:
    """A train's device outputs as numpy. On a card they are copied on a
    stream of the calling thread's own, after the train's ready event
    (or the current stream's work so far) and into pinned memory: a copy
    on the legacy default stream would wait for every train launched
    after this one. This call returns only once the copies have ended,
    and `tensors` are held until then, so no block is handed out again
    while the copy stream still reads it (``record_stream`` would keep
    each block counted as allocated until the allocator's next poll of
    its events)."""
    out: List[Any] = [None] * len(tensors)
    done = []
    for i, t in enumerate(tensors):
        if t.device.type != "cuda":
            out[i] = t.numpy()
            continue
        streams = getattr(_COPY_STREAMS, "by_device", None)
        if streams is None:
            streams = _COPY_STREAMS.by_device = {}
        stream = streams.get(t.device)
        if stream is None:
            stream = streams[t.device] = torch.cuda.Stream(t.device)
        ev = (ready or {}).get(t.device)
        if ev is None:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(t.device))
        with torch.cuda.stream(stream):
            stream.wait_event(ev)
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            end = torch.cuda.Event()
            end.record(stream)
        done.append(end)
        out[i] = host
    for end in done:
        end.synchronize()
    return [o if isinstance(o, np.ndarray) else o.numpy() for o in out]


def _finish_exact(launch: Dict[str, Any],
                  ready: Optional[Dict[Any, Any]] = None,
                  stages: Optional["StageTimes"] = None
                  ) -> List[FlatQueryResult]:
    t_dev = time.perf_counter()
    vals, gids, totals = _to_host(
        [launch["vals"], launch["gids"], launch["totals"]], ready)
    if stages is not None:
        stages.add(f"exact_device_wait.{launch['variant']}",
                   time.perf_counter() - t_dev)
    return _columnar_results(launch["resident"], vals, gids, totals,
                             launch["n"], lambda qi: "eq",
                             k_cap=launch["k"], variant=launch["variant"])


def _prune_t_slots(prefix_cap: int) -> int:
    return PRUNE_MAX_TERMS * max(1, prefix_cap // dist.CHUNK_CAP)


def _candidate_k(k: int) -> int:
    """Candidate-count buckets of a pruned launch (k + slack)."""
    return 128 if k <= 64 else 2048


def _pruned_variant(packed_sort: bool) -> str:
    """"packed" lets a prefix launch sort one u32 key a lane (pack_keys,
    a per-launch gate); the setting is the reference's packed_sort."""
    return "packed" if packed_sort else "ref"


def _slots_needed(resident: ResidentPack, flat: FlatQuery) -> int:
    """Max over pack rows of Σ_terms ceil(row_len / CHUNK_CAP): the slots
    a full-postings launch of this query needs (a term missing from a
    row still costs its zero-length slot), memoized per pack by terms."""
    memo_key = tuple(flat.terms)
    cached = resident.slots_memo.get(memo_key)
    if cached is not None:
        return cached
    pack = resident.pack
    worst = 0
    for si in range(len(pack.vocabs)):
        vocab = pack.vocabs[si]
        rstart = pack.row_starts[si]
        n = 0
        for t in flat.terms:
            r = vocab.get(t)
            if r is None:
                n += 1
                continue
            ln = int(rstart[r + 1] - rstart[r])
            n += max(1, (ln + dist.CHUNK_CAP - 1) // dist.CHUNK_CAP)
        worst = max(worst, n)
    result = max(worst, 1)
    if len(resident.slots_memo) < 65536:
        resident.slots_memo[memo_key] = result
    return result


def _full_bucket(slots: int) -> Optional[int]:
    for b in FULL_SLOT_BUCKETS:
        if slots <= b:
            return b
    return None


def _launch_pruned(resident: ResidentPack, flats: Sequence[FlatQuery],
                   k: int, prefix_cap: int = PREFIX_CAP,
                   full_slots: Optional[int] = None,
                   packed_sort: bool = True,
                   stages: Optional["StageTimes"] = None) -> Dict[str, Any]:
    """One pruned launch over a raw pack: with full_slots=N the
    full-postings tier at N slots (its run totals are the exact scores:
    no rescore, exact totals); else the prefix tier (each term's first
    prefix_cap impact-sorted entries, the exact rescore on the device).
    `stages` records the reference's ``batch_prep`` and
    ``batch_dispatch[.{variant}]``."""
    t_prep = time.perf_counter()
    pack = resident.pack
    imp_impacts = resident.imp_host[1]
    k_cand = _candidate_k(k)
    k_out = 128 if k_cand == 128 else 1024
    b_bucket = _data_bucket(resident, len(flats))
    terms = [f.terms for f in flats]
    boosts = [f.boost for f in flats]
    with_rescore = full_slots is None
    if full_slots is not None:
        k_cand = k_out  # exact totals: the candidate pool is the result
        batch = dist.prepare_query_batch(
            pack, terms, boosts=boosts, min_counts=[1] * len(flats),
            pad_batch_to=b_bucket, pad_t_slots=full_slots,
            pad_max_len=dist.CHUNK_CAP)
    else:
        batch = dist.prepare_query_batch(
            pack, terms, boosts=boosts, min_counts=[1] * len(flats),
            pad_batch_to=b_bucket, prefix_cap=prefix_cap,
            imp_impacts=imp_impacts, pad_t_slots=_prune_t_slots(prefix_cap),
            pad_max_len=dist.CHUNK_CAP)
    ranges = dist.prepare_term_ranges(pack, terms, boosts=boosts,
                                      pad_batch_to=b_bucket,
                                      pad_terms=PRUNE_MAX_TERMS)
    variant = _pruned_variant(packed_sort)
    pack_keys = (variant == "packed" and with_rescore
                 and sparse.packable(pack.d_pad, batch.weights)
                 and sparse.packable(pack.d_pad, ranges[2]))
    step = dist.make_pruned_search(
        resident.image.mesh, max_len=batch.max_len, d_pad=pack.d_pad,
        p_pad=pack.p_pad, c_cand=k_cand, k_out=k_out,
        t_window=max(_PRUNE_WINDOW, batch.window), t_terms=PRUNE_MAX_TERMS,
        with_rescore=with_rescore, variant=variant, pack_keys=pack_keys)
    ops = dist.pack_pruned_operands(batch, *ranges)
    t_disp = time.perf_counter()
    packed = step(resident.image, ops)
    if stages is not None:
        t_dev = time.perf_counter()
        stages.add("batch_prep", t_disp - t_prep)
        stages.add("batch_dispatch", t_dev - t_disp)
        stages.add(f"batch_dispatch.{variant}", t_dev - t_disp)
    return {"resident": resident, "flats": flats, "k": k,
            "packed": packed, "variant": variant}


def _finish_pruned(launch: Dict[str, Any],
                   ready: Optional[Dict[Any, Any]] = None,
                   stages: Optional["StageTimes"] = None
                   ) -> Tuple[List[Optional[FlatQueryResult]], List[int]]:
    """Decode a pruned launch and check the WAND validity bound: a doc
    outside the candidates scores below cutoff + β (a cut candidate) or β
    (tail only); a query whose k-th score is below that, or that has
    fewer than k hits while its postings were cut, is invalid (None, its
    index listed) and escalates. `stages` records the reference's
    ``batch_device_wait[.{variant}]`` and ``batch_decode``."""
    resident, flats, k = launch["resident"], launch["flats"], launch["k"]
    t_dev = time.perf_counter()
    vals, gids, totals, cutoff, beta = dist.unpack_pruned(
        _to_host([launch["packed"]], ready)[0])
    t_decode = time.perf_counter()
    if stages is not None:
        stages.add("batch_device_wait", t_decode - t_dev)
        stages.add(f"batch_device_wait.{launch['variant']}",
                   t_decode - t_dev)
    decoded = _columnar_results(
        resident, vals, gids.astype(np.int64), totals, len(flats),
        lambda qi: "gte" if beta[qi] > 0.0 else "eq",
        variant=launch["variant"])
    results: List[Optional[FlatQueryResult]] = []
    invalid: List[int] = []
    for qi, res in enumerate(decoded):
        b_q = float(beta[qi])
        n = len(res.scores)
        if n > k:
            res = dataclasses.replace(res, scores=res.scores[:k],
                                      rows=res.rows[:k], ords=res.ords[:k])
            n = k
        if b_q > 0.0:
            kth = float(res.scores[k - 1]) if n >= k else float("-inf")
            c_q = float(cutoff[qi])
            threshold = (c_q + b_q) if c_q > dist.NEG_INF else b_q
            if kth < threshold or n < k:
                results.append(None)
                invalid.append(qi)
                continue
        results.append(res)
    if stages is not None:
        stages.add("batch_decode", time.perf_counter() - t_decode)
    return results, invalid


def _execute_pruned(resident: ResidentPack, flats: Sequence[FlatQuery],
                    k: int, stages: Optional["StageTimes"] = None, **kw
                    ) -> Tuple[List[Optional[FlatQueryResult]], List[int]]:
    return _finish_pruned(_launch_pruned(resident, flats, k, stages=stages,
                                         **kw), stages=stages)


#: the routes a query of a train can take (execute_flat_batch's tiers)
TIERS = tuple(f"full-{b}" for b in FULL_SLOT_BUCKETS) + (
    "prefix-16k", "escalated-64k", "exact")


def launch_flat_batch(resident: ResidentPack, flats: Sequence[FlatQuery],
                      k: int, packed_sort: bool = True,
                      stages: Optional["StageTimes"] = None
                      ) -> Dict[str, Any]:
    """The first half of a train, the reference's r5 routing: host prep
    and every device launch of the train's first pass. On a raw pack an
    OR query (min_count 1) of at most PRUNE_MAX_TERMS terms with k ≤
    PRUNE_MAX_K takes the smallest full-postings tier that holds its
    postings (a tier of fewer than 16 queries joins the next wider one
    when that one launches anyway), else the prefix tier at PREFIX_CAP2;
    the exact launch takes every other query (and every query of a
    compressed pack). → the state finish_flat_batch completes, with the
    events its copies wait for ("ready"). The train's launches and
    finishes record the reference's stages into `stages` (kept in the
    state as "stages") where it is given."""
    raw = resident.imp_host is not None
    pruned_idx = [i for i, f in enumerate(flats)
                  if raw and f.min_count == 1 and k <= PRUNE_MAX_K
                  and len(f.terms) <= PRUNE_MAX_TERMS]
    pruned_set = set(pruned_idx)
    exact_idx = [i for i in range(len(flats)) if i not in pruned_set]
    full_groups: Dict[int, List[int]] = {b: [] for b in FULL_SLOT_BUCKETS}
    hot_idx: List[int] = []
    for i in pruned_idx:
        b = _full_bucket(_slots_needed(resident, flats[i]))
        if b is None:
            hot_idx.append(i)
        else:
            full_groups[b].append(i)
    buckets = list(FULL_SLOT_BUCKETS)
    for bi, b in enumerate(buckets[:-1]):
        if 0 < len(full_groups[b]) < 16 and full_groups[buckets[bi + 1]]:
            full_groups[buckets[bi + 1]].extend(full_groups[b])
            full_groups[b] = []
    st: Dict[str, Any] = {"resident": resident, "flats": flats, "k": k,
                          "packed_sort": packed_sort, "stages": stages,
                          "full_groups": full_groups, "hot_idx": hot_idx,
                          "exact_idx": exact_idx}
    outputs: List[torch.Tensor] = []
    for b, idxs in full_groups.items():
        if idxs:
            launch = st[f"full_launch_{b}"] = _launch_pruned(
                resident, [flats[i] for i in idxs], k, full_slots=b,
                packed_sort=packed_sort, stages=stages)
            outputs.append(launch["packed"])
    if hot_idx:
        launch = st["hot_launch"] = _launch_pruned(
            resident, [flats[i] for i in hot_idx], k,
            prefix_cap=PREFIX_CAP2, packed_sort=packed_sort, stages=stages)
        outputs.append(launch["packed"])
    if exact_idx:
        launch = st["exact_launch"] = _launch_exact(
            resident, [flats[i] for i in exact_idx], k,
            packed_sort=packed_sort, stages=stages)
        outputs += [launch["vals"], launch["gids"], launch["totals"]]
    st["ready"] = _ready_events(outputs)
    return st


def finish_flat_batch(st: Dict[str, Any],
                      tiers: Optional[Dict[str, int]] = None,
                      variants: Optional[Dict[str, int]] = None,
                      shapes: Optional[Dict[Tuple[int, int, int], int]]
                      = None) -> List[FlatQueryResult]:
    """The second half of a train: its results to the host; queries
    whose validity bound fails escalate to PREFIX_CAP3, then to the exact
    launch. `tiers` counts the queries each tier of TIERS took (an
    escalated query in each tier it passed), `variants` the exact
    launches by variant and `shapes` by (batch bucket, slots, kernel
    k)."""
    resident, flats, k = st["resident"], st["flats"], st["k"]
    packed_sort, ready = st["packed_sort"], st["ready"]
    stages = st["stages"]
    out: List[Optional[FlatQueryResult]] = [None] * len(flats)
    taken: Dict[str, int] = {}
    escalate: List[int] = []
    for b, idxs in st["full_groups"].items():
        if not idxs:
            continue
        results, invalid = _finish_pruned(st[f"full_launch_{b}"], ready,
                                          stages)
        for j, i in enumerate(idxs):
            out[i] = results[j]
        taken[f"full-{b}"] = len(idxs)
        # full-postings runs are exact (beta 0, never invalid); should
        # that ever break, escalate rather than fail the train
        escalate.extend(idxs[j] for j in invalid)
    hot_idx = st["hot_idx"]
    if hot_idx:
        results, invalid = _finish_pruned(st["hot_launch"], ready, stages)
        for j, i in enumerate(hot_idx):
            out[i] = results[j]
        taken["prefix-16k"] = len(hot_idx)
        escalate.extend(hot_idx[j] for j in invalid)
    tier3_idx: List[int] = []
    if escalate:
        if stages is not None:
            stages.add("pruned_invalid_t2", 0.0, n=len(escalate))
        results, invalid = _execute_pruned(
            resident, [flats[i] for i in escalate], k, stages=stages,
            prefix_cap=PREFIX_CAP3, packed_sort=packed_sort)
        for j, i in enumerate(escalate):
            out[i] = results[j]
        taken["escalated-64k"] = len(escalate)
        tier3_idx = [escalate[j] for j in invalid]
        if invalid and stages is not None:
            stages.add("pruned_invalid_t3", 0.0, n=len(invalid))
    exact_launches = []
    if st["exact_idx"]:
        exact_launches.append((st["exact_idx"], st["exact_launch"], ready))
    t_tier3 = time.perf_counter()
    if tier3_idx:
        exact_launches.append((tier3_idx, _launch_exact(
            resident, [flats[i] for i in tier3_idx], k,
            packed_sort=packed_sort, stages=stages), None))
    for idxs, launch, events in exact_launches:
        if variants is not None:
            v = launch["variant"]
            variants[v] = variants.get(v, 0) + 1
        if shapes is not None:
            shape = (launch["bucket"], launch["t_slots"], _kernel_k(k))
            shapes[shape] = shapes.get(shape, 0) + 1
        results = _finish_exact(launch, events, stages)
        for j, i in enumerate(idxs):
            out[i] = results[j]
        taken["exact"] = taken.get("exact", 0) + len(idxs)
        if idxs is tier3_idx and stages is not None:
            stages.add("exact_batch", time.perf_counter() - t_tier3,
                       n=len(tier3_idx))
    if tiers is not None:
        for name, n in taken.items():
            tiers[name] = tiers.get(name, 0) + n
    return out  # type: ignore[return-value]


def execute_flat_batch(resident: ResidentPack, flats: Sequence[FlatQuery],
                       k: int, packed_sort: bool = True,
                       tiers: Optional[Dict[str, int]] = None,
                       variants: Optional[Dict[str, int]] = None,
                       shapes: Optional[Dict[Tuple[int, int, int], int]]
                       = None) -> List[FlatQueryResult]:
    """One train, launched and finished in the caller's thread."""
    return finish_flat_batch(
        launch_flat_batch(resident, flats, k, packed_sort=packed_sort),
        tiers=tiers, variants=variants, shapes=shapes)


# ---------------------------------------------------------------------------
# micro-batching
# ---------------------------------------------------------------------------

#: a query whose rows need more posting slots than this rides trains of
#: its own: its launch takes T 2048 and more, 20-50x a narrow train's
#: kernel time, which would hold every narrow query sharing the train
WIDE_SLOTS = 1024


@dataclasses.dataclass
class _Pending:
    flat: FlatQuery
    k: int
    future: Future
    wide: bool = False
    # batch_wait's marks (perf_counter): submit on the request thread,
    # the train's cycle, take and launch by the launch worker; the
    # request thread reads them after the result, so the four parts of
    # the split sum to its batch_wait
    t_submit: float = 0.0
    t_cycle: float = 0.0
    t_take: float = 0.0
    t_launched: float = 0.0


class _PackQueue:
    """One pack's pending queries, a launch worker and a completion
    thread. Launch and completion are split, so train N+1 is prepared
    and launched while train N runs on the device and comes back; at
    most PIPELINE_DEPTH trains are in flight (the launch worker blocks
    past that). A train takes the oldest waiting query and those of its
    class (narrow or wide, WIDE_SLOTS) behind it, up to max_batch, once
    max_batch wait or the oldest has waited window_s: queries that
    queued while the worker launched the last train go at once."""

    PIPELINE_DEPTH = 3

    def __init__(self, batcher: "MicroBatcher", resident: ResidentPack):
        self.batcher = batcher
        self.resident = resident
        self.cv = threading.Condition()
        self.pendings: List[_Pending] = []
        self.closed = False
        # trains launched and not yet finished
        self.n_inflight = 0
        self.inflight: "queue.Queue" = queue.Queue(
            maxsize=self.PIPELINE_DEPTH)
        self.completer = threading.Thread(target=self._complete,
                                          daemon=True,
                                          name="gpu-micro-batcher-complete")
        self.completer.start()
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
        try:
            while True:
                with self.cv:
                    while not self.pendings and not self.closed:
                        self.cv.wait()
                    if self.closed and not self.pendings:
                        return
                    taken = self._gather()
                self._launch(taken)
        finally:
            self.inflight.put(None)  # stops the completer
            self.completer.join()

    def _gather(self) -> List[_Pending]:
        """One train's queries (the caller holds cv, and pendings is not
        empty): the window from the oldest query's submit, then the
        oldest query's class in arrival order."""
        batcher = self.batcher
        t_cycle = time.perf_counter()
        deadline = self.pendings[0].t_submit + batcher.window_s
        while len(self.pendings) < batcher.max_batch and not self.closed:
            left = deadline - time.perf_counter()
            if left <= 0:
                break
            self.cv.wait(timeout=left)
        wide = self.pendings[0].wide
        taken: List[_Pending] = []
        rest: List[_Pending] = []
        for p in self.pendings:
            (taken if p.wide == wide and len(taken) < batcher.max_batch
             else rest).append(p)
        self.pendings = rest
        t_take = time.perf_counter()
        for p in taken:
            p.t_cycle = t_cycle
            p.t_take = t_take
        return taken

    def _launch(self, taken: List[_Pending]) -> None:
        """Launch one train and hand it to the completion thread (this
        blocks while PIPELINE_DEPTH trains are in flight)."""
        batcher = self.batcher
        batcher.train_began()
        try:
            st = batcher.launch(self.resident, [p.flat for p in taken],
                                max(p.k for p in taken))
        except Exception as exc:  # noqa: BLE001 — handed to the futures
            self._fail(taken, exc)
            batcher.train_ended()
            return
        t_launched = time.perf_counter()
        for p in taken:
            p.t_launched = t_launched
        with self.cv:
            self.n_inflight += 1
        self.inflight.put((st, taken))

    def _complete(self) -> None:
        while True:
            item = self.inflight.get()
            if item is None:
                return
            self._finish(*item)
            # nothing of the train stays referenced while this thread
            # waits: its device outputs go back to the allocator now
            del item

    def _finish(self, st: Dict[str, Any], taken: List[_Pending]) -> None:
        batcher = self.batcher
        try:
            results = batcher.finish(st)
        except Exception as exc:  # noqa: BLE001 — handed to the futures
            self._fail(taken, exc)
        else:
            batcher.record(len(taken))
            for p, res in zip(taken, results):
                p.future.set_result(res)
        finally:
            with self.cv:
                self.n_inflight -= 1
            batcher.train_ended()

    def _fail(self, taken: List[_Pending], exc: BaseException) -> None:
        """A train that failed: its one query gets the error, or each of
        its queries runs alone, so that a fault of one request reaches no
        other client."""
        if len(taken) == 1:
            taken[0].future.set_exception(exc)
            return
        batcher = self.batcher
        for p in taken:
            try:
                res = batcher.finish(batcher.launch(self.resident,
                                                    [p.flat], p.k))[0]
            except Exception as exc1:  # noqa: BLE001 — to its future
                p.future.set_exception(exc1)
            else:
                batcher.record(1)
                p.future.set_result(res)


class MicroBatcher:
    """Coalesces concurrent queries per resident pack into trains:
    queries arriving within window_s (or until max_batch) share one; k
    pads to the max requested. `launch(resident, flats, k)` starts a
    train and `finish(state)` completes it; each pack's queue runs them
    on two threads, so its trains pipeline."""

    def __init__(self, launch, finish, window_s: float = 0.005,
                 max_batch: int = 128):
        self.launch = launch
        self.finish = finish
        self.window_s = window_s
        self.max_batch = max_batch
        self._lock = threading.Lock()
        self._queues: Dict[int, _PackQueue] = {}
        self._closed = False
        self.batch_sizes: Dict[int, int] = {}  # queries per train → trains
        #: trains between the start of their launch and the end of their
        #: finish, now and at most: past 1, a train was launching while
        #: another one's results came back
        self.active = 0
        self.max_inflight = 0

    def record(self, n: int) -> None:
        with self._lock:
            self.batch_sizes[n] = self.batch_sizes.get(n, 0) + 1

    def train_began(self) -> None:
        with self._lock:
            self.active += 1
            self.max_inflight = max(self.max_inflight, self.active)

    def train_ended(self) -> None:
        with self._lock:
            self.active -= 1

    def submit(self, resident: ResidentPack, flat: FlatQuery,
               k: int) -> Optional[Future]:
        """The future of `flat`'s result (its `_Pending`, with the
        batch_wait marks, rides on it as `.pending`), or None when
        `resident` was retired: the caller looks its pack up again."""
        if resident.retired:
            return None
        pending = _Pending(flat, k, Future(),
                           wide=_slots_needed(resident, flat) > WIDE_SLOTS,
                           t_submit=time.perf_counter())
        pending.future.pending = pending  # type: ignore[attr-defined]
        while True:
            with self._lock:
                if self._closed:
                    raise RuntimeError("micro-batcher is closed")
                if resident.retired:
                    return None
                queue_ = self._queues.get(id(resident))
                if queue_ is None:
                    queue_ = self._queues[id(resident)] = _PackQueue(
                        self, resident)
            if queue_.submit(pending):
                return pending.future
            # the queue closed after the lookup: look again

    def retire(self, resident: ResidentPack) -> Optional[threading.Thread]:
        """Refuse new work for `resident`; its queue drains what it holds
        and its threads end. → its launch worker (None without a queue),
        which ends after its completion thread: until then they hold
        `resident` and so its device arrays."""
        with self._lock:
            resident.retired = True
            queue_ = self._queues.pop(id(resident), None)
        if queue_ is None:
            return None
        queue_.close()
        return queue_.thread

    def queue_depths(self) -> Dict[str, int]:
        """Queues, waiting queries and trains in flight, now."""
        with self._lock:
            queues = list(self._queues.values())
        return {"queues": len(queues),
                "pending": sum(len(q.pendings) for q in queues),
                "inflight": sum(q.n_inflight for q in queues),
                "max_inflight": self.max_inflight}

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

class _BareShard:
    """A shard of one of the service's own indices: its frozen segments,
    read through one ShardReader until they change (the pack cache keys
    on the readers' identities, as it does for an IndexShard's)."""

    def __init__(self, mapper: MapperService):
        self.mapper = mapper
        self.segments: List[Segment] = []
        self._reader: Optional[ShardReader] = None
        # concurrent first searches must share one reader: a reader each
        # would give each its own pack key, and each would build a pack
        self._lock = threading.Lock()

    def add(self, segment: Segment) -> None:
        with self._lock:
            self.segments.append(segment)
            self._reader = None

    def acquire_searcher(self) -> ShardReader:
        with self._lock:
            if self._reader is None:
                self._reader = ShardReader(
                    [(seg, None) for seg in self.segments], self.mapper)
            return self._reader


class _Index:
    """One of the service's own indices, shaped as the node's
    IndexService is where the serving path reads it (name, mapper with
    its generation, shards with acquire_searcher): try_search, the pack
    cache, the plan cache and the prewarm take it as they take an
    IndexService."""

    def __init__(self, name: str, number_of_shards: int,
                 mapping: Optional[dict]):
        self.name = name
        self.num_shards = number_of_shards
        self.mapper = MapperService(mapping)
        self.writers: Dict[int, SegmentWriter] = {}
        self.shards: Dict[int, _BareShard] = {
            s: _BareShard(self.mapper) for s in range(number_of_shards)}
        self.ids: set = set()
        self.generation = 0
        self.lock = threading.Lock()


class GpuSearchService:
    """The kernel path of ``_search`` over a mesh (``make_mesh()``: every
    visible GPU on the shards axis; ``device=``: a (1, 1) mesh of that
    device, ``device="cpu"`` the plain path): ``try_search`` over a
    node's IndexService, through the plan cache, the IndexPackCache
    (charged to `breaker`, the node's ``hbm`` breaker) and the pipelined
    micro-batcher; ``prewarm`` of an (index, field); and create_index /
    index / refresh / search / delete_index over indices of its own,
    which go through the same ``try_search``."""

    def __init__(self, device=None, window_s: float = 0.005,
                 max_batch: int = 128, batch_timeout_s: float = 300.0,
                 breaker=None, mesh: Optional[Mesh] = None,
                 packed_sort: bool = True, compressed_pack: bool = True,
                 delta: Optional[Dict[str, Any]] = None,
                 prewarm_concurrency: int = 4):
        self.mesh = resolve_mesh(device, mesh)
        self.batch_timeout_s = batch_timeout_s
        self._indices: Dict[str, _Index] = {}
        self._lock = threading.Lock()
        #: the reference's KERNEL_CONFIG routing keys (its settings
        #: search.tpu_serving.kernel.packed_sort / .compressed_pack), per
        #: service: compressed_pack decides the format of the packs built
        #: from then on (False keeps every pack raw), packed_sort lets a
        #: raw pack's launches take "packed"
        self.kernel_config = {"packed_sort": bool(packed_sort),
                              "compressed_pack": bool(compressed_pack)}
        self.batcher = MicroBatcher(self._launch_train, self._finish_train,
                                    window_s=window_s, max_batch=max_batch)
        self._breaker = breaker
        self.packs = IndexPackCache(self.mesh, breaker, self.kernel_config)
        self.packs.on_evict = self._on_evict
        # the launch workers of retired packs: delete_index joins them
        self._retired_threads: List[threading.Thread] = []
        self.plans = PlanCache()
        self.stages = StageTimes()
        self.served = 0
        #: requests try_search did not serve: a query outside the
        #: lowering subset, traffic during a prewarm, a request deadline
        #: that expired in the batcher
        self.fallback = 0
        #: batch waits that outlived their deadline (request or service)
        self.timeouts = 0
        self.last_error: Optional[str] = None
        #: exact launches by kernel variant (compressed: the fused merge
        #: kernel; compressed_exact: the exact merge, for unpackable
        #: weights; ref / packed: the raw merge)
        self.variant_launches: Dict[str, int] = {}
        self.launch_shapes: Dict[Tuple[int, int, int], int] = {}
        #: queries each tier of TIERS took (an escalated query in each it
        #: passed) and results whose total's relation is "gte"
        self.tier_queries: Dict[str, int] = {}
        self.gte_results = 0
        # the prewarm: its grace (traffic goes to the planner while it
        # runs) and its progress
        self.prewarm_concurrency = max(1, int(prewarm_concurrency))
        self._warming = False
        self._prewarm_lock = threading.Lock()
        self._prewarm_progress: Dict[str, Any] = {
            "state": "idle", "total": 0, "done": 0, "seconds": 0.0}
        # the streaming delta chain: opt-in, so a bare GpuSearchService()
        # keeps rebuild-on-refresh (the reference's bare service does);
        # the node passes its delta settings, on by default
        dcfg = dict(delta or {})
        self.packs.delta_enabled = (delta is not None
                                    and bool(dcfg.get("enabled", True)))
        self.packs.delta_max_packs = int(dcfg.get("max_packs", 4))
        self.packs.delta_max_docs = int(dcfg.get("max_docs", 50_000))
        self.packs.on_compact_needed = self._request_compaction
        self.delta_stats = self.packs.delta_stats
        self._compact_lock = threading.Lock()
        self._compact_pending: set = set()
        self._compacting = False
        self._compact_wakeup = threading.Event()
        self._compact_closed = False
        self._compact_thread: Optional[threading.Thread] = None

    # -- background compaction -------------------------------------------

    def _request_compaction(self, key) -> None:
        """The pack cache's callback: `key`'s chain crossed its fold
        threshold. Folds run on ONE background thread, started on first
        demand (a full build at scale takes seconds: never on a serving
        thread)."""
        with self._compact_lock:
            self._compact_pending.add(tuple(key))
            if self._compact_thread is None and not self._compact_closed:
                self._compact_thread = threading.Thread(
                    target=self._compact_loop, daemon=True,
                    name="delta-compactor")
                self._compact_thread.start()
        self._compact_wakeup.set()

    def _compact_loop(self) -> None:
        while not self._compact_closed:
            self._compact_wakeup.wait(timeout=1.0)
            self._compact_wakeup.clear()
            while True:
                with self._compact_lock:
                    if self._compact_closed or not self._compact_pending:
                        self._compacting = False
                        break
                    key = self._compact_pending.pop()
                    self._compacting = True
                self.packs.compact(key)  # counts its own failures

    def compaction_idle(self) -> bool:
        """No fold pending or running: a quiescent point."""
        with self._compact_lock:
            return not self._compact_pending and not self._compacting

    def stats(self) -> Dict[str, Any]:
        """The counters, the plan and pack caches, the delta chains'
        totals, the prewarm's progress, the batcher's queues and the
        stage times (the reference's shape, less its supervision,
        watchdog and device blocks)."""
        cache = self.packs.stats()
        chains = cache["deltas"].values()
        with self._prewarm_lock:
            prewarm = dict(self._prewarm_progress)
        return {"served": self.served, "fallback": self.fallback,
                "timeouts": self.timeouts, "last_error": self.last_error,
                "batches": sum(self.batcher.batch_sizes.values()),
                "batched_queries": sum(
                    n * c for n, c in self.batcher.batch_sizes.items()),
                "plan_cache": self.plans.stats(), "pack_cache": cache,
                "deltas": dict(dataclasses.asdict(self.delta_stats),
                               enabled=self.packs.delta_enabled,
                               packs=sum(c["packs"] for c in chains),
                               bytes=sum(c["bytes"] for c in chains)),
                "prewarm": prewarm,
                "queue": self.batcher.queue_depths(),
                "stages": self.stages.snapshot()}

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
        of an existing id are refused."""
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
                writer.add_document(
                    idx.mapper.parse_document(doc_id, source),
                    dv_kinds=idx.mapper.dv_kinds())
                n += 1
        return n

    def add_segment(self, name: str, shard: int, segment: Segment) -> None:
        """Make a built segment searchable on `shard` (bulk loading)."""
        idx = self._index(name)
        with idx.lock:
            idx.ids.update(segment.doc_ids)
            idx.shards[shard].add(segment)
        self.packs.invalidate(name, deleted=False)

    def refresh(self, name: str) -> None:
        """Freeze every shard's buffered documents into one new segment
        per shard and drop the resident packs (rebuilt on next search)."""
        idx = self._index(name)
        with idx.lock:
            for shard, writer in sorted(idx.writers.items()):
                if writer.num_docs:
                    idx.shards[shard].add(writer.freeze())
            idx.writers.clear()
            idx.generation += 1
        self.packs.invalidate(name, deleted=False)

    def _on_evict(self, resident: ResidentPack) -> None:
        """The pack cache evicted `resident`: retire its batcher queue;
        its launch worker is kept for delete_index to join."""
        thread = self.batcher.retire(resident)
        with self._lock:
            self._retired_threads = [t for t in self._retired_threads
                                     if t.is_alive()]
            if thread is not None:
                self._retired_threads.append(thread)

    def delete_index(self, name: str) -> None:
        """Drop an index of the service's own, its resident packs, their
        plans and their breaker charge. Returns once the packs' batcher
        threads have ended, so that their device arrays are freed."""
        self._index(name)
        self.invalidate_index(name)
        with self._lock:
            self._indices.pop(name, None)
            threads = list(self._retired_threads)
        for thread in threads:
            if thread is not threading.current_thread():
                thread.join()

    def resident(self, name: str, field: str) -> Optional[ResidentPack]:
        """The field's resident pack, built and placed on first use; None
        when no segment holds postings of the field."""
        return self.packs.get(self._index(name), field)

    # -- trains ------------------------------------------------------------

    def _launch_train(self, resident: ResidentPack,
                      flats: Sequence[FlatQuery], k: int) -> Dict[str, Any]:
        t0 = time.perf_counter()
        st = launch_flat_batch(
            resident, flats, k,
            packed_sort=self.kernel_config["packed_sort"],
            stages=self.stages)
        st["t0"] = t0
        return st

    def _finish_train(self, st: Dict[str, Any]) -> List[FlatQueryResult]:
        tiers: Dict[str, int] = {}
        variants: Dict[str, int] = {}
        shapes: Dict[Tuple[int, int, int], int] = {}
        out = finish_flat_batch(st, tiers=tiers, variants=variants,
                                shapes=shapes)
        with self._lock:
            for mine, total in ((tiers, self.tier_queries),
                                (variants, self.variant_launches),
                                (shapes, self.launch_shapes)):
                for key, n in mine.items():
                    total[key] = total.get(key, 0) + n
            self.gte_results += sum(r.total_relation == "gte" for r in out)
        self.stages.add("train", time.perf_counter() - st["t0"])
        return out

    def _execute(self, resident: ResidentPack, flats: Sequence[FlatQuery],
                 k: int) -> List[FlatQueryResult]:
        """One train launched and finished in the caller's thread (its
        tiers, variants and stage time counted as a queue's train's)."""
        return self._finish_train(self._launch_train(resident, flats, k))

    # -- the node's path (the reference's TpuSearchService.try_search) -----

    def try_search(self, index_service, query: dsl.QueryNode, *,
                   k: int, timeout_s: Optional[float] = None,
                   profile_sink: Optional[Dict[str, Any]] = None
                   ) -> Optional[FlatQueryResult]:
        """The kernel result of `query` over `index_service` (k = from +
        size, the window the coordinator needs, which checks it against
        MAX_K), or None where the reference's planner answers instead
        and the coordinator runs the port's: traffic during a prewarm,
        and a request deadline (`timeout_s`) that expired in the
        batcher. A query outside the lowering subset raises
        NotLowerable (the negative is cached too). `profile_sink` (a
        ``profile: true`` search) receives the variant, the plan cache's
        outcome and this request's stage times.

        Unlike the reference, a fault of the kernel path, or a batch
        that outlives the service's cap, reaches the caller: its
        catch-all fallback to the planner and its tripped breaker are not
        ported, because they would hide a kernel fault."""
        if k <= 0 or k > MAX_K:
            raise ValueError(f"k = {k} is outside (0, {MAX_K}]")
        if self._warming:
            # the prewarm's grace: the planner answers until it ends
            with self._lock:
                self.fallback += 1
            return None
        t0 = time.perf_counter()
        pkey = plan_key(query)
        cache_key = None
        if pkey is not None:
            cache_key = (index_service.name,
                         getattr(index_service.mapper, "generation", 0),
                         pkey)
        cached = self.plans.get(cache_key) if cache_key is not None else None
        cached_rk = None
        if cached is None:
            flat = _lower(query, index_service.mapper)
        elif cached is NOT_LOWERABLE:
            flat = None
        else:
            flat, cached_rk = cached
        if flat is None:
            if cache_key is not None and cached is None:
                self.plans.put(cache_key, NOT_LOWERABLE)
            self.stages.add("lower", time.perf_counter() - t0)
            with self._lock:
                self.fallback += 1
            raise _not_lowerable(query)
        t1 = time.perf_counter()
        while True:
            chain = self.packs.get_chain(index_service, flat.field)
            t2 = time.perf_counter()
            if chain is None:
                # the field has postings nowhere: zero hits, kernel-free
                self.stages.add("lower", t1 - t0)
                self.stages.add("pack_get", t2 - t1)
                with self._lock:
                    self.served += 1
                if profile_sink is not None:
                    profile_sink["empty_pack"] = True
                return FlatQueryResult.empty()
            # a plan validates against the chain's reader key: the base
            # keeps its older key while deltas cover the newer segments
            outcome = ("uncacheable" if cache_key is None
                       else "hit" if cached is not None else "miss")
            if cache_key is not None:
                if cached is None:
                    self.plans.put(cache_key, (flat, chain.reader_key))
                elif cached_rk != chain.reader_key:
                    # the pack was rebuilt since the plan was cached:
                    # lower again against it, and pin the entry to it
                    outcome = "revalidated"
                    flat = lower_query(query, index_service.mapper)
                    self.plans.put(cache_key, (flat, chain.reader_key))
                    cached_rk = chain.reader_key
            # the deltas are operands of the same lowered query: each
            # batches in its own queue, the columns merge on the host
            t_sub = time.perf_counter()
            futures = [self.batcher.submit(p, flat, k)
                       for p in chain.parts]
            if all(f is not None for f in futures):
                break
            # a refresh, fold or delete retired a pack of the chain
            # after the lookup: resolve the whole chain again
        self.stages.add("lower", t1 - t0)
        self.stages.add("pack_get", t2 - t1)
        # the wait: the service's cap, or the request's deadline when
        # that is shorter; one deadline shared by the chain's parts
        wait = self.batch_timeout_s
        deadline_limited = (timeout_s is not None
                            and timeout_s < self.batch_timeout_s)
        if deadline_limited:
            wait = max(0.05, timeout_s)
        deadline = t_sub + wait
        try:
            parts = [f.result(timeout=max(0.01,
                                          deadline - time.perf_counter()))
                     for f in futures]
        except FuturesTimeout:
            with self._lock:
                self.timeouts += 1
                if deadline_limited:
                    self.fallback += 1
                    self.last_error = "request deadline during kernel batch"
            if deadline_limited:
                return None
            raise
        result = (parts[0] if len(parts) == 1
                  else _union_results(parts, chain, k))
        t_done = time.perf_counter()
        self.stages.add("batch_wait", t_done - t_sub)
        split = self._record_batch_wait_split(
            getattr(futures[0], "pending", None), t_sub, t_done,
            result.variant)
        with self._lock:
            self.served += 1
        if profile_sink is not None:
            profile_sink.update({
                "variant": result.variant,
                "plan_cache": outcome,
                "stages_ms": {"lower": round((t1 - t0) * 1e3, 4),
                              "pack_get": round((t2 - t1) * 1e3, 4),
                              "batch_wait": round((t_done - t_sub) * 1e3,
                                                  4)}})
            if split:
                profile_sink["stages_ms"]["batch_wait_split"] = {
                    name: round(dt * 1e3, 4) for name, dt in split.items()}
        return result

    def _record_batch_wait_split(self, pending, t_sub: float,
                                 t_done: float, variant: Optional[str]
                                 ) -> Optional[Dict[str, float]]:
        """One query's batch_wait in four parts, from the marks its
        train's workers stamped: queue (submit to the train's cycle),
        window (the batching window), dispatch (the launch's host work)
        and completion (the device, the copy back and the decode); they
        sum to batch_wait by construction."""
        if pending is None or not pending.t_take or not pending.t_launched:
            return None
        t_c, t_t, t_l = pending.t_cycle, pending.t_take, pending.t_launched
        split = {"queue": max(0.0, t_c - t_sub),
                 "window": max(0.0, t_t - max(t_sub, t_c)),
                 "dispatch": max(0.0, t_l - t_t),
                 "completion": max(0.0, t_done - t_l)}
        for name, dt in split.items():
            self.stages.add(f"batch_wait.{name}", dt)
            if variant:
                self.stages.add(f"batch_wait.{name}.{variant}", dt)
        return split

    def invalidate_index(self, name: str) -> None:
        """Drop the index's resident packs, their breaker charge, their
        batcher queues and its lowered plans (index delete or close)."""
        self.packs.invalidate(name)
        self.plans.invalidate_index(name)

    def invalidate_plans(self, name: str) -> None:
        """Drop the index's lowered plans only (a mapping update: the
        generation in the key already makes them unreachable; this keeps
        the LRU from carrying them)."""
        self.plans.invalidate_index(name)

    # -- prewarm -----------------------------------------------------------

    def prewarm(self, index_service, field: str,
                concurrency: Optional[int] = None) -> Dict[str, Any]:
        """Make the (index, field) pack resident and run every
        steady-state serving signature once, now, instead of on the first
        requests (the reference's index warmer). On a card that builds
        the kernel library (nvcc at first use), places the pack and runs
        one warm train a deduped signature (batch bucket × kernel-k
        bucket × width or prefix × variant), on `concurrency` threads.
        Traffic that arrives meanwhile goes to the planner (try_search's
        `_warming` grace); the library is built before the grace opens,
        since that planner launches shard_topk from the same library."""
        t0 = time.perf_counter()
        workers = max(1, concurrency or self.prewarm_concurrency)
        if any(d.type == "cuda" for row in self.mesh.grid for d in row):
            merge_kernel.build()
        with self._prewarm_lock:
            self._prewarm_progress = {"state": "warming", "total": 0,
                                      "done": 0, "seconds": 0.0}
        self._warming = True
        try:
            resident = self.packs.get(index_service, field)
            t_pack = time.perf_counter() - t0
            compiled: List[Dict[str, Any]] = []
            if resident is not None:
                self._compile_signatures(resident, field, compiled,
                                         workers)
            return {"pack_seconds": round(t_pack, 2), "compiled": compiled,
                    "total_seconds": round(time.perf_counter() - t0, 2)}
        finally:
            self._warming = False
            with self._prewarm_lock:
                self._prewarm_progress["state"] = "done"
                self._prewarm_progress["seconds"] = round(
                    time.perf_counter() - t0, 2)

    def prewarm_async(self, index_service, field: str,
                      concurrency: Optional[int] = None
                      ) -> threading.Thread:
        """prewarm on a thread of its own; try_search sends traffic to
        the planner until it ends; stats()["prewarm"] shows progress."""
        t = threading.Thread(
            target=lambda: self.prewarm(index_service, field,
                                        concurrency=concurrency),
            daemon=True, name="gpu-prewarm")
        t.start()
        return t

    def _compile_signatures(self, resident: ResidentPack, field: str,
                            compiled: List[Dict[str, Any]],
                            workers: int) -> None:
        """The reference's signature table, deduped the same way, each
        signature's warm train run once (best effort: a failure is
        recorded on its entry, and after three in a row the rest are
        skipped)."""
        from concurrent.futures import ThreadPoolExecutor

        terms: List[str] = []
        for v in resident.pack.vocabs:
            if v:
                terms = [next(iter(v))]
                break
        flat = FlatQuery(field, terms or ["_warm_"], 1.0, 1)
        buckets = sorted({8, 64, _serving_bucket(self.batcher.max_batch)})
        table = []   # (batch, k, slots | None, prefix | None)
        for b_bucket in buckets:
            for k in (10, PRUNE_MAX_K):
                for slots in FULL_SLOT_BUCKETS:
                    table.append((b_bucket, k, slots, None))
                table.append((b_bucket, k, None, PREFIX_CAP2))
        # the PREFIX_CAP3 escalation runs inside a train's completion
        for b_bucket in buckets:
            for k in (10, PRUNE_MAX_K):
                table.append((b_bucket, k, None, PREFIX_CAP3))
        packed_sort = self.kernel_config["packed_sort"]
        compressed = resident.streams is not None
        # a compressed pack has no impact-sorted copy: no pruned tier
        if compressed:
            pruned_variants: Tuple[str, ...] = ()
            exact_variants: Tuple[str, ...] = ("compressed",
                                               "compressed_exact")
        else:
            pruned_variants = ("packed", "ref") if packed_sort else ("ref",)
            exact_variants = (("packed", "ref")
                              if packed_sort
                              and sparse.packable(resident.pack.d_pad)
                              else ("ref",))
        seen = set()
        jobs = []  # (entry, run)
        for b_bucket, k, slots, cap in table:
            for variant in pruned_variants:
                sig = (b_bucket, _candidate_k(k), slots, cap, variant)
                if sig in seen:
                    continue
                seen.add(sig)
                jobs.append(({"batch": b_bucket, "k": k, "slots": slots,
                              "prefix": cap, "variant": variant},
                             lambda b_bucket=b_bucket, k=k, slots=slots,
                             cap=cap, variant=variant: _execute_pruned(
                                 resident, [flat] * b_bucket, k,
                                 prefix_cap=cap or PREFIX_CAP2,
                                 full_slots=slots,
                                 packed_sort=variant == "packed")))
        # the exact launch (msm/AND, the escalation's last tier) at its
        # common signatures; with counts through min_count 2
        flat_and = FlatQuery(flat.field, flat.terms * 2, 1.0, 2)
        for b_bucket, k in ((8, 10), (64, PRUNE_MAX_K)):
            for variant in exact_variants:
                jobs.append(({"batch": b_bucket, "k": k, "exact": True,
                              "variant": variant},
                             lambda b_bucket=b_bucket, k=k,
                             variant=variant: _execute_exact(
                                 resident, [flat_and] * b_bucket, k,
                                 variant=variant)))
        with self._prewarm_lock:
            self._prewarm_progress["total"] += len(jobs)
        fail_lock = threading.Lock()
        consecutive_failures = [0]

        def warm_one(entry, run):
            with fail_lock:
                skip = consecutive_failures[0] >= 3
            t1 = time.perf_counter()
            if skip:
                entry["error"] = "skipped: systemic prewarm failure"
            else:
                try:
                    run()
                    with fail_lock:
                        consecutive_failures[0] = 0
                except Exception as exc:  # noqa: BLE001 — record, go on
                    entry["error"] = f"{type(exc).__name__}: {exc}"[:160]
                    with fail_lock:
                        consecutive_failures[0] += 1
                    logger.warning("prewarm %s failed: %s", entry, exc)
                entry["seconds"] = round(time.perf_counter() - t1, 2)
            compiled.append(entry)
            with self._prewarm_lock:
                self._prewarm_progress["done"] += 1

        if workers <= 1 or len(jobs) <= 1:
            for entry, run in jobs:
                warm_one(entry, run)
            return
        with ThreadPoolExecutor(max_workers=workers,
                                thread_name_prefix="gpu-prewarm") as pool:
            for f in [pool.submit(warm_one, entry, run)
                      for entry, run in jobs]:
                f.result()

    # -- the service's own indices ------------------------------------------

    def search(self, name: str, body: Optional[dict] = None) -> dict:
        """``_search`` over one index of the service's own, through
        try_search → {"took", "timed_out", "_shards", "hits": {"total":
        {"value", "relation"}, "max_score", "hits": [{"_index", "_id",
        "_score", "_source"}]}}. Raises NotLowerable for a query or body
        outside the device path's subset (this service has no planner),
        and while a prewarm runs."""
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
        k = from_ + size
        if k <= 0 or k > MAX_K:
            # refused on every device alike, before it joins a train (the
            # reference hands such a request to its planner)
            raise NotLowerable(f"from + size = {k} is outside (0, "
                               f"{MAX_K}], the device path's window")
        res = self.try_search(idx, query, k=k)
        if res is None:
            raise NotLowerable("the kernel path is warming")
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
                if source is not False:
                    src = segs[row].stored_source[o]
                    if isinstance(source, (list, tuple)):
                        src = filter_source(src or {}, list(source))
                    hit["_source"] = src
                hits.append(hit)
        n_shards = idx.num_shards
        return {
            "took": int((time.perf_counter() - t0) * 1000),
            "timed_out": False,
            "_shards": {"total": n_shards, "successful": n_shards,
                        "skipped": 0, "failed": 0},
            "hits": {"total": {"value": res.total_hits,
                               "relation": res.total_relation},
                     "max_score": (float(res.scores[0]) if len(res.scores)
                                   else None),
                     "hits": hits},
        }

    def close(self) -> None:
        with self._compact_lock:
            self._compact_closed = True
            thread = self._compact_thread
        self._compact_wakeup.set()
        if thread is not None:
            thread.join(timeout=30.0)
        self.batcher.close()
        self.packs.invalidate_all()
