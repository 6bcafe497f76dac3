"""GPU serving path for ``_search``: resident packs + a micro-batched
kernel.

Counterpart of the reference's ``search/tpu_service.py`` for the main
path. A ``_search`` body goes:

  parse_query → lower_query → MicroBatcher (8 / 64 / 128 query buckets)
  → the train's routing (execute_flat_batch) → prepare_query_batch →
  the kernels on every device of the mesh → all-gather, totals sum and
  cross-shard top-k (shard_topk) → decode → hits response.

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
  MicroBatcher — coalesces concurrent queries per pack for a short
    window (or until the batch cap) and runs them as one launch.
  StageTimes — per-stage wall time of the serving path.
  GpuSearchService — ``try_search`` over a node's IndexService (the
    reference's TpuSearchService.try_search), and a bare service of its
    own: create_index / index / refresh / search.

A query outside the lowering subset raises ``NotLowerable`` from
``lower_query``; the planner path that answers it in the reference
comes with a later slice. Nothing here falls back: a fault of the
kernel path reaches the caller.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
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


def lower_query(query: dsl.QueryNode, mapper) -> FlatQuery:
    """QueryNode → FlatQuery. Raises NotLowerable for a query the merge
    kernel does not serve (the reference hands it to its planner)."""
    flat = _lower(query, mapper)
    if flat is None:
        raise NotLowerable(f"[{query.query_name()}] query does not lower "
                           f"to the merge kernel")
    return flat


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

    def invalidate(self, index_name: str) -> None:
        """Drop every pack of `index_name`, its deltas included, and
        release their charge."""
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
                self._build_locks.pop(key, None)
            self._epochs[index_name] = self._epochs.get(index_name, 0) + 1
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
                  k: int, packed_sort: bool = True) -> Dict[str, Any]:
    """Host prep + device dispatch of one micro-batch through the exact
    variants: bucketed batch (8/64/pow2), kernel k (128/1024/pow2), slot
    count (pow2 ≥ 8), window (≥ 8) and chunk length (pinned CHUNK_CAP),
    as the reference pins them. A compressed pack takes "compressed" or
    "compressed_exact", a raw one "packed" or "ref" (the raw merge).
    Returns the launch state for _finish_exact."""
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
    variant = choose_kernel_variant(pack.d_pad, batch.weights,
                                    enabled=packed_sort,
                                    compressed=compressed)
    vals, gids, totals = dist.distributed_search_raw(
        pack, batch, _kernel_k(k), resident.image.mesh,
        device_arrays=resident.image,
        t_window=max(_PRUNE_WINDOW, batch.window), materialize=False,
        variant=variant)
    return {"resident": resident, "n": len(flats), "k": k, "vals": vals,
            "gids": gids, "totals": totals, "variant": variant,
            "bucket": batch.starts.shape[1], "t_slots": batch.t_slots}


def _columnar_results(resident: ResidentPack, vals: np.ndarray,
                      gids: np.ndarray, totals: np.ndarray,
                      n_queries: int, relation_fn,
                      k_cap: Optional[int] = None) -> List[FlatQueryResult]:
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
            total_relation=relation_fn(qi)))
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
                                     for p in parts) else "eq"))


def _finish_exact(launch: Dict[str, Any]) -> List[FlatQueryResult]:
    vals = launch["vals"].cpu().numpy()
    gids = launch["gids"].cpu().numpy()
    totals = launch["totals"].cpu().numpy()
    return _columnar_results(launch["resident"], vals, gids, totals,
                             launch["n"], lambda qi: "eq",
                             k_cap=launch["k"])


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
                   packed_sort: bool = True) -> Dict[str, Any]:
    """One pruned launch over a raw pack: with full_slots=N the
    full-postings tier at N slots (its run totals are the exact scores:
    no rescore, exact totals); else the prefix tier (each term's first
    prefix_cap impact-sorted entries, the exact rescore on the device)."""
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
    packed = step(resident.image,
                  dist.pack_pruned_operands(batch, *ranges))
    return {"resident": resident, "flats": flats, "k": k,
            "packed": packed, "variant": variant}


def _finish_pruned(launch: Dict[str, Any]
                   ) -> Tuple[List[Optional[FlatQueryResult]], List[int]]:
    """Decode a pruned launch and check the WAND validity bound: a doc
    outside the candidates scores below cutoff + β (a cut candidate) or β
    (tail only); a query whose k-th score is below that, or that has
    fewer than k hits while its postings were cut, is invalid (None, its
    index listed) and escalates."""
    resident, flats, k = launch["resident"], launch["flats"], launch["k"]
    vals, gids, totals, cutoff, beta = dist.unpack_pruned(
        launch["packed"].cpu().numpy())
    decoded = _columnar_results(
        resident, vals, gids.astype(np.int64), totals, len(flats),
        lambda qi: "gte" if beta[qi] > 0.0 else "eq")
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
    return results, invalid


def _execute_pruned(resident: ResidentPack, flats: Sequence[FlatQuery],
                    k: int, **kw
                    ) -> Tuple[List[Optional[FlatQueryResult]], List[int]]:
    return _finish_pruned(_launch_pruned(resident, flats, k, **kw))


#: the routes a query of a train can take (execute_flat_batch's tiers)
TIERS = tuple(f"full-{b}" for b in FULL_SLOT_BUCKETS) + (
    "prefix-16k", "escalated-64k", "exact")


def execute_flat_batch(resident: ResidentPack, flats: Sequence[FlatQuery],
                       k: int, packed_sort: bool = True,
                       tiers: Optional[Dict[str, int]] = None,
                       variants: Optional[Dict[str, int]] = None,
                       shapes: Optional[Dict[Tuple[int, int, int], int]]
                       = None) -> List[FlatQueryResult]:
    """Run one micro-batch, the reference's r5 routing. On a raw pack an
    OR query (min_count 1) of at most PRUNE_MAX_TERMS terms with k ≤
    PRUNE_MAX_K takes the smallest full-postings tier that holds its
    postings (a tier of fewer than 16 queries joins the next wider one
    when that one launches anyway), else the prefix tier at PREFIX_CAP2;
    queries whose validity bound fails escalate to PREFIX_CAP3, then to
    the exact launch, which also takes every other query (and every query
    of a compressed pack). `tiers` counts the queries each tier of TIERS
    took (an escalated query in each tier it passed), `variants` the
    exact launches by variant and `shapes` by (batch bucket, slots,
    kernel k)."""
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
    out: List[Optional[FlatQueryResult]] = [None] * len(flats)
    taken: Dict[str, int] = {}
    escalate: List[int] = []
    for b, idxs in full_groups.items():
        if not idxs:
            continue
        results, invalid = _execute_pruned(
            resident, [flats[i] for i in idxs], k, full_slots=b,
            packed_sort=packed_sort)
        for j, i in enumerate(idxs):
            out[i] = results[j]
        taken[f"full-{b}"] = len(idxs)
        # full-postings runs are exact (beta 0, never invalid); should
        # that ever break, escalate rather than fail the train
        escalate.extend(idxs[j] for j in invalid)
    if hot_idx:
        results, invalid = _execute_pruned(
            resident, [flats[i] for i in hot_idx], k,
            prefix_cap=PREFIX_CAP2, packed_sort=packed_sort)
        for j, i in enumerate(hot_idx):
            out[i] = results[j]
        taken["prefix-16k"] = len(hot_idx)
        escalate.extend(hot_idx[j] for j in invalid)
    tier3_idx: List[int] = []
    if escalate:
        results, invalid = _execute_pruned(
            resident, [flats[i] for i in escalate], k,
            prefix_cap=PREFIX_CAP3, packed_sort=packed_sort)
        for j, i in enumerate(escalate):
            out[i] = results[j]
        taken["escalated-64k"] = len(escalate)
        tier3_idx = [escalate[j] for j in invalid]
    for idxs in (exact_idx, tier3_idx):
        if not idxs:
            continue
        launch = _launch_exact(resident, [flats[i] for i in idxs], k,
                               packed_sort=packed_sort)
        if variants is not None:
            v = launch["variant"]
            variants[v] = variants.get(v, 0) + 1
        if shapes is not None:
            shape = (launch["bucket"], launch["t_slots"], _kernel_k(k))
            shapes[shape] = shapes.get(shape, 0) + 1
        results = _finish_exact(launch)
        for j, i in enumerate(idxs):
            out[i] = results[j]
        taken["exact"] = taken.get("exact", 0) + len(idxs)
    if tiers is not None:
        for name, n in taken.items():
            tiers[name] = tiers.get(name, 0) + n
    return out  # type: ignore[return-value]


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

    def retire(self, resident: ResidentPack) -> Optional[threading.Thread]:
        """Refuse new work for `resident`; its queue drains what it holds
        and its thread ends. → that thread (None without a queue): until
        it ends it holds `resident` and so its device arrays."""
        with self._lock:
            resident.retired = True
            queue = self._queues.pop(id(resident), None)
        if queue is None:
            return None
        queue.close()
        return queue.thread

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
    """The kernel path of ``_search`` over a mesh (``make_mesh()``: every
    visible GPU on the shards axis; ``device=``: a (1, 1) mesh of that
    device, ``device="cpu"`` the plain path): ``try_search`` over a
    node's IndexService, through the IndexPackCache (charged to
    `breaker`, the node's ``hbm`` breaker) and the micro-batcher; and
    create_index / index / refresh / search / delete_index over indices
    of its own, whose packs charge the same breaker."""

    def __init__(self, device=None, window_s: float = 0.005,
                 max_batch: int = 128, batch_timeout_s: float = 300.0,
                 breaker=None, mesh: Optional[Mesh] = None,
                 packed_sort: bool = True, compressed_pack: bool = True,
                 delta: Optional[Dict[str, Any]] = None):
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
        self.batcher = MicroBatcher(self._execute, window_s=window_s,
                                    max_batch=max_batch)
        self._breaker = breaker
        self.packs = IndexPackCache(self.mesh, breaker, self.kernel_config)
        self.packs.on_evict = self.batcher.retire
        self.stages = StageTimes()
        self.served = 0
        #: exact launches by kernel variant (compressed: the fused merge
        #: kernel; compressed_exact: the exact merge, for unpackable
        #: weights; ref / packed: the raw merge)
        self.variant_launches: Dict[str, int] = {}
        self.launch_shapes: Dict[Tuple[int, int, int], int] = {}
        #: queries each tier of TIERS took (an escalated query in each it
        #: passed) and results whose total's relation is "gte"
        self.tier_queries: Dict[str, int] = {}
        self.gte_results = 0
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
        """The pack cache's stats, the delta chains' totals and
        lifecycle counters, and the stage times."""
        cache = self.packs.stats()
        chains = cache["deltas"].values()
        return {"served": self.served, "pack_cache": cache,
                "deltas": dict(dataclasses.asdict(self.delta_stats),
                               enabled=self.packs.delta_enabled,
                               packs=sum(c["packs"] for c in chains),
                               bytes=sum(c["bytes"] for c in chains)),
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

    def _drop_packs(self, idx: _Index) -> List[threading.Thread]:
        """Retire and uncharge the index's packs → their batcher threads."""
        threads = []
        for resident in idx.packs.values():
            thread = self.batcher.retire(resident)
            if thread is not None:
                threads.append(thread)
            if self._breaker is not None:
                self._breaker.release(resident.hbm_bytes)
        idx.packs.clear()
        return threads

    def delete_index(self, name: str) -> None:
        """Drop an index of the service's own, its resident packs and
        their breaker charge. Returns once the packs' batcher threads
        have ended, so that their device arrays are freed."""
        idx = self._index(name)
        with idx.lock:
            threads = self._drop_packs(idx)
        with self._lock:
            self._indices.pop(name, None)
        for thread in threads:
            if thread is not threading.current_thread():
                thread.join()

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
            pack = dist.build_stacked_pack(
                segments, field, row_groups=groups,
                pad_shards_to=_pad_rows(len(segments), self.mesh))
            entry = place_pack(
                pack, self.mesh, origin, segments, breaker=self._breaker,
                compressed_pack=self.kernel_config["compressed_pack"])
            idx.packs[field] = entry
            return entry

    # -- search ------------------------------------------------------------

    def _execute(self, resident: ResidentPack, flats: Sequence[FlatQuery],
                 k: int) -> List[FlatQueryResult]:
        t0 = time.perf_counter()
        tiers: Dict[str, int] = {}
        variants: Dict[str, int] = {}
        shapes: Dict[Tuple[int, int, int], int] = {}
        out = execute_flat_batch(
            resident, flats, k,
            packed_sort=self.kernel_config["packed_sort"], tiers=tiers,
            variants=variants, shapes=shapes)
        with self._lock:
            for mine, total in ((tiers, self.tier_queries),
                                (variants, self.variant_launches),
                                (shapes, self.launch_shapes)):
                for key, n in mine.items():
                    total[key] = total.get(key, 0) + n
            self.gte_results += sum(r.total_relation == "gte" for r in out)
        self.stages.add("train", time.perf_counter() - t0)
        return out

    # -- the node's path (the reference's TpuSearchService.try_search) -----

    def try_search(self, index_service, query: dsl.QueryNode, *,
                   k: int) -> FlatQueryResult:
        """The kernel result of `query` over `index_service` (k = from +
        size, the window the coordinator needs, which checks it against
        MAX_K). Raises lower_query's NotLowerable where the reference
        hands the query to its planner; a fault of the kernel path (or a
        batch that outlives the wait) reaches the caller."""
        if k <= 0 or k > MAX_K:
            raise ValueError(f"k = {k} is outside (0, {MAX_K}]")
        t0 = time.perf_counter()
        try:
            flat = lower_query(query, index_service.mapper)
        except NotLowerable:
            self.stages.add("lower", time.perf_counter() - t0)
            raise
        while True:
            chain = self.packs.get_chain(index_service, flat.field)
            t1 = time.perf_counter()
            if chain is None:
                # the field has postings nowhere: zero hits, kernel-free
                self.stages.add("lower", t1 - t0)
                with self._lock:
                    self.served += 1
                return FlatQueryResult.empty()
            # the deltas are operands of the same lowered query: each
            # batches in its own queue, the columns merge on the host
            futures = [self.batcher.submit(p, flat, k)
                       for p in chain.parts]
            if all(f is not None for f in futures):
                break
            # a refresh, fold or delete retired a pack of the chain
            # after the lookup: resolve the whole chain again
        self.stages.add("lower", t1 - t0)
        # one deadline shared by the parts
        deadline = t1 + self.batch_timeout_s
        parts = [f.result(timeout=max(0.01, deadline - time.perf_counter()))
                 for f in futures]
        result = (parts[0] if len(parts) == 1
                  else _union_results(parts, chain, k))
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
        k = from_ + size
        if k <= 0 or k > MAX_K:
            # refused on every device alike, before it joins a train (the
            # reference hands such a request to its planner)
            raise NotLowerable(f"from + size = {k} is outside (0, "
                               f"{MAX_K}], the device path's window")
        flat = lower_query(query, idx.mapper)
        while True:
            resident = self.resident(name, flat.field)
            t1 = time.perf_counter()
            if resident is None:
                res = FlatQueryResult.empty()
                break
            future = self.batcher.submit(resident, flat, k)
            if future is not None:
                self.stages.add("lower", t1 - t0)
                res = future.result(timeout=self.batch_timeout_s)
                self.stages.add("batch_wait", time.perf_counter() - t1)
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
        for idx in list(self._indices.values()):
            with idx.lock:
                self._drop_packs(idx)
