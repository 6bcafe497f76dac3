"""Stacked-shard BM25 search over a device mesh.

Counterpart of the reference's ``parallel/distributed.py`` for the
compressed main path. A pack's shards are laid over the mesh's shards
axis and replicated down its data axis (``device_put_compressed``). One
step (``make_distributed_search``) scores, on each device, its shards ×
its data row's slice of the batch through ``sparse.sorted_merge_topk``
(one call for all its (shard, query) rows), then each data row gathers
its columns' lists in column order, sums their totals and takes the
cross-shard top-k: the reference's ``_local_body`` + ``tail``
(all_gather, psum, top-k). On CUDA devices the gather and the sum are
NCCL collectives of one process over every device of the row
(``torch.cuda.nccl``), as the reference is one SPMD program over its
local chips; on CPU entries they are ``torch.cat`` and a sum. One device
is a (1, 1) mesh, whose step ``make_local_search`` returns as the
reference's one-device step. The device bodies of a step run one after
another; only the collectives are serialized between steps.

  StackedShardPack — S shards' postings for one field, padded to common
    shapes, with group-level statistics (one group per index shard).
  CompressedStreams — the compressed resident image: u16 (or u8-delta)
    doc stream, u16 value codes, u16 ranks, block-max codes, residual
    tables.
  MeshImage — the image placed over a mesh: the compressed streams, or a
    raw pack (``device_put_pack``: the doc-sorted int32 docs and f32
    impacts, the live masks and the impact-sorted copy of
    ``build_impact_sorted``).
  QueryBatch — per-(shard, query, slot) chunk arrays.

A raw pack also serves the block-max pruned tiers (``make_pruned_search``,
the reference's r5 routing): phase A merges each query's impact-sorted
postings prefixes (or its full postings, in the no-rescore tier) over
groups of at most FUSE_ROWS rows into candidates (the
``pruned_candidates`` kernel), the tail gathers them in column order and
takes the global top-c; phase B rescores every candidate exactly by a
binary search of each term's doc-sorted postings and orders them by
(−score, gid) (the ``pruned_rescore`` kernel).

A dense_vector field's shards serve the exact kNN step
(``make_distributed_knn``, ``distributed_knn``): each column scores its
shards' vectors with the ``knn_scores`` kernel, takes its local top-k,
and the row gathers and merges as the BM25 step's tail does.

Global doc identity: shard s, local ordinal d → s * (d_pad + 1) + d,
decoded host-side by ``decode_refs``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.index.pack import LANE, _pad_to
from elasticsearch_tpu_torch.index.segment import Segment
from elasticsearch_tpu_torch.ops import knn_kernel, sparse
from elasticsearch_tpu_torch.parallel.device import (device_context,
                                                     resolve_device)
from elasticsearch_tpu_torch.parallel.mesh import (DATA_AXIS, SHARD_AXIS,
                                                   Mesh)

NEG_INF = float("-inf")
CHUNK_CAP = 4096  # max postings chunk per slot; flat arrays pad by this much
FUSE_ROWS = 8     # max pack rows fused into one phase-A group
#: phase-A element budget per group: the group size derives from it, so a
#: wide-slot, big-batch launch fuses fewer rows
FUSE_ELEM_BUDGET = 192 * 1024 * 1024


def fuse_group_rows(batch_b: int, t_slots: int, max_len: int) -> int:
    """Rows of one phase-A group for a batch of batch_b queries."""
    per_row = batch_b * t_slots * max_len
    return max(1, min(FUSE_ROWS, FUSE_ELEM_BUDGET // max(per_row, 1)))


@dataclasses.dataclass
class StackedShardPack:
    """S shards' postings for one field, stacked and padded to common
    shapes (host arrays): flat_docs int32[S, P_pad] (pad = d_pad),
    flat_impact f32[S, P_pad] eager BM25 impacts, live bool[S, D_pad].
    Per shard: vocab, row starts, doc ids; statistics per group."""

    field: str
    num_shards: int
    d_pad: int
    p_pad: int
    flat_docs: np.ndarray
    flat_impact: np.ndarray
    flat_tfs: np.ndarray
    live: np.ndarray
    vocabs: List[Dict[str, int]]
    row_starts: List[np.ndarray]
    shard_num_docs: List[int]
    shard_doc_ids: List[List[str]]
    total_doc_count: int
    avgdl: float
    df: Dict[str, int]
    k1: float = 1.2
    b: float = 0.75
    row_group: Optional[List[int]] = None
    group_df: Optional[List[Dict[str, int]]] = None
    group_doc_count: Optional[List[int]] = None

    def nbytes_device(self) -> int:
        """Bytes of the doc-sorted raw image: docs, impacts, live masks."""
        return (self.flat_docs.nbytes + self.flat_impact.nbytes
                + self.live.nbytes)


def build_stacked_pack(segments: Sequence[Segment], field: str,
                       live_docs: Optional[Sequence[Optional[np.ndarray]]] = None,
                       k1: float = 1.2, b: float = 0.75,
                       row_groups: Optional[Sequence[int]] = None,
                       pad_shards_to: Optional[int] = None,
                       pad_docs_to: Optional[int] = None,
                       pad_postings_to: Optional[int] = None
                       ) -> StackedShardPack:
    """Each segment is one pack row. Shapes pad to the max across rows +
    CHUNK_CAP slack so chunk windows never run past the arrays.
    row_groups[i] assigns segment i to a statistics group (one group per
    index shard → per-shard idf/avgdl); omitted → one index-level group.
    pad_shards_to appends empty rows up to that many (a multiple of a
    mesh's shards axis); pad_docs_to / pad_postings_to force the doc and
    posting axes to at least those sizes (the delta packs' buckets)."""
    from elasticsearch_tpu_torch.index.pack import build_field_pack

    s_real = len(segments)
    s = pad_shards_to or s_real
    if s < s_real:
        raise ValueError(
            f"pad_shards_to={s} < {s_real} segments (would drop shards)")
    d_pad = max(_pad_to(seg.num_docs) for seg in segments)
    if pad_docs_to is not None:
        if pad_docs_to < d_pad:
            raise ValueError(f"pad_docs_to={pad_docs_to} < d_pad={d_pad}")
        d_pad = pad_docs_to
    packs = [build_field_pack(seg, field, d_pad) for seg in segments]
    p_pad = max((p.flat_docs.shape[0] for p in packs if p is not None),
                default=LANE) + CHUNK_CAP
    if pad_postings_to is not None:
        if pad_postings_to < p_pad:
            raise ValueError(
                f"pad_postings_to={pad_postings_to} < p_pad={p_pad}")
        p_pad = pad_postings_to
    flat_docs = np.full((s, p_pad), d_pad, dtype=np.int32)
    flat_tfs = np.zeros((s, p_pad), dtype=np.int32)
    norms = np.zeros((s, d_pad), dtype=np.uint8)
    live = np.zeros((s, d_pad), dtype=bool)
    vocabs: List[Dict[str, int]] = []
    row_starts: List[np.ndarray] = []
    shard_num_docs: List[int] = []
    shard_doc_ids: List[List[str]] = []
    groups = list(row_groups) if row_groups is not None else [0] * s_real
    if len(groups) != s_real:
        raise ValueError(f"row_groups has {len(groups)} entries for "
                         f"{s_real} segments")
    n_groups = (max(groups) + 1) if groups else 1
    total_docs = 0
    sum_ttf = 0
    df: Dict[str, int] = {}
    group_df: List[Dict[str, int]] = [dict() for _ in range(n_groups)]
    group_doc_count = [0] * n_groups
    group_sum_ttf = [0] * n_groups
    for i, seg in enumerate(segments):
        fp = packs[i]
        g = groups[i]
        if fp is not None:
            n = fp.flat_docs.shape[0]
            flat_docs[i, :n] = fp.flat_docs
            flat_tfs[i, :n] = fp.flat_tfs
            norms[i] = fp.norms_u8
            vocabs.append(fp.vocab)
            row_starts.append(fp.row_start)
            for term, row in fp.vocab.items():
                dfv = int(fp.doc_freq[row])
                df[term] = df.get(term, 0) + dfv
                group_df[g][term] = group_df[g].get(term, 0) + dfv
        else:
            vocabs.append({})
            row_starts.append(np.zeros(1, dtype=np.int64))
        mask = (live_docs[i] if live_docs is not None
                and live_docs[i] is not None
                else np.ones(seg.num_docs, dtype=bool))
        live[i, : seg.num_docs] = mask
        shard_num_docs.append(seg.num_docs)
        shard_doc_ids.append(seg.doc_ids)
        st = seg.field_stats.get(field)
        if st:
            total_docs += st.doc_count
            sum_ttf += st.sum_total_term_freq
            group_doc_count[g] += st.doc_count
            group_sum_ttf[g] += st.sum_total_term_freq
    for _ in range(s_real, s):
        vocabs.append({})
        row_starts.append(np.zeros(1, dtype=np.int64))
        shard_num_docs.append(0)
        shard_doc_ids.append([])
        groups.append(0)
    avgdl = (sum_ttf / total_docs) if total_docs else 1.0
    group_avgdl = [(group_sum_ttf[g] / group_doc_count[g])
                   if group_doc_count[g] else 1.0 for g in range(n_groups)]
    flat_impact = np.zeros((s, p_pad), dtype=np.float32)
    for i in range(s_real):
        flat_impact[i] = sparse.eager_impacts(
            flat_docs[i], flat_tfs[i], norms[i], k1, b,
            group_avgdl[groups[i]])
        # tombstones bake into impacts: a dead doc's contributions all go
        # to 0, so the kernel's total>0 mask drops it
        safe = np.minimum(flat_docs[i], d_pad - 1)
        flat_impact[i] *= live[i][safe]
    return StackedShardPack(field, s, d_pad, p_pad, flat_docs, flat_impact,
                            flat_tfs, live, vocabs, row_starts,
                            shard_num_docs, shard_doc_ids, total_docs, avgdl,
                            df, k1, b, row_group=groups, group_df=group_df,
                            group_doc_count=group_doc_count)


def _shape_bucket(n: int, floor: int) -> int:
    """The smallest power-of-two multiple of `floor` that covers n."""
    b = max(floor, 1)
    while b < n:
        b *= 2
    return b


def build_delta_pack(segments: Sequence[Segment], field: str,
                     live_docs: Optional[Sequence[Optional[np.ndarray]]] = None,
                     k1: float = 1.2, b: float = 0.75,
                     pad_shards_to: Optional[int] = None,
                     row_groups: Optional[Sequence[int]] = None
                     ) -> StackedShardPack:
    """A small pack of the streaming delta chain: build_stacked_pack's
    format with two contracts on top (the reference's build_delta_pack).

    1. The doc axis pads up to a power-of-two multiple of LANE and the
       posting axis to one of 2·CHUNK_CAP, so that a stream of small
       deltas keeps to a few shapes.
    2. The impacts bake group_avgdl[row_group[i]] at build time: a delta
       scores with the statistics of its own rows only (one group per
       (delta, shard)). A full rebuild equals base ∪ deltas bit for bit
       only when its rows are grouped the same way."""
    from elasticsearch_tpu_torch.index.pack import build_field_pack

    d_raw = max(_pad_to(seg.num_docs) for seg in segments)
    probe = [build_field_pack(seg, field, d_raw) for seg in segments]
    p_raw = max((p.flat_docs.shape[0] for p in probe if p is not None),
                default=LANE) + CHUNK_CAP
    return build_stacked_pack(
        segments, field, live_docs=live_docs, k1=k1, b=b,
        pad_shards_to=pad_shards_to, row_groups=row_groups,
        pad_docs_to=_shape_bucket(d_raw, LANE),
        pad_postings_to=_shape_bucket(p_raw, 2 * CHUNK_CAP))


@dataclasses.dataclass
class CompressedStreams:
    """Per-shard compressed resident streams stacked to common widths.
    Delta-doc mode: the u8 delta stream (flat_docs8) plus per-block u16
    bases (doc_bases) replace the u16 doc stream on the device."""

    flat_docs16: np.ndarray   # u16[S, P_pad] doc ids (pad = d_pad)
    flat_code16: np.ndarray   # u16[S, P_pad] monotone impact value codes
    flat_rank16: np.ndarray   # u16[S, P_pad] per-term residual ranks
    block_max: np.ndarray     # u16[S, NBp] block-max codes (+1 slack)
    res_vals: np.ndarray      # f32[S, RC_pad] residual tables
    res_row_starts: List[np.ndarray]  # per shard: i64[n_rows+1]
    flat_docs8: Optional[np.ndarray] = None  # u8[S, P_pad] block deltas
    doc_bases: Optional[np.ndarray] = None   # u16[S, NBD] block min docs

    @property
    def delta(self) -> bool:
        return self.doc_bases is not None

    def nbytes_device(self) -> int:
        """Exactly the bytes device_put_compressed places."""
        doc_stream = (self.flat_docs8.nbytes + self.doc_bases.nbytes
                      if self.delta else self.flat_docs16.nbytes)
        return (doc_stream + self.flat_code16.nbytes
                + self.flat_rank16.nbytes + self.block_max.nbytes
                + self.res_vals.nbytes)


def compress_pack_reason(pack: StackedShardPack) -> Optional[str]:
    """First reason any shard can NOT take the compressed format."""
    for si in range(pack.num_shards):
        reason = sparse.compress_reason(
            pack.flat_docs[si], pack.flat_impact[si],
            pack.row_starts[si], pack.d_pad)
        if reason is not None:
            return f"shard {si}: {reason}"
    return None


def delta_pack_reason(pack: StackedShardPack) -> Optional[str]:
    """First reason any shard's doc stream can NOT take the u8 delta
    encoding (the gate is per pack: one uniform device format)."""
    for si in range(pack.num_shards):
        reason = sparse.delta_doc_reason(pack.flat_docs[si],
                                         pack.row_starts[si])
        if reason is not None:
            return f"shard {si}: {reason}"
    return None


def build_compressed_streams(pack: StackedShardPack,
                             delta: Optional[bool] = None
                             ) -> CompressedStreams:
    """compress_flat per shard row, stacked. delta=None auto-detects the
    u8 delta doc stream; True forces it, False keeps u16 docs."""
    s, p_pad = pack.flat_docs.shape
    nbp = (p_pad + sparse.COMPRESSED_BLOCK - 1) // sparse.COMPRESSED_BLOCK + 1
    if delta is None:
        delta = delta_pack_reason(pack) is None
    docs16 = np.full((s, p_pad), min(pack.d_pad, (1 << 16) - 1),
                     dtype=np.uint16)
    code16 = np.zeros((s, p_pad), dtype=np.uint16)
    rank16 = np.zeros((s, p_pad), dtype=np.uint16)
    block_max = np.zeros((s, nbp), dtype=np.uint16)
    # the kernel reads max_len // 128 + 2 bases from a slot's cursor: +2
    # slack past the last real block keeps that window inside the column
    nbd = ((p_pad + sparse.COMPRESSED_BLOCK - 1) // sparse.COMPRESSED_BLOCK
           + 2)
    docs8 = np.zeros((s, p_pad), dtype=np.uint8) if delta else None
    doc_bases = np.zeros((s, nbd), dtype=np.uint16) if delta else None
    res_parts: List[np.ndarray] = []
    res_row_starts: List[np.ndarray] = []
    for si in range(s):
        rstart = pack.row_starts[si]
        d16, c16, r16, bm, rv, rrs = sparse.compress_flat(
            pack.flat_docs[si], pack.flat_impact[si], rstart, pack.d_pad)
        docs16[si], code16[si], rank16[si] = d16, c16, r16
        block_max[si, :bm.size] = bm
        if delta:
            d8, db = sparse.delta_encode_docs(
                pack.flat_docs[si], rstart, nbd)
            docs8[si], doc_bases[si] = d8[:p_pad], db
        res_parts.append(rv)
        res_row_starts.append(rrs)
    rc_pad = _pad_to(max([rv.size for rv in res_parts] + [1]))
    res_vals = np.zeros((s, rc_pad), dtype=np.float32)
    for si, rv in enumerate(res_parts):
        res_vals[si, :rv.size] = rv
    return CompressedStreams(docs16, code16, rank16, block_max, res_vals,
                             res_row_starts, flat_docs8=docs8,
                             doc_bases=doc_bases)


@dataclasses.dataclass
class MeshImage:
    """A resident image laid over a mesh: parts[d][c] holds shards
    [c·S_l, (c+1)·S_l) of every array on device grid[d][c] (the
    reference's P(SHARD_AXIS, None): split over the shards axis,
    replicated down the data axis). A compressed image's part is its 5
    streams (6 in delta mode); a raw one's (raw=True) its 5 arrays
    (device_put_pack)."""

    mesh: Mesh
    parts: Tuple[Tuple[Tuple[torch.Tensor, ...], ...], ...]
    raw: bool = False

    @property
    def delta(self) -> bool:
        return not self.raw and len(self.parts[0][0]) == 6

    def row_arrays(self) -> Tuple[torch.Tensor, ...]:
        """Every tensor of one data row: the image once."""
        return tuple(t for part in self.parts[0] for t in part)


def device_put_compressed(streams: CompressedStreams,
                          mesh: Mesh) -> MeshImage:
    """Place the compressed image over `mesh` (the pack's shard count must
    be a multiple of the shards axis: build the pack with
    pad_shards_to). Each part is 5 tensors (docs16, code16, rank16,
    block_max, res_vals), or 6 in delta mode (docs8 in the doc slot,
    doc_bases appended): the tuple length is the format."""
    if streams.delta:
        arrays = (streams.flat_docs8, streams.flat_code16,
                  streams.flat_rank16, streams.block_max,
                  streams.res_vals, streams.doc_bases)
    else:
        arrays = (streams.flat_docs16, streams.flat_code16,
                  streams.flat_rank16, streams.block_max, streams.res_vals)
    return _place(arrays, mesh)


def build_impact_sorted(pack: StackedShardPack
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-term impact-DESCENDING copies of the postings arrays (the
    block-max layout): the pruned tiers read each term's highest-impact
    prefix, and what they skip is bounded by the impact at the cut. Ties
    order by doc id. Returns host (docs, impacts) [S, P_pad]."""
    s, p_pad = pack.flat_docs.shape
    imp_docs = pack.flat_docs.copy()
    imp_impacts = pack.flat_impact.copy()
    for si in range(s):
        rstart = pack.row_starts[si]
        total = int(rstart[-1])
        if total <= 1:
            continue
        # one lexsort per row: term id first (keeps the rows), then
        # -impact, then doc (deterministic ties)
        term_ids = np.repeat(np.arange(len(rstart) - 1, dtype=np.int64),
                             np.diff(rstart))
        seg_doc = pack.flat_docs[si, :total]
        seg_imp = pack.flat_impact[si, :total]
        order = np.lexsort((seg_doc, -seg_imp, term_ids))
        imp_docs[si, :total] = seg_doc[order]
        imp_impacts[si, :total] = seg_imp[order]
    return imp_docs, imp_impacts


def raw_image_nbytes(pack: StackedShardPack, imp_docs: np.ndarray,
                     imp_impacts: np.ndarray) -> int:
    """Bytes of a raw image, as the reference's cache charges them: the
    doc-sorted pack and its impact-sorted copy."""
    return pack.nbytes_device() + imp_docs.nbytes + imp_impacts.nbytes


def device_put_pack(pack: StackedShardPack, mesh: Mesh,
                    imp_docs: np.ndarray, imp_impacts: np.ndarray
                    ) -> MeshImage:
    """Place a raw pack over `mesh`: each part holds (flat_docs int32,
    flat_impact f32, live bool, imp_docs int32, imp_impacts f32), the
    doc-sorted pack and its impact-sorted copy, raw_image_nbytes in
    all."""
    return _place((pack.flat_docs, pack.flat_impact, pack.live, imp_docs,
                   imp_impacts), mesh, raw=True)


def _place(arrays, mesh: Mesh, raw: bool = False) -> MeshImage:
    n_sh = mesh.shape[SHARD_AXIS]
    s = arrays[0].shape[0]
    if s % n_sh:
        raise ValueError(f"{s} pack shards do not split over a shards "
                         f"axis of {n_sh}")
    s_l = s // n_sh
    host = [[torch.from_numpy(np.ascontiguousarray(a[c * s_l:(c + 1) * s_l]))
             for a in arrays] for c in range(n_sh)]
    parts = tuple(tuple(tuple(t.to(dev) for t in host[c])
                        for c, dev in enumerate(row))
                  for row in mesh.grid)
    return MeshImage(mesh, parts, raw=raw)


@dataclasses.dataclass
class QueryBatch:
    """Chunked slot arrays for B queries × S shards (plan_slots over all
    (shard, query) rows, so the (T, L_c) bucket is shared)."""

    starts: np.ndarray     # int32[S, B, T] relative to each shard's base
    lengths: np.ndarray    # int32[S, B, T]
    weights: np.ndarray    # f32[S, B, T]
    min_count: np.ndarray  # int32[B]
    max_len: int
    t_slots: int
    window: int            # max same-doc entries per row (= max terms)
    need_counts: bool      # any query has min_count > 1 (msm/AND)
    # the pruned tiers only: per (shard, query) bound on the score a doc
    # can collect from truncated postings tails, Σ_t w_t · impact_t[cap]
    tail_bounds: Optional[np.ndarray] = None  # f32[S, B]
    truncated: bool = False  # any slot shorter than its full postings row
    res_starts: Optional[np.ndarray] = None   # int32[S, B, T]
    res_lens: Optional[np.ndarray] = None     # int32[S, B, T]
    slot_terms: Optional[np.ndarray] = None   # int32[S, B, T]


def term_weights(pack: StackedShardPack, si: int, terms: Sequence[str],
                 boost: float = 1.0) -> List[float]:
    """idf·(k1+1)·boost per term for pack row si, with the row's
    statistics group."""
    if pack.row_group is not None and pack.group_df is not None:
        g = pack.row_group[si]
        g_df = pack.group_df[g]
        g_docs = pack.group_doc_count[g]
    else:
        g_df = pack.df
        g_docs = pack.total_doc_count
    out = []
    for term in terms:
        dfv = g_df.get(term, 0)
        w = 0.0
        if dfv > 0:
            idf = math.log(1.0 + (g_docs - dfv + 0.5) / (dfv + 0.5))
            w = boost * idf * (pack.k1 + 1.0)
        out.append(w)
    return out


def prepare_query_batch(pack: StackedShardPack,
                        queries: Sequence[Sequence[str]],
                        boosts: Optional[Sequence[float]] = None,
                        min_counts: Optional[Sequence[int]] = None,
                        pad_batch_to: Optional[int] = None,
                        pad_max_len: Optional[int] = None,
                        compressed: Optional[CompressedStreams] = None,
                        prefix_cap: Optional[int] = None,
                        imp_impacts: Optional[np.ndarray] = None,
                        pad_t_slots: Optional[int] = None
                        ) -> QueryBatch:
    """Host-side planning: vocab lookups, group-level idf, chunk
    splitting. min_counts[i] = required matched clauses. compressed: the
    pack's streams, to fill the residual extents and slot→term ids.
    prefix_cap (the pruned tiers): each term's slots stop at its first
    prefix_cap impact-sorted entries, valid only against the
    impact-sorted copy, whose host imp_impacts give the tail bound at the
    cut. pad_t_slots pads the slot count up to that many."""
    if prefix_cap is not None and imp_impacts is None:
        raise ValueError("prefix_cap requires imp_impacts")
    b_real = len(queries)
    b = pad_batch_to or b_real
    if b < b_real:
        raise ValueError(
            f"pad_batch_to={b} < {b_real} queries (would drop queries)")
    s = pack.num_shards
    rows: List[List[Tuple[int, int, float, int]]] = []
    mins: List[int] = []
    tail_bounds = (np.zeros((s, b), dtype=np.float32)
                   if prefix_cap is not None else None)
    truncated = False
    for si in range(s):
        vocab = pack.vocabs[si]
        rstart = pack.row_starts[si]
        for qi in range(b):
            if qi >= b_real:
                rows.append([])
                mins.append(1)
                continue
            terms = queries[qi]
            boost = boosts[qi] if boosts is not None else 1.0
            weights_r = term_weights(pack, si, terms, boost)
            row = []
            for tid, term in enumerate(terms):
                w = weights_r[tid]
                r = vocab.get(term, -1)
                if r >= 0:
                    st = int(rstart[r])
                    ln = int(rstart[r + 1] - rstart[r])
                else:
                    st, ln = 0, 0
                if prefix_cap is not None and ln > prefix_cap:
                    # the skipped entries' impacts are at most the one at
                    # the cut (impact-descending layout)
                    tail_bounds[si, qi] += w * float(
                        imp_impacts[si, st + prefix_cap])
                    ln = prefix_cap
                    truncated = True
                row.append((st, ln, w, tid))
            rows.append(row)
            mins.append(int(min_counts[qi]) if min_counts is not None else 1)
    plan = sparse.plan_slots(rows, mins, chunk_cap=CHUNK_CAP)
    t_slots = plan.t_slots
    starts_a, lengths_a, weights_a = plan.starts, plan.lengths, plan.weights
    if pad_t_slots is not None and pad_t_slots > t_slots:
        pad = ((0, 0), (0, pad_t_slots - t_slots))
        starts_a = np.pad(starts_a, pad)
        lengths_a = np.pad(lengths_a, pad)
        weights_a = np.pad(weights_a, pad)
        t_slots = pad_t_slots
    max_len = plan.max_len
    if pad_max_len is not None and pad_max_len > max_len:
        max_len = pad_max_len
    shape3 = (s, b, t_slots)
    starts3 = starts_a.reshape(shape3)
    lengths3 = lengths_a.reshape(shape3)
    mc = plan.min_count.reshape(s, b)[0].copy()
    res_starts3 = res_lens3 = slot_terms3 = None
    if compressed is not None:
        # per-slot term row (a chunk's start lies inside its term's row)
        # → residual extents + term group ids; pad slots resolve to row 0
        res_starts3 = np.zeros(shape3, dtype=np.int32)
        res_lens3 = np.zeros(shape3, dtype=np.int32)
        slot_terms3 = np.zeros(shape3, dtype=np.int32)
        for si in range(s):
            rstart = pack.row_starts[si]
            n_rows = rstart.size - 1
            if n_rows <= 0:
                continue
            rr = np.searchsorted(rstart, starts3[si], side="right") - 1
            rr = np.clip(rr, 0, n_rows - 1)
            rrs = compressed.res_row_starts[si]
            slot_terms3[si] = rr.astype(np.int32)
            res_starts3[si] = rrs[rr].astype(np.int32)
            res_lens3[si] = (rrs[rr + 1] - rrs[rr]).astype(np.int32)
            res_lens3[si][lengths3[si] == 0] = 0
    return QueryBatch(starts3, lengths3, weights_a.reshape(shape3), mc,
                      max_len, t_slots, plan.window, bool((mc > 1).any()),
                      tail_bounds=tail_bounds, truncated=truncated,
                      res_starts=res_starts3, res_lens=res_lens3,
                      slot_terms=slot_terms3)


# ---------------------------------------------------------------------------
# the search step
# ---------------------------------------------------------------------------

def _local_body(flat_docs, flat_impact, starts, lengths, weights, min_count,
                *, max_len: int, d_pad: int, p_pad: int, k: int,
                t_window: int, with_counts: bool, variant: str, comp,
                shard_offset: int = 0):
    """Score S shards × B queries in one sorted_merge_topk call → per
    query (vals [B, S·k'], gids int64 [B, S·k'], totals int32 [B]).

    flat_docs/flat_impact [S, P_pad]; starts/lengths/weights [S, B, T]
    (shard-relative starts); comp = (flat_rank, block_max, res_vals,
    res_starts, res_lens, slot_terms, doc_bases or None), flattened here
    with per-shard offsets, or None for a raw pack. With doc_bases (delta
    doc stream) each slot's base cursor (dbs, dlo) derives from its
    shard-relative start."""
    dev = flat_docs.device
    s_l, b, t = starts.shape
    base = torch.arange(s_l, dtype=torch.int32, device=dev) * p_pad
    starts_abs = starts + base[:, None, None]
    r = s_l * b
    extra = {}
    if comp is not None:
        extra = _compressed_operands(comp, starts, r, t)
    vals, docs, totals = sparse.sorted_merge_topk(
        flat_docs.reshape(-1), flat_impact.reshape(-1),
        starts_abs.reshape(r, t).contiguous(),
        lengths.reshape(r, t).contiguous(),
        weights.reshape(r, t).contiguous(),
        min_count.repeat(s_l).contiguous(),
        max_len=max_len, d_pad=d_pad, k=k, t_window=t_window,
        with_counts=with_counts, with_totals=True, variant=variant,
        **extra)
    k_l = vals.shape[1]
    vals = vals.reshape(s_l, b, k_l)
    docs = docs.reshape(s_l, b, k_l)
    totals_b = totals.reshape(s_l, b).sum(dim=0, dtype=torch.int32)
    shard_ids = shard_offset + torch.arange(s_l, dtype=torch.int64,
                                            device=dev)
    gids = docs.to(torch.int64) + (shard_ids * (d_pad + 1))[:, None, None]
    vals_b = vals.permute(1, 0, 2).reshape(b, -1)
    gids_b = gids.permute(1, 0, 2).reshape(b, -1)
    return vals_b, gids_b, totals_b


def _compressed_operands(comp, starts, r: int, t: int):
    """The compressed streams' keyword operands of sorted_merge_topk,
    flattened with per-shard offsets."""
    dev = starts.device
    s_l = starts.shape[0]
    (flat_rank, block_max, res_vals, res_starts, res_lens, slot_terms,
     doc_bases) = comp
    nbp = block_max.shape[1]
    rcp = res_vals.shape[1]
    sb = torch.arange(s_l, dtype=torch.int32, device=dev)[:, None, None]
    blk = torch.div(starts, sparse.COMPRESSED_BLOCK,
                    rounding_mode="floor") + sb * nbp
    extra = dict(flat_rank=flat_rank.reshape(-1),
                 res_starts=(res_starts + sb * rcp).reshape(r, t),
                 res_lens=res_lens.reshape(r, t).contiguous(),
                 res_vals=res_vals.reshape(-1),
                 block_max=block_max.reshape(-1),
                 blk_starts=blk.reshape(r, t).contiguous(),
                 slot_terms=slot_terms.reshape(r, t).contiguous())
    if doc_bases is not None:
        nbd = doc_bases.shape[1]
        dbs = torch.div(starts, sparse.COMPRESSED_BLOCK,
                        rounding_mode="floor") + sb * nbd
        extra.update(doc_bases=doc_bases.reshape(-1),
                     dbs_starts=dbs.reshape(r, t).contiguous(),
                     dlo_starts=(starts % sparse.COMPRESSED_BLOCK
                                 ).reshape(r, t).contiguous())
    return extra


def _merge_topk(vals_b, gids_b, k: int, topk=None):
    """Cross-shard top-k, earliest index first among equal scores
    (`topk`: the top-k function, default sparse.hierarchical_top_k)."""
    top_vals, pos = (topk or sparse.hierarchical_top_k)(
        vals_b, min(k, vals_b.shape[1]))
    return top_vals, torch.gather(gids_b, 1, pos)


#: held while a step of a multi-device mesh enqueues its collectives, so
#: that those of two steps (two packs' batcher threads) reach every
#: device in the same order; the device bodies run outside it, so two
#: packs' trains overlap on the cards
DEVICE_DISPATCH_LOCK = threading.Lock()


def _run_bodies(jobs):
    """Run the device bodies of a step, one after another in the calling
    thread → their results in order. Each waits on its device once (the
    wrappers read their counts on the host), but a body's device work is
    a small part of its host work: run in threads, one a device, the
    bodies lost more to the interpreter lock than they overlapped on the
    cards (tools/mesh_ab.py; PERF.md §6)."""
    return [job() for job in jobs]


#: the batch operands a step takes, in order ([S, B, T] each, then [B]);
#: a raw pack's step takes the first three
_BATCH_FIELDS = ("starts", "lengths", "weights", "res_starts", "res_lens",
                 "slot_terms")
_RAW_FIELDS = _BATCH_FIELDS[:3]


def _gather_row(outs, cuda: bool):
    """The tail's transport for one data row: the columns' (vals_b
    [B_l, S_l·k'], gids_b, totals_b) → the row's [B_l, S·k'] values and
    ids in column order and its summed totals, on column 0's device. On
    CUDA devices an NCCL all_gather and all_reduce (one process, every
    device of the row: torch.cuda.nccl); on CPU entries cat and sum.
    Columns' (vals_b, gids_b) pairs without totals (the kNN step) →
    the gathered pair."""
    with_totals = len(outs[0]) == 3
    if not cuda:
        pair = (torch.cat([o[0] for o in outs], dim=1),
                torch.cat([o[1] for o in outs], dim=1))
        if not with_totals:
            return pair
        return pair + (torch.stack([o[2] for o in outs]).sum(
            dim=0, dtype=torch.int32),)
    from torch.cuda import nccl
    n = len(outs)
    gathered = []
    for j in (0, 1):
        ins = [o[j].contiguous() for o in outs]
        outs_j = [torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                              device=t.device) for t in ins]
        nccl.all_gather(ins, outs_j)
        b_l = ins[0].shape[0]
        gathered.append(outs_j[0].permute(1, 0, 2).reshape(b_l, -1))
    if not with_totals:
        return gathered[0], gathered[1]
    totals = [o[2].contiguous() for o in outs]
    nccl.all_reduce(totals)
    return gathered[0], gathered[1], totals[0]


def make_distributed_search(mesh: Mesh, *, max_len: int, d_pad: int,
                            p_pad: int, k: int, t_window: int,
                            with_counts: bool = False,
                            variant: str = "compressed"):
    """The search step over a (data, shards) mesh: device (d, c) scores
    its S_l shards (global ids from shard_offset = c·S_l) for data row
    d's slice of the batch, [B/data, S_l, T], on its own current stream;
    each data row then gathers its columns' lists in column order, sums
    their totals and takes the cross-shard top-k (the tail). The step
    takes a MeshImage and the host batch arrays and returns each data
    row's (vals [B_l, k'], gids [B_l, k'], totals [B_l]) on the row's
    column-0 device, in data-row order. A raw variant ("ref", "packed")
    takes a raw MeshImage, a compressed one the streams'."""
    if variant not in sparse.KERNEL_VARIANTS:
        raise ValueError(f"unknown kernel variant {variant!r}")
    raw = variant not in sparse.COMPRESSED_VARIANTS
    fields = _RAW_FIELDS if raw else _BATCH_FIELDS
    n_data = mesh.shape[DATA_AXIS]

    def device_body(dev, arrays, batch_part, min_count, shard_offset):
        put = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
               for a in batch_part]
        starts, lengths, weights = put[:3]
        comp = None
        if not raw:
            flat_rank, block_max, res_vals = arrays[2:5]
            doc_bases = arrays[5] if len(arrays) == 6 else None
            comp = (flat_rank, block_max, res_vals, *put[3:], doc_bases)
        return _local_body(
            arrays[0], arrays[1], starts, lengths, weights,
            torch.from_numpy(np.ascontiguousarray(min_count)).to(dev),
            max_len=max_len, d_pad=d_pad, p_pad=p_pad, k=k,
            t_window=t_window, with_counts=with_counts, variant=variant,
            comp=comp, shard_offset=shard_offset)

    def run_body(dev, arrays, batch_part, min_count, shard_offset):
        with device_context(dev):
            return device_body(dev, arrays, batch_part, min_count,
                               shard_offset)

    def step(image: MeshImage, batch: QueryBatch):
        if image.raw != raw:
            raise ValueError(f"variant {variant!r} does not read a "
                             f"{'raw' if image.raw else 'compressed'} image")
        b = batch.starts.shape[1]
        if b % n_data:
            raise ValueError(f"a batch of {b} queries does not split over "
                             f"a data axis of {n_data}")
        b_l = b // n_data
        s_l = image.parts[0][0][0].shape[0]
        jobs = []
        for d, row in enumerate(mesh.grid):
            qs = slice(d * b_l, (d + 1) * b_l)
            for c, dev in enumerate(row):
                ss = slice(c * s_l, (c + 1) * s_l)
                part = [getattr(batch, f)[ss, qs] for f in fields]
                jobs.append(functools.partial(
                    run_body, dev, image.parts[d][c], part,
                    batch.min_count[qs], c * s_l))
        outs = _run_bodies(jobs)
        n_cols = len(mesh.grid[0])
        lock = (DEVICE_DISPATCH_LOCK if len(mesh.devices) > 1
                else contextlib.nullcontext())
        rows = []
        for d, row in enumerate(mesh.grid):
            with device_context(row[0]):
                with lock:
                    vals, gids, totals = _gather_row(
                        outs[d * n_cols:(d + 1) * n_cols], mesh.is_cuda)
                top_vals, top_ids = _merge_topk(vals, gids, k)
            rows.append((top_vals, top_ids, totals))
        return rows

    return step


def make_local_search(*, max_len: int, d_pad: int, p_pad: int, k: int,
                      t_window: int, with_counts: bool = False,
                      variant: str = "compressed"):
    """The reference's one-device step: the step of a (1, 1) mesh. It
    takes a MeshImage placed on a (1, 1) mesh and a QueryBatch and
    returns (vals [B, k'], gids [B, k'], totals [B]) on that device."""
    kw = dict(max_len=max_len, d_pad=d_pad, p_pad=p_pad, k=k,
              t_window=t_window, with_counts=with_counts, variant=variant)

    def step(image: MeshImage, batch: QueryBatch):
        if len(image.mesh.devices) != 1:
            raise ValueError(f"make_local_search runs on a (1, 1) mesh, "
                             f"not {image.mesh}")
        (row,) = make_distributed_search(image.mesh, **kw)(image, batch)
        return row

    return step


def distributed_search_raw(pack: StackedShardPack, batch: QueryBatch,
                           k: int, mesh: Mesh,
                           device_arrays: Optional[MeshImage] = None,
                           with_counts: Optional[bool] = None,
                           t_window: Optional[int] = None,
                           materialize: bool = True,
                           variant: str = "compressed"):
    """One step of make_distributed_search over `mesh`, raw outputs:
    numpy (vals [B, k'], gids int64 [B, k'], totals [B]); materialize=
    False returns torch tensors without waiting (data rows past the
    first moved to the first's device). device_arrays is the pack's
    MeshImage (placed here when None: the compressed streams for a
    compressed variant, the raw image for "ref"/"packed"); a compressed
    variant's batch must be prepared with compressed= streams."""
    compressed = variant in sparse.COMPRESSED_VARIANTS
    if compressed and batch.res_starts is None:
        raise ValueError(
            "compressed variant needs a batch prepared with "
            "compressed= streams (res_starts/res_lens/slot_terms)")
    if with_counts is None:
        with_counts = batch.need_counts
    if t_window is None:
        t_window = batch.window
    elif t_window < batch.window:
        raise ValueError(f"t_window={t_window} < needed {batch.window}")
    if device_arrays is None:
        if compressed:
            device_arrays = device_put_compressed(
                build_compressed_streams(pack), mesh)
        else:
            device_arrays = device_put_pack(pack, mesh,
                                            *build_impact_sorted(pack))
    step = make_distributed_search(
        mesh, max_len=batch.max_len, d_pad=pack.d_pad, p_pad=pack.p_pad,
        k=k, t_window=t_window, with_counts=with_counts, variant=variant)
    rows = step(device_arrays, batch)
    if len(rows) == 1:
        vals, ids, totals = rows[0]
    elif materialize:
        return tuple(np.concatenate([r[j].cpu().numpy() for r in rows])
                     for j in range(3))
    else:
        dev = rows[0][0].device
        vals, ids, totals = (torch.cat([r[j].to(dev) for r in rows])
                             for j in range(3))
    if not materialize:
        return vals, ids, totals
    return vals.cpu().numpy(), ids.cpu().numpy(), totals.cpu().numpy()


def distributed_search(pack: StackedShardPack, batch: QueryBatch, k: int,
                       mesh: Mesh, device_arrays: Optional[MeshImage] = None,
                       with_counts: Optional[bool] = None,
                       t_window: Optional[int] = None,
                       variant: str = "compressed"):
    """One search step → (scores [B, k'], refs, totals [B]): refs[q] =
    [(score, shard, local ord), ...] decoded on the host; totals[q] is
    the exact matched-doc count."""
    vals, ids, totals = distributed_search_raw(
        pack, batch, k, mesh, device_arrays=device_arrays,
        with_counts=with_counts, t_window=t_window, variant=variant)
    vals, refs = decode_refs(pack, vals, ids)
    return vals, refs, totals


# ---------------------------------------------------------------------------
# the block-max pruned tiers (raw packs)
# ---------------------------------------------------------------------------

def prepare_term_ranges(pack: StackedShardPack,
                        queries: Sequence[Sequence[str]],
                        boosts: Optional[Sequence[float]] = None,
                        pad_batch_to: Optional[int] = None,
                        pad_terms: int = 8):
    """Per-TERM (unchunked) postings ranges for phase B's exact rescore:
    (starts, lengths, weights) int32/int32/f32 [S, B, pad_terms]."""
    b_real = len(queries)
    b = pad_batch_to or b_real
    s = pack.num_shards
    starts = np.zeros((s, b, pad_terms), dtype=np.int32)
    lengths = np.zeros((s, b, pad_terms), dtype=np.int32)
    weights = np.zeros((s, b, pad_terms), dtype=np.float32)
    for si in range(s):
        vocab = pack.vocabs[si]
        rstart = pack.row_starts[si]
        for qi in range(b_real):
            terms = list(queries[qi])[:pad_terms]
            boost = boosts[qi] if boosts is not None else 1.0
            ws = term_weights(pack, si, terms, boost)
            for t, term in enumerate(terms):
                r = vocab.get(term, -1)
                if r < 0:
                    continue
                starts[si, qi, t] = int(rstart[r])
                lengths[si, qi, t] = int(rstart[r + 1] - rstart[r])
                weights[si, qi, t] = ws[t]
    return starts, lengths, weights


def pack_pruned_operands(batch: QueryBatch, t_starts: np.ndarray,
                         t_lengths: np.ndarray, t_weights: np.ndarray
                         ) -> np.ndarray:
    """The 7 per-launch query arrays as ONE [S, B, 3T + 3T_terms + 1] f32
    array (ints bitcast): slot starts, lengths, weights, term starts,
    lengths, weights, tail bound. One host-to-device copy a device."""
    tail = (batch.tail_bounds[:, :, None] if batch.tail_bounds is not None
            else np.zeros(batch.starts.shape[:2] + (1,), dtype=np.float32))
    parts = [batch.starts.view(np.float32), batch.lengths.view(np.float32),
             batch.weights,
             t_starts.view(np.float32), t_lengths.view(np.float32),
             t_weights, tail]
    return np.concatenate(parts, axis=2)


def unpack_pruned(packed: np.ndarray, k_keep: Optional[int] = None):
    """make_pruned_search's [B, 2k + 3] output → (vals [B, k], gids int32
    [B, k], totals [B], cutoff [B], beta [B]). k comes from the width:
    the step clamps k_out to its candidate pool."""
    derived = (packed.shape[1] - 3) // 2
    if packed.shape[1] != 2 * derived + 3:
        raise ValueError(
            f"packed width {packed.shape[1]} is not of the form 2k+3")
    if k_keep is None:
        k_keep = derived
    elif k_keep != derived:
        raise ValueError(
            f"packed width {packed.shape[1]} implies k_keep={derived}, "
            f"caller passed {k_keep}")
    vals = packed[:, :k_keep]
    gids = np.ascontiguousarray(packed[:, k_keep:2 * k_keep]
                                ).view(np.int32)
    totals = packed[:, 2 * k_keep].astype(np.int64)
    cutoff = packed[:, 2 * k_keep + 1]
    beta = packed[:, 2 * k_keep + 2]
    return vals, gids, totals, cutoff, beta


def _split_ops(ops: torch.Tensor, t_terms: int):
    """The fused operand [S_l, B_l, W] → (starts, lengths, weights,
    t_starts, t_lengths, t_weights, tail_bound)."""
    t = (ops.shape[2] - 3 * t_terms - 1) // 3

    def ints(a):
        return a.contiguous().view(torch.int32)

    o = 3 * t
    return (ints(ops[:, :, 0:t]), ints(ops[:, :, t:2 * t]),
            ops[:, :, 2 * t:o].contiguous(),
            ints(ops[:, :, o:o + t_terms]),
            ints(ops[:, :, o + t_terms:o + 2 * t_terms]),
            ops[:, :, o + 2 * t_terms:o + 3 * t_terms].contiguous(),
            ops[:, :, o + 3 * t_terms])


def _phase_a(imp_docs, imp_impacts, starts, lengths, weights, *, p_pad,
             max_len, d_pad, t_window, c_local, pack_keys, with_rescore):
    """Phase A on one device: its S_l rows' slots, fused in groups of
    fuse_group_rows rows → (vals [B, n_groups·k_dev], local gids int64,
    totals int32 [B], cut_local f32 [B], use_pack)."""
    from elasticsearch_tpu_torch.ops import merge_kernel
    dev = starts.device
    s_l, b, t = starts.shape
    row_of_slot = torch.arange(s_l, dtype=torch.int32,
                               device=dev)[:, None, None].expand(s_l, b, t)
    starts_abs = starts + row_of_slot * p_pad
    g = min(fuse_group_rows(b, t, max_len), s_l)
    n_groups = (s_l + g - 1) // g
    pad_rows = n_groups * g - s_l

    def grouped(a):  # [S_l, B, T] → [n_groups, B, G·T]
        if pad_rows:
            a = torch.cat([a, torch.zeros((pad_rows,) + tuple(a.shape[1:]),
                                          dtype=a.dtype, device=dev)])
        return (a.reshape(n_groups, g, b, t).permute(0, 2, 1, 3)
                .reshape(n_groups, b, g * t).contiguous())

    g_starts, g_lengths = grouped(starts_abs), grouped(lengths)
    g_weights, g_rows = grouped(weights), grouped(row_of_slot)
    k_dev = min(c_local, g * t * max_len)
    # one u32 key a lane when a group's relative gid range fits 16 bits;
    # never in the no-rescore tier, whose phase-A totals are the scores
    use_pack = (pack_keys and with_rescore
                and g * (d_pad + 1) <= sparse.PACKED_DOC_LIMIT)
    flat_docs, flat_imps = imp_docs.reshape(-1), imp_impacts.reshape(-1)
    outs = [merge_kernel.pruned_candidates(
        flat_docs, flat_imps, g_starts[j], g_lengths[j], g_weights[j],
        g_rows[j], max_len=max_len, d_pad=d_pad, t_window=t_window,
        k=k_dev, pack_keys=use_pack) for j in range(n_groups)]
    if n_groups == 1:
        vals_b, gid_local, totals_b = outs[0]
        return vals_b, gid_local, totals_b, vals_b[:, -1], use_pack
    vals_gs = torch.stack([o[0] for o in outs])
    # [n_groups, B, k_dev] → [B, n_groups·k_dev]
    vals_b = vals_gs.permute(1, 0, 2).reshape(b, -1)
    gid_local = torch.stack([o[1] for o in outs]).permute(1, 0, 2
                                                          ).reshape(b, -1)
    totals_b = torch.stack([o[2] for o in outs]).sum(dim=0,
                                                     dtype=torch.int32)
    # a doc cut in ANY group fell below ITS group's k_dev-th
    return (vals_b, gid_local, totals_b, vals_gs[:, :, -1].max(dim=0).values,
            use_pack)


def _row_cat(tensors, dev, cuda: bool):
    """The columns' [B_l, n] tensors of one data row side by side in
    column order, on `dev` (an NCCL all_gather on CUDA devices)."""
    if not cuda:
        return torch.cat([t.to(dev) for t in tensors], dim=1)
    from torch.cuda import nccl
    ins = [t.contiguous() for t in tensors]
    outs = [torch.empty((len(ins),) + tuple(t.shape), dtype=t.dtype,
                        device=t.device) for t in ins]
    nccl.all_gather(ins, outs)
    return outs[0].permute(1, 0, 2).reshape(ins[0].shape[0], -1)


def _row_broadcast(t: torch.Tensor, devices, cuda: bool):
    """Column 0's tensor on every device of the row (NCCL on CUDA)."""
    if not cuda or len(devices) == 1:
        return [t.to(d) for d in devices]
    from torch.cuda import nccl
    outs = [t.contiguous()] + [torch.empty_like(t, device=d)
                               for d in devices[1:]]
    nccl.broadcast(outs, root=0)
    return outs


def make_pruned_search(mesh: Mesh, *, max_len: int, d_pad: int, p_pad: int,
                       c_cand: int, k_out: int, t_window: int, t_terms: int,
                       search_iters: Optional[int] = None,
                       c_local: Optional[int] = None,
                       with_rescore: bool = True, variant: str = "ref",
                       pack_keys: bool = False):
    """The block-max serving step over a raw image (the reference's
    make_pruned_search):

      phase A  candidates over each query's impact-sorted postings
               prefixes (or full postings in the no-rescore tier), this
               device's rows merged in groups of at most FUSE_ROWS
               (pruned_candidates), then the row's tail: the max of the
               group cuts, an all-gather of the candidates in column
               order, the totals summed, the global top-c_cand;
      phase B  every candidate's exact score from a binary search of
               each term's doc-sorted postings on the device that holds
               its row, summed over the row's columns, and the final
               order by (−score, gid) (pruned_rescore).

    step(image, ops) takes a raw MeshImage and pack_pruned_operands'
    [S, B, W] array and returns [B, 2k + 3] f32 (scores, gids as int32
    bits, totals, cutoff, beta: unpack_pruned) on the first device. The
    caller checks the WAND bound `kth ≥ (cutoff if full else 0) + beta`
    with its k and escalates when it fails. pack_keys (variant "packed",
    rescore tiers): each phase-A lane's group-relative gid and 16-bit
    impact code as one u32 key when the group's gid range fits 16 bits,
    its totals quantized lower bounds; the cutoff is inflated by the
    quantization slack to keep the bound conservative."""
    from elasticsearch_tpu_torch.ops import merge_kernel
    if search_iters is None:
        # a postings row is at most d_pad docs long
        search_iters = max(1, math.ceil(math.log2(d_pad + 1)))
    if c_local is None:
        c_local = c_cand
    n_data = mesh.shape[DATA_AXIS]

    def step(image: MeshImage, ops: np.ndarray) -> torch.Tensor:
        if not image.raw:
            raise ValueError("the pruned tiers read a raw image")
        b = ops.shape[1]
        if b % n_data:
            raise ValueError(f"a batch of {b} queries does not split over "
                             f"a data axis of {n_data}")
        b_l = b // n_data
        s_l = image.parts[0][0][0].shape[0]
        rows = []
        for d, row in enumerate(mesh.grid):
            qs = slice(d * b_l, (d + 1) * b_l)
            rows.append(_pruned_row(image.parts[d], row, ops[:, qs], s_l))
        dev0 = mesh.grid[0][0]
        with device_context(dev0):
            return torch.cat([r.to(dev0) for r in rows])

    def _pruned_row(parts, devices, ops, s_l):
        cuda = mesh.is_cuda
        bodies = []
        for c, dev in enumerate(devices):
            with device_context(dev):
                part = torch.from_numpy(np.ascontiguousarray(
                    ops[c * s_l:(c + 1) * s_l])).to(dev)
                (starts, lengths, weights, t_st, t_ln, t_w,
                 tail) = _split_ops(part, t_terms)
                _, _, _, imp_docs, imp_imps = parts[c]
                vals_b, gid_local, totals_b, cut, use_pack = _phase_a(
                    imp_docs, imp_imps, starts, lengths, weights,
                    p_pad=p_pad, max_len=max_len, d_pad=d_pad,
                    t_window=t_window, c_local=c_local,
                    pack_keys=pack_keys and variant == "packed",
                    with_rescore=with_rescore)
                gids_b = gid_local + c * s_l * (d_pad + 1)
                gids_b = torch.where(vals_b > NEG_INF, gids_b,
                                     torch.zeros_like(gids_b))
                bodies.append((vals_b, gids_b, totals_b, cut,
                               tail.max(dim=0).values, (t_st, t_ln, t_w),
                               use_pack))
        dev0 = devices[0]
        lock = (DEVICE_DISPATCH_LOCK if len(mesh.devices) > 1
                else contextlib.nullcontext())
        with device_context(dev0):
            with lock:
                all_vals = _row_cat([o[0] for o in bodies], dev0, cuda)
                all_gids = _row_cat([o[1] for o in bodies], dev0, cuda)
                totals = _row_cat([o[2][:, None] for o in bodies], dev0,
                                  cuda).sum(dim=1, dtype=torch.int32)
                row_cut = _row_cat([o[3][:, None] for o in bodies], dev0,
                                   cuda).max(dim=1).values
                beta = _row_cat([o[4][:, None] for o in bodies], dev0,
                                cuda).max(dim=1).values
            c = min(c_cand, all_vals.shape[1])
            cand_vals, pos = sparse.hierarchical_top_k(all_vals, c)
            cand_gids = torch.gather(all_gids, 1, pos)
            k_keep = min(k_out, c)
            if not with_rescore:
                # the full-postings tier: phase-A run totals are the
                # exact scores
                out_vals, out_gids = merge_kernel.pruned_order(
                    cand_vals, cand_vals, cand_gids, k=k_keep)
            else:
                out_vals, out_gids = _phase_b(
                    parts, devices, bodies, cand_vals, cand_gids, k_keep,
                    s_l, cuda, lock)
            cutoff = torch.maximum(cand_vals[:, -1], row_cut)
            if bodies[0][6]:
                # packed phase-A totals are quantized lower bounds (< 2**-7
                # relative a lane): a cut doc's true phase-A score may
                # exceed its quantized one by that much
                cutoff = torch.where(cutoff > 0.0,
                                     cutoff * (1.0 + 2.0 ** -6), cutoff)
            gids_f32 = out_gids.to(torch.int32).view(torch.float32)
            return torch.cat([out_vals, gids_f32,
                              totals[:, None].to(torch.float32),
                              cutoff[:, None], beta[:, None]], dim=1)

    def _phase_b(parts, devices, bodies, cand_vals, cand_gids, k_keep, s_l,
                 cuda, lock):
        if len(devices) == 1:
            t_st, t_ln, t_w = bodies[0][5]
            return merge_kernel.pruned_rescore(
                parts[0][0], parts[0][1], cand_gids, t_st, t_ln, t_w,
                d_pad=d_pad, p_pad=p_pad, row_base=0,
                search_iters=search_iters, cand_vals=cand_vals, k=k_keep)
        with lock:
            cands = _row_broadcast(cand_gids, devices, cuda)
        exact_parts = []
        for c, dev in enumerate(devices):
            with device_context(dev):
                t_st, t_ln, t_w = bodies[c][5]
                exact_parts.append(merge_kernel.pruned_rescore(
                    parts[c][0], parts[c][1], cands[c], t_st, t_ln, t_w,
                    d_pad=d_pad, p_pad=p_pad, row_base=c * s_l,
                    search_iters=search_iters))
        with lock:
            stacked = _row_cat(exact_parts, devices[0], cuda)
        b_l, n_cand = cand_gids.shape
        cols = stacked.reshape(b_l, len(devices), n_cand)
        # the psum over the shards axis, in column order
        exact = cols[:, 0]
        for j in range(1, len(devices)):
            exact = exact + cols[:, j]
        return merge_kernel.pruned_order(exact, cand_vals, cand_gids,
                                         k=k_keep)

    return step


def decode_refs(pack: StackedShardPack, vals: np.ndarray, ids: np.ndarray):
    """→ (vals, refs): refs[q] = [(score, shard, local ord), ...] without
    the -inf and sentinel lanes."""
    refs = []
    for qi in range(vals.shape[0]):
        row = []
        for v, gid in zip(vals[qi], ids[qi]):
            if v == NEG_INF:
                continue
            shard, ord_ = divmod(int(gid), pack.d_pad + 1)
            if ord_ >= pack.d_pad:
                continue  # sentinel lane
            row.append((float(v), shard, ord_))
        refs.append(row)
    return vals, refs


def resolve_hits(pack: StackedShardPack,
                 refs: List[List[Tuple[float, int, int]]]):
    """(score, shard, ord) → [{'_id', '_score'}] via the host doc-id
    maps."""
    out = []
    for row in refs:
        hits = []
        for score, shard, ord_ in row:
            if shard < len(pack.shard_doc_ids) \
                    and ord_ < len(pack.shard_doc_ids[shard]):
                hits.append({"_id": pack.shard_doc_ids[shard][ord_],
                             "_score": score})
        out.append(hits)
    return out


# ---------------------------------------------------------------------------
# distributed kNN: exact similarity top-k over the docs axis
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StackedVectorPack:
    """S doc-axis shards of one dense_vector field as an f32 [S, D_pad,
    dims] array (NaN rows: missing docs) with the live docs bool [S,
    D_pad], laid over the mesh's shards axis (host arrays)."""

    field: str
    num_shards: int
    d_pad: int
    dims: int
    vectors: np.ndarray          # f32[S, D_pad, dims]
    live: np.ndarray             # bool[S, D_pad]
    shard_doc_ids: List[List[str]]
    similarity: str = "cosine"


def build_stacked_vector_pack(segments: Sequence[Segment], field: str,
                              live_docs: Optional[
                                  Sequence[Optional[np.ndarray]]] = None,
                              similarity: str = "cosine",
                              pad_shards_to: Optional[int] = None
                              ) -> StackedVectorPack:
    """Each segment is one doc-axis shard; shapes pad to the widest."""
    dims = 0
    for seg in segments:
        col = seg.doc_values.get(field)
        if col is not None and col.kind == "vec":
            dims = max(dims, col.values.shape[1])
    if dims == 0:
        raise ValueError(f"no dense_vector column [{field}] in segments")
    d_pad = _pad_to(max((s.num_docs for s in segments), default=1))
    s = len(segments)
    s_pad = max(pad_shards_to or s, s)
    vectors = np.full((s_pad, d_pad, dims), np.nan, dtype=np.float32)
    live = np.zeros((s_pad, d_pad), dtype=bool)
    doc_ids: List[List[str]] = []
    for i, seg in enumerate(segments):
        col = seg.doc_values.get(field)
        if col is not None and col.kind == "vec":
            vectors[i, : seg.num_docs, : col.values.shape[1]] = col.values
        if live_docs is not None and live_docs[i] is not None:
            live[i, : seg.num_docs] = live_docs[i]
        else:
            live[i, : seg.num_docs] = True
        doc_ids.append(list(seg.doc_ids))
    return StackedVectorPack(field, s_pad, d_pad, dims, vectors, live,
                             doc_ids, similarity)


@dataclasses.dataclass
class VectorImage:
    """A StackedVectorPack placed over a mesh's first data row: column c
    holds shards [c·S_l, (c+1)·S_l) as (vectors f32 [S_l, D_pad, dims],
    live bool [S_l, D_pad]) on its device."""

    mesh: Mesh
    parts: List[Tuple[torch.Tensor, torch.Tensor]]


def device_put_vector_pack(pack: StackedVectorPack, mesh: Mesh
                           ) -> VectorImage:
    """Lay the pack's shards over the mesh's shards axis. The step's
    output is the same on every data row, so one row holds the pack."""
    n_cols = mesh.shape[SHARD_AXIS]
    if pack.num_shards % n_cols:
        raise ValueError(f"{pack.num_shards} shards do not split over "
                         f"{n_cols} columns (pad_shards_to)")
    s_l = pack.num_shards // n_cols
    parts = []
    for c, dev in enumerate(mesh.grid[0]):
        ss = slice(c * s_l, (c + 1) * s_l)
        parts.append((torch.from_numpy(pack.vectors[ss]).to(dev),
                      torch.from_numpy(pack.live[ss]).to(dev)))
    return VectorImage(mesh, parts)


def _knn_local_body(vectors, live, queries, *, similarity: str, k: int,
                    d_pad: int, first_shard: int):
    """One device's scores over its [s_l, D_pad, dims] block: the
    knn_scores kernel (the mesh formulas) over the flattened [s_l·D_pad,
    dims] rows, masked by missing vectors and the live docs, then the
    local top-k with global ids (the BM25 step's scheme: shard ·
    (d_pad + 1) + ord; -1 for a -inf entry)."""
    s_l = vectors.shape[0]
    flat = vectors.reshape(s_l * d_pad, -1)
    scores = knn_kernel.knn_scores(flat, queries, similarity,
                                   formula="mesh",
                                   ok=live.reshape(s_l * d_pad))
    vals, flat_idx = knn_kernel.knn_topk(scores, min(k, s_l * d_pad))
    j = torch.div(flat_idx, d_pad, rounding_mode="floor")
    ords = flat_idx % d_pad
    gids = (first_shard + j) * (d_pad + 1) + ords
    gids = torch.where(vals == NEG_INF, torch.full_like(gids, -1), gids)
    return vals, gids


@functools.lru_cache(maxsize=32)
def make_distributed_knn(mesh: Mesh, *, d_pad: int, dims: int, k: int,
                         similarity: str):
    """The kNN step over the (data, shards) mesh: each column of the first
    data row scores its shards' vectors and takes its local top-k (global
    ids from first_shard = c·S_l); the row gathers the columns' lists in
    column order (NCCL on CUDA devices) and takes the global top-k on
    column 0's device: the reference's shard_map of _knn_local_body,
    all_gather and _merge_topk. The step takes a VectorImage and f32 [B,
    dims] host queries and returns (vals [B, k'], gids [B, k'])."""

    def run_body(dev, part, q, first_shard):
        with device_context(dev):
            vectors, live = part
            return _knn_local_body(
                vectors, live, torch.from_numpy(q).to(dev),
                similarity=similarity, k=k, d_pad=d_pad,
                first_shard=first_shard)

    def step(image: VectorImage, queries: np.ndarray):
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.shape[1] != dims:
            raise ValueError(f"queries have {q.shape[1]} dims, the pack "
                             f"{dims}")
        s_l = image.parts[0][0].shape[0]
        row = mesh.grid[0]
        outs = _run_bodies([functools.partial(run_body, dev,
                                              image.parts[c], q, c * s_l)
                            for c, dev in enumerate(row)])
        lock = (DEVICE_DISPATCH_LOCK if len(mesh.devices) > 1
                else contextlib.nullcontext())
        with device_context(row[0]):
            with lock:
                vals, gids = _gather_row(outs, mesh.is_cuda)
            return _merge_topk(vals, gids, k, topk=knn_kernel.knn_topk)

    return step


def distributed_knn(pack: StackedVectorPack, queries: np.ndarray, k: int,
                    mesh: Optional[Mesh] = None,
                    device_arrays: Optional[VectorImage] = None,
                    device=None):
    """Batched exact kNN: queries [B, dims] → (scores [B, k'] numpy,
    refs [[(score, shard, ord), ...]]). With no mesh, the one-device
    path on `device` (default cuda:0), or over the one part of a (1, 1)
    mesh's `device_arrays`: the local body over every shard and the same
    top-k, the same bits as a mesh's."""
    q = np.asarray(queries, dtype=np.float32)
    if q.ndim == 1:
        q = q[None, :]
    if mesh is not None:
        step = make_distributed_knn(mesh, d_pad=pack.d_pad, dims=pack.dims,
                                    k=k, similarity=pack.similarity)
        image = (device_arrays if device_arrays is not None
                 else device_put_vector_pack(pack, mesh))
        vals, gids = step(image, q)
    else:
        if device_arrays is not None:
            (vectors, live), = device_arrays.parts
        else:
            dev = resolve_device(device)
            vectors = torch.from_numpy(pack.vectors).to(dev)
            live = torch.from_numpy(pack.live).to(dev)
        dev = vectors.device
        with device_context(dev):
            vals, gids = _knn_local_body(
                vectors, live, torch.from_numpy(q).to(dev),
                similarity=pack.similarity, k=k, d_pad=pack.d_pad,
                first_shard=0)
            vals, gids = _merge_topk(vals, gids, k,
                                     topk=knn_kernel.knn_topk)
    vals = vals.cpu().numpy()
    gids = gids.cpu().numpy()
    refs = []
    for qi in range(vals.shape[0]):
        row = []
        for v, gid in zip(vals[qi], gids[qi]):
            if v == NEG_INF or gid < 0:
                continue
            shard, ord_ = divmod(int(gid), pack.d_pad + 1)
            row.append((float(v), shard, ord_))
        refs.append(row)
    return vals, refs
