"""Stacked-shard BM25 search on one device.

Counterpart of the reference's ``parallel/distributed.py`` for the
compressed main path on one card. The reference fans shards out over a
mesh and merges with ``all_gather`` + top-k; here every shard of the pack
lies on the one device, which is the reference's ``make_local_search``
shape: per-(shard, query) rows go through ``sparse.sorted_merge_topk`` in
one call, then a top-k over the shards' concatenated lists.

  StackedShardPack — S shards' postings for one field, padded to common
    shapes, with group-level statistics (one group per index shard).
  CompressedStreams — the compressed resident image: u16 (or u8-delta)
    doc stream, u16 value codes, u16 ranks, block-max codes, residual
    tables.
  QueryBatch — per-(shard, query, slot) chunk arrays.

Global doc identity: shard s, local ordinal d → s * (d_pad + 1) + d,
decoded host-side by ``decode_refs``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.index.pack import LANE, _pad_to
from elasticsearch_tpu_torch.index.segment import Segment
from elasticsearch_tpu_torch.ops import sparse

NEG_INF = float("-inf")
CHUNK_CAP = 4096  # max postings chunk per slot; flat arrays pad by this much


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


def build_stacked_pack(segments: Sequence[Segment], field: str,
                       live_docs: Optional[Sequence[Optional[np.ndarray]]] = None,
                       k1: float = 1.2, b: float = 0.75,
                       row_groups: Optional[Sequence[int]] = None
                       ) -> StackedShardPack:
    """Each segment is one pack row. Shapes pad to the max across rows +
    CHUNK_CAP slack so chunk windows never run past the arrays.
    row_groups[i] assigns segment i to a statistics group (one group per
    index shard → per-shard idf/avgdl); omitted → one index-level group."""
    from elasticsearch_tpu_torch.index.pack import build_field_pack

    s = len(segments)
    d_pad = max(_pad_to(seg.num_docs) for seg in segments)
    packs = [build_field_pack(seg, field, d_pad) for seg in segments]
    p_pad = max((p.flat_docs.shape[0] for p in packs if p is not None),
                default=LANE) + CHUNK_CAP
    flat_docs = np.full((s, p_pad), d_pad, dtype=np.int32)
    flat_tfs = np.zeros((s, p_pad), dtype=np.int32)
    norms = np.zeros((s, d_pad), dtype=np.uint8)
    live = np.zeros((s, d_pad), dtype=bool)
    vocabs: List[Dict[str, int]] = []
    row_starts: List[np.ndarray] = []
    shard_num_docs: List[int] = []
    shard_doc_ids: List[List[str]] = []
    groups = list(row_groups) if row_groups is not None else [0] * s
    if len(groups) != s:
        raise ValueError(f"row_groups has {len(groups)} entries for "
                         f"{s} segments")
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
    avgdl = (sum_ttf / total_docs) if total_docs else 1.0
    group_avgdl = [(group_sum_ttf[g] / group_doc_count[g])
                   if group_doc_count[g] else 1.0 for g in range(n_groups)]
    flat_impact = np.zeros((s, p_pad), dtype=np.float32)
    for i in range(s):
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


def device_put_compressed(streams: CompressedStreams,
                          device: torch.device) -> Tuple[torch.Tensor, ...]:
    """Place the compressed image on `device` → 5 tensors (docs16,
    code16, rank16, block_max, res_vals), or 6 in delta mode (docs8 in
    the doc slot, doc_bases appended): the tuple length is the format."""
    if streams.delta:
        arrays = (streams.flat_docs8, streams.flat_code16,
                  streams.flat_rank16, streams.block_max,
                  streams.res_vals, streams.doc_bases)
    else:
        arrays = (streams.flat_docs16, streams.flat_code16,
                  streams.flat_rank16, streams.block_max, streams.res_vals)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


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
                        compressed: Optional[CompressedStreams] = None
                        ) -> QueryBatch:
    """Host-side planning: vocab lookups, group-level idf, chunk
    splitting. min_counts[i] = required matched clauses. compressed: the
    pack's streams, to fill the residual extents and slot→term ids."""
    b_real = len(queries)
    b = pad_batch_to or b_real
    if b < b_real:
        raise ValueError(
            f"pad_batch_to={b} < {b_real} queries (would drop queries)")
    s = pack.num_shards
    rows: List[List[Tuple[int, int, float, int]]] = []
    mins: List[int] = []
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
                r = vocab.get(term, -1)
                if r >= 0:
                    st = int(rstart[r])
                    ln = int(rstart[r + 1] - rstart[r])
                else:
                    st, ln = 0, 0
                row.append((st, ln, weights_r[tid], tid))
            rows.append(row)
            mins.append(int(min_counts[qi]) if min_counts is not None else 1)
    plan = sparse.plan_slots(rows, mins, chunk_cap=CHUNK_CAP)
    t_slots = plan.t_slots
    starts_a, lengths_a, weights_a = plan.starts, plan.lengths, plan.weights
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
                      res_starts=res_starts3, res_lens=res_lens3,
                      slot_terms=slot_terms3)


# ---------------------------------------------------------------------------
# the search step
# ---------------------------------------------------------------------------

def _local_body(flat_docs, flat_impact, starts, lengths, weights, min_count,
                *, max_len: int, d_pad: int, p_pad: int, k: int,
                t_window: int, with_counts: bool, variant: str, comp):
    """Score S shards × B queries in one sorted_merge_topk call → per
    query (vals [B, S·k'], gids int64 [B, S·k'], totals int32 [B]).

    flat_docs/flat_impact [S, P_pad]; starts/lengths/weights [S, B, T]
    (shard-relative starts); comp = (flat_rank, block_max, res_vals,
    res_starts, res_lens, slot_terms, doc_bases or None), flattened here
    with per-shard offsets. With doc_bases (delta doc stream) each slot's
    base cursor (dbs, dlo) derives from its shard-relative start."""
    dev = flat_docs.device
    s_l, b, t = starts.shape
    base = torch.arange(s_l, dtype=torch.int32, device=dev) * p_pad
    starts_abs = starts + base[:, None, None]
    r = s_l * b
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
    shard_ids = torch.arange(s_l, dtype=torch.int64, device=dev)
    gids = docs.to(torch.int64) + (shard_ids * (d_pad + 1))[:, None, None]
    vals_b = vals.permute(1, 0, 2).reshape(b, -1)
    gids_b = gids.permute(1, 0, 2).reshape(b, -1)
    return vals_b, gids_b, totals_b


def _merge_topk(vals_b, gids_b, k: int):
    """Cross-shard top-k, earliest index first among equal scores."""
    top_vals, pos = sparse.hierarchical_top_k(
        vals_b, min(k, vals_b.shape[1]))
    return top_vals, torch.gather(gids_b, 1, pos)


def make_local_search(*, max_len: int, d_pad: int, p_pad: int, k: int,
                      t_window: int, with_counts: bool = False,
                      variant: str = "compressed"):
    """Single-device search step: S shards × B queries → global top-k.
    The step takes the compressed image and the batch tensors on one
    device and returns (vals [B, k], gids [B, k], totals [B])."""
    if variant not in sparse.KERNEL_VARIANTS:
        raise ValueError(f"unknown kernel variant {variant!r}")

    def step(flat_docs, flat_impact, flat_rank, block_max, res_vals,
             starts, lengths, weights, res_starts, res_lens, slot_terms,
             min_count, doc_bases=None):
        vals_b, gids_b, totals_b = _local_body(
            flat_docs, flat_impact, starts, lengths, weights, min_count,
            max_len=max_len, d_pad=d_pad, p_pad=p_pad, k=k,
            t_window=t_window, with_counts=with_counts, variant=variant,
            comp=(flat_rank, block_max, res_vals, res_starts, res_lens,
                  slot_terms, doc_bases))
        top_vals, top_ids = _merge_topk(vals_b, gids_b, k)
        return top_vals, top_ids, totals_b

    return step


def distributed_search_raw(pack: StackedShardPack, batch: QueryBatch,
                           k: int, device_arrays: Tuple[torch.Tensor, ...],
                           with_counts: Optional[bool] = None,
                           t_window: Optional[int] = None,
                           materialize: bool = True,
                           variant: str = "compressed"):
    """One search step, raw outputs: numpy (vals [B, k'], gids int64
    [B, k'], totals [B]); materialize=False returns the device tensors
    without waiting. device_arrays is device_put_compressed's tuple (5
    tensors, or 6 with the delta doc stream); the batch must be prepared
    with compressed= streams."""
    if batch.res_starts is None:
        raise ValueError(
            "compressed variant needs a batch prepared with "
            "compressed= streams (res_starts/res_lens/slot_terms)")
    if with_counts is None:
        with_counts = batch.need_counts
    if t_window is None:
        t_window = batch.window
    elif t_window < batch.window:
        raise ValueError(f"t_window={t_window} < needed {batch.window}")
    dev = device_arrays[0].device
    fn = make_local_search(max_len=batch.max_len, d_pad=pack.d_pad,
                           p_pad=pack.p_pad, k=k, t_window=t_window,
                           with_counts=with_counts, variant=variant)
    bases = device_arrays[5:]
    put = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
           for a in (batch.starts, batch.lengths, batch.weights,
                     batch.res_starts, batch.res_lens, batch.slot_terms,
                     batch.min_count)]
    vals, ids, totals = fn(*device_arrays[:5], *put, *bases)
    if not materialize:
        return vals, ids, totals
    return vals.cpu().numpy(), ids.cpu().numpy(), totals.cpu().numpy()


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
