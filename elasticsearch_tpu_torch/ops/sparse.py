"""Sorted-merge top-k: host helpers and the plain torch core.

Counterpart of ``elasticsearch_tpu/ops/sparse.py`` for the compressed
and the raw resident packs. The host half (code helpers, ``compress_flat``, the
delta doc stream, ``packable``, ``plan_slots``, ``eager_impacts``) is a
verbatim numpy copy. The device half is written in torch:

  * ``segmented_run_sum`` — the Hillis-Steele per-run prefix sum, op for
    op, so its f32 rounding tree is the reference's;
  * ``hierarchical_top_k`` — top-k with the earliest-index tie rule
    (``lax.top_k``), built on a stable descending sort;
  * ``_rank_decode``, ``_packed_rescore_topk`` and ``_merge_topk_core``
    for the ``compressed`` and ``compressed_exact`` variants on the
    compressed streams, and ``ref`` and ``packed`` on a raw pack (int32
    docs, f32 impacts).

Every sort that the reference runs through ``lax.sort`` (stable) or
``lax.top_k`` (earliest index wins) is a ``torch.sort(stable=True)`` on
explicit keys here; u32 sort keys ride as int64, because torch has few
uint32 ops. The result is bit-identical to the JAX package on the same
operands: scores compared as uint32, doc ids and totals exactly.

``sorted_merge_topk(variant=...)`` takes every variant of the
reference. On a CUDA tensor each launches its hand-written Hopper
kernels (``ops/merge_kernel.py``): the fused merge for
``compressed``/``pallas``, the exact merge and the shard top-k for
``compressed_exact`` (the gate for weights that fail ``packable()``),
the raw merge and the shard top-k for ``ref`` and ``packed``; on a CPU
tensor each runs the plain core below, ``merge_topk_core``, whose top-k
is ``top_k_plain``.

``union_topk`` merges the per-pack top-k columns of a delta chain on
the host (numpy), as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

NEG_INF = float("-inf")

#: doc-id field width of the packed sort key: doc ids (including the
#: d_pad sentinel) must be < 2**16 for the packed variants to apply
PACKED_DOC_LIMIT = 1 << 16

#: positive slot weights outside this range route to the exact-f32
#: variant (see packable())
PACKED_WEIGHT_MIN = 1e-12
PACKED_WEIGHT_MAX = 1e30

#: every variant of the reference: "ref"/"packed" read a raw pack
#: (int32 docs, f32 impacts), the others the compressed streams
KERNEL_VARIANTS = ("ref", "packed", "compressed", "compressed_exact",
                   "pallas")
COMPRESSED_VARIANTS = ("compressed", "compressed_exact", "pallas")

#: block-max metadata granularity (one max code per 128 postings lanes)
COMPRESSED_BLOCK = 128

#: per-term rank codes are u16 with 0 reserved for "no impact"
COMPRESSED_RANK_LIMIT = (1 << 16) - 1

#: widest doc-id span an aligned 128-lane block may cover and still take
#: the u8 delta encoding
DELTA_DOC_SPAN = (1 << 8) - 1

#: the plain core runs its rows in chunks of at most this many gathered
#: lanes, so a full serving batch stays within a few GiB of scratch
PLAIN_CHUNK_LANES = 1 << 25


# ---------------------------------------------------------------------------
# 16-bit value codes
# ---------------------------------------------------------------------------

def impact_code16(x: torch.Tensor) -> torch.Tensor:
    """Monotone 16-bit code of non-negative f32s (the top 16 bits of the
    bit pattern), as int64."""
    bits = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    return (bits & 0xFFFFFFFF) >> 16


def decode_code16(code: torch.Tensor) -> torch.Tensor:
    """Lower-bound f32 of each 16-bit code (zero low bits)."""
    bits = (code.to(torch.int64) << 16) & 0xFFFFFFFF
    return bits.to(torch.int32).view(torch.float32)


def impact_code16_np(x: np.ndarray) -> np.ndarray:
    """Host-side impact_code16: uint16 codes of non-negative f32s."""
    flat = np.ascontiguousarray(x, dtype=np.float32)
    return (flat.view(np.uint32) >> 16).astype(np.uint16)


def decode_code16_np(code: np.ndarray) -> np.ndarray:
    """Host-side decode_code16: lower-bound f32 of each uint16 code."""
    return (np.asarray(code).astype(np.uint32) << 16).view(np.float32)


# ---------------------------------------------------------------------------
# host-side stream construction (verbatim numpy)
# ---------------------------------------------------------------------------

def _posting_terms(row_starts: np.ndarray, n: int) -> np.ndarray:
    """Term id per flat posting position. Positions past the last row
    (the CHUNK_CAP slack tail) get the one-past-the-end id."""
    rs = np.asarray(row_starts, dtype=np.int64)
    counts = np.diff(rs)
    terms = np.repeat(np.arange(counts.size, dtype=np.int64), counts)
    if terms.size < n:
        terms = np.concatenate(
            [terms, np.full(n - terms.size, counts.size, dtype=np.int64)])
    return terms[:n]


def compress_reason(flat_docs: np.ndarray, flat_impact: np.ndarray,
                    row_starts: np.ndarray, d_pad: int) -> Optional[str]:
    """Why this shard's flats can NOT take the compressed resident
    format — None means compressible: doc ids (and the d_pad sentinel)
    fit 16 bits, every positive impact has a nonzero 16-bit value code,
    and no term exceeds the 16-bit rank space of distinct impacts."""
    if d_pad >= PACKED_DOC_LIMIT:
        return (f"d_pad {d_pad} does not fit the 16-bit doc stream "
                f"(limit {PACKED_DOC_LIMIT})")
    imp = np.asarray(flat_impact, dtype=np.float32)
    if imp.size == 0:
        return None
    if not np.isfinite(imp).all() or bool((imp < 0).any()):
        return "impacts must be finite and non-negative"
    codes = impact_code16_np(imp)
    pos = imp > 0
    if bool((codes[pos] == 0).any()):
        return "positive impact below the 16-bit code floor"
    terms = _posting_terms(row_starts, imp.size)
    t_p, v_p = terms[pos], imp[pos]
    if t_p.size:
        order = np.lexsort((v_p, t_p))
        t_s, v_s = t_p[order], v_p[order]
        first = np.ones(t_s.size, dtype=bool)
        first[1:] = (t_s[1:] != t_s[:-1]) | (v_s[1:] != v_s[:-1])
        per_term = np.bincount(t_s[first])
        if per_term.size and int(per_term.max()) > COMPRESSED_RANK_LIMIT:
            return (f"a term has more than {COMPRESSED_RANK_LIMIT} "
                    f"distinct impacts (rank code overflow)")
    return None


def compress_flat(flat_docs: np.ndarray, flat_impact: np.ndarray,
                  row_starts: np.ndarray, d_pad: int,
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                             np.ndarray, np.ndarray, np.ndarray]:
    """One shard's compressed resident streams from its doc-sorted
    flats → (docs16 u16[P], code16 u16[P], rank16 u16[P], block_max
    u16[NB+1], res_vals f32[RC], res_row_starts i64[n_rows+1]).
    Raises ValueError when compress_reason() is non-None."""
    reason = compress_reason(flat_docs, flat_impact, row_starts, d_pad)
    if reason is not None:
        raise ValueError(f"flats not compressible: {reason}")
    docs = np.asarray(flat_docs)
    imp = np.asarray(flat_impact, dtype=np.float32)
    n = imp.size
    docs16 = np.minimum(docs, d_pad).astype(np.uint16)
    code16 = impact_code16_np(imp)

    nb = (n + COMPRESSED_BLOCK - 1) // COMPRESSED_BLOCK
    padded = np.zeros(nb * COMPRESSED_BLOCK, dtype=np.uint16)
    padded[:n] = code16
    block_max = np.concatenate(
        [padded.reshape(nb, COMPRESSED_BLOCK).max(axis=1),
         np.zeros(1, dtype=np.uint16)])

    terms = _posting_terms(row_starts, n)
    n_rows = np.asarray(row_starts).size - 1
    pos = imp > 0
    t_p, v_p = terms[pos], imp[pos]
    order = np.lexsort((v_p, t_p))
    t_s, v_s = t_p[order], v_p[order]
    first = np.ones(t_s.size, dtype=bool)
    if t_s.size:
        first[1:] = (t_s[1:] != t_s[:-1]) | (v_s[1:] != v_s[:-1])
    res_row_starts = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(np.bincount(t_s[first], minlength=n_rows),
              out=res_row_starts[1:])
    rank16 = np.zeros(n, dtype=np.uint16)
    if t_s.size:
        distinct_idx = np.cumsum(first) - 1
        rank_sorted = distinct_idx - res_row_starts[t_s] + 1
        rank_pos = np.empty(t_s.size, dtype=np.int64)
        rank_pos[order] = rank_sorted
        rank16[pos] = rank_pos.astype(np.uint16)
    return (docs16, code16, rank16, block_max,
            v_s[first].astype(np.float32), res_row_starts)


def delta_doc_reason(flat_docs: np.ndarray, row_starts: np.ndarray,
                     ) -> Optional[str]:
    """Why this shard's doc stream can NOT take the per-block u8 delta
    encoding — None means every aligned 128-lane block of real postings
    spans ≤ DELTA_DOC_SPAN doc ids."""
    rs = np.asarray(row_starts, dtype=np.int64)
    total = int(rs[-1]) if rs.size else 0
    if total == 0:
        return None
    docs = np.asarray(flat_docs[:total], dtype=np.int64)
    nb = (total + COMPRESSED_BLOCK - 1) // COMPRESSED_BLOCK
    pad = nb * COMPRESSED_BLOCK - total
    mx = np.concatenate([docs, np.full(pad, -1, dtype=np.int64)])
    mn = np.concatenate([docs, np.full(pad, 1 << 30, dtype=np.int64)])
    span = (mx.reshape(nb, COMPRESSED_BLOCK).max(axis=1)
            - mn.reshape(nb, COMPRESSED_BLOCK).min(axis=1))
    worst = int(span.max())
    if worst > DELTA_DOC_SPAN:
        return (f"a {COMPRESSED_BLOCK}-lane block spans {worst} doc ids "
                f"(u8 delta limit {DELTA_DOC_SPAN})")
    return None


def delta_encode_docs(flat_docs: np.ndarray, row_starts: np.ndarray,
                      n_bases: int) -> Tuple[np.ndarray, np.ndarray]:
    """One shard's delta doc stream → (docs8 u8[P], bases u16[n_bases]):
    bases[j] is the minimum doc id of aligned block j, docs8[p] =
    doc − bases[p // 128]. Raises ValueError when delta_doc_reason() is
    non-None."""
    reason = delta_doc_reason(flat_docs, row_starts)
    if reason is not None:
        raise ValueError(f"doc stream not delta-encodable: {reason}")
    docs = np.asarray(flat_docs, dtype=np.int64)
    rs = np.asarray(row_starts, dtype=np.int64)
    total = int(rs[-1]) if rs.size else 0
    nb = (total + COMPRESSED_BLOCK - 1) // COMPRESSED_BLOCK
    if n_bases < nb:
        raise ValueError(f"n_bases {n_bases} < {nb} real blocks")
    bases = np.zeros(n_bases, dtype=np.uint16)
    docs8 = np.zeros(docs.size, dtype=np.uint8)
    if total:
        pad = nb * COMPRESSED_BLOCK - total
        mn = np.concatenate(
            [docs[:total], np.full(pad, 1 << 30, dtype=np.int64)]
        ).reshape(nb, COMPRESSED_BLOCK).min(axis=1)
        bases[:nb] = mn.astype(np.uint16)
        docs8[:total] = (docs[:total]
                         - np.repeat(mn, COMPRESSED_BLOCK)[:total]
                         ).astype(np.uint8)
    return docs8, bases


def packable(d_pad: int, weights: Optional[np.ndarray] = None) -> bool:
    """May the quantized single-key pipeline serve this (pack, batch)?
    Every doc id including the d_pad sentinel fits 16 bits, and every
    slot weight is finite, non-negative and, when positive, inside
    [PACKED_WEIGHT_MIN, PACKED_WEIGHT_MAX]."""
    if d_pad >= PACKED_DOC_LIMIT:
        return False
    if weights is not None:
        w = np.asarray(weights)
        if w.size:
            if not np.isfinite(w).all() or bool((w < 0).any()):
                return False
            pos = w[w > 0]
            if pos.size and (float(pos.min()) < PACKED_WEIGHT_MIN
                             or float(pos.max()) > PACKED_WEIGHT_MAX):
                return False
    return True


@dataclasses.dataclass
class SlotPlan:
    """Chunked term slots for a batch of rows (query × shard pairs)."""

    starts: np.ndarray    # int32[R, T]
    lengths: np.ndarray   # int32[R, T]
    weights: np.ndarray   # f32[R, T]
    min_count: np.ndarray  # int32[R]
    max_len: int          # L_c (static bucket)
    t_slots: int          # T
    window: int           # max same-doc entries per row = max terms/row


def _len_bucket(n: int, lane: int = 128) -> int:
    b = lane
    while b < n:
        b *= 2
    return b


def _cap_bucket(cap: int, lane: int) -> int:
    """Largest lane-based power-of-two bucket that does NOT exceed cap."""
    b = lane
    while b * 2 <= cap:
        b *= 2
    return b


def plan_slots(rows: Sequence[Sequence[Tuple[int, int, float, int]]],
               min_counts: Sequence[int],
               chunk_cap: int = 4096,
               lane: int = 128) -> SlotPlan:
    """rows[r] = [(start, length, weight, term_id), ...]. Long rows split
    into chunks of ≤ L_c = min(bucket(max row length), largest bucket ≤
    chunk_cap). Returns padded static-shape slot arrays."""
    longest = 1
    window = 1
    for row in rows:
        window = max(window, len(row))
        for (_, ln, _, _) in row:
            longest = max(longest, ln)
    max_len = min(_len_bucket(longest, lane), _cap_bucket(chunk_cap, lane))

    chunked: List[List[Tuple[int, int, float, int]]] = []
    t_needed = 1
    for row in rows:
        out = []
        for (s, ln, w, tid) in row:
            off = 0
            while off < ln:
                take = min(max_len, ln - off)
                out.append((s + off, take, w, tid))
                off += take
            if ln == 0:
                # empty terms stay as zero-length slots so min_count
                # semantics see the term as present-but-unmatched
                out.append((s, 0, w, tid))
        chunked.append(out)
        t_needed = max(t_needed, len(out))
    t_slots = 1
    while t_slots < t_needed:
        t_slots *= 2

    r = len(rows)
    starts = np.zeros((r, t_slots), dtype=np.int32)
    lengths = np.zeros((r, t_slots), dtype=np.int32)
    weights = np.zeros((r, t_slots), dtype=np.float32)
    for ri, out in enumerate(chunked):
        for ti, (s, ln, w, _tid) in enumerate(out[:t_slots]):
            starts[ri, ti] = s
            lengths[ri, ti] = ln
            weights[ri, ti] = w
    return SlotPlan(starts, lengths, weights,
                    np.asarray(min_counts, dtype=np.int32), max_len, t_slots,
                    window)


def eager_impacts(flat_docs: np.ndarray, flat_tfs: np.ndarray,
                  norms_u8: np.ndarray, k1: float, b: float,
                  avgdl: float) -> np.ndarray:
    """Per-posting BM25 impacts tf / (tf + k1·(1 − b + b·dl/avgdl))."""
    from elasticsearch_tpu_torch.ops.smallfloat import LENGTH_TABLE
    d = norms_u8.shape[0]
    safe = np.minimum(flat_docs, d - 1)
    dl = LENGTH_TABLE[norms_u8[safe].astype(np.int64)].astype(np.float32)
    denom_add = (k1 * (1.0 - b + b * dl / (avgdl if avgdl > 0 else 1.0))
                 ).astype(np.float32)
    tf = flat_tfs.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        imp = tf / (tf + denom_add)
    return np.where(flat_tfs > 0, imp, 0.0).astype(np.float32)


# ---------------------------------------------------------------------------
# plain torch device functions
# ---------------------------------------------------------------------------

def hierarchical_top_k(score: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's hierarchical_top_k over [R, L]: its per-block
    split runs only on a TPU and selects exactly what a flat top_k does,
    so this is lax.top_k — the min(k, L) largest values, equal values in
    ascending index order. A CUDA tensor launches the shard_topk kernel
    (ops/merge_kernel.py); a CPU tensor takes top_k_plain."""
    from elasticsearch_tpu_torch.ops import merge_kernel
    return merge_kernel.shard_topk(score, k)


def top_k_plain(score: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """hierarchical_top_k as a stable descending sort on whatever device
    the tensor lies: the plain pipeline's top-k. It sorts by the IEEE
    total order of the f32 bits, as lax.top_k ranks: -NaN below -inf,
    +NaN above +inf, -0 below +0."""
    kk = min(k, score.shape[1])
    u = score.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)
    _, pos = torch.sort(key, dim=1, descending=True, stable=True)
    pos = pos[:, :kk]
    return torch.gather(score, 1, pos), pos


def _gather(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr[idx] with integer streams widened to int64. u16 streams are
    read through an int16 view (u16 indexing is not implemented on every
    device) and masked back to 16 bits."""
    if arr.dtype == torch.uint16:
        return arr.view(torch.int16)[idx].to(torch.int64) & 0xFFFF
    vals = arr[idx]
    if vals.dtype != torch.float32:
        vals = vals.to(torch.int64)
    return vals


def _take(arr: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """jnp.take(arr, idx, mode="fill"): out-of-range indices read `fill`."""
    n = arr.shape[0]
    ok = (idx >= 0) & (idx < n)
    vals = _gather(arr, torch.clamp(idx, 0, max(n - 1, 0)))
    return torch.where(ok, vals, torch.as_tensor(fill, dtype=vals.dtype,
                                                 device=vals.device))


def _rank_decode(ranks: torch.Tensor, r_start: torch.Tensor,
                 r_len: torch.Tensor, res_vals: torch.Tensor
                 ) -> torch.Tensor:
    """Exact f32 impact of each posting from its per-term rank code:
    rank r ≥ 1 reads res_vals[r_start + r − 1]; rank 0 decodes to 0.0."""
    ok = (ranks > 0) & (ranks <= r_len)
    at = r_start + torch.clamp(ranks, min=1) - 1
    vals = _take(res_vals, at, 0.0)
    return torch.where(ok, vals, torch.zeros_like(vals))


def segmented_run_sum(sk: torch.Tensor, sv: torch.Tensor,
                      t_window: int) -> torch.Tensor:
    """Inclusive per-run prefix sums over a key-sorted [R, L] pair via
    Hillis-Steele doubling (the reference's exact op sequence)."""
    length = sk.shape[1]
    total = sv
    step = 1
    while step < t_window:
        shifted_t = torch.nn.functional.pad(total, (step, 0))[:, :length]
        shifted_k = torch.nn.functional.pad(sk, (step, 0),
                                            value=-1)[:, :length]
        total = total + torch.where(shifted_k == sk, shifted_t,
                                    torch.zeros_like(shifted_t))
        step *= 2
    return total


def _window(stream: torch.Tensor, starts: torch.Tensor,
            width: int) -> torch.Tensor:
    """[R, T, width] windows of a flat stream at each slot start, with
    dynamic_slice's clamp of the start into [0, len − width]."""
    n = stream.shape[0]
    s = torch.clamp(starts.to(torch.int64), 0, max(n - width, 0))
    idx = s[..., None] + torch.arange(width, dtype=torch.int64,
                                      device=stream.device)
    return _gather(stream, idx)


def _lane_decode(flat_docs, flat_impact, starts, lengths, weights, *,
                 max_len: int, d_pad: int, exact: bool, flat_rank=None,
                 res_starts=None, res_lens=None, res_vals=None,
                 doc_bases=None, dbs_starts=None, dlo_starts=None):
    """Stage 1: gather every slot's window and decode lane docs and
    weighted lane values → (docs int64[R,T,L], imp f32[R,T,L]). An f32
    flat_impact is a raw pack's: its lanes are w · impact as they lie."""
    dev = starts.device
    idx = torch.arange(max_len, dtype=torch.int64, device=dev)
    docs = _window(flat_docs, starts, max_len).to(torch.int64)
    valid = idx[None, None, :] < lengths[:, :, None]
    pad = torch.full_like(docs, d_pad)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if flat_impact.dtype == torch.float32:
        # a raw pack: int32 docs, f32 impacts
        imps = _window(flat_impact, starts, max_len)
        return (torch.where(valid, docs, pad),
                torch.where(valid, weights[:, :, None] * imps, zero))
    codes = _window(flat_impact, starts, max_len).to(torch.int64)
    if doc_bases is not None:
        nb_slice = max_len // COMPRESSED_BLOCK + 2
        n_bd = doc_bases.shape[0]
        dbs = torch.clamp(dbs_starts.to(torch.int64), 0,
                          max(n_bd - nb_slice, 0))
        lane_blk = torch.div(dlo_starts.to(torch.int64)[:, :, None] + idx,
                             COMPRESSED_BLOCK, rounding_mode="floor")
        lane_base = _gather(doc_bases, dbs[:, :, None] + lane_blk)
        docs = torch.where(valid, lane_base + docs, pad)
    else:
        docs = torch.where(valid, docs, pad)
    codes = torch.where(valid, codes, torch.zeros_like(codes))
    w3 = weights[:, :, None]
    if exact:
        ranks = _window(flat_rank, starts, max_len).to(torch.int64)
        ranks = torch.where(valid, ranks, torch.zeros_like(ranks))
        lane_exact = _rank_decode(ranks, res_starts.to(torch.int64)[:, :, None],
                                  res_lens.to(torch.int64)[:, :, None],
                                  res_vals)
        imp = torch.where(valid, w3 * lane_exact, zero)
    else:
        imp = torch.where(valid, w3 * decode_code16(codes), zero)
    return docs, imp


def group_bounds(lengths, weights, block_max, blk_starts, *, max_len: int):
    """Per-128-lane group upper bounds of every slot and their max per
    slot → (grp_ub f32[R,T,G], slot_ub f32[R,T])."""
    dev = lengths.device
    n_grp = (max_len + COMPRESSED_BLOCK - 1) // COMPRESSED_BLOCK
    bm = _window(block_max, blk_starts, n_grp + 1).to(torch.int64)
    grp_code = torch.maximum(bm[..., :-1], bm[..., 1:])
    # the clamp keeps the +1 from wrapping past the f32 space
    ub = decode_code16(torch.clamp(grp_code + 1, max=0x7F80))
    g_base = (torch.arange(n_grp, dtype=torch.int64, device=dev)
              * COMPRESSED_BLOCK)[None, None, :]
    g_valid = g_base < lengths[:, :, None]
    w3 = weights[:, :, None]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    grp_ub = torch.where(g_valid & (w3 > 0), w3 * ub, zero)
    return grp_ub, grp_ub.max(dim=2).values


def slot_kth(imp, lengths, kk: int):
    """Each slot's kk-th largest lane lower bound, −inf for a slot of
    fewer than kk lanes (it cannot set the row threshold) → f32[R,T]."""
    kth = torch.topk(imp, kk, dim=2).values[..., kk - 1]
    return torch.where(lengths >= kk, kth, torch.full_like(kth, NEG_INF))


def _skip_bounds(imp, lengths, weights, min_count, block_max, blk_starts,
                 slot_terms, *, max_len: int, kk: int, with_counts: bool):
    """Stage 2a: per-128-lane group upper bounds, the per-slot bound of
    every OTHER term, and the row threshold (the k-th best lane lower
    bound of a long-enough slot) → (grp_ub f32[R,T,G], others f32[R,T],
    thr f32[R])."""
    dev = imp.device
    t_slots = lengths.shape[1]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    grp_ub, slot_ub = group_bounds(lengths, weights, block_max, blk_starts,
                                   max_len=max_len)
    if slot_terms is not None:
        # a doc appears in at most ONE chunk of a term: max over a
        # term's slots, sum over distinct terms
        eq = slot_terms[:, :, None] == slot_terms[:, None, :]
        term_ub = torch.where(eq, slot_ub[:, None, :], zero).max(dim=2).values
        tri = torch.tril(torch.ones((t_slots, t_slots), dtype=torch.bool,
                                    device=dev), diagonal=-1)
        first = ~torch.any(eq & tri[None], dim=2)
        others = (torch.where(first, term_ub, zero).sum(dim=1, keepdim=True)
                  - term_ub)
    else:
        others = slot_ub.sum(dim=1, keepdim=True) - slot_ub
    thr = slot_kth(imp, lengths, kk).max(dim=1).values     # [R]
    if with_counts:
        thr = torch.where(min_count <= 1, thr, torch.full_like(thr, NEG_INF))
    return grp_ub, others, thr


def _apply_skip(docs, imp, grp_ub, others, thr, *, max_len: int,
                d_pad: int):
    """Stage 2b: mask every lane of a group whose bound plus the other
    terms' bounds stays strictly below the row threshold."""
    idx = torch.arange(max_len, dtype=torch.int64, device=docs.device)
    skip_grp = (grp_ub + others[:, :, None]) < thr[:, None, None]
    lane_skip = skip_grp[:, :, idx // COMPRESSED_BLOCK]
    docs = torch.where(lane_skip, torch.full_like(docs, d_pad), docs)
    imp = torch.where(lane_skip, torch.zeros_like(imp), imp)
    return docs, imp


def _count_totals(docs, imp, min_count, *, d_pad: int, t_window: int,
                  with_counts: bool) -> torch.Tensor:
    """Exact TotalHits from the PRE-skip lanes: one u32 sort of
    (doc << 1 | positive-code bit) plus the run machinery."""
    r = docs.shape[0]
    posb = (impact_code16(imp) > 0).to(torch.int64)
    ckey = torch.sort(((docs << 1) | posb).reshape(r, -1), dim=1).values
    cdoc = ckey >> 1
    cpos = (ckey & 1).to(torch.float32)
    c_end = torch.cat([cdoc[:, :-1] != cdoc[:, 1:],
                       torch.ones((r, 1), dtype=torch.bool,
                                  device=docs.device)], dim=1)
    c_ok = c_end & (cdoc < d_pad) & (
        segmented_run_sum(cdoc, cpos, t_window) > 0)
    if with_counts:
        c_cnt = segmented_run_sum(cdoc, torch.ones_like(cpos), t_window)
        c_ok = c_ok & (c_cnt >= min_count[:, None].to(torch.float32))
    return c_ok.sum(dim=1).to(torch.int32)


def _key_sort(docs, imp):
    """Stage 3: ONE u32 key per lane, doc high and value code low, sorted
    per row → (sk int64[R, L], sv f32[R, L])."""
    r = docs.shape[0]
    key = ((docs << 16) | impact_code16(imp)).reshape(r, -1)
    sk_key = torch.sort(key, dim=1).values
    return sk_key >> 16, decode_code16(sk_key & 0xFFFF)


def _run_totals(sk, sv, min_count, *, d_pad: int, t_window: int,
                with_counts: bool, need_cnt: bool):
    """Stage 4: run sums over the sorted lanes → (score f32[R, L] with
    -inf off the matching run ends, cnt f32[R, L] or None, totals
    int32[R])."""
    r = sk.shape[0]
    total = segmented_run_sum(sk, sv, t_window)
    run_end = torch.cat([sk[:, :-1] != sk[:, 1:],
                         torch.ones((r, 1), dtype=torch.bool,
                                    device=sk.device)], dim=1)
    ok = run_end & (sk < d_pad) & (total > 0)
    cnt = None
    if with_counts or need_cnt:
        # clause count per doc = run length (≤ t_window by construction)
        cnt = segmented_run_sum(sk, torch.ones_like(sv), t_window)
    if with_counts:
        ok = ok & (cnt >= min_count[:, None].to(torch.float32))
    totals = ok.sum(dim=1).to(torch.int32)
    score = torch.where(ok, total, torch.full_like(total, NEG_INF))
    return score, cnt, totals


def _packed_rescore_topk(flat_docs, starts, lengths, weights, sk, score,
                         cnt, kk, *, max_len: int, d_pad: int,
                         t_window: int, res=None, delta=None,
                         flat_impact=None):
    """Stage 5: candidate selection over the quantized run totals (with
    the reference's slack: doubled for the compressed streams, which
    quantize twice), exact rescore through the residual tables (res) or
    from a raw pack's f32 impacts (flat_impact), and the final (−score,
    doc) order. The rescore sums the matched contributions in slot order
    with the SAME log-step tree as segmented_run_sum, so the scores equal
    the reference's bit for bit."""
    dev = sk.device
    r, t_slots = starts.shape
    length = sk.shape[1]
    slack = max(2 * kk, 256) if res is not None else max(2 * kk, 128)
    kc = min(length, kk + slack)
    a_vals, a_pos = top_k_plain(score, kc)
    cand_docs = torch.gather(sk, 1, a_pos)                      # [R, kc]
    cand_cnt = torch.gather(cnt, 1, a_pos).to(torch.int64)

    st3 = starts.to(torch.int64)[:, None, :]
    ln3 = lengths.to(torch.int64)[:, None, :].expand(r, kc, t_slots)
    lo = st3.expand(r, kc, t_slots)
    end = lo + ln3
    hi = end
    target = cand_docs[:, :, None]
    if delta is None:
        def doc_at(pos):
            return _take(flat_docs, pos, d_pad)
    else:
        d_bases, dbs, dlo = delta
        dbs3 = dbs.to(torch.int64)[:, None, :]
        dlo3 = dlo.to(torch.int64)[:, None, :]

        def doc_at(pos):
            jrel = pos - st3
            bidx = dbs3 + torch.div(dlo3 + jrel, COMPRESSED_BLOCK,
                                    rounding_mode="floor")
            base = _take(d_bases, bidx, 0)
            dd = _take(flat_docs, pos, 0)
            inside = (jrel >= 0) & (jrel < ln3)
            return torch.where(inside, base + dd,
                               torch.full_like(dd, d_pad))
    for _ in range(max(1, int(max_len).bit_length())):
        active = lo < hi
        mid = (lo + hi) >> 1
        go = doc_at(mid) < target
        lo = torch.where(active & go, mid + 1, lo)
        hi = torch.where(active & ~go, mid, hi)
    v = doc_at(lo)
    found = (ln3 > 0) & (lo < end) & (v == target) & (target < d_pad)
    if res is None:
        imp_exact = _take(flat_impact, lo, 0.0)
    else:
        res_st, res_ln, r_vals, f_rank = res
        rank_at = _take(f_rank, lo, 0)
        imp_exact = _rank_decode(rank_at,
                                 res_st.to(torch.int64)[:, None, :],
                                 res_ln.to(torch.int64)[:, None, :], r_vals)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    contrib = torch.where(found, weights[:, None, :] * imp_exact, zero)

    # compact matched slots to the front in slot order (a stable sort on
    # the found flag), then the reference's tree over the run length
    flat_rc = (r * kc, t_slots)
    comp_order = torch.sort(
        torch.where(found, 0, 1).reshape(flat_rc), dim=1,
        stable=True).indices
    comp_val = torch.gather(contrib.reshape(flat_rc), 1, comp_order)
    run_pos = torch.arange(t_slots, dtype=torch.int64, device=dev)[None, :]
    m = cand_cnt.reshape(r * kc, 1)
    scan_keys = torch.where(run_pos < m, torch.zeros_like(run_pos),
                            run_pos + 1)
    scan_tot = segmented_run_sum(scan_keys, comp_val, t_window)
    gather_at = torch.clamp(m - 1, 0, t_slots - 1)
    exact = torch.gather(scan_tot, 1, gather_at).reshape(r, kc)
    exact = torch.where(a_vals > NEG_INF, exact,
                        torch.full_like(exact, NEG_INF))

    # final order on exact scores, equal scores → smaller doc id; -inf
    # lanes pinned to (+inf, d_pad) so they tail-sort identically
    live = exact > NEG_INF
    neg = torch.where(live, -exact, torch.full_like(exact, float("inf")))
    docs_key = torch.where(live, cand_docs, torch.full_like(cand_docs, d_pad))
    o1 = torch.sort(docs_key, dim=1, stable=True).indices
    o2 = torch.sort(torch.gather(neg, 1, o1), dim=1, stable=True).indices
    order = torch.gather(o1, 1, o2)
    neg_s = torch.gather(neg, 1, order)[:, :kk]
    docs_s = torch.gather(docs_key, 1, order)[:, :kk]
    vals = torch.where(torch.isinf(neg_s), torch.full_like(neg_s, NEG_INF),
                       -neg_s)
    hit_docs = torch.where(vals > NEG_INF, docs_s,
                           torch.full_like(docs_s, d_pad))
    return vals, hit_docs.to(torch.int32)


def sorted_merge_topk(
    flat_docs: torch.Tensor,    # u16[P] doc ids, or u8[P] deltas with
                                # doc_bases; int32[P] on a raw pack
    flat_impact: torch.Tensor,  # u16[P] value codes; f32[P] on a raw pack
    starts: torch.Tensor,       # int32[R, T] absolute offsets into the streams
    lengths: torch.Tensor,      # int32[R, T] chunk lengths (0 = empty slot)
    weights: torch.Tensor,      # f32[R, T] idf·(k1+1)·boost per slot
    min_count: torch.Tensor,    # int32[R] minimum matched clauses (msm/AND)
    *,
    max_len: int,
    d_pad: int,
    k: int,
    t_window: int,
    with_counts: bool,
    with_totals: bool = False,
    variant: str = "compressed",
    flat_rank: Optional[torch.Tensor] = None,   # u16[P] per-term ranks
    res_starts: Optional[torch.Tensor] = None,  # int32[R, T]
    res_lens: Optional[torch.Tensor] = None,    # int32[R, T]
    res_vals: Optional[torch.Tensor] = None,    # f32[RC]
    block_max: Optional[torch.Tensor] = None,   # u16[NB+1]
    blk_starts: Optional[torch.Tensor] = None,  # int32[R, T]
    slot_terms: Optional[torch.Tensor] = None,  # int32[R, T]
    doc_bases: Optional[torch.Tensor] = None,   # u16[NBD]
    dbs_starts: Optional[torch.Tensor] = None,  # int32[R, T]
    dlo_starts: Optional[torch.Tensor] = None,  # int32[R, T]
) -> Tuple[torch.Tensor, ...]:
    """→ (scores f32[R, k'], doc_ids int32[R, k'][, totals int32[R]]);
    empty lanes are (-inf, d_pad), k' = min(k, T·L_c). Same operands,
    gates and bits as the reference's sorted_merge_topk. "ref" and
    "packed" read a raw pack; "packed" needs d_pad < 2**16."""
    if variant not in KERNEL_VARIANTS:
        raise ValueError(f"unknown kernel variant {variant!r}")
    compressed = variant in COMPRESSED_VARIANTS
    if variant != "ref" and d_pad >= PACKED_DOC_LIMIT:
        raise ValueError(
            f"variant {variant!r} needs d_pad < {PACKED_DOC_LIMIT}, got "
            f"{d_pad} — caller must fall back to variant='ref'")
    if compressed and (flat_rank is None or res_starts is None
                       or res_lens is None or res_vals is None):
        raise ValueError(
            "compressed variants need flat_rank/res_starts/res_lens/"
            "res_vals — build them with compress_flat()")
    if doc_bases is not None and (dbs_starts is None or dlo_starts is None):
        raise ValueError(
            "delta doc stream needs dbs_starts/dlo_starts alongside "
            "doc_bases")
    kw = dict(
        max_len=max_len, d_pad=d_pad, k=k, t_window=t_window,
        with_counts=with_counts, with_totals=with_totals,
        flat_rank=flat_rank, res_starts=res_starts, res_lens=res_lens,
        res_vals=res_vals, block_max=block_max, blk_starts=blk_starts,
        slot_terms=slot_terms, doc_bases=doc_bases,
        dbs_starts=dbs_starts, dlo_starts=dlo_starts)
    from elasticsearch_tpu_torch.ops import merge_kernel
    if variant in ("compressed", "pallas"):
        return merge_kernel.fused_merge_topk(
            flat_docs, flat_impact, starts, lengths, weights, min_count,
            **kw)
    if variant == "compressed_exact":
        return merge_kernel.exact_merge_topk(
            flat_docs, flat_impact, starts, lengths, weights, min_count,
            **kw)
    return merge_kernel.raw_merge_topk(
        flat_docs, flat_impact, starts, lengths, weights, min_count,
        packed=variant == "packed", **kw)


def merge_topk_core(flat_docs, flat_impact, starts, lengths, weights,
                    min_count, *, max_len: int, d_pad: int, k: int,
                    t_window: int, with_counts: bool, with_totals: bool,
                    variant: str, **optional) -> Tuple[torch.Tensor, ...]:
    """The plain torch pipeline for `variant` (any but "pallas"), run
    over row chunks so the gathered [R, T, L]
    scratch stays bounded. Rows are independent, so chunking changes no
    bit of the result."""
    r, t_slots = starts.shape
    rows = max(1, PLAIN_CHUNK_LANES // max(1, t_slots * max_len))
    per_row = ("res_starts", "res_lens", "blk_starts", "slot_terms",
               "dbs_starts", "dlo_starts")
    outs = []
    for a in range(0, max(r, 1), rows):
        sl = slice(a, a + rows)
        opt = {name: (val[sl] if name in per_row and val is not None
                      else val) for name, val in optional.items()}
        outs.append(_merge_topk_core(
            flat_docs, flat_impact, starts[sl], lengths[sl], weights[sl],
            min_count[sl], max_len=max_len, d_pad=d_pad, k=k,
            t_window=t_window, with_counts=with_counts,
            with_totals=with_totals, variant=variant, **opt))
    return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))


def _merge_topk_core(
    flat_docs, flat_impact, starts, lengths, weights, min_count, *,
    max_len: int, d_pad: int, k: int, t_window: int, with_counts: bool,
    with_totals: bool, variant: str, flat_rank=None, res_starts=None,
    res_lens=None, res_vals=None, block_max=None, blk_starts=None,
    slot_terms=None, doc_bases=None, dbs_starts=None, dlo_starts=None,
) -> Tuple[torch.Tensor, ...]:
    """The reference's _merge_topk_core in torch ops, stage by stage:
    "ref" and "compressed_exact" sort exact f32 lanes by doc and take
    their top-k; "packed" and "compressed" sort one quantized key a lane
    and rescore their candidates exactly."""
    r, t_slots = starts.shape
    exact = variant in ("ref", "compressed_exact")
    docs, imp = _lane_decode(
        flat_docs, flat_impact, starts, lengths, weights, max_len=max_len,
        d_pad=d_pad, exact=variant == "compressed_exact",
        flat_rank=flat_rank,
        res_starts=res_starts, res_lens=res_lens, res_vals=res_vals,
        doc_bases=doc_bases, dbs_starts=dbs_starts, dlo_starts=dlo_starts)
    length = t_slots * max_len
    kk = min(k, length)

    do_skip = (variant == "compressed" and block_max is not None
               and blk_starts is not None and k <= max_len)
    skip_totals = None
    if do_skip and with_totals:
        skip_totals = _count_totals(docs, imp, min_count, d_pad=d_pad,
                                    t_window=t_window,
                                    with_counts=with_counts)
    if do_skip:
        grp_ub, others, thr = _skip_bounds(
            imp, lengths, weights, min_count, block_max, blk_starts,
            slot_terms, max_len=max_len, kk=kk, with_counts=with_counts)
        docs, imp = _apply_skip(docs, imp, grp_ub, others, thr,
                                max_len=max_len, d_pad=d_pad)

    if exact:
        # the reference pipeline on exact f32 lanes: one stable
        # (doc, value) sort by doc
        order = torch.sort(docs.reshape(r, length), dim=1,
                           stable=True).indices
        sk = torch.gather(docs.reshape(r, length), 1, order)
        sv = torch.gather(imp.reshape(r, length), 1, order)
    else:
        sk, sv = _key_sort(docs, imp)
    score, cnt, totals = _run_totals(
        sk, sv, min_count, d_pad=d_pad, t_window=t_window,
        with_counts=with_counts, need_cnt=not exact)
    if skip_totals is not None:
        totals = skip_totals

    if exact:
        vals, pos = top_k_plain(score, kk)
        hit_docs = torch.gather(sk, 1, pos)
        hit_docs = torch.where(vals > NEG_INF, hit_docs,
                               torch.full_like(hit_docs, d_pad))
        hit_docs = hit_docs.to(torch.int32)
    else:
        delta = None
        if doc_bases is not None:
            delta = (doc_bases, dbs_starts, dlo_starts)
        res = None
        if variant == "compressed":
            res = (res_starts, res_lens, res_vals, flat_rank)
        vals, hit_docs = _packed_rescore_topk(
            flat_docs, starts, lengths, weights, sk, score, cnt, kk,
            max_len=max_len, d_pad=d_pad, t_window=t_window, res=res,
            delta=delta, flat_impact=flat_impact)
    if with_totals:
        return vals, hit_docs, totals
    return vals, hit_docs


def union_topk(scores_list, rows_list, ords_list, row_offsets, k: int):
    """Union of per-pack kernel top-k columns (the streaming delta path).

    The base pack and each delta pack run the kernel on their own; a doc
    lives in exactly one pack (deltas are append-only: an update of a
    committed doc forces a full rebuild), so the union is a k-way top-k
    over disjoint candidates: no dedup, totals add. Rows re-base into
    the concatenated row space by ``row_offsets`` (each pack's first
    row). Ties break by (score desc, pack order, in-pack rank): the
    result is deterministic and the identity for one operand. Host
    numpy, as the reference's."""
    scores = np.concatenate([np.asarray(s) for s in scores_list])
    rows = np.concatenate(
        [np.asarray(r, dtype=np.int64) + int(off)
         for r, off in zip(rows_list, row_offsets)])
    ords = np.concatenate([np.asarray(o) for o in ords_list])
    pack_tag = np.concatenate(
        [np.full(len(np.asarray(s)), i, dtype=np.int32)
         for i, s in enumerate(scores_list)])
    rank = np.concatenate(
        [np.arange(len(np.asarray(s)), dtype=np.int32)
         for s in scores_list])
    order = np.lexsort((rank, pack_tag, -scores))[:k]
    return scores[order], rows[order], ords[order]
