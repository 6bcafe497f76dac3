"""BM25 scoring and boolean-mask ops over one segment's padded doc axis.

Copy of the reference's ``ops/bm25.py`` (XLA code there, not a Pallas
kernel) as eager torch functions on the tensors' device: the planner's
dense evaluation (``search/planner.py``) runs them on the card.

  score_and_mask   B queries × T term slots → dense per-doc BM25 sums
                   f32[B, D_pad+1] and a term-presence bitmask
                   i32[B, D_pad+1] (bit t set ⇔ slot t matched the doc;
                   one term's postings never repeat a doc, so a
                   scatter-add of 1 << t is an exact OR)
  eval_bool_masks  must / must_not / should-msm over the bitmask
  range_mask_*     doc-value range filters (i64, f64)
  topk             top-k of a score row, ties to the lower doc
                   (sparse.hierarchical_top_k: the shard_topk kernel on a
                   CUDA tensor)
  mask_scores      match and live masks → -inf where either fails

Every op is eager and keeps the reference's rounding order: the impact
is (w·tf) / (tf + cache[norm]) in f32, and slots add into the row one
after another. The +1 column of score_and_mask is the drop slot of
padded lanes.
"""

from __future__ import annotations

from typing import Tuple

import torch

from elasticsearch_tpu_torch.ops import sparse
from elasticsearch_tpu_torch.ops.xla_math import xla_divf, xla_ftz, xla_mulf

NEG_INF = float("-inf")


def slot_bit(slot: int) -> int:
    """int32 ``1 << slot``: slot 31 is the sign bit, negative as in
    JAX."""
    return (1 << slot) if slot < 31 else -(1 << 31)


def score_and_mask(flat_docs: torch.Tensor, flat_tfs: torch.Tensor,
                   norms_u8: torch.Tensor, norm_cache: torch.Tensor,
                   starts: torch.Tensor, lengths: torch.Tensor,
                   idf_boost: torch.Tensor, *, max_len: int, d_pad: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """flat_docs/flat_tfs i32[P] (pad doc = d_pad), norms_u8 u8[d_pad],
    norm_cache f32[256], starts/lengths i32[B, T] (length 0 = absent
    term), idf_boost f32[B, T] (0 = non-scoring slot) → (scores
    f32[B, D_pad+1], termmask i32[B, D_pad+1]). Lanes past a row's
    length, or past the flat arrays' end, read the drop doc d_pad with
    tf 0."""
    dev = flat_docs.device
    b, t = starts.shape
    norms = norms_u8.to(torch.int64)
    idx = torch.arange(max_len, dtype=torch.int64, device=dev)
    rows = torch.arange(b, dtype=torch.int64, device=dev)[:, None] \
        .expand(b, max_len)
    n_flat = flat_docs.shape[0]
    scores = torch.zeros((b, d_pad + 1), dtype=torch.float32, device=dev)
    mask = torch.zeros((b, d_pad + 1), dtype=torch.int32, device=dev)
    for slot in range(t):
        start = starts[:, slot].to(torch.int64)
        length = lengths[:, slot].to(torch.int64)
        w = idf_boost[:, slot]
        pos = start[:, None] + idx[None, :]                        # [B, L]
        inside = (pos >= 0) & (pos < n_flat)
        safe = torch.clamp(pos, 0, max(n_flat - 1, 0))
        valid = inside & (idx[None, :] < length[:, None])
        docs = torch.where(valid, flat_docs[safe].to(torch.int64),
                           torch.full_like(pos, d_pad))
        tfs = torch.where(valid, flat_tfs[safe],
                          torch.zeros_like(flat_tfs[safe]))
        safe_docs = torch.clamp(docs, max=d_pad - 1)
        denom_add = norm_cache[norms[safe_docs]]                   # [B, L]
        tf = tfs.to(torch.float32)
        # each op rounded and flushed as XLA:CPU does (FTZ / DAZ)
        impact = xla_divf(xla_mulf(w[:, None], tf),
                          xla_ftz(tf + denom_add))
        hit = tfs > 0
        impact = torch.where(hit, impact, torch.zeros_like(impact))
        scores.index_put_((rows, docs), impact, accumulate=True)
        matched = torch.where(
            hit, torch.tensor(slot_bit(slot), dtype=torch.int32,
                              device=dev),
            torch.zeros((), dtype=torch.int32, device=dev))
        mask.index_put_((rows, docs), matched, accumulate=True)
    return scores, mask


def eval_bool_masks(termmask: torch.Tensor, must_masks: torch.Tensor,
                    must_not_mask: torch.Tensor, should_masks: torch.Tensor,
                    min_should_match: torch.Tensor) -> torch.Tensor:
    """Flat one-level boolean evaluation → bool[B, D]: every must clause
    (an OR of its slots; a 0 clause is neutral), no must_not slot, and
    at least min_should_match should clauses (0 clauses ignored)."""
    tm = termmask[:, None, :]
    must = must_masks[:, :, None]
    must_ok = torch.all(((tm & must) != 0) | (must == 0), dim=1)
    mn_ok = (termmask & must_not_mask[:, None]) == 0
    should = should_masks[:, :, None]
    should_hits = torch.sum(((tm & should) != 0) & (should != 0), dim=1)
    should_ok = should_hits >= min_should_match[:, None]
    return must_ok & mn_ok & should_ok


def range_mask_i64(col: torch.Tensor, lo: torch.Tensor,
                   hi: torch.Tensor) -> torch.Tensor:
    """col i64[D]; lo/hi i64[B] → bool[B, D]. The missing sentinel
    (int64 min) lies below any real bound."""
    return (col[None, :] >= lo[:, None]) & (col[None, :] <= hi[:, None])


def range_mask_f64(col: torch.Tensor, lo: torch.Tensor,
                   hi: torch.Tensor) -> torch.Tensor:
    ok = (col[None, :] >= lo[:, None]) & (col[None, :] <= hi[:, None])
    return ok & ~torch.isnan(col)[None, :]


def topk(scores: torch.Tensor, *, k: int
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k per row, equal scores in ascending doc order."""
    k = min(k, scores.shape[-1])
    return sparse.hierarchical_top_k(scores, k)


def mask_scores(scores: torch.Tensor, match: torch.Tensor,
                live: torch.Tensor) -> torch.Tensor:
    """-inf where the match mask or the live-docs mask fails."""
    ok = match & live[None, :]
    return torch.where(ok, scores, torch.full_like(scores, NEG_INF))
