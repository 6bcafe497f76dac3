"""Seeded numpy corpora and compressed operands for the port's merge-kernel
tests. Imports no JAX, so the GPU tests can use it on a machine without
it; the parity tests hand the same arrays to both packages."""

import json
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.ops import sparse

#: slack past the last posting: covers the widest max_len bucket (4096)
SLACK = 4352


def make_flat(rng, n_terms, d_pad, max_df, slack=SLACK):
    """n_terms sorted postings rows of random docs with impacts in
    [0.1, 1) → (flat_docs i32, flat_imp f32, [(start, length)])."""
    sizes = [int(rng.integers(1, max_df)) for _ in range(n_terms)]
    total = sum(sizes)
    flat_docs = np.full(total + slack, d_pad, dtype=np.int32)
    flat_imp = np.zeros(total + slack, dtype=np.float32)
    pos = 0
    extents = []
    for sz in sizes:
        docs = np.sort(rng.choice(d_pad, size=sz, replace=False))
        flat_docs[pos:pos + sz] = docs
        flat_imp[pos:pos + sz] = rng.uniform(0.1, 1.0, size=sz)
        extents.append((pos, sz))
        pos += sz
    return flat_docs, flat_imp, extents


def make_heavy_flat(rng, d_pad, dfs, skew=3.0):
    """Long skewed postings: most blocks' maxima sit far below the k-th
    best score, so the block-max skip has work to do."""
    docs_all, imps_all, ext = [], [], []
    pos = 0
    for df in dfs:
        ds = np.sort(rng.choice(d_pad, size=df, replace=False)).astype(
            np.int32)
        im = (rng.random(df).astype(np.float32) ** skew * 0.9
              + 0.01).astype(np.float32)
        docs_all.append(ds)
        imps_all.append(im)
        ext.append((pos, df))
        pos += df
    flat_docs = np.concatenate(docs_all + [np.full(SLACK, d_pad, np.int32)])
    flat_imp = np.concatenate(imps_all + [np.zeros(SLACK, np.float32)])
    return flat_docs, flat_imp, ext


def make_case(rng, *, tie_heavy=False):
    """Random corpus + one query row: OR, msm or AND, small k."""
    d_pad = int(rng.integers(200, 5000))
    n_terms = int(rng.integers(2, 7))
    max_df = max(2, min(d_pad - 1, int(rng.integers(20, 800))))
    flat_docs, flat_imp, ext = make_flat(rng, n_terms, d_pad, max_df)
    if tie_heavy:
        flat_imp = (np.ceil(flat_imp * 8.0) / 8.0).astype(np.float32)
    weights = [float(rng.uniform(0.2, 4.0)) for _ in range(n_terms)]
    if tie_heavy:
        weights = [1.0] * n_terms
    rows = [[(ext[t][0], ext[t][1], weights[t], t)
             for t in range(n_terms)]]
    mc = int(rng.integers(1, n_terms + 1))
    k = int(rng.integers(1, 64))
    return flat_docs, flat_imp, rows, [mc], d_pad, k, ext


def row_starts_of(ext) -> np.ndarray:
    rs = [pos for pos, _ in ext] + [ext[-1][0] + ext[-1][1]]
    return np.asarray(rs, dtype=np.int64)


def compressed_operands(flat_docs, flat_imp, ext, d_pad, plan,
                        delta: Optional[bool] = None):
    """Compress the corpus and derive the per-slot operands (the
    prepare_query_batch mirror) → (doc stream, code16, {name: array}).
    delta=None takes the u8 delta doc stream whenever the gate passes."""
    rs = row_starts_of(ext)
    reason = sparse.compress_reason(flat_docs, flat_imp, rs, d_pad)
    assert reason is None, reason
    docs16, code16, rank16, block_max, res_vals, res_rs = \
        sparse.compress_flat(flat_docs, flat_imp, rs, d_pad)
    rr = (np.searchsorted(rs, plan.starts, side="right") - 1).astype(
        np.int32)
    rr = np.clip(rr, 0, len(ext) - 1)
    res_starts = res_rs[rr].astype(np.int32)
    res_lens = (res_rs[rr + 1] - res_rs[rr]).astype(np.int32)
    res_lens[plan.lengths == 0] = 0
    blk = (plan.starts // sparse.COMPRESSED_BLOCK).astype(np.int32)
    extra: Dict[str, np.ndarray] = dict(
        flat_rank=rank16, res_starts=res_starts, res_lens=res_lens,
        res_vals=res_vals, block_max=block_max, blk_starts=blk,
        slot_terms=rr)
    doc_stream = docs16
    eligible = sparse.delta_doc_reason(flat_docs, rs) is None
    if eligible and delta is not False:
        nbd = (flat_docs.size + sparse.COMPRESSED_BLOCK - 1) \
            // sparse.COMPRESSED_BLOCK + 2
        docs8, bases = sparse.delta_encode_docs(flat_docs, rs, nbd)
        extra.update(
            doc_bases=bases,
            dbs_starts=(plan.starts // sparse.COMPRESSED_BLOCK).astype(
                np.int32),
            dlo_starts=(plan.starts % sparse.COMPRESSED_BLOCK).astype(
                np.int32))
        doc_stream = docs8
    return doc_stream, code16, extra


def kernel_args(flat_docs, flat_imp, rows, mins, d_pad, ext, *,
                chunk_cap=4096, delta=None
                ) -> Tuple[List[np.ndarray], Dict[str, np.ndarray], dict]:
    """Plan the rows and compress → (six positional operands, optional
    operands, static keywords) as numpy arrays."""
    plan = sparse.plan_slots(rows, mins, chunk_cap=chunk_cap, lane=8)
    ds, code16, extra = compressed_operands(flat_docs, flat_imp, ext,
                                            d_pad, plan, delta=delta)
    pos = [ds, code16, plan.starts, plan.lengths, plan.weights,
           plan.min_count]
    static = dict(max_len=plan.max_len, d_pad=d_pad,
                  t_window=plan.window,
                  with_counts=any(m > 1 for m in mins))
    return pos, extra, static


def to_torch(arrays, device="cpu"):
    """numpy arrays (list or dict) → torch tensors on `device`."""
    if isinstance(arrays, dict):
        return {n: torch.from_numpy(np.array(a)).to(device)
                for n, a in arrays.items()}
    return [torch.from_numpy(np.array(a)).to(device) for a in arrays]


def assert_bitwise(got, want, msg=""):
    """(scores, docs[, totals]) equal bit for bit: scores as uint32."""
    got = [np.asarray(g.cpu() if hasattr(g, "cpu") else g) for g in got]
    want = [np.asarray(w.cpu() if hasattr(w, "cpu") else w) for w in want]
    assert len(got) == len(want), msg
    np.testing.assert_array_equal(got[0].view(np.uint32),
                                  want[0].view(np.uint32), err_msg=msg)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w, err_msg=msg)


def make_full_slot_case(rng, n_terms, df=32768, d_pad=60000, skew=1.0):
    """n_terms long postings of df docs each: at chunk_cap 4096 every
    slot is full and a row of all the terms fills n_terms * df / 4096
    slots (T = 16 for two terms, 32 for four). Its keys exceed the row
    sort's shared-memory class and its candidates the select's. Rows:
    every term (OR), and the first two terms with min_count 2."""
    fd, fi, ext = make_heavy_flat(rng, d_pad, [df] * n_terms, skew=skew)
    ws = [float(w) for w in rng.uniform(0.5, 3.0, size=n_terms)]
    rows = [[(ext[t][0], ext[t][1], ws[t], t) for t in range(n_terms)],
            [(ext[t][0], ext[t][1], ws[t], t) for t in range(2)]]
    return fd, fi, rows, [1, 2], d_pad, ext


def make_tie_heavy_full_case(rng, df=32768, d_pad=60000):
    """Two full-slot terms with impacts on an eighths grid and unit
    weights: ~50,000 candidate docs per OR row whose quantized scores
    tie in large groups, so the candidate cut at kc = 3k splits a tie
    (more candidates than kc at k = 4096 and at k = 10,000)."""
    fd, fi, ext = make_heavy_flat(rng, d_pad, [df, df], skew=1.0)
    fi = (np.ceil(fi * 8.0) / 8.0).astype(np.float32)
    rows = [[(ext[t][0], ext[t][1], 1.0, t) for t in range(2)],
            [(ext[t][0], ext[t][1], 1.0, t) for t in range(2)]]
    return fd, fi, rows, [1, 2], d_pad, ext


# ---------------------------------------------------------------------------
# the node parity corpus: documents with _ids d{i} and the search bodies
# both nodes answer
# ---------------------------------------------------------------------------

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
         "theta", "iota", "kappa", "lamda", "mu", "nu", "xi"]


def make_docs(n=240, seed=20) -> List[Tuple[str, dict]]:
    """Zipf-skewed documents over WORDS: early words common, late rare."""
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        n_words = int(rng.integers(2, 14))
        picks = np.minimum(rng.zipf(1.3, n_words) - 1, len(WORDS) - 1)
        docs.append((f"d{i}", {"body": " ".join(WORDS[int(w)]
                                                for w in picks)}))
    return docs


#: match OR / AND / msm, term, terms and bool-should bodies, with sizes
#: and offsets
PARITY_BODIES = [
    {"query": {"match": {"body": "alpha beta"}}},
    {"query": {"match": {"body": "gamma delta epsilon"}}, "size": 25},
    {"query": {"match": {"body": {"query": "alpha beta gamma",
                                  "operator": "and"}}}},
    {"query": {"match": {"body": {"query": "beta gamma delta zeta",
                                  "minimum_should_match": 2}}},
     "size": 30},
    {"query": {"term": {"body": "eta"}}, "size": 7, "from": 3},
    {"query": {"terms": {"body": ["theta", "iota", "kappa"]}}},
    {"query": {"bool": {"should": [{"term": {"body": "lamda"}},
                                   {"term": {"body": "mu"}},
                                   {"term": {"body": "alpha"}}],
                        "minimum_should_match": 2}}, "size": 40},
    {"query": {"match": {"body": {"query": "nu xi absentword",
                                  "boost": 2.5}}}},
    {"query": {"match": {"body": "alpha"}}, "size": 200},
]


def bulk_ndjson(docs, index=None) -> bytes:
    """(id, source) pairs → a _bulk body of index ops."""
    lines = []
    for doc_id, src in docs:
        meta = {"_id": doc_id} if index is None else {"_index": index,
                                                      "_id": doc_id}
        lines.append(json.dumps({"index": meta}))
        lines.append(json.dumps(src))
    return ("\n".join(lines) + "\n").encode()
