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


def gathered_rows(rng, b, shards, per_shard, levels, step=0.25):
    """[b, shards * per_shard] f32 as the cross-shard top-k gets it: each
    shard's list descending with a -inf tail, scores on a grid of
    `levels` multiples of `step`, so equal scores meet across shards."""
    out = np.full((b, shards * per_shard), -np.inf, dtype=np.float32)
    for r in range(b):
        for s in range(shards):
            n = int(rng.integers(0, per_shard + 1))
            v = np.sort(rng.integers(1, levels + 1, n))[::-1] * step
            out[r, s * per_shard: s * per_shard + n] = v
    return out


#: shard_topk's device-class cases (topk_case) and the exact merge's
#: window cases (exact_window_case), run by the emulated and card tests
TOPK_DEVICE_CASES = ("multi_block", "run_holds_its_slice", "all_neg_inf",
                     "nan_and_zeros", "k_above_width",
                     "tie_run_across_slices")
EXACT_WINDOW_CASES = ("uneven_slots", "budget_split",
                      "equal_docs_many_slots", "msm", "delta",
                      "descending_slot")


def topk_case(rng, case):
    """[B, N] f32 rows and the k's of a shard_topk case."""
    if case == "multi_block":
        return gathered_rows(rng, 3, 8, 64, 9), (65, 200, 511, 512)
    if case == "run_holds_its_slice":
        # every finalist in the first slice of each row, one run of a
        # whole slice (more finalists than TOPK_SORT_CAP) in one block
        vals = gathered_rows(rng, 2, 4, 128, 5, step=0.125)
        vals[:, 128:] -= 100.0
        return vals, (100, 128, 300)
    if case == "all_neg_inf":
        vals = gathered_rows(rng, 3, 4, 100, 5)
        vals[1] = -np.inf
        return vals, (90, 250, 400)
    if case == "nan_and_zeros":
        vals = rng.choice(np.array([np.nan, 0.0, -0.0, 1.5, -1.0, np.inf,
                                    -np.inf], dtype=np.float32),
                          size=(2, 300))
        return vals, (70, 150, 299)
    if case == "k_above_width":
        return gathered_rows(rng, 2, 3, 40, 4), (121, 500)
    # a tie run over the slice boundaries: the k-th value is one of
    # 180 equal values at positions 30-209 (slices of 64)
    vals = np.sort(rng.uniform(0.0, 1.0, (2, 256)).astype(np.float32),
                   axis=1)[:, ::-1].copy()
    vals[:, 30:210] = 0.5
    return vals, (66, 100, 200)


def exact_window_case(rng, case):
    """(flat docs, flat impacts, rows, mins, d_pad, ext, delta) of an
    exact-merge window case; weights packable() refuses."""
    if case == "uneven_slots":
        # one long term, short ones, a one-lane one
        d_pad = 3000
        fd, fi, ext = make_heavy_flat(rng, d_pad, [900, 12, 40, 1],
                                            skew=1.0)
        rows = [[(ext[t][0], ext[t][1], 1e-15 * (t + 1), t)
                 for t in range(4)],
                [(ext[t][0], ext[t][1], 3e-15, t) for t in (1, 0)]]
        return fd, fi, rows, [1, 1], d_pad, ext, False
    if case == "budget_split":
        # five slots of uneven length: past a 64-lane window its parts
        # share the window unevenly (the two of 256 lanes get less than
        # their lanes); 1022 lanes: one 1024-lane window
        d_pad = 2000
        dfs = [256, 256, 210, 250, 50]
        fd, fi, ext = make_heavy_flat(rng, d_pad, dfs, skew=1.0)
        rows = [[(ext[t][0], ext[t][1], 1e-15 * (t + 1), t)
                 for t in range(len(dfs))]]
        return fd, fi, rows, [1], d_pad, ext, False
    if case == "equal_docs_many_slots":
        # one term in six slots of different weights: every doc a run of
        # six lanes, summed in slot order
        d_pad = 1200
        fd, fi, ext = make_flat(rng, 2, d_pad, 300)
        ws = [0.3e-15, 1.7e-15, -0.2e-15, 0.9e-15, 2.5e-15, 0.1e-15]
        rows = [[(ext[0][0], ext[0][1], w, 0) for w in ws]
                + [(ext[1][0], ext[1][1], 1e-15, 1)]]
        return fd, fi, rows, [1], d_pad, ext, False
    if case == "msm":
        d_pad = 400
        fd, fi, ext = make_flat(rng, 4, d_pad, 300)
        rows = [[(ext[t][0], ext[t][1], 1e-15 * (t + 1), t)
                 for t in range(4)]] * 2
        return fd, fi, rows, [2, 3], d_pad, ext, False
    if case == "delta":
        d_pad = 250
        fd, fi, ext = make_flat(rng, 5, d_pad, 200)
        rows = [[(ext[t][0], ext[t][1], -0.5 + t, t) for t in range(5)],
                [(ext[t][0], ext[t][1], 1e-14, t) for t in (1, 3)]]
        return fd, fi, rows, [1, 2], d_pad, ext, True
    # a slot window past the end of its term, into the next term's
    # postings: its docs descend, and the row takes the radix class
    d_pad = 900
    fd, fi, ext = make_flat(rng, 3, d_pad, 200)
    s0, n0 = ext[0]
    rows = [[(s0 + n0 - 5, 30, 2e-15, 0), (ext[2][0], ext[2][1], 1e-15, 2)],
            [(ext[1][0], ext[1][1], 1e-15, 1)]]
    return fd, fi, rows, [1, 1], d_pad, ext, False



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


#: a mapping with every field type the planner slice maps
TYPED_MAPPING = {"properties": {
    "body": {"type": "text"}, "tag": {"type": "keyword"},
    "views": {"type": "long"}, "price": {"type": "double"},
    "published": {"type": "date"}, "flag": {"type": "boolean"},
    "meta": {"properties": {"rank": {"type": "integer"}}}}}


def make_typed_docs(n=120, seed=21) -> List[Tuple[str, dict]]:
    """Documents over TYPED_MAPPING: body text over WORDS, Zipf views,
    prices, dates over 2019-2024 (ISO strings and epoch millis), flags,
    tags, an object sub-field, and some docs missing each field."""
    rng = np.random.default_rng(seed)
    docs = []
    base = 1546300800000   # 2019-01-01T00:00:00Z
    span = 6 * 365 * 86400000
    for i in range(n):
        n_words = int(rng.integers(2, 10))
        picks = np.minimum(rng.zipf(1.3, n_words) - 1, len(WORDS) - 1)
        src = {"body": " ".join(WORDS[int(w)] for w in picks)}
        if i % 7 != 3:
            src["views"] = int(min(rng.zipf(1.5), 10**6))
        if i % 5 != 1:
            src["price"] = round(float(rng.uniform(0, 500)), 2)
        if i % 6 != 2:
            ms = base + int(rng.integers(0, span))
            src["published"] = (ms if i % 2 else
                                __import__("datetime").datetime.fromtimestamp(
                                    ms / 1000, __import__("datetime")
                                    .timezone.utc).strftime(
                                    "%Y-%m-%dT%H:%M:%SZ"))
        if i % 4 != 0:
            src["flag"] = bool(rng.integers(0, 2))
        src["tag"] = f"t{int(rng.integers(0, 5))}"
        if i % 3 == 0:
            src["meta"] = {"rank": int(rng.integers(0, 20))}
        if i % 11 == 5:
            src["views"] = [int(rng.integers(1, 50)),
                            int(rng.integers(1, 50))]
        docs.append((f"t{i}", src))
    return docs


#: planner bodies over TYPED_MAPPING fields
TYPED_BODIES = {
    "range_long": {"query": {"range": {"views": {"gte": 2, "lt": 9}}},
                   "size": 50},
    "range_long_gt": {"query": {"range": {"views": {"gt": 3}}}},
    "range_double": {"query": {"range": {"price": {"gt": 100.5,
                                                   "lte": 300}}},
                     "size": 40},
    "range_date_iso": {"query": {"range": {"published": {
        "gte": "2020-01-01", "lt": "2022-06-30T12:00:00Z"}}}, "size": 30},
    "range_date_millis": {"query": {"range": {"published": {
        "lte": 1609459200000}}}},
    "range_disjoint": {"query": {"range": {"views": {"gte": 10**7}}}},
    "term_flag": {"query": {"term": {"flag": True}}, "size": 20},
    "term_flag_string": {"query": {"term": {"flag": "false"}}},
    "term_long": {"query": {"term": {"views": 1}}, "size": 15},
    "terms_tag": {"query": {"terms": {"tag": ["t1", "t3"]}}, "size": 12},
    "match_long": {"query": {"match": {"views": "2"}}},
    "exists_price": {"query": {"exists": {"field": "price"}}, "size": 5},
    "object_subfield": {"query": {"range": {"meta.rank": {"gte": 5}}}},
    "bool_filter_range": {"query": {"bool": {
        "must": [{"match": {"body": "alpha beta"}}],
        "filter": [{"range": {"views": {"gte": 1, "lte": 20}}}],
        "must_not": [{"term": {"flag": False}}]}}, "size": 25},
    "fvf_log1p": {"query": {"function_score": {
        "query": {"match": {"body": "alpha gamma"}},
        "field_value_factor": {"field": "views", "modifier": "log1p",
                               "missing": 1}}}, "size": 30},
    "fvf_plain": {"query": {"function_score": {
        "query": {"match_all": {}},
        "field_value_factor": {"field": "views", "factor": 1.5},
        "boost_mode": "replace"}}, "size": 30},
    "fvf_sqrt_sum": {"query": {"function_score": {
        "query": {"match": {"body": "beta"}},
        "functions": [
            {"field_value_factor": {"field": "price", "modifier": "sqrt"}},
            {"filter": {"term": {"flag": True}}, "weight": 3},
            {"weight": 0.5}],
        "score_mode": "sum", "boost_mode": "sum", "max_boost": 20}},
        "size": 30},
    "min_score_range": {"query": {"bool": {
        "should": [{"match": {"body": "gamma"}},
                   {"range": {"price": {"gte": 250}}}]}},
        "min_score": 1.2, "size": 30},
}

#: TYPED_BODIES whose scores pass through a log (held bitwise like the
#: rest: the port computes XLA:CPU's f32 log, ``ops/xla_math.py``)
LOG_BODIES = {"fvf_log1p"}


# ---------------------------------------------------------------------------
# raw packs: the raw merge's operands and the pruned kernels' cases
# ---------------------------------------------------------------------------

def raw_args(fd, fi, rows, mins, d_pad, chunk_cap=256):
    """The raw merge's six positional operands (int32 docs, f32 impacts,
    the planned slots) and static keywords, as numpy arrays."""
    plan = sparse.plan_slots(rows, mins, chunk_cap=chunk_cap, lane=8)
    pos = [fd, fi, plan.starts, plan.lengths, plan.weights, plan.min_count]
    static = dict(max_len=plan.max_len, d_pad=d_pad, t_window=plan.window,
                  with_counts=any(m > 1 for m in mins))
    return pos, static


def impact_sorted_rows(rng, n_rows, n_terms, d_pad, max_df, slack=SLACK):
    """n_rows pack rows of n_terms postings each in impact-descending
    order (ties by doc; impacts on a 1/16 grid, so ties are many) →
    (docs int32 [S, P_pad], impacts f32, p_pad, ext[row][term] = (start,
    length) within the row)."""
    rows, ext = [], []
    for _ in range(n_rows):
        docs_r, imps_r, ext_r, pos = [], [], [], 0
        for _t in range(n_terms):
            df = int(rng.integers(1, max_df))
            d = rng.choice(d_pad, size=df, replace=False).astype(np.int32)
            im = (np.ceil(rng.uniform(0.05, 1.0, df) * 16) / 16).astype(
                np.float32)
            order = np.lexsort((d, -im))
            docs_r.append(d[order])
            imps_r.append(im[order])
            ext_r.append((pos, df))
            pos += df
        rows.append((np.concatenate(docs_r), np.concatenate(imps_r)))
        ext.append(ext_r)
    p_pad = max(r[0].size for r in rows) + slack
    docs = np.full((n_rows, p_pad), d_pad, dtype=np.int32)
    imps = np.zeros((n_rows, p_pad), dtype=np.float32)
    for i, (d, im) in enumerate(rows):
        docs[i, :d.size] = d
        imps[i, :im.size] = im
    return docs, imps, p_pad, ext


def candidates_case(rng, g=3, t_slots=4, d_pad=400, max_len=128, b=5,
                    n_terms=6, max_df=120):
    """One phase-A group of g rows: each of b queries takes up to t_slots
    terms of every row, whole (even queries) or a random prefix (odd) →
    ([flat docs, flat impacts, starts, lengths, weights, rows] numpy,
    static keywords)."""
    docs, imps, p_pad, ext = impact_sorted_rows(rng, g, n_terms, d_pad,
                                                max_df)
    starts = np.zeros((b, g * t_slots), dtype=np.int32)
    lengths = np.zeros_like(starts)
    weights = np.zeros((b, g * t_slots), dtype=np.float32)
    rows = np.repeat(np.arange(g, dtype=np.int32), t_slots)[None].repeat(
        b, axis=0)
    for q in range(b):
        terms = rng.choice(n_terms, size=int(rng.integers(
            1, min(t_slots, n_terms) + 1)), replace=False)
        ws = rng.uniform(0.3, 3.0, len(terms)).astype(np.float32)
        for r in range(g):
            for j, (term, w) in enumerate(zip(terms, ws)):
                st, ln = ext[r][term]
                cap = int(rng.integers(1, ln + 1)) if q % 2 else ln
                starts[q, r * t_slots + j] = r * p_pad + st
                lengths[q, r * t_slots + j] = min(cap, max_len)
                weights[q, r * t_slots + j] = w
    arrays = [docs.reshape(-1), imps.reshape(-1), starts, lengths, weights,
              rows]
    return arrays, dict(max_len=max_len, d_pad=d_pad, t_window=8)


def banded_candidates_case(rng, d_pad=2000, t_slots=8, max_len=512):
    """A phase-A group of 3 rows (row 2 a padding row, as the service
    pads a group: row 0, length 0) for pruned_candidates' classes at
    shrunk caps. Queries: 0 empty; 1 one lane; 2 eight terms over rows
    0 and 1 whose postings share docs (runs of up to 8 lanes) and hold
    docs at power-of-two gid edges (a band's first and last keys); 3
    prefixes of the same; 4 lanes packed into 0 .. 150 of row 0 (a band
    past a small cap; three lone lanes in row 1); 5 sixteen lanes, two
    gids of two lanes. Impacts take
    five values, two pairs of which share their 16-bit code (ties of
    pack_keys' codes) → ([flat docs, flat impacts, starts, lengths,
    weights, rows] numpy, static keywords)."""
    d1 = d_pad + 1
    edges = sorted({(m << s) + e for s in range(5, 12) for m in range(1, 8)
                    for e in (-1, 0) if 0 <= (m << s) + e < 2 * d1})
    edge_docs = [[], []]
    for rel in edges:
        row, doc = divmod(rel, d1)
        if doc < d_pad:
            edge_docs[row].append(doc)
    shared = rng.choice(d_pad, size=40, replace=False)
    values = np.array([0.5, 0.5001, 1.25, 1.2501, 2.0], dtype=np.float32)
    flat_docs, flat_imps, ext = [], [], {}
    pos = 0

    def add(key, docs):
        nonlocal pos
        docs = np.unique(np.asarray(docs, dtype=np.int32))
        imps = rng.choice(values, size=docs.size)
        order = np.lexsort((docs, -imps))   # impact order, as a pack
        flat_docs.append(docs[order])
        flat_imps.append(imps[order])
        ext[key] = (pos, docs.size)
        pos += docs.size

    for row in (0, 1):
        for t in range(t_slots):
            own = rng.choice(d_pad, size=int(rng.integers(30, 90)),
                             replace=False)
            edge = [d for i, d in enumerate(edge_docs[row])
                    if i % t_slots == t or i % 3 == 0]
            add(("term", row, t), np.concatenate(
                [own, shared[:int(rng.integers(10, 40))], edge]))
        add(("cluster", row), rng.choice(150, size=110, replace=False)
            if row == 0 else [100, 900, 1500])   # bands of one and none
    add(("pair",), [7, 7 + d1 // 2])
    flat_docs.append(np.full(max_len, d_pad, dtype=np.int32))  # slack
    flat_imps.append(np.zeros(max_len, dtype=np.float32))
    fd = np.concatenate(flat_docs)
    fi = np.concatenate(flat_imps)
    b, gt = 6, 3 * t_slots
    starts = np.zeros((b, gt), dtype=np.int32)
    lengths = np.zeros_like(starts)
    weights = np.zeros((b, gt), dtype=np.float32)
    rows = np.zeros((b, gt), dtype=np.int32)
    rows[:, :2 * t_slots] = np.repeat(np.arange(2, dtype=np.int32), t_slots)

    def slot(q, j, key, length=None, w=1.0):
        st, ln = ext[key]
        starts[q, j] = st
        lengths[q, j] = ln if length is None else min(length, ln)
        weights[q, j] = w

    slot(1, 3, ("term", 0, 3), length=1, w=0.75)
    ws = rng.uniform(0.3, 3.0, t_slots).astype(np.float32)
    for row in (0, 1):
        for t in range(t_slots):
            j = row * t_slots + t
            slot(2, j, ("term", row, t), w=ws[t])
            slot(3, j, ("term", row, t),
                 length=int(rng.integers(1, 120)), w=ws[t])
    slot(4, 0, ("cluster", 0), w=1.5)
    slot(4, 1, ("term", 0, 1), w=0.5)
    slot(4, t_slots, ("cluster", 1), w=1.5)
    slot(5, 2, ("pair",), w=1.0)
    slot(5, 4, ("term", 0, 4), length=5, w=2.0)
    slot(5, 5, ("term", 0, 5), length=5, w=2.0)
    starts[5, 3] = starts[5, 2]     # the pair twice in row 0: runs of 2
    lengths[5, 3] = 2
    weights[5, 3] = 0.25
    slot(5, t_slots + 2, ("pair",), w=0.5)
    arrays = [fd, fi, starts, lengths, weights, rows]
    return arrays, dict(max_len=max_len, d_pad=d_pad, t_window=8)


def rescore_case(rng, s_l=3, d_pad=300, b=4, t_terms=8, c=100,
                 n_terms=10, max_df=150, device="cpu"):
    """Phase B on a device holding rows 2 .. 2 + s_l of 6: doc-sorted
    rows, each query's term ranges, c candidate gids of every row (some
    repeated, the last 7 -inf with gid 0) → (doc-sorted [docs, impacts],
    cand gids, [t_starts, t_lengths, t_weights], cand_vals, keywords), as
    torch tensors on `device`."""
    docs, imps, p_pad, ext = impact_sorted_rows(rng, s_l, n_terms, d_pad,
                                                max_df)
    for r in range(s_l):   # doc-sorted within each term
        for st, ln in ext[r]:
            o = np.argsort(docs[r, st:st + ln], kind="stable")
            docs[r, st:st + ln] = docs[r, st:st + ln][o]
            imps[r, st:st + ln] = imps[r, st:st + ln][o]
    t_starts = np.zeros((s_l, b, t_terms), dtype=np.int32)
    t_lengths = np.zeros_like(t_starts)
    t_weights = np.zeros((s_l, b, t_terms), dtype=np.float32)
    for q in range(b):
        terms = rng.choice(n_terms, size=int(rng.integers(1, t_terms + 1)),
                           replace=False)
        for r in range(s_l):
            for j, term in enumerate(terms):
                t_starts[r, q, j], t_lengths[r, q, j] = ext[r][term]
                t_weights[r, q, j] = rng.uniform(0.2, 2.0)
    gids = (rng.integers(0, 6, (b, c)) * (d_pad + 1)
            + rng.integers(0, d_pad, (b, c))).astype(np.int64)
    gids[:, :10] = gids[:, 10:20]
    cand_vals = rng.uniform(0.1, 5.0, (b, c)).astype(np.float32)
    cand_vals[:, -7:] = float("-inf")
    gids[:, -7:] = 0

    def t(a):
        return torch.from_numpy(a).to(device)

    return ([t(docs), t(imps)], t(gids),
            [t(t_starts), t(t_lengths), t(t_weights)], t(cand_vals),
            dict(d_pad=d_pad, p_pad=p_pad, row_base=2, search_iters=9))
