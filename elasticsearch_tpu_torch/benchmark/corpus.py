"""Zipf-realistic synthetic corpus + queries + relevance judgments.

BASELINE.md obligation #1/#2 groundwork: with no network access, MS MARCO
itself is unreachable, so the quality/throughput harness runs on a
synthetic corpus shaped like real text — Zipf(s≈1.07) word frequencies,
log-normal passage lengths (mean ≈ 55 tokens, the MS MARCO passage
shape) — with *planted* graded relevance: each query's relevant docs get
the query terms injected with rating-scaled frequency, so nDCG@10/MRR@10
are computable without human judgments and identical for every system
scoring the same corpus (the parity comparison is system-vs-system, not
vs an absolute number).

Generation is vectorized numpy — 1M docs ≈ seconds, not minutes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np


@dataclasses.dataclass
class SyntheticCorpus:
    doc_tokens: List[np.ndarray]          # per doc: int32 token ids
    queries: List[List[int]]              # per query: token ids
    qrels: List[Dict[int, int]]           # per query: {doc_index: rating}
    vocab: List[str]                      # token id → word

    @property
    def num_docs(self) -> int:
        return len(self.doc_tokens)

    def doc_text(self, i: int) -> str:
        return " ".join(self.vocab[t] for t in self.doc_tokens[i])

    def query_text(self, qi: int) -> str:
        return " ".join(self.vocab[t] for t in self.queries[qi])


def _zipf_probs(vocab_size: int, s: float) -> np.ndarray:
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    p = 1.0 / ranks**s
    return p / p.sum()


def generate(num_docs: int, *, vocab_size: int = 30_000,
             mean_len: float = 55.0, num_queries: int = 256,
             terms_per_query: Tuple[int, int] = (2, 5),
             relevant_per_query: int = 5, zipf_s: float = 1.07,
             seed: int = 42) -> SyntheticCorpus:
    rng = np.random.default_rng(seed)
    probs = _zipf_probs(vocab_size, zipf_s)
    vocab = [f"w{i}" for i in range(vocab_size)]

    # log-normal lengths around mean_len, clipped to [8, 6*mean]
    sigma = 0.45
    mu = np.log(mean_len) - sigma**2 / 2
    lengths = np.clip(rng.lognormal(mu, sigma, num_docs).astype(np.int64),
                      8, int(6 * mean_len))
    # one big Zipf draw, then split per doc (vectorized)
    flat = rng.choice(vocab_size, size=int(lengths.sum()), p=probs
                      ).astype(np.int32)
    offsets = np.zeros(num_docs + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    doc_tokens = [flat[offsets[i]:offsets[i + 1]] for i in range(num_docs)]

    # queries: mid-frequency band terms (realistic queries are neither
    # stopwords nor hapaxes)
    band_lo, band_hi = 20, min(3000, vocab_size - 1)
    queries: List[List[int]] = []
    qrels: List[Dict[int, int]] = []
    for _ in range(num_queries):
        n_terms = int(rng.integers(terms_per_query[0],
                                   terms_per_query[1] + 1))
        terms = rng.choice(np.arange(band_lo, band_hi), size=n_terms,
                           replace=False).astype(np.int32)
        queries.append([int(t) for t in terms])
        # plant graded relevance: rating r ∈ {1, 2, 3} injects the query
        # terms r+1 times each into a random doc
        rel: Dict[int, int] = {}
        chosen = rng.choice(num_docs, size=relevant_per_query, replace=False)
        for j, doc_idx in enumerate(chosen):
            rating = 3 - (j * 3 // relevant_per_query)  # 3,3,2,2,1...
            inject = np.repeat(terms, rating + 1)
            doc_tokens[doc_idx] = np.concatenate(
                [doc_tokens[doc_idx], inject]).astype(np.int32)
            rel[int(doc_idx)] = rating
        qrels.append(rel)
    return SyntheticCorpus(doc_tokens, queries, qrels, vocab)
