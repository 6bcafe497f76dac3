"""Lucene SmallFloat byte4 encoding — the lossy 1-byte norm.

Reference: Lucene's org.apache.lucene.util.SmallFloat (intToByte4 /
byte4ToInt), used by BM25Similarity to store each document's field length in
one byte (SURVEY.md §3.3: "norm = 1-byte SmallFloat-encoded doc length
(lossy!) — decoded via 256-entry lookup table"). Exact replication is a
parity requirement (§7.3#2): scores drift silently otherwise.

Encoding: values 0..7 (i.e. <4 bits) are stored verbatim ("subnormal");
larger values keep the top 4 significant bits — an implicit leading 1, 3
mantissa bits, and a 5-bit shift stored +1.
"""

from __future__ import annotations

import numpy as np


def int_to_byte4(i: int) -> int:
    """Lucene SmallFloat.intToByte4 (via longToInt4). 0 <= i; returns 0..255."""
    if i < 0:
        raise ValueError(f"only non-negative values accepted: {i}")
    num_bits = i.bit_length()
    if num_bits < 4:
        return i
    shift = num_bits - 4
    encoded = (i >> shift) & 0x07
    encoded |= (shift + 1) << 3
    return encoded


def byte4_to_int(b: int) -> int:
    """Lucene SmallFloat.byte4ToInt (via int4ToLong). b is 0..255."""
    bits = b & 0x07
    shift = (b >> 3) - 1
    if shift == -1:
        return bits
    return (bits | 0x08) << shift


# 256-entry decode table: LENGTH_TABLE[norm_byte] = decoded field length
LENGTH_TABLE = np.array([byte4_to_int(b) for b in range(256)], dtype=np.int64)


def encode_norm(field_length: int) -> int:
    """Field length (token count) → 1-byte norm, exactly as
    BM25Similarity#computeNorm does (intToByte4 of the length)."""
    return int_to_byte4(max(0, int(field_length)))


def decode_norms(norm_bytes: np.ndarray) -> np.ndarray:
    """u8 norms → decoded field lengths (i64)."""
    return LENGTH_TABLE[norm_bytes.astype(np.int64)]


def encode_norms(field_lengths: np.ndarray) -> np.ndarray:
    """Vectorized intToByte4 over an i64 field-length column (the bulk
    write path's norms build). Exact for lengths < 2^53 — np.frexp's
    exponent IS the bit length there."""
    v = np.maximum(field_lengths.astype(np.int64), 0)
    _, nb = np.frexp(v.astype(np.float64))  # bit length (0 for v == 0)
    shift = np.maximum(nb - 4, 0).astype(np.int64)
    enc = np.where(nb < 4, v, ((v >> shift) & 0x07) | ((shift + 1) << 3))
    return enc.astype(np.uint8)


def bm25_norm_cache(k1: float, b: float, avgdl: float) -> np.ndarray:
    """The per-norm-byte BM25 denominator term, as Lucene's BM25Scorer caches:
    cache[n] = k1 * (1 - b + b * LENGTH_TABLE[n] / avgdl); the score is then
    idf * (k1+1) * tf / (tf + cache[norm]) (SURVEY.md §3.3 formula)."""
    if avgdl <= 0:
        avgdl = 1.0
    return (k1 * ((1.0 - b) + b * LENGTH_TABLE.astype(np.float64) / avgdl)).astype(np.float32)


def idf(doc_freq: np.ndarray, doc_count: int) -> np.ndarray:
    """Lucene BM25 idf: ln(1 + (N - n + 0.5) / (n + 0.5)), with SHARD-level
    N (docCount) and n (docFreq) (SURVEY.md §3.3, §7.3#2)."""
    n = np.asarray(doc_freq, dtype=np.float64)
    return np.log(1.0 + (doc_count - n + 0.5) / (n + 0.5)).astype(np.float32)
