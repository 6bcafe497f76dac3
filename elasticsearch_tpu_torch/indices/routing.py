"""Shard routing: a copy of the reference's ``murmur3_hash`` and
``shard_for`` (indices/service.py), so a document lands on the same shard
in both packages."""

from __future__ import annotations


def murmur3_hash(key: str, encoding: str = "utf-16-le") -> int:
    """murmur3_x86_32, seed 0, as signed i32, over the UTF-16-LE code
    units of `key` (two bytes per Java char, as the reference's
    Murmur3HashFunction#hash(String) feeds it)."""
    data = key.encode(encoding)
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h1 = 0
    n = len(data) & ~3
    for i in range(0, n, 4):
        k1 = int.from_bytes(data[i:i + 4], "little")
        k1 = (k1 * c1) & 0xFFFFFFFF
        k1 = ((k1 << 15) | (k1 >> 17)) & 0xFFFFFFFF
        k1 = (k1 * c2) & 0xFFFFFFFF
        h1 ^= k1
        h1 = ((h1 << 13) | (h1 >> 19)) & 0xFFFFFFFF
        h1 = (h1 * 5 + 0xE6546B64) & 0xFFFFFFFF
    k1 = 0
    tail = len(data) & 3
    if tail >= 3:
        k1 ^= data[n + 2] << 16
    if tail >= 2:
        k1 ^= data[n + 1] << 8
    if tail >= 1:
        k1 ^= data[n]
        k1 = (k1 * c1) & 0xFFFFFFFF
        k1 = ((k1 << 15) | (k1 >> 17)) & 0xFFFFFFFF
        k1 = (k1 * c2) & 0xFFFFFFFF
        h1 ^= k1
    h1 ^= len(data)
    h1 ^= h1 >> 16
    h1 = (h1 * 0x85EBCA6B) & 0xFFFFFFFF
    h1 ^= h1 >> 13
    h1 = (h1 * 0xC2B2AE35) & 0xFFFFFFFF
    h1 ^= h1 >> 16
    return h1 - (1 << 32) if h1 >= (1 << 31) else h1


def shard_for(routing: str, num_shards: int) -> int:
    """OperationRouting#shardId: floorMod(murmur3(routing), num_shards)."""
    return murmur3_hash(routing) % num_shards

