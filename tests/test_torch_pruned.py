"""The raw pack's pruned tiers of the port against the JAX package's.

Port copies of what the reference's make_pruned_search serves: the
full-postings tier (``with_rescore=False``) and the prefix tier (the
impact-sorted prefixes with the phase-B rescore, its WAND cutoff and tail
bound), with ``variant="ref"`` and with ``"packed"`` and ``pack_keys``
(the single-key phase-A sort), one phase-A group and several (FUSE_ROWS
shrunk on both sides). The same segments give both packs (6 shards
padded to 8); the reference runs on its 8 virtual CPU devices, the port
on CPU meshes (1, 1), (1, 2) and (2, 2), its phase A through
merge_kernel.pruned_candidates and its phase B through pruned_rescore
and pruned_order, all their plain versions here. The [B, 2k + 3] output
(scores and cutoffs as uint32, gids, totals, beta) must be equal bit for
bit.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from elasticsearch_tpu.common.settings import Settings
from elasticsearch_tpu.index.segment import SegmentWriter as RefWriter
from elasticsearch_tpu.mapping import MapperService as RefMapper
from elasticsearch_tpu.parallel import distributed as jdist
from elasticsearch_tpu.parallel.mesh import (DATA_AXIS as J_DATA,
                                             SHARD_AXIS as J_SHARD,
                                             make_mesh as ref_make_mesh)

from elasticsearch_tpu_torch.index.segment import SegmentWriter
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.ops import merge_kernel
from elasticsearch_tpu_torch.parallel import distributed as tdist
from elasticsearch_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

VOCAB = [f"w{i}" for i in range(40)]
MAPPING = {"properties": {"body": {"type": "text"}}}
SHAPES = [(1, 1), (1, 2), (2, 2)]
N_SEGMENTS = 6
PAD_SHARDS = 8
QUERIES = [["w0"], ["w1", "w2"], ["w0", "w3", "w5", "w9"], ["absent"],
           ["w2", "w0", "w1", "w4", "w6", "w7", "w8", "w11"],
           ["w6", "w30"], [], ["w1"]]
BOOSTS = [1.0, 1.0, 2.5, 1.0, 1.0, 0.5, 1.0, 1e-3]
T_TERMS = 8


@pytest.fixture(scope="module")
def segments():
    rng = np.random.default_rng(23)
    ref_ms = RefMapper(Settings.EMPTY, MAPPING)
    ms = MapperService(MAPPING)
    ref, port = [], []
    for s in range(N_SEGMENTS):
        rw, pw = RefWriter(f"shard{s}"), SegmentWriter(f"shard{s}")
        for i in range(40):
            words = [VOCAB[min(int(rng.zipf(1.3)) - 1, len(VOCAB) - 1)]
                     for _ in range(int(rng.integers(1, 20)))]
            src = {"body": " ".join(words)}
            rw.add_document(ref_ms.parse_document(f"s{s}-d{i}", src), {})
            pw.add_document(ms.parse_document(f"s{s}-d{i}", src),
                            ms.dv_kinds())
        ref.append(rw.freeze())
        port.append(pw.freeze())
    return ref, port


@pytest.fixture(scope="module")
def packs(segments):
    ref_segs, port_segs = segments
    live = [None] * N_SEGMENTS
    live[1] = np.arange(ref_segs[1].num_docs) % 3 != 0   # tombstones
    jpack = jdist.build_stacked_pack(ref_segs, "body", live_docs=live,
                                     pad_shards_to=PAD_SHARDS)
    tpack = tdist.build_stacked_pack(port_segs, "body", live_docs=live,
                                     pad_shards_to=PAD_SHARDS)
    np.testing.assert_array_equal(tpack.flat_impact, jpack.flat_impact)
    return jpack, tpack


def test_impact_sorted_copy_matches_reference(packs):
    jpack, tpack = packs
    for got, want in zip(tdist.build_impact_sorted(tpack),
                         jdist.build_impact_sorted(jpack)):
        np.testing.assert_array_equal(got, want)


def make_batch(dist, pack, tier):
    """(batch, t_starts, t_lengths, t_weights) as the service prepares a
    tier's launch (full: the whole postings at 8 slots; prefix: each
    term's first 3 impact-sorted entries)."""
    kw = dict(boosts=BOOSTS, min_counts=[1] * len(QUERIES),
              pad_batch_to=len(QUERIES), pad_t_slots=T_TERMS)
    if tier == "prefix":
        kw.update(prefix_cap=3,
                  imp_impacts=dist.build_impact_sorted(pack)[1])
    batch = dist.prepare_query_batch(pack, QUERIES, **kw)
    ranges = dist.prepare_term_ranges(pack, QUERIES, boosts=BOOSTS,
                                      pad_batch_to=len(QUERIES),
                                      pad_terms=T_TERMS)
    return batch, ranges


def run_reference(jpack, tier, c_cand, k_out, variant, pack_keys):
    mesh = ref_make_mesh()
    batch, ranges = make_batch(jdist, jpack, tier)
    imp_docs, imp_imps = jdist.build_impact_sorted(jpack)
    fn = jdist.make_pruned_search(
        mesh, max_len=batch.max_len, d_pad=jpack.d_pad, p_pad=jpack.p_pad,
        c_cand=c_cand, k_out=k_out, t_window=max(8, batch.window),
        t_terms=T_TERMS, with_rescore=tier == "prefix", variant=variant,
        pack_keys=pack_keys)
    imp_arrays = jdist.device_put_pack(
        dataclasses.replace(jpack, flat_docs=imp_docs,
                            flat_impact=imp_imps), mesh)
    arrays = jdist.device_put_pack(jpack, mesh)
    ops = jdist.pack_pruned_operands(batch, *ranges)
    sbt = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(J_SHARD, J_DATA, None))
    out = fn(imp_arrays[0], imp_arrays[1], arrays[0], arrays[1],
             jax.device_put(ops, sbt))
    return batch, np.asarray(out)


def run_port(tpack, tier, c_cand, k_out, variant, pack_keys, shape):
    batch, ranges = make_batch(tdist, tpack, tier)
    mesh = make_mesh(["cpu"] * (shape[0] * shape[1]), shape)
    image = tdist.device_put_pack(tpack, mesh,
                                  *tdist.build_impact_sorted(tpack))
    step = tdist.make_pruned_search(
        mesh, max_len=batch.max_len, d_pad=tpack.d_pad, p_pad=tpack.p_pad,
        c_cand=c_cand, k_out=k_out, t_window=max(8, batch.window),
        t_terms=T_TERMS, with_rescore=tier == "prefix", variant=variant,
        pack_keys=pack_keys)
    ops = tdist.pack_pruned_operands(batch, *ranges)
    return batch, step(image, ops).numpy()


CONFIGS = {
    # tier, c_cand, k_out, variant, pack_keys
    "full_ref": ("full", 128, 128, "ref", False),
    "full_cut": ("full", 12, 6, "ref", False),
    "prefix_ref": ("prefix", 128, 128, "ref", False),
    "prefix_cut": ("prefix", 10, 4, "ref", False),
    "prefix_packed_keys": ("prefix", 16, 8, "packed", True),
}


@pytest.mark.parametrize("groups", ["one_group", "fuse_rows_1"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_pruned_step_matches_reference(packs, monkeypatch, config, shape,
                                       groups):
    jpack, tpack = packs
    tier, c_cand, k_out, variant, pack_keys = CONFIGS[config]
    if groups == "fuse_rows_1":
        # several phase-A groups on every device, as on a pack of more
        # rows than FUSE_ROWS
        monkeypatch.setattr(jdist, "FUSE_ROWS", 1)
        monkeypatch.setattr(tdist, "FUSE_ROWS", 1)
    jdist.make_pruned_search.cache_clear()
    try:
        jbatch, want = run_reference(jpack, tier, c_cand, k_out, variant,
                                     pack_keys)
    finally:
        jdist.make_pruned_search.cache_clear()
    _, got = run_port(tpack, tier, c_cand, k_out, variant, pack_keys, shape)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    vals, gids, totals, cutoff, beta = tdist.unpack_pruned(got)
    assert (totals > 0).any()
    if tier == "prefix":
        assert jbatch.truncated and (beta > 0).any()
    else:
        assert (beta == 0).all()


def test_phase_b_sum_follows_the_reference_association():
    """Eight terms' contributions whose f32 sums differ by association:
    pruned_rescore_plain adds them as the reference's fused rescore does
    (halving: ((x0 + x4) + (x2 + x6)) + ((x1 + x5) + (x3 + x7))), where
    left to right or neighbouring pairs would differ. The parity tests
    above hold that association against the reference's step itself
    (an 8-term query with impacts of unequal scale)."""
    rng = np.random.default_rng(5)
    b, c, t = 3, 40, 8
    contrib = (rng.random((b, c, t))
               * np.exp(rng.uniform(-12, 12, (b, c, t)))).astype(np.float32)
    d_pad = 64
    p_pad = t * c + 4096
    ds_docs = np.full((1, p_pad), d_pad, dtype=np.int32)
    starts = np.zeros((1, 1, t), dtype=np.int32)
    lengths = np.full((1, 1, t), c, dtype=np.int32)
    weights = np.ones((1, 1, t), dtype=np.float32)
    for tt in range(t):
        ds_docs[0, tt * c:(tt + 1) * c] = np.arange(c)
        starts[0, 0, tt] = tt * c
    gids = torch.arange(c, dtype=torch.int64)[None]
    got = []
    for q in range(b):
        imps = np.zeros((1, p_pad), dtype=np.float32)
        for tt in range(t):
            imps[0, tt * c:(tt + 1) * c] = contrib[q, :, tt]
        got.append(merge_kernel.pruned_rescore_plain(
            torch.from_numpy(ds_docs), torch.from_numpy(imps), gids,
            torch.from_numpy(starts), torch.from_numpy(lengths),
            torch.from_numpy(weights), d_pad=d_pad, p_pad=p_pad,
            row_base=0, search_iters=9).numpy()[0])
    got = np.stack(got)
    x = contrib
    half = ((x[..., 0] + x[..., 4]) + (x[..., 2] + x[..., 6])) + (
        (x[..., 1] + x[..., 5]) + (x[..., 3] + x[..., 7]))
    seq = x[..., 0]
    for tt in range(1, t):
        seq = seq + x[..., tt]
    pairs = ((x[..., 0] + x[..., 1]) + (x[..., 2] + x[..., 3])) + (
        (x[..., 4] + x[..., 5]) + (x[..., 6] + x[..., 7]))
    bits = got.view(np.uint32)
    assert (bits != seq.view(np.uint32)).any()
    assert (bits != pairs.view(np.uint32)).any()
    np.testing.assert_array_equal(bits, half.view(np.uint32))
