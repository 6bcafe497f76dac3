"""The port's stacked-shard search step against the JAX package.

The same segments (built by the reference's SegmentWriter) give the
reference's StackedShardPack; convert.py carries its fields across, and
build_compressed_streams → prepare_query_batch → the local search step
run on both sides (the reference's one-device step; the port's
distributed_search_raw on a (1, 1) CPU mesh, the path its service runs).
Vals (as uint32), global ids and totals must equal
dist.make_local_search(variant="pallas"): padding rows, tombstones, AND
counts and a 32-term window. The port's own SegmentWriter and bulk
token-id builder are held equal to the reference's segments too.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.common.settings import Settings
from elasticsearch_tpu.index.segment import SegmentWriter as RefWriter
from elasticsearch_tpu.mapping import MapperService as RefMapper
from elasticsearch_tpu.parallel import distributed as jdist

from elasticsearch_tpu_torch import convert
from elasticsearch_tpu_torch.index.segment import (SegmentWriter,
                                                   segment_from_token_ids)
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.parallel import distributed as tdist
from elasticsearch_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

VOCAB = [f"w{i}" for i in range(48)]
MAPPING = {"properties": {"body": {"type": "text"}}}


def make_docs(rng, n_shards, docs_per_shard):
    out = []
    for s in range(n_shards):
        docs = []
        for i in range(docs_per_shard):
            n_tokens = int(rng.integers(1, 25))
            words = [VOCAB[min(int(rng.zipf(1.4)) - 1, len(VOCAB) - 1)]
                     for _ in range(n_tokens)]
            docs.append((f"s{s}-d{i}", {"body": " ".join(words)}))
        out.append(docs)
    return out


def ref_segments(shard_docs):
    ms = RefMapper(Settings.EMPTY, MAPPING)
    segs = []
    for s, docs in enumerate(shard_docs):
        w = RefWriter(f"shard{s}")
        for doc_id, src in docs:
            w.add_document(ms.parse_document(doc_id, src), {})
        segs.append(w.freeze())
    return segs


def port_segments(shard_docs):
    ms = MapperService(MAPPING)
    segs = []
    for s, docs in enumerate(shard_docs):
        w = SegmentWriter(f"shard{s}")
        for doc_id, src in docs:
            w.add_document(ms.parse_document(doc_id, src), ms.dv_kinds())
        segs.append(w.freeze())
    return segs


def fields_of(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def assert_same_arrays(a, b):
    for name, va in fields_of(a).items():
        vb = getattr(b, name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, name
            np.testing.assert_array_equal(va, vb, err_msg=name)
        elif isinstance(va, list) and va and isinstance(va[0], np.ndarray):
            for x, y in zip(va, vb):
                np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            assert va == vb, name


def run_both(segments, queries, *, k, min_counts=None, pad_batch_to=None,
             live_docs=None, row_groups=None, t_window=None):
    jpack = jdist.build_stacked_pack(segments, "body", live_docs=live_docs,
                                     row_groups=row_groups)
    tpack = convert.pack_from_reference(fields_of(jpack))
    jstreams = jdist.build_compressed_streams(jpack)
    tstreams = tdist.build_compressed_streams(tpack)
    assert_same_arrays(tstreams, jstreams)
    kw = dict(min_counts=min_counts, pad_batch_to=pad_batch_to,
              pad_max_len=jdist.CHUNK_CAP)
    jbatch = jdist.prepare_query_batch(jpack, queries, compressed=jstreams,
                                       **kw)
    tbatch = tdist.prepare_query_batch(tpack, queries, compressed=tstreams,
                                       **kw)
    for name in ("starts", "lengths", "weights", "min_count", "res_starts",
                 "res_lens", "slot_terms"):
        np.testing.assert_array_equal(getattr(tbatch, name),
                                      getattr(jbatch, name), err_msg=name)
    window = t_window or max(8, jbatch.window)
    with_counts = jbatch.need_counts
    arrays = jdist.device_put_compressed(jstreams)
    step = jdist.make_local_search(
        max_len=jbatch.max_len, d_pad=jpack.d_pad, p_pad=jpack.p_pad, k=k,
        t_window=window, with_counts=with_counts, variant="pallas")
    bases = arrays[5:]
    jv, jg, jt = step(*arrays[:5], *(jnp.asarray(getattr(jbatch, n)) for n in
                                     ("starts", "lengths", "weights",
                                      "res_starts", "res_lens",
                                      "slot_terms", "min_count")), *bases)
    mesh = make_mesh(["cpu"])
    tv, tg, tt = tdist.distributed_search_raw(
        tpack, tbatch, k, mesh, tdist.device_put_compressed(tstreams, mesh),
        t_window=window, variant="compressed")
    np.testing.assert_array_equal(tv.view(np.uint32),
                                  np.asarray(jv).view(np.uint32))
    np.testing.assert_array_equal(tg, np.asarray(jg))
    np.testing.assert_array_equal(tt, np.asarray(jt))
    return tpack, tv, tg, tt


class TestSegments:
    def test_port_segment_writer_builds_the_reference_pack(self):
        rng = np.random.default_rng(31)
        shard_docs = make_docs(rng, 3, 40)
        jpack = jdist.build_stacked_pack(ref_segments(shard_docs), "body",
                                         row_groups=[0, 1, 2])
        tpack = tdist.build_stacked_pack(port_segments(shard_docs), "body",
                                         row_groups=[0, 1, 2])
        assert_same_arrays(tpack, convert.pack_from_reference(
            fields_of(jpack)))

    def test_bulk_token_builder_equals_segment_writer(self):
        rng = np.random.default_rng(32)
        tokens = [rng.integers(0, len(VOCAB), int(rng.integers(1, 30)))
                  .astype(np.int32) for _ in range(70)]
        ids = [f"t{i}" for i in range(70)]
        ms = MapperService(MAPPING)
        w = SegmentWriter("seg")
        for doc_id, tok in zip(ids, tokens):
            w.add_document(ms.parse_document(
                doc_id, {"body": " ".join(VOCAB[t] for t in tok)}),
                ms.dv_kinds())
        want = w.freeze()
        got = segment_from_token_ids("seg", ids, tokens, VOCAB, "body")
        assert got.doc_ids == want.doc_ids
        assert list(got.postings["body"]) == list(want.postings["body"])
        for term, (d, tf) in want.postings["body"].items():
            np.testing.assert_array_equal(got.postings["body"][term][0], d)
            np.testing.assert_array_equal(got.postings["body"][term][1], tf)
        np.testing.assert_array_equal(got.norms["body"], want.norms["body"])
        assert got.field_stats == want.field_stats
        assert [got.stored_source[i] for i in range(70)] == \
            want.stored_source


@pytest.fixture(scope="module")
def shard_docs():
    # one corpus for every local-search case, so the reference's jitted
    # step compiles once per static signature
    return make_docs(np.random.default_rng(41), 3, 50)


K = 50


class TestLocalSearch:
    def test_matches_reference(self, shard_docs):
        queries = [["w0"], ["w1", "w2"], ["w3", "w0", "w5", "w9"],
                   ["absent-term"]]
        run_both(ref_segments(shard_docs), queries, k=K,
                 row_groups=[0, 1, 2])

    def test_empty_query_row_padding(self, shard_docs):
        _, vals, _, totals = run_both(ref_segments(shard_docs), [["w0"]],
                                      k=K, pad_batch_to=3)
        assert (vals[1:] == float("-inf")).all() and not totals[1:].any()

    def test_tombstones_excluded(self, shard_docs):
        segments = ref_segments(shard_docs)
        live = [np.zeros(segments[0].num_docs, dtype=bool), None,
                np.arange(segments[2].num_docs) % 2 == 0]
        tpack, vals, gids, _ = run_both(segments, [["w0"], ["w1", "w4"]],
                                        k=K, live_docs=live)
        shards = gids[vals > float("-inf")] // (tpack.d_pad + 1)
        assert not (shards == 0).any()

    def test_and_counts(self, shard_docs):
        run_both(ref_segments(shard_docs), [["w0", "w1"], ["w0", "w2", "w3"]],
                 k=K, min_counts=[2, 3])

    def test_32_term_window(self, shard_docs):
        terms = VOCAB[:32]
        _, vals, _, _ = run_both(ref_segments(shard_docs), [terms, terms[:3]],
                                 k=K, min_counts=[4, 1], t_window=32)
        assert (vals[0] > float("-inf")).any()


@pytest.mark.parametrize("delta", [True, False])
def test_streams_formats_match_reference(delta):
    rng = np.random.default_rng(46)
    jpack = jdist.build_stacked_pack(ref_segments(make_docs(rng, 2, 30)),
                                     "body")
    tpack = convert.pack_from_reference(fields_of(jpack))
    assert_same_arrays(tdist.build_compressed_streams(tpack, delta=delta),
                       jdist.build_compressed_streams(jpack, delta=delta))
    assert tdist.delta_pack_reason(tpack) == jdist.delta_pack_reason(jpack)
