"""The port's distributed search over CPU meshes against the JAX
package's on its 8-device virtual mesh.

Port copies of the exact cases of ``tests/test_distributed.py::
TestDistributedSearch`` (matches the oracle, empty-query row padding,
tombstones, AND counts from the batch) and of ``TestSegmentedRunSum::
test_32_term_query_stays_on_kernel``, each through the stacked-pack
search step. The same segments give both packs (6 shards padded to 8
with ``pad_shards_to``); the port's step runs on CPU meshes of shape
(1, 1), (1, 2), (2, 2) and (2, 4), which split the pack over the shards
axis and the batch over the data axis, gather in column order and sum
the totals exactly as a mesh of cards does, with ``torch.cat`` and a sum
as the transport. Vals (as uint32), gids and totals must equal the
reference's ``distributed_search_raw(..., variant=...)`` bit for bit,
for both compressed variants. One process, no spawned ranks.
"""

import dataclasses

import numpy as np
import pytest
import torch

from elasticsearch_tpu.common.settings import Settings
from elasticsearch_tpu.index.segment import SegmentWriter as RefWriter
from elasticsearch_tpu.mapping import MapperService as RefMapper
from elasticsearch_tpu.parallel import distributed as jdist
from elasticsearch_tpu.parallel.mesh import make_mesh as ref_make_mesh

from elasticsearch_tpu_torch.index.segment import SegmentWriter
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.parallel import distributed as tdist
from elasticsearch_tpu_torch.parallel.device import NoDeviceError
from elasticsearch_tpu_torch.parallel.mesh import (DATA_AXIS, SHARD_AXIS,
                                                   factorize_2d, make_mesh,
                                                   resolve_mesh)

torch.set_num_threads(1)

VOCAB = [f"w{i}" for i in range(48)]
MAPPING = {"properties": {"body": {"type": "text"}}}
SHAPES = [(1, 1), (1, 2), (2, 2), (2, 4)]
VARIANTS = ["compressed", "compressed_exact"]
N_SEGMENTS = 6
PAD_SHARDS = 8   # a multiple of every mesh's shards axis here


@pytest.fixture(scope="module")
def shard_docs():
    rng = np.random.default_rng(17)
    out = []
    for s in range(N_SEGMENTS):
        docs = []
        for i in range(30):
            n_tokens = int(rng.integers(1, 25))
            words = [VOCAB[min(int(rng.zipf(1.4)) - 1, len(VOCAB) - 1)]
                     for _ in range(n_tokens)]
            docs.append((f"s{s}-d{i}", {"body": " ".join(words)}))
        out.append(docs)
    return out


@pytest.fixture(scope="module")
def segments(shard_docs):
    ref_ms = RefMapper(Settings.EMPTY, MAPPING)
    ms = MapperService(MAPPING)
    ref, port = [], []
    for s, docs in enumerate(shard_docs):
        rw, pw = RefWriter(f"shard{s}"), SegmentWriter(f"shard{s}")
        for doc_id, src in docs:
            rw.add_document(ref_ms.parse_document(doc_id, src), {})
            pw.add_document(ms.parse_document(doc_id, src), ms.dv_kinds())
        ref.append(rw.freeze())
        port.append(pw.freeze())
    return ref, port


@pytest.fixture(scope="module")
def ref_mesh():
    return ref_make_mesh()   # the 8 virtual CPU devices → (2, 4)


def fields_of(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def assert_same_pack(tpack, jpack):
    for name, va in fields_of(jpack).items():
        if name not in fields_of(tpack):
            continue
        vb = getattr(tpack, name)
        if isinstance(va, np.ndarray):
            np.testing.assert_array_equal(vb, va, err_msg=name)
        elif isinstance(va, list) and va and isinstance(va[0], np.ndarray):
            for x, y in zip(vb, va):
                np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            assert vb == va, name


CASES = {
    # test_matches_oracle: OR queries of 1-4 terms, one absent term
    "matches_oracle": dict(queries=[["w0"], ["w1", "w2"],
                                    ["w3", "w0", "w5", "w9"],
                                    ["absent-term"]], k=12),
    # test_empty_query_row_padding: one query padded to the data axis
    "empty_query_row_padding": dict(queries=[["w0"]], k=5),
    # test_live_mask_excludes_tombstones: every doc of shard 0 deleted
    "live_mask_excludes_tombstones": dict(queries=[["w0"], ["w1", "w4"]],
                                          k=50, tombstones=True),
    # test_and_min_counts_default: min_count 2 turns counting on
    "and_min_counts_default": dict(queries=[["w0", "w1"]], k=500,
                                   min_counts=[2]),
    # TestSegmentedRunSum::test_32_term_query_stays_on_kernel: a
    # 33-term disjunction (t_window 33) beside a 3-term one
    "32_term_query_stays_on_kernel": dict(queries=[VOCAB[:33],
                                                   VOCAB[:3]], k=10),
}


def run_reference(segments, case, variant, mesh):
    ref_segs, _ = segments
    live = None
    if case.get("tombstones"):
        live = [np.zeros(ref_segs[0].num_docs, dtype=bool)] + [None] * (
            N_SEGMENTS - 1)
    jpack = jdist.build_stacked_pack(ref_segs, "body", live_docs=live,
                                     pad_shards_to=PAD_SHARDS)
    jstreams = jdist.build_compressed_streams(jpack)
    jbatch = jdist.prepare_query_batch(
        jpack, case["queries"], min_counts=case.get("min_counts"),
        pad_batch_to=4, compressed=jstreams)
    out = jdist.distributed_search_raw(jpack, jbatch, case["k"], mesh,
                                       variant=variant)
    return jpack, [np.asarray(a) for a in out]


def run_port(segments, case, variant, shape):
    _, port_segs = segments
    live = None
    if case.get("tombstones"):
        live = [np.zeros(port_segs[0].num_docs, dtype=bool)] + [None] * (
            N_SEGMENTS - 1)
    tpack = tdist.build_stacked_pack(port_segs, "body", live_docs=live,
                                     pad_shards_to=PAD_SHARDS)
    tstreams = tdist.build_compressed_streams(tpack)
    tbatch = tdist.prepare_query_batch(
        tpack, case["queries"], min_counts=case.get("min_counts"),
        pad_batch_to=4, compressed=tstreams)
    mesh = make_mesh(["cpu"] * (shape[0] * shape[1]), shape)
    image = tdist.device_put_compressed(tstreams, mesh)
    out = tdist.distributed_search_raw(tpack, tbatch, case["k"], mesh,
                                       device_arrays=image, variant=variant)
    return tpack, mesh, image, out


@pytest.fixture(scope="module")
def reference_results(segments, ref_mesh):
    """The reference's answer per (case, variant), computed once."""
    return {(name, variant): run_reference(segments, case, variant,
                                           ref_mesh)
            for name, case in CASES.items() for variant in VARIANTS}


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_search_matches_reference(segments, reference_results, name,
                                       shape, variant):
    jpack, (jv, jg, jt) = reference_results[(name, variant)]
    tpack, mesh, image, (tv, tg, tt) = run_port(segments, CASES[name],
                                                variant, shape)
    assert_same_pack(tpack, jpack)
    assert mesh.shape == {DATA_AXIS: shape[0], SHARD_AXIS: shape[1]}
    assert len(image.parts) == shape[0] and len(image.parts[0]) == shape[1]
    np.testing.assert_array_equal(tv.view(np.uint32), jv.view(np.uint32))
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_array_equal(tt, jt)
    # the reference tests' own checks, on the port's answer
    _, refs = tdist.decode_refs(tpack, tv, tg)
    hits = tdist.resolve_hits(tpack, refs)
    assert hits == jdist.resolve_hits(jpack, jdist.decode_refs(
        jpack, jv, jg)[1])
    case = CASES[name]
    n_real = len(case["queries"])
    assert all(r == [] for r in refs[n_real:]) and not tt[n_real:].any()
    if case.get("tombstones"):
        assert all(shard != 0 for row in refs for _, shard, _ in row)
    if name == "and_min_counts_default":
        got = {(s, d) for _, s, d in refs[0]}
        want = set()
        for si, seg in enumerate(segments[1]):
            p = seg.postings.get("body", {})
            d0 = set(int(x) for x in p.get("w0", (np.array([]), 0))[0])
            d1 = set(int(x) for x in p.get("w1", (np.array([]), 0))[0])
            want |= {(si, d) for d in d0 & d1}
        assert got == want
    if name == "32_term_query_stays_on_kernel":
        assert (tv[0] > float("-inf")).any()


def test_mesh_image_splits_shards_and_replicates_rows(segments):
    """Column c of every data row holds shards [c·S_l, (c+1)·S_l) of each
    stream; the data rows hold the same image."""
    tpack = tdist.build_stacked_pack(segments[1], "body",
                                     pad_shards_to=PAD_SHARDS)
    streams = tdist.build_compressed_streams(tpack)
    mesh = make_mesh(["cpu"] * 8, (2, 4))
    image = tdist.device_put_compressed(streams, mesh)
    host = tdist.device_put_compressed(streams,
                                       make_mesh(["cpu"])).parts[0][0]
    for d in range(2):
        for c in range(4):
            for part, whole in zip(image.parts[d][c], host):
                assert torch.equal(part, whole[2 * c: 2 * c + 2])
    assert sum(t.numel() * t.element_size() for t in image.row_arrays()) \
        == streams.nbytes_device()
    with pytest.raises(ValueError, match="shards axis"):
        tdist.device_put_compressed(streams, make_mesh(["cpu"] * 3))


def test_make_mesh_rules(monkeypatch):
    assert factorize_2d(8) == (2, 4) and factorize_2d(7) == (1, 7)
    mesh = make_mesh(["cpu"] * 4)
    assert mesh.shape == {DATA_AXIS: 1, SHARD_AXIS: 4}
    assert make_mesh(["cpu"] * 4, (2, 2)).grid[1][0] == torch.device("cpu")
    assert resolve_mesh("cpu").shape == {DATA_AXIS: 1, SHARD_AXIS: 1}
    with pytest.raises(ValueError, match="not both"):
        resolve_mesh("cpu", mesh)
    with pytest.raises(ValueError, match="shape"):
        make_mesh(["cpu"] * 4, (3, 1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoDeviceError):
        make_mesh()
    with pytest.raises(NoDeviceError):
        make_mesh(["cuda:0"])


def test_local_search_is_the_one_device_mesh_step(segments):
    """make_local_search runs the (1, 1) mesh's step: the same answer as
    distributed_search_raw on that mesh; a larger mesh is refused."""
    case = CASES["matches_oracle"]
    tpack, mesh, image, (tv, tg, tt) = run_port(segments, case,
                                                "compressed", (1, 1))
    tbatch = tdist.prepare_query_batch(
        tpack, case["queries"], pad_batch_to=4,
        compressed=tdist.build_compressed_streams(tpack))
    step = tdist.make_local_search(
        max_len=tbatch.max_len, d_pad=tpack.d_pad, p_pad=tpack.p_pad,
        k=case["k"], t_window=tbatch.window,
        with_counts=tbatch.need_counts)
    lv, lg, lt = (x.numpy() for x in step(image, tbatch))
    np.testing.assert_array_equal(lv.view(np.uint32), tv.view(np.uint32))
    np.testing.assert_array_equal(lg, tg)
    np.testing.assert_array_equal(lt, tt)
    wide = make_mesh(["cpu"] * 2)
    with pytest.raises(ValueError, match=r"\(1, 1\) mesh"):
        step(tdist.device_put_compressed(
            tdist.build_compressed_streams(tpack), wide), tbatch)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_device_bodies_run_outside_the_dispatch_lock(segments, monkeypatch,
                                                     shape):
    """A multi-device step holds DEVICE_DISPATCH_LOCK only around its
    collectives: every device body runs with the lock free, so another
    pack's train can use the cards meanwhile. Each device runs its body
    once, in grid order, and the answer is the plain step's."""
    case = CASES["matches_oracle"]
    _, _, _, want = run_port(segments, case, "compressed", shape)
    real = tdist._local_body
    offsets = []

    def body(*args, **kw):
        assert not tdist.DEVICE_DISPATCH_LOCK.locked()
        offsets.append(kw["shard_offset"])
        return real(*args, **kw)

    monkeypatch.setattr(tdist, "_local_body", body)
    _, _, _, got = run_port(segments, case, "compressed", shape)
    s_l = PAD_SHARDS // shape[1]
    assert offsets == [c * s_l for c in range(shape[1])] * shape[0]
    np.testing.assert_array_equal(got[0].view(np.uint32),
                                  want[0].view(np.uint32))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
