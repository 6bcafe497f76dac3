"""Port copy of ``test_distributed.py::TestDistributedKnn``: the mesh kNN
step on CPU meshes.

Bars, each with its reason:

* the reference test's numpy oracle: top-10 ids equal, scores within
  rtol 2e-4;
* the port's mesh against its own no-mesh run: bit for bit (every
  (doc, query) score is one kernel chain, independent of the device
  that holds the doc, and the gathered lists keep position order);
* the port against the reference's ``distributed_knn`` on the same pack
  (``convert.vector_pack_from_reference``): ids equal, scores within
  rtol 1e-5. Not bit for bit, because the reference's mesh step has no
  bitwise bar of its own: its ``q @ safe.T`` is a [B, dims] x [dims, N]
  GEMM whose association XLA:CPU chooses by shape (a sequential FMA
  chain over 512-column blocks at [4, dims] x [dims, 64], neither that
  nor the gemv's at [8, 128] x [128, 1024]), so its mesh and
  single-device runs agree only to rtol 1e-5
  (``TestDistributedKnn::test_single_device_fallback_matches_mesh``).
  The port computes the mesh step's dot products as the gemv chain of
  the per-segment path.
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.segment import SegmentWriter as RefSegmentWriter
from elasticsearch_tpu.mapping import ParsedDocument as RefParsedDocument
from elasticsearch_tpu.parallel import distributed as ref_dist
from elasticsearch_tpu.parallel.mesh import make_mesh as ref_make_mesh

from elasticsearch_tpu_torch.convert import vector_pack_from_reference
from elasticsearch_tpu_torch.index.segment import SegmentWriter
from elasticsearch_tpu_torch.mapping import ParsedDocument
from elasticsearch_tpu_torch.parallel import distributed as dist
from elasticsearch_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

MESH_SHAPES = [(1, 1), (1, 2), (1, 4), (2, 2)]


def _mesh(shape):
    return make_mesh(["cpu"] * (shape[0] * shape[1]), shape)


def _make_vec_segments(rng, n_shards, docs_per_shard, dims,
                       writer=SegmentWriter, parsed=ParsedDocument):
    segments, all_vecs, all_ids = [], [], []
    for s in range(n_shards):
        w = writer(f"seg{s}")
        for d in range(docs_per_shard):
            vec = rng.standard_normal(dims).astype(np.float32)
            doc_id = f"s{s}d{d}"
            pd = parsed(doc_id=doc_id, routing=None,
                        source={"e": vec.tolist()}, postings_terms={},
                        field_lengths={}, doc_values={"e": vec.tolist()},
                        term_slots={}, nested={})
            w.add_document(pd, {"e": "vec"})
            all_vecs.append(vec)
            all_ids.append(doc_id)
        segments.append(w.freeze())
    return segments, np.stack(all_vecs), all_ids


def _oracle(mat, q, similarity):
    if similarity == "l2_norm":
        d2 = ((mat - q) ** 2).sum(axis=1)
        return 1.0 / (1.0 + d2)
    if similarity == "dot_product":
        return (1.0 + mat @ q) / 2.0
    cos = (mat @ q) / (np.linalg.norm(mat, axis=1) * np.linalg.norm(q))
    return (1.0 + cos) / 2.0


@pytest.mark.parametrize("similarity", ["cosine", "dot_product", "l2_norm"])
@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_matches_oracle(seeded_np, shape, similarity):
    mesh = _mesh(shape)
    n_shards = 4
    segments, mat, ids = _make_vec_segments(seeded_np, n_shards, 40, 16)
    pack = dist.build_stacked_vector_pack(segments, "e",
                                          similarity=similarity)
    q = seeded_np.standard_normal((3, 16)).astype(np.float32)
    vals, refs = dist.distributed_knn(pack, q, 10, mesh)
    for qi in range(3):
        oracle_scores = _oracle(mat, q[qi], similarity)
        oracle_order = np.argsort(-oracle_scores)[:10]
        got_ids = [pack.shard_doc_ids[shard][ord_]
                   for _, shard, ord_ in refs[qi]]
        assert got_ids == [ids[i] for i in oracle_order]
        np.testing.assert_allclose(
            [v for v in vals[qi] if v != dist.NEG_INF][:10],
            oracle_scores[oracle_order], rtol=2e-4)


@pytest.mark.parametrize("similarity", ["cosine", "dot_product", "l2_norm"])
@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_single_device_matches_mesh_bitwise(seeded_np, shape, similarity):
    segments, _, _ = _make_vec_segments(seeded_np, 4, 25, 8)
    pack = dist.build_stacked_vector_pack(segments, "e",
                                          similarity=similarity)
    q = seeded_np.standard_normal((2, 8)).astype(np.float32)
    vals_m, refs_m = dist.distributed_knn(pack, q, 5, _mesh(shape))
    vals_s, refs_s = dist.distributed_knn(pack, q, 5, None, device="cpu")
    np.testing.assert_array_equal(vals_m.view(np.uint32),
                                  vals_s.view(np.uint32))
    assert refs_m == refs_s


def test_tombstones_excluded(seeded_np):
    mesh = _mesh((1, 4))
    n_shards = 4
    segments, _, _ = _make_vec_segments(seeded_np, n_shards, 20, 4)
    live, dead = [], set()
    for s, seg in enumerate(segments):
        m = np.ones(seg.num_docs, dtype=bool)
        m[3] = False
        dead.add(f"s{s}d3")
        live.append(m)
    pack = dist.build_stacked_vector_pack(segments, "e", live_docs=live)
    q = seeded_np.standard_normal((1, 4)).astype(np.float32)
    _, refs = dist.distributed_knn(pack, q, 200, mesh)
    got = {pack.shard_doc_ids[s][o] for _, s, o in refs[0]}
    assert not (got & dead)
    assert len(got) == n_shards * 20 - len(dead)


def test_missing_vectors_and_padded_shards(seeded_np):
    """Rows without a vector (NaN) and padding shards never surface; a
    pack padded to the columns splits over them."""
    segments, _, _ = _make_vec_segments(seeded_np, 3, 30, 8)
    pack = dist.build_stacked_vector_pack(segments, "e", pad_shards_to=4)
    pack.vectors[1, 5] = np.nan
    q = seeded_np.standard_normal((2, 8)).astype(np.float32)
    _, refs = dist.distributed_knn(pack, q, 500, _mesh((1, 4)))
    for row in refs:
        assert len(row) == 3 * 30 - 1
        assert (1, 5) not in {(s, o) for _, s, o in row}
        assert all(s < 3 for _, s, _ in row)


@pytest.mark.parametrize("similarity", ["cosine", "dot_product", "l2_norm"])
def test_matches_reference_distributed_knn(seeded_np, similarity):
    """The reference's distributed_knn on its own mesh and on one device
    against the port's on the same pack: ids equal, scores within rtol
    1e-5 (the reference's own mesh-against-single bar: see the module
    docstring)."""
    ref_segments, _, _ = _make_vec_segments(
        seeded_np, 8, 30, 24, writer=RefSegmentWriter,
        parsed=RefParsedDocument)
    ref_pack = ref_dist.build_stacked_vector_pack(
        ref_segments, "e", similarity=similarity)
    ref_pack.live[2, 7] = False
    ref_pack.vectors[5, 3] = np.nan
    pack = vector_pack_from_reference(
        {f: getattr(ref_pack, f) for f in ref_pack.__dataclass_fields__})
    q = np.random.default_rng(3).standard_normal((4, 24)).astype(
        np.float32)
    ref_mesh = ref_make_mesh()
    for ref_run in (ref_dist.distributed_knn(ref_pack, q, 10, ref_mesh),
                    ref_dist.distributed_knn(ref_pack, q, 10, None)):
        for shape in ((1, 1), (1, 4)):
            vals, refs = dist.distributed_knn(pack, q, 10, _mesh(shape))
            assert [[(s, o) for _, s, o in row] for row in refs] == \
                [[(s, o) for _, s, o in row] for row in ref_run[1]]
            np.testing.assert_allclose(vals, np.asarray(ref_run[0]),
                                       rtol=1e-5)
