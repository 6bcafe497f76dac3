"""A row past 1,024 posting slots through both nodes' REST path: the
reference's bytes.

One document of 1,100 distinct words and a ``terms`` query over all of
them: 1,100 slots a row (T 2048), the document's run of 1,100 lanes (the
doubling run sum's 11th step). tests/test_torch_node.py sends it to a
compressed pack on both nodes (the fused merge kernel's plain version
here); this file sends it to a raw pack on the port (the node setting
``search.tpu_serving.kernel.compressed_pack: false``, the raw merge's
plain version), against the reference's compressed pack (its Pallas
kernel, interpreted, on one device of its CPU mesh).

The reference's own raw variant at this shape (8 rows × 2,048 slots ×
4,096 lanes on XLA:CPU) grew past 47 GB here and was killed, and its
compressed_exact (unpackable weights) peaked at 53.8 GB, past what a
test process may take; so its compressed pack, whose answers its
contract makes equal to the raw pack's bit for bit, stands in for the
first, and the unpackable format is held to the reference op by op
(tests/test_torch_wide_slots.py, compressed_exact at T 2048 and 4096)
and to the CPU node's bytes on the card (tests/test_torch_node_gpu.py).

The reference must serve the query from its kernel path (``served``
up, ``fallback`` unchanged: its planner would meet the int32 overflow
of a 32-term pass, Queue C4, and answer 503). A train of this row takes
~20 s on the reference and up to ~60 s on the port's plain version, so
both nodes wait up to 600 s for a train.
"""

import pytest
import torch

from elasticsearch_tpu.parallel.mesh import make_mesh as ref_make_mesh
from elasticsearch_tpu.search import tpu_service as ref_tpu

from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.node import Node

from torch_rest_pair import Pair

torch.set_num_threads(1)

WORDS = [f"w{i}" for i in range(1100)]


def one_device(tpu):
    """The reference's packs from now on on one device of its CPU mesh:
    the tests' 8 virtual devices would pad the one shard's rows to 8."""
    tpu.packs.invalidate_all()
    tpu.packs.set_mesh(ref_make_mesh(
        shape=(1, 1), devices=ref_make_mesh().devices.flat[:1]))
    tpu.batcher.mesh = tpu.packs.mesh
WAIT = {"search.tpu_serving.batch_timeout_seconds": 600.0}


def test_wide_row_bytes_match_reference(tmp_path):
    saved = dict(ref_tpu.KERNEL_CONFIG)
    pair = Pair(tmp_path, settings=WAIT)
    try:
        pair.port.close()
        pair.port = Node(str(tmp_path / "port"), device="cpu",
                         settings=Settings.of(dict(WAIT, **{
                             "search.tpu_serving.kernel."
                             "compressed_pack": False})))
        assert ref_tpu.KERNEL_CONFIG["compressed_pack"]
        one_device(pair.ref.tpu_search)
        pair.same("PUT", "/wide/_doc/1", {"body": " ".join(WORDS)},
                  params={"refresh": "true"})
        pair.same("PUT", "/wide/_doc/2", {"body": "w0 w7 w1099"},
                  params={"refresh": "true"})
        terms = {"body": WORDS}
        served = pair.ref.tpu_search.served
        fallback = pair.ref.tpu_search.fallback
        status, res = pair.same("POST", "/wide/_search",
                                {"query": {"terms": terms}})
        assert pair.ref.tpu_search.served == served + 1
        assert pair.ref.tpu_search.fallback == fallback
        assert status == 200
        assert [h["_id"] for h in res["hits"]["hits"]] == ["1", "2"]
        gpu = pair.port.gpu_search
        assert gpu.launch_shapes == {(8, 2048, 128): 1}
        assert gpu.variant_launches == {"packed": 1}
        assert gpu.packs.residents()[0].streams is None  # a raw pack
    finally:
        pair.close()
        ref_tpu.KERNEL_CONFIG.clear()
        ref_tpu.KERNEL_CONFIG.update(saved)
