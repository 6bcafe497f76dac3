"""The port's node on the card against the same node on the CPU: the
same REST requests give the same response bytes (``took`` set to 0)
when the merge kernel answers on the card and its plain version on the
CPU; deleting the index drains the ``hbm`` breaker to 0 and returns
``torch.cuda.memory_allocated()`` to its value before the pack.

Marked gpu: skips without a CUDA device. On the card:
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_node_gpu.py -q``.
"""

import gc
import json
import time

import pytest
import torch

from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops import merge_kernel
from elasticsearch_tpu_torch.search.serializer import dumps_response

from torch_parity_cases import PARITY_BODIES, bulk_ndjson, make_docs

pytestmark = pytest.mark.gpu

INDEX_BODY = {"settings": {"number_of_shards": 3},
              "mappings": {"properties": {"body": {"type": "text"}}}}


def call(node, method, path, body=None, raw=None):
    if raw is None:
        raw = json.dumps(body).encode() if body is not None else b""
    status, payload = node.handle(method, path, {}, None, raw)
    if isinstance(payload, dict) and "took" in payload:
        payload["took"] = 0
    return status, dumps_response(payload)


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    gpu = Node(str(tmp_path_factory.mktemp("gpu")))
    cpu = Node(str(tmp_path_factory.mktemp("cpu")), device="cpu")
    try:
        for node in (gpu, cpu):
            call(node, "PUT", "/corpus", INDEX_BODY)
            call(node, "POST", "/corpus/_bulk", raw=bulk_ndjson(make_docs()))
            call(node, "POST", "/corpus/_refresh")
        yield gpu, cpu
    finally:
        gpu.close()
        cpu.close()


@pytest.mark.parametrize("source", [True, False], ids=["source", "nosource"])
@pytest.mark.parametrize("body", PARITY_BODIES,
                         ids=[f"body{i}" for i in range(len(PARITY_BODIES))])
def test_card_bytes_match_cpu_bytes(nodes, body, source):
    gpu, cpu = nodes
    before = merge_kernel.LAUNCHES["select_rescore"]
    got = call(gpu, "POST", "/corpus/_search", dict(body, _source=source))
    assert merge_kernel.LAUNCHES["select_rescore"] > before
    want = call(cpu, "POST", "/corpus/_search", dict(body, _source=source))
    assert got[0] == 200, got
    assert got == want


def test_delete_drains_breaker_and_device_memory(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    node = Node(str(tmp_path))
    try:
        call(node, "PUT", "/drain", INDEX_BODY)
        call(node, "POST", "/drain/_bulk", raw=bulk_ndjson(make_docs(120, 5)))
        call(node, "POST", "/drain/_refresh")
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        hbm = node.breakers.get_breaker("hbm")
        assert call(node, "POST", "/drain/_search",
                    {"query": {"match": {"body": "alpha"}}})[0] == 200
        resident = node.gpu_search.packs.residents()[0]
        assert hbm.used == resident.nbytes_device() > 0
        del resident
        assert call(node, "DELETE", "/drain")[0] == 200
        assert hbm.used == 0
        after = None
        for _ in range(50):  # the retired batcher thread lets go
            gc.collect()
            torch.cuda.synchronize()
            after = torch.cuda.memory_allocated()
            if after == before:
                break
            time.sleep(0.1)
        assert after == before
    finally:
        node.close()
