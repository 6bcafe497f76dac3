"""A reference node and a port node driven with the same requests.

``Pair.both`` sends one ``node.handle(...)`` request to each and returns
both answers as the bytes the HTTP layer sends (``dumps_response``),
with ``took`` set to 0. The reference node runs its fused kernel in
interpret mode on the CPU; the port node runs on the CPU (its plain
path)."""

import json

from elasticsearch_tpu.common.settings import Settings as RefSettings
from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.search.serializer import dumps_response as ref_dumps

from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.search.serializer import dumps_response

REF_SETTINGS = {"search.tpu_serving.kernel.pallas": True,
                "search.flight_recorder.enabled": False}


def call(node, dumps, method, path, body=None, raw=None, params=None):
    """One request through node.handle → (status, response bytes with
    took = 0)."""
    if raw is None:
        raw = json.dumps(body).encode() if body is not None else b""
    status, payload = node.handle(method, path, dict(params or {}), None,
                                  raw)
    if isinstance(payload, dict) and "took" in payload:
        payload["took"] = 0
    return status, dumps(payload)


class Pair:
    """The two nodes, each on its own data path under `root`; `settings`
    go to both (over REF_SETTINGS on the reference's side)."""

    def __init__(self, root, settings=None):
        self.root = root
        self.settings = dict(settings or {})
        self.ref = RefNode(str(root / "ref"), settings=RefSettings.of(
            dict(REF_SETTINGS, **self.settings)))
        self.port = self._port_node()

    def _port_node(self):
        return Node(str(self.root / "port"), device="cpu",
                    settings=Settings.of(self.settings))

    def both(self, method, path, body=None, raw=None, params=None):
        """→ (reference answer, port answer)."""
        want = call(self.ref, ref_dumps, method, path, body, raw, params)
        got = call(self.port, dumps_response, method, path, body, raw,
                   params)
        return want, got

    def same(self, method, path, body=None, raw=None, params=None):
        """Send to both, assert the same bytes, return the parsed
        answer."""
        want, got = self.both(method, path, body, raw, params)
        assert got == want, (method, path, want, got)
        return want[0], json.loads(want[1])

    def restart_port(self):
        """Close the port node and open a new one on its data path."""
        self.port.close()
        self.port = self._port_node()

    def close(self):
        self.port.close()
        self.ref.close()
