"""A reference node and a port node driven with the same requests.

``Pair.both`` sends one ``node.handle(...)`` request to each and returns
both answers as the bytes the HTTP layer sends (``dumps_response``, or
the text of a ``_cat`` table), with ``took`` set to 0 and the fields of
``MASKED`` masked. The reference node runs its fused kernel in interpret
mode on the CPU; the port node runs on the CPU (its plain path). Both
nodes get the same node id (written into each data path before the
node starts), so that the ids in ``_nodes/stats``, ``_cluster/state``
and ``_cat/master`` compare as they are.

``random_agg_docs`` and ``random_agg_body`` make a seeded random mix of
aggregation requests (terms with metrics under it, fixed and calendar
histograms, stats, cardinality, range, filters, percentiles and
pipelines, under random queries, sizes and sorts) over
``AGG_MIX_MAPPING``, for the pair to compare."""

import json
import os
import re

from elasticsearch_tpu.common.settings import Settings as RefSettings
from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.search.serializer import dumps_response as ref_dumps

from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.search.serializer import dumps_response

REF_SETTINGS = {"search.tpu_serving.kernel.pallas": True,
                "search.flight_recorder.enabled": False}

NODE_ID = "pairnode0000000000id"

#: the fields that differ between two nodes whatever the port does, each
#: with its reason. A key's scalar value is masked wherever it appears;
#: everything else is compared byte for byte.
MASKED = {
    "took": "wall-clock time (each _msearch item carries its own)",
    "uuid": "an index's uuid is drawn at random by each node",
    "creation_date": "the wall clock when the index was created",
    "allocation_id": "a shard copy's id is drawn at random",
    "cluster_uuid": "drawn at random by each node",
    "search_visible_lag_seconds": "wall-clock time from a write to its "
                                  "refresh",
    "max_rss_bytes": "the test process's memory, not the node's",
    "_scroll_id": "a scroll context's id: uuid4, drawn by each node",
    "pit_id": "a point-in-time context's id: uuid4, drawn by each node",
    "id": "a point-in-time context's id (the open response): uuid4, "
          "drawn by each node",
}
#: blocks of _nodes/stats masked whole, with their reasons
MASKED_NODE_BLOCKS = {
    "tpu_search": "the device block: the reference's TpuSearchService "
                  "against the port's GpuSearchService.stats()",
    "thread_pool": "thread pools are not ported yet",
    "indexing_pressure": "indexing pressure is not ported yet",
    "search_backpressure": "search backpressure is not ported yet",
    "tenants": "tenancy is not ported yet",
}
_SCALAR = r'("(?:[^"\\]|\\.)*"|-?[0-9][0-9.eE+-]*|null|true|false)'
_MASK_RE = re.compile(r'"(%s)": ?%s' % ("|".join(MASKED), _SCALAR))
_UUID_RE = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
                      r"[0-9a-f]{12}")
#: a _cat table's epoch and wall-clock columns (_cat/health, _cat/count)
_CLOCK_RE = re.compile(r"^\d{10} \d\d:\d\d:\d\d", re.M)


def _mask_tree(obj):
    if isinstance(obj, dict):
        return {k: "<masked>" if k in MASKED else _mask_tree(v)
                for k, v in obj.items() if k not in MASKED_NODE_BLOCKS}
    if isinstance(obj, list):
        return [_mask_tree(v) for v in obj]
    return obj


def masked(text):
    """`text` with the MASKED fields replaced: in JSON by key; in a _cat
    table the uuid and clock columns, by same-width placeholders (so the
    column widths still compare). _nodes/stats, plain json.dumps on both
    sides, is masked on its parsed body, where the MASKED_NODE_BLOCKS go
    and a masked key's value may be an object."""
    if text.startswith("{"):
        if text.startswith('{"_nodes": '):
            return json.dumps(_mask_tree(json.loads(text)))
        return _MASK_RE.sub(lambda m: f'"{m.group(1)}": "<masked>"', text)
    text = _UUID_RE.sub("u" * 36, text)
    return _CLOCK_RE.sub("e" * 10 + " " + "t" * 8, text)


def call(node, dumps, method, path, body=None, raw=None, params=None):
    """One request through node.handle → (status, response bytes with
    took = 0)."""
    if raw is None:
        raw = json.dumps(body).encode() if body is not None else b""
    status, payload = node.handle(method, path, dict(params or {}), None,
                                  raw)
    if isinstance(payload, dict) and "took" in payload:
        payload["took"] = 0
    if isinstance(payload, dict) and list(payload) == ["_cat"]:
        return status, payload["_cat"]
    return status, dumps(payload)


class Pair:
    """The two nodes, each on its own data path under `root`; `settings`
    go to both (over REF_SETTINGS on the reference's side)."""

    def __init__(self, root, settings=None):
        self.root = root
        self.settings = dict(settings or {})
        for side in ("ref", "port"):
            os.makedirs(root / side / "_state", exist_ok=True)
            (root / side / "_state" / "node_id").write_text(NODE_ID)
        self.ref = self._ref_node()
        self.port = self._port_node()
        # context ids: the reference's → the port's, and back
        self._port_ids = {}
        self._ref_ids = {}

    def _ref_node(self):
        return RefNode(str(self.root / "ref"), settings=RefSettings.of(
            dict(REF_SETTINGS, **self.settings)))

    def _port_node(self):
        return Node(str(self.root / "port"), device="cpu",
                    settings=Settings.of(self.settings))

    def both(self, method, path, body=None, raw=None, params=None):
        """→ (reference answer, port answer)."""
        want = call(self.ref, ref_dumps, method, path, body, raw, params)
        got = call(self.port, dumps_response, method, path, body, raw,
                   params)
        return (want[0], masked(want[1])), (got[0], masked(got[1]))

    def same(self, method, path, body=None, raw=None, params=None):
        """Send to both, assert the same bytes, return the parsed
        answer."""
        want, got = self.both(method, path, body, raw, params)
        assert got == want, (method, path, want, got)
        return want[0], json.loads(want[1])

    def handle(self, method, path, params=None, body=None, raw=None):
        """``same`` for a test that carries a scroll or PIT id from one
        answer into its next request: the caller sees and sends the
        reference's ids, the port's request carries the port's own id
        for each, and the port's answer has its ids put back before the
        bytes are compared. → (status, parsed reference answer)."""
        port_args = [self._translate(v, self._port_ids)
                     for v in (path, body, params)]
        want = call(self.ref, ref_dumps, method, path, body, raw, params)
        got = call(self.port, dumps_response, method, port_args[0],
                   port_args[1], raw, port_args[2])
        self._learn_ids(want[1], got[1])
        got = (got[0], self._translate(got[1], self._ref_ids))
        assert (got[0], masked(got[1])) == (want[0], masked(want[1])), \
            (method, path, want, got)
        return want[0], json.loads(want[1])

    #: the answers' keys that hold a context id
    _ID_KEYS = ("_scroll_id", "id", "pit_id")

    def _learn_ids(self, want_text, got_text):
        if not (want_text.startswith("{") and got_text.startswith("{")):
            return
        want, got = json.loads(want_text), json.loads(got_text)
        for key in self._ID_KEYS:
            a, b = want.get(key), got.get(key)
            if isinstance(a, str) and isinstance(b, str):
                self._port_ids[a] = b
                self._ref_ids[b] = a

    @staticmethod
    def _translate(value, ids):
        """`value` (a path, a body, params or an answer's text) with every
        id of `ids` replaced by its counterpart."""
        if isinstance(value, str):
            for old, new in ids.items():
                value = value.replace(old, new)
            return value
        if isinstance(value, dict):
            return {k: Pair._translate(v, ids) for k, v in value.items()}
        if isinstance(value, list):
            return [Pair._translate(v, ids) for v in value]
        return value

    def restart_port(self):
        """Close the port node and open a new one on its data path."""
        self.port.close()
        self.port = self._port_node()

    def restart(self):
        """Close both nodes and open new ones on their data paths."""
        self.ref.close()
        self.ref = self._ref_node()
        self.restart_port()

    def close(self):
        self.port.close()
        self.ref.close()


#: the mapping random_agg_body's aggregations read: a keyword, a long,
#: a double and a date (random_agg_docs fills it)
AGG_MIX_MAPPING = {"properties": {
    "tag": {"type": "keyword"}, "n": {"type": "long"},
    "x": {"type": "double"}, "when": {"type": "date"},
    "body": {"type": "text"}}}


def random_agg_docs(rng, count):
    """`count` seeded docs over AGG_MIX_MAPPING: Zipf tags, missing
    values, ±0 and subnormal doubles among normal ones."""
    docs = []
    for _ in range(count):
        doc = {"tag": f"t{int(rng.zipf(1.6)) % 12}",
               "body": " ".join(rng.choice(["red", "blue", "green"], 2))}
        if rng.random() < 0.9:
            doc["n"] = int(rng.integers(-500, 5000))
        if rng.random() < 0.9:
            doc["x"] = float(rng.choice([rng.normal(0, 100), -0.0, 0.0,
                                         1e-310, rng.normal(0, 1e-3)]))
        if rng.random() < 0.9:
            doc["when"] = int(1_600_000_000_000
                              + rng.integers(0, 400) * 86_400_000)
        docs.append(doc)
    return docs


def random_agg_body(rng):
    """One seeded search body from the aggregation mix: terms (with
    numeric metrics under it), histograms (fixed and calendar), stats,
    cardinality, range, filters and pipelines, under a random query,
    size and sort."""
    metric = lambda: {str(rng.choice(["avg", "sum", "min", "max",  # noqa
                                      "stats", "value_count"])): {
        "field": str(rng.choice(["n", "x"]))}}
    kinds = [
        lambda: {"terms": {"field": "tag", "size": int(rng.integers(1, 15))},
                 "aggs": {"m": metric(), "k": metric()}},
        lambda: {"terms": {"field": "tag", "order": {"_key": "asc"}}},
        lambda: {"histogram": {"field": str(rng.choice(["n", "x"])),
                               "interval": float(rng.choice([7, 250, 0.5]))}},
        lambda: {"date_histogram": {"field": "when", "calendar_interval":
                                    str(rng.choice(["month", "week"]))},
                 "aggs": {"s": {"sum": {"field": "n"}},
                          "cs": {"cumulative_sum": {"buckets_path": "s"}},
                          "d": {"derivative": {"buckets_path": "s"}}}},
        lambda: {"date_histogram": {"field": "when",
                                    "fixed_interval": "10d"}},
        lambda: metric(),
        lambda: {"cardinality": {"field": "tag"}},
        lambda: {"range": {"field": "n", "ranges": [
            {"to": 100}, {"from": 100, "to": 2000}, {"from": 2000}]}},
        lambda: {"filters": {"filters": {
            "r": {"match": {"body": "red"}},
            "b": {"range": {"n": {"gte": 1000}}}}}},
        lambda: {"percentiles": {"field": "x"}},
    ]
    aggs = {f"a{j}": kinds[int(rng.integers(0, len(kinds)))]()
            for j in range(int(rng.integers(1, 4)))}
    for name, agg in list(aggs.items()):
        if "date_histogram" in agg and "aggs" in agg:
            aggs["avg_s"] = {"avg_bucket": {"buckets_path": f"{name}>s"}}
            break
    body = {"size": int(rng.choice([0, 0, 3])), "aggs": aggs}
    q = int(rng.integers(0, 4))
    if q == 1:
        body["query"] = {"match": {"body": str(rng.choice(
            ["red", "blue"]))}}
    elif q == 2:
        body["query"] = {"range": {"n": {"gte": int(rng.integers(0, 3000))}}}
    elif q == 3:
        body["query"] = {"match": {"body": "green"}}
        body["min_score"] = 0.1
    if body["size"] and rng.random() < 0.5:
        body["sort"] = [{"n": "desc"}]
    return body
