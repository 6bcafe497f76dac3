"""``GET /``: the node's identity (the reference's root action in
``rest/actions/cluster.py``)."""

from __future__ import annotations

from elasticsearch_tpu_torch import __version__
from elasticsearch_tpu_torch.rest.controller import RestController, RestRequest


def register(controller: RestController, node) -> None:

    def root(req: RestRequest):
        return 200, {
            "name": node.node_name,
            "cluster_name": node.cluster_name,
            "cluster_uuid": node.cluster_uuid,
            "version": {"number": __version__,
                        "build_flavor": "cuda",
                        "lucene_version": "n/a (hand-written CUDA kernels)"},
            "tagline": "You Know, for Search — on GPUs",
        }

    controller.register("GET", "/", root)
