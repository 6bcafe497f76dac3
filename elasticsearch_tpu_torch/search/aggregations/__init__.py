"""Aggregations: copy of the reference's ``search/aggregations``.

Import order matters: the bucket and metrics modules register their
parsers with base's registry on import."""

from elasticsearch_tpu_torch.search.aggregations.base import (  # noqa: F401
    Aggregator,
    AggregatorFactories,
    InternalAggregation,
    SegmentAggContext,
    parse_aggregations,
)
from elasticsearch_tpu_torch.search.aggregations import bucket as _bucket  # noqa: F401,E402
from elasticsearch_tpu_torch.search.aggregations import metrics as _metrics  # noqa: F401,E402
from elasticsearch_tpu_torch.search.aggregations.pipeline import (  # noqa: F401,E402
    build_response,
)
