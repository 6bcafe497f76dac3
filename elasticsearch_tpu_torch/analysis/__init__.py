"""Text analysis of the port: the ``standard`` and ``keyword`` analyzers
(``analysis/analyzers.py``)."""

from elasticsearch_tpu_torch.analysis.analyzers import (  # noqa: F401
    ANALYZERS, KeywordAnalyzer, StandardAnalyzer, standard_tokenize)
