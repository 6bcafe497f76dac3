"""Text analysis of the port: tokenizers, token filters, analyzers and
the per-index registry (``analysis/analyzers.py``,
``analysis/filters.py``)."""

from elasticsearch_tpu_torch.analysis.analyzers import (  # noqa: F401
    ENGLISH_STOP_WORDS, AnalysisRegistry, Analyzer, CustomAnalyzer,
    KeywordAnalyzer, SimpleAnalyzer, StandardAnalyzer, StopAnalyzer,
    WhitespaceAnalyzer, standard_tokenize)
