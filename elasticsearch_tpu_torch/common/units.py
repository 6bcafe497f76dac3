"""Byte-size and time-value units.

Copy of the parsers of the reference's ``common/units.py`` (its
``ByteSizeValue.parse`` and ``TimeValue.parse``): the same suffix grammar,
so a size or a duration written for the reference ("512mb", "30s")
reads the same here.
"""

from __future__ import annotations

import re

from elasticsearch_tpu_torch.common.errors import IllegalArgumentException

_BYTE_SUFFIXES = {"b": 1, "kb": 1024, "mb": 1024 ** 2, "gb": 1024 ** 3,
                  "tb": 1024 ** 4, "pb": 1024 ** 5}

_TIME_SUFFIXES = {"nanos": 1e-9, "micros": 1e-6, "ms": 1e-3, "s": 1.0,
                  "m": 60.0, "h": 3600.0, "d": 86400.0}


def parse_bytes(value) -> int:
    """"512mb" → bytes; a bare number is bytes."""
    if isinstance(value, (int, float)):
        return int(value)
    s = str(value).strip().lower()
    m = re.fullmatch(r"(-?\d+(?:\.\d+)?)\s*([kmgtp]?b)?", s)
    if not m:
        raise IllegalArgumentException(f"failed to parse byte size [{value}]")
    num, suffix = m.groups()
    if "." in num and suffix in (None, "b"):
        raise IllegalArgumentException(
            f"failed to parse byte size [{value}]: fractional bytes")
    return int(float(num) * _BYTE_SUFFIXES[suffix or "b"])


def parse_seconds(value) -> float:
    """"30s" → seconds; a bare number is milliseconds, -1 stays -1."""
    if isinstance(value, (int, float)):
        return -1.0 if value == -1 else float(value) / 1000.0
    s = str(value).strip().lower()
    if s == "-1":
        return -1.0
    m = re.fullmatch(r"(-?\d+(?:\.\d+)?)\s*(nanos|micros|ms|s|m|h|d)", s)
    if not m:
        raise IllegalArgumentException(f"failed to parse time value [{value}]")
    num, suffix = m.groups()
    return float(num) * _TIME_SUFFIXES[suffix]
