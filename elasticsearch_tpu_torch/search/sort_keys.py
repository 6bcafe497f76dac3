"""The sort-spec grammar and the comparable keys of a sort.

Copy of the reference's ``search/sort_keys.py``: ``parse_sort`` (the
FieldSortBuilder grammar) and ``sort_key``, which turns a hit's sort
values into a tuple that compares in sort order (missing placement,
direction, strings descending by inverted code points). Standard
library only; ``search/sort.py`` re-exports these names.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Sequence, Tuple

from elasticsearch_tpu_torch.common.errors import IllegalArgumentException


@dataclasses.dataclass
class SortSpec:
    field: str                      # field name | "_score" | "_doc"
    order: str = "asc"              # "asc" | "desc"
    missing: Any = "_last"          # "_last" | "_first" | literal value


def parse_sort(spec: Any) -> List[SortSpec]:
    """Reference grammar (FieldSortBuilder#fromXContent)."""
    if spec is None:
        return []
    if not isinstance(spec, list):
        spec = [spec]
    out: List[SortSpec] = []
    for entry in spec:
        if isinstance(entry, str):
            default = "desc" if entry == "_score" else "asc"
            out.append(SortSpec(entry, default))
        elif isinstance(entry, dict):
            if len(entry) != 1:
                raise IllegalArgumentException(
                    "[sort] entry must name exactly one field")
            field, opts = next(iter(entry.items()))
            if isinstance(opts, str):
                opts = {"order": opts}
            if not isinstance(opts, dict):
                raise IllegalArgumentException(
                    f"[sort] malformed options for [{field}]")
            order = opts.get("order", "desc" if field == "_score" else "asc")
            if order not in ("asc", "desc"):
                raise IllegalArgumentException(
                    f"[sort] unknown order [{order}]")
            out.append(SortSpec(field, order, opts.get("missing", "_last")))
        else:
            raise IllegalArgumentException("[sort] malformed sort entry")
    return out


def _is_missing(v: Any) -> bool:
    if v is None:
        return True
    if isinstance(v, float) and math.isnan(v):
        return True
    return False


def _element_key(spec: SortSpec, v: Any) -> Tuple:
    """Ascending-comparable key for one sort element honoring order +
    missing placement. Shape: (missing_rank, direction-adjusted value)."""
    if _is_missing(v):
        if spec.missing == "_first":
            return (0, 0)
        if spec.missing == "_last":
            return (2, 0)
        v = spec.missing  # literal replacement value
    if isinstance(v, str):
        # strings can't negate: desc uses an inverted-codepoint key
        key: Any = v if spec.order == "asc" else _invert_str(v)
    else:
        key = v if spec.order == "asc" else -float(v)
    return (1, key)


def _invert_str(s: str) -> Tuple:
    return tuple(-ord(c) for c in s) + (float("inf"),)


def sort_key(specs: Sequence[SortSpec], values: Sequence[Any]) -> Tuple:
    return tuple(_element_key(s, v) for s, v in zip(specs, values))
