"""The query phase's source filtering.

Copy of the reference's ``search/query_phase.py::filter_source``, which
the kernel path's response assembly uses for a ``_source`` list. The
rest of the module (the planner's query and fetch phases) comes with
the planner path.
"""

from __future__ import annotations

from typing import Any, Dict, List


def filter_source(src: Dict[str, Any],
                  includes: List[str]) -> Dict[str, Any]:
    """Project a stored _source onto an includes list (dotted paths
    descend into objects)."""
    out: Dict[str, Any] = {}
    for key, value in src.items():
        for inc in includes:
            if key == inc or inc.startswith(key + ".") \
                    or key.startswith(inc + "."):
                if isinstance(value, dict) and inc.startswith(key + "."):
                    sub = filter_source(value, [inc[len(key) + 1:]])
                    if sub:
                        out[key] = sub
                else:
                    out[key] = value
                break
    return out
