"""Carry pack state across from the JAX package.

``pack_from_reference``, ``streams_from_reference`` and
``vector_pack_from_reference`` take the fields of the reference's
``StackedShardPack`` / ``CompressedStreams`` / ``StackedVectorPack`` as plain
data (numpy arrays, lists, dicts — e.g. ``{f.name: getattr(pack, f.name)
for f in dataclasses.fields(pack)}``) and build the port's dataclasses,
so both packages can run on identical pack state. Nothing here imports
the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np

from elasticsearch_tpu_torch.parallel.distributed import (
    CompressedStreams, StackedShardPack, StackedVectorPack)


def _build(cls, fields: Dict[str, Any]):
    names = {f.name for f in dataclasses.fields(cls)}
    required = {f.name for f in dataclasses.fields(cls)
                if f.default is dataclasses.MISSING
                and f.default_factory is dataclasses.MISSING}
    missing = sorted(required - set(fields))
    if missing:
        raise ValueError(f"{cls.__name__} fields missing: {missing}")
    kw = {}
    for name, value in fields.items():
        if name not in names:
            continue  # reference-only fields (none today) are dropped
        if isinstance(value, np.ndarray):
            value = np.array(value, copy=True)
        elif isinstance(value, list):
            value = [np.array(v, copy=True) if isinstance(v, np.ndarray)
                     else (dict(v) if isinstance(v, dict)
                           else (list(v) if isinstance(v, list) else v))
                     for v in value]
        elif isinstance(value, dict):
            value = dict(value)
        kw[name] = value
    return cls(**kw)


def pack_from_reference(fields: Dict[str, Any]) -> StackedShardPack:
    """The reference StackedShardPack's fields → the port's pack."""
    return _build(StackedShardPack, fields)


def streams_from_reference(fields: Dict[str, Any]) -> CompressedStreams:
    """The reference CompressedStreams's fields → the port's streams."""
    return _build(CompressedStreams, fields)


def vector_pack_from_reference(fields: Dict[str, Any]) -> StackedVectorPack:
    """The reference StackedVectorPack's fields → the port's vector pack
    (the same vectors, live docs and doc ids)."""
    return _build(StackedVectorPack, fields)
