"""Kernel-variant choice (the reference's planner.choose_kernel_variant,
compressed branch)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from elasticsearch_tpu_torch.ops import sparse


def choose_kernel_variant(d_pad: int,
                          weights: Optional[np.ndarray] = None) -> str:
    """Variant for one lowered (compressed pack, batch): "compressed" —
    quantized sort keys + block-max pruning, the Hopper kernel on a card —
    when sparse.packable() holds for the doc axis and the slot weights;
    otherwise "compressed_exact", exact for any weights. (The reference's
    "pallas" spelling is the same kernel in the port; sorted_merge_topk
    still accepts it.)"""
    if sparse.packable(d_pad, weights):
        return "compressed"
    return "compressed_exact"
