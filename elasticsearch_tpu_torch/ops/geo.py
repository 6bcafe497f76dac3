"""The geo_distance mask: a haversine over a segment's lat/lon columns,
with the reference's bits at the radius.

The reference computes, in float64 on its host, op by op (each jnp call
its own XLA computation, so nothing is fused or contracted):

  rad  = pi / 180
  a    = sin(dlat/2)² + cos(lat·rad) · cos(qlat·rad) · sin(dlon/2)²
         (dlat = (lat - qlat)·rad, dlon = (lon - qlon)·rad, x² = x·x)
  dist = (2·R) · asin(sqrt(clip(a, 0, 1)))
  mask = present & (dist <= distance_m)

XLA:CPU calls the C library for float64 ``sin`` and ``cos``, and
expands ``asin(y)`` as ``2·atan2(y, 1 + sqrt((1 - y)·(y + 1)))`` with
the library's ``atan2``. Those are not correctly rounded, and neither
torch's nor CUDA's float64 sin/cos/atan2 are the C library's, so the
last bits of `dist` differ between the three. The mask differs only for
a point whose distance lies within those bits of the radius.

``distance_mask`` therefore decides every point on the device from
torch's float64 haversine, except the points within ``BAND_REL`` ·
radius + ``BAND_M`` metres of the radius — far wider than the few ulps
the functions differ by, even at the antipode, where asin turns an ulp
of `a` into ~0.2 m — which it computes again on the host in the
reference's exact sequence above with Python's ``math`` (the C
library's sin, cos and atan2; + - · / and sqrt are correctly rounded
everywhere). The CPU path and the card run the same code, so they
agree with each other, and on the reference's host with the reference.
A random point falls in the band about once in a million queries.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: mean earth radius in metres, as Lucene uses
EARTH_R_M = 6371008.7714
BAND_REL = 1e-7
BAND_M = 1.0


def reference_distance(lat: float, lon: float, qlat: float,
                       qlon: float) -> float:
    """One point's haversine distance (m) in the reference's exact op
    sequence (module doc)."""
    rad = math.pi / 180.0
    dlat = (lat - qlat) * rad
    dlon = (lon - qlon) * rad
    s1 = math.sin(dlat / 2)
    s2 = math.sin(dlon / 2)
    a = s1 * s1 + math.cos(lat * rad) * math.cos(qlat * rad) * (s2 * s2)
    y = math.sqrt(min(max(a, 0.0), 1.0))
    t = math.atan2(y, math.sqrt((1.0 - y) * (y + 1.0)) + 1.0)
    return (2 * EARTH_R_M) * (t + t)


def distance_mask(lat: torch.Tensor, lon: torch.Tensor, qlat: float,
                  qlon: float, distance_m: float) -> torch.Tensor:
    """bool mask of the points (float64 columns, NaN = missing) within
    `distance_m` of (qlat, qlon), the reference's mask bit for bit."""
    rad = math.pi / 180.0
    dlat = (lat - qlat) * rad
    dlon = (lon - qlon) * rad
    s1 = torch.sin(dlat / 2)
    s2 = torch.sin(dlon / 2)
    a = s1 * s1 + torch.cos(lat * rad) * math.cos(qlat * rad) * (s2 * s2)
    dist = (2 * EARTH_R_M) * torch.asin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))
    mask = dist <= distance_m        # NaN (a missing point) is False
    near = (dist - distance_m).abs() <= BAND_REL * distance_m + BAND_M
    idx = torch.nonzero(near).flatten()
    if idx.numel():
        pts = idx.cpu().numpy()
        lat_h = lat[idx].cpu().numpy()
        lon_h = lon[idx].cpu().numpy()
        exact = np.array([reference_distance(float(la), float(lo), qlat,
                                             qlon) <= distance_m
                          for la, lo in zip(lat_h, lon_h)], dtype=bool)
        mask = mask.clone()
        mask[torch.as_tensor(pts, device=mask.device)] = torch.as_tensor(
            exact, device=mask.device)
    return mask
