"""Geometry primitives (port of mind_tpu/common/geometry.py).

Host (numpy, float64): `resample_polyline`, used once per scenario for the
target lane. Device (torch, fixed shape): point -> polyline distances
batched over leading axes, with padded polylines and validity masks.
"""

from __future__ import annotations

import numpy as np
import torch


def resample_polyline(polyline: np.ndarray, interval: float = 1.0):
    """Resample a polyline at ~`interval` spacing, per-segment ceil split
    (reference planner.py:147-171). Returns (points [M,2], src_index [M])
    where src_index[k] is the index of the source segment each point was
    taken from (the last point maps to the last source point)."""
    pts = []
    src = []
    n = len(polyline)
    for i in range(n - 1):
        a, b = polyline[i], polyline[i + 1]
        seg_len = float(np.linalg.norm(a - b))
        num = int(np.ceil(seg_len / interval))
        for j in range(num):
            alpha = j / num
            pts.append(a + alpha * (b - a))
            src.append(i)
    pts.append(polyline[-1])
    src.append(n - 1)
    return np.array(pts), np.array(src)


def point_segments_dist(points, seg_starts, seg_ends, seg_mask):
    """Min distance from points [..., 2] to masked segments [S, 2], [S, 2],
    [S] (counterpart of jx_point_segments_dist, vmapped over points). The
    reciprocal segment lengths stay off the point axis and the square root
    is taken once per point, after the min over squared distances."""
    seg = seg_ends - seg_starts
    len_sq = (seg * seg).sum(-1)
    pos = len_sq > 0
    inv_len_sq = pos.to(len_sq.dtype) / torch.where(pos, len_sq, torch.ones_like(len_sq))
    p = points.unsqueeze(-2)                                   # [..., 1, 2]
    t = torch.clamp(((p - seg_starts) * seg).sum(-1) * inv_len_sq, 0.0, 1.0)
    diff = p - (seg_starts + t.unsqueeze(-1) * seg)
    d_sq = (diff * diff).sum(-1)
    inf = torch.full((), float("inf"), dtype=d_sq.dtype, device=d_sq.device)
    return torch.sqrt(torch.where(seg_mask, d_sq, inf).amin(-1))


def points_polyline_dist(points, polyline, poly_mask):
    """Min distances from points [..., 2] to a masked padded polyline [P, 2]
    (counterpart of jx_points_polyline_dist). Segment i is valid iff points
    i and i+1 are both valid."""
    seg_mask = poly_mask[:-1] & poly_mask[1:]
    return point_segments_dist(points, polyline[:-1], polyline[1:], seg_mask)
