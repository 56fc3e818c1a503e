"""Geometry primitives (port of mind_tpu/common/geometry.py).

Host (numpy, float64): used once per scenario during loading and
target-lane construction. Device (torch, fixed shape): point -> polyline distances
batched over leading axes, with padded polylines and validity masks.
"""

from __future__ import annotations

import numpy as np
import torch


def wrap_angle(a):
    """Normalize angle(s) to [-pi, pi] via atan2 (reference loader.py:196)."""
    return np.arctan2(np.sin(a), np.cos(a))


def project_point_on_polyline(point: np.ndarray, polyline: np.ndarray):
    """Project `point` onto a polyline.

    Returns (proj_pt [2], heading, arclength) with the same conventions as
    the reference common/geometry.py:81-109: nearest point over all segments,
    heading of the nearest segment, cumulative arclength to the projection.
    """
    px, py = float(point[0]), float(point[1])
    sx, sy = polyline[:-1, 0], polyline[:-1, 1]
    ex, ey = polyline[1:, 0], polyline[1:, 1]
    dx, dy = ex - sx, ey - sy
    len_sq = dx**2 + dy**2
    assert np.all(len_sq != 0.0), "Polyline segments should not have zero lengths."
    t = np.clip(((px - sx) * dx + (py - sy) * dy) / len_sq, 0.0, 1.0)
    nx = sx + t * dx
    ny = sy + t * dy
    dists = np.sqrt((px - nx) ** 2 + (py - ny) ** 2)
    i = int(np.argmin(dists))
    proj_pt = np.array([nx[i], ny[i]])
    cum = np.sum(np.sqrt(len_sq[:i])) + np.sqrt(len_sq[i]) * t[i]
    heading = np.arctan2(dy[i], dx[i])
    return proj_pt, heading, cum


def remove_close_points(points: np.ndarray, min_dist: float) -> np.ndarray:
    """Drop points closer than `min_dist` to the last kept point
    (reference common/geometry.py:33-41)."""
    if len(points) < 2:
        return points
    kept = [points[0]]
    for p in points[1:]:
        if np.linalg.norm(p - kept[-1]) > min_dist:
            kept.append(p)
    return np.array(kept)


def point_line_distance(points: np.ndarray, seg_start: np.ndarray, seg_end: np.ndarray):
    """Distances from many points to one segment (common/geometry.py:70-78)."""
    seg = seg_end - seg_start
    len_sq = float(np.dot(seg, seg))
    t = np.clip((points - seg_start) @ seg / len_sq, 0.0, 1.0).reshape(-1, 1)
    proj = seg_start + t * seg
    return np.linalg.norm(points - proj, axis=1)


def is_inside_ellipse(point, mean, cov, chi2=5.991):
    """Point within the 95% confidence ellipse of a 2D Gaussian
    (reference common/geometry.py:3-5)."""
    d = point - mean
    return float(d.T @ np.linalg.inv(cov) @ d) <= chi2


def ellipse_points(mean, cov, n=20, chi2=5.991):
    """Boundary points of the confidence ellipse (common/geometry.py:8-16)."""
    vals, vecs = np.linalg.eigh(cov)
    theta = np.linspace(0, 2 * np.pi, n)
    a, b = np.sqrt(np.abs(vals) * chi2)
    pts = vecs @ np.stack([a * np.cos(theta), b * np.sin(theta)])
    return (pts + np.asarray(mean)[:, None]).T


def mahalanobis_distances(points, mean, cov):
    """Per-point Mahalanobis distance (common/geometry.py:19-24)."""
    v = points - mean
    left = v @ np.linalg.inv(cov)
    return np.sqrt(np.sum(left * v, axis=1))


def point_mean_distances(points, mean):
    """Euclidean distances to a mean point (common/geometry.py:27-30)."""
    v = points - mean
    return np.sqrt(np.sum(v * v, axis=1))


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


def point_polyline_distance(point, polyline):
    """Host convenience: min distance from one point to a polyline (numpy)."""
    seg_starts, seg_ends = polyline[:-1], polyline[1:]
    seg = seg_ends - seg_starts
    len_sq = np.sum(seg * seg, axis=-1)
    t = np.clip(np.sum((point - seg_starts) * seg, axis=-1) / len_sq, 0.0, 1.0)
    proj = seg_starts + t[:, None] * seg
    return float(np.min(np.linalg.norm(point - proj, axis=-1)))


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
    """Min distances from points [..., 2] to a masked padded polyline
    [..., P, 2] (counterpart of jx_points_polyline_dist). Segment i is valid
    iff points i and i+1 are both valid."""
    seg_mask = poly_mask[..., :-1] & poly_mask[..., 1:]
    return point_segments_dist(points, polyline[..., :-1, :], polyline[..., 1:, :], seg_mask)
