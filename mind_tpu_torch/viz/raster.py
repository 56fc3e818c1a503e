"""Frames drawn in numpy: the display list that viz/render.py emits, the 3D
camera, painter's order, rasterization with anti-aliasing by coverage, and a
PNG writer and reader (zlib).

The camera is the one matplotlib's mplot3d gives the JAX package's
render_frame axes (mind_tpu/viz/render.py:173-199): a 3D axes with the
limits, elevation and azimuth of the display list's view, mplot3d's default
perspective projection (focal length 1, camera distance 10, box aspect
4:4:3), the axis off, and `tight_layout` in a figsize x figsize inch figure
at 100 dpi. The projection follows the published math of
`mpl_toolkits/mplot3d/axes3d.py::get_proj` and `proj3d`; the code is this
module's own. Painter's order is mplot3d's `computed_zorder`: collections
(here, polygons) sorted by their nearest projected depth, farthest first,
take z-orders 2.5, 3.5, ...; lines keep 2 and text 3, and a stable sort by
z-order gives the drawing order.

Coverage: polygons are filled (nonzero rule) with exact horizontal coverage
over SUB sub-scanlines per pixel row; strokes (round joins, projecting caps
on open lines as matplotlib's Line2D has them) take a box filter across and
along each segment, joined by discs; primitives whose segments are all
horizontal or vertical snap to the pixel grid as Agg's renderer does.
Labels use a 5 x 7 bitmap font carried below as data, drawn unrotated with
the baseline at the projected point, as a Text3D without a direction is.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

DPI = 100
DIST = 10.0                         # mplot3d's camera distance
# mplot3d's default box aspect 4:4:3, scaled as set_box_aspect does
_ASPECT = np.asarray((4, 4, 3), dtype=float)
BOX_ASPECT = _ASPECT * (1.8294640721620434 * 25 / 24 * 1 / np.linalg.norm(_ASPECT))
VIEW_LIM = (-0.95 / DIST, 0.9 / DIST)   # set_top_view's 2D view limits
PAD_PT = 1.08 * 10.0                # tight_layout's pad: 1.08 x the 10 pt font
LINE_Z, TEXT_Z, POLY_Z0 = 2.0, 3.0, 2.5
SUB = 4                             # sub-scanlines per pixel row in a fill
LABEL_CAP = 0.73                    # cap height of a label, in font sizes

RGBA = Tuple[float, float, float, float]

NAMED_COLORS = {
    "black": "#000000", "white": "#FFFFFF", "gray": "#808080", "grey": "#808080",
    "blue": "#0000FF", "deepskyblue": "#00BFFF", "lightskyblue": "#87CEFA",
    "salmon": "#FA8072", "lightcoral": "#F08080", "indianred": "#CD5C5C",
    "lime": "#00FF00", "red": "#FF0000", "green": "#008000",
}


def to_rgba(color, alpha: Optional[float] = None) -> RGBA:
    """A named colour, '#rrggbb' or an RGB(A) tuple of floats in [0, 1] as
    RGBA; `alpha` replaces the alpha where given (matplotlib's to_rgba)."""
    if isinstance(color, str):
        hexa = NAMED_COLORS.get(color.lower(), color)
        if not (hexa.startswith("#") and len(hexa) == 7):
            raise ValueError(f"raster: unknown colour {color!r}")
        rgba = tuple(int(hexa[i:i + 2], 16) / 255 for i in (1, 3, 5)) + (1.0,)
    else:
        rgba = tuple(float(c) for c in color)
        rgba = rgba + (1.0,) if len(rgba) == 3 else rgba
    if alpha is not None:
        rgba = rgba[:3] + (float(alpha),)
    return rgba


# -- display list -------------------------------------------------------------

@dataclass
class Polygon:
    """A filled polygon with an edge: verts [N, 3] in world coordinates,
    width in points (a Poly3DCollection of one face)."""

    verts: np.ndarray
    face: RGBA
    edge: RGBA
    width: float


@dataclass
class Polyline:
    """A line through verts [N, 3], width in points (a Line3D)."""

    verts: np.ndarray
    color: RGBA
    width: float


@dataclass
class Label:
    """Text with its baseline's left end at pos [3], size in points."""

    pos: np.ndarray
    text: str
    color: RGBA
    size: float


@dataclass
class View:
    xlim: Tuple[float, float]
    ylim: Tuple[float, float]
    zlim: Tuple[float, float]
    elev: float
    azim: float


class DisplayList:
    """What a frame draws, in the order it was drawn, and its view: the
    calls render.py made on a matplotlib 3D axes, as primitives."""

    def __init__(self):
        self.items: List[object] = []
        self.view: Optional[View] = None

    def set_view(self, xlim, ylim, zlim, elev, azim):
        self.view = View(tuple(map(float, xlim)), tuple(map(float, ylim)),
                         tuple(map(float, zlim)), float(elev), float(azim))

    def plot(self, xs, ys, zs, color, linewidth, alpha=None):
        xs = np.asarray(xs, dtype=float).ravel()
        ys = np.asarray(ys, dtype=float).ravel()
        zs = np.broadcast_to(np.asarray(zs, dtype=float).ravel(), xs.shape)
        self.items.append(Polyline(np.stack([xs, ys, zs], axis=1), to_rgba(color, alpha),
                                   float(linewidth)))

    def polygon(self, verts, facecolor, edgecolor, linewidth=1.0, alpha=None):
        """A face: `alpha` applies to the fill alone, as it does to a
        Poly3DCollection's face (its edge keeps its colour's alpha)."""
        self.items.append(Polygon(np.asarray(verts, dtype=float), to_rgba(facecolor, alpha),
                                  to_rgba(edgecolor), float(linewidth)))

    def text(self, x, y, z, s, fontsize, color="black"):
        self.items.append(Label(np.array([x, y, z], dtype=float), str(s), to_rgba(color),
                                float(fontsize)))


# -- camera --------------------------------------------------------------------

def _norm_angle(a: float) -> float:
    a = (a + 360) % 360
    return a - 360 if a > 180 else a


def projection(view: View) -> np.ndarray:
    """The 4 x 4 matrix from world to projected coordinates
    (mplot3d's Axes3D.get_proj under a perspective camera, no roll)."""
    (x0, x1), (y0, y1), (z0, z1) = view.xlim, view.ylim, view.zlim
    dx, dy, dz = (x1 - x0) / BOX_ASPECT[0], (y1 - y0) / BOX_ASPECT[1], (z1 - z0) / BOX_ASPECT[2]
    world = np.array([[1 / dx, 0, 0, -x0 / dx],
                      [0, 1 / dy, 0, -y0 / dy],
                      [0, 0, 1 / dz, -z0 / dz],
                      [0, 0, 0, 1]])
    R = 0.5 * BOX_ASPECT
    elev, azim = np.deg2rad(view.elev), np.deg2rad(view.azim)
    ps = np.array([np.cos(elev) * np.cos(azim), np.cos(elev) * np.sin(azim), np.sin(elev)])
    eye = R + DIST * ps
    up = np.zeros(3)
    up[2] = -1 if abs(np.deg2rad(_norm_angle(view.elev))) > np.pi / 2 else 1
    w = eye - R
    w = w / np.linalg.norm(w)
    u = np.cross(up, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    rot, shift = np.eye(4), np.eye(4)
    rot[:3, :3] = [u, v, w]
    shift[:3, -1] = -(R + DIST * ps * 1.0)      # the eye at focal length 1
    view_m = np.dot(rot, shift)
    front, back = -DIST, DIST
    persp = np.array([[1, 0, 0, 0],
                      [0, 1, 0, 0],
                      [0, 0, (front + back) / (front - back), -2 * (front * back) / (front - back)],
                      [0, 0, -1, 0]])
    return np.dot(persp, np.dot(view_m, world))


class Camera:
    """The projection and the pixel frame of one figure size: image
    coordinates are columns from the left and rows from the top, pixel
    (r, c) covering [c, c + 1) x [r, r + 1)."""

    def __init__(self, view: View, figsize: float, dpi: float = DPI):
        self.M = projection(view)
        self.dpi = dpi
        self.size = int(round(figsize * dpi))
        pad = PAD_PT / 72 * dpi
        self.origin, self.side = pad, figsize * dpi - 2 * pad
        # the axes' clip box in whole pixels (Agg rounds its edges)
        lo = int(np.floor(pad + 0.5))
        hi = int(np.floor(pad + self.side + 0.5))
        self.clip = (lo, self.size - hi, hi, self.size - lo)     # c0, r0, c1, r1

    def project(self, verts: np.ndarray):
        """(image xy [N, 2], projected depth [N], inside [N]): inside is
        mplot3d's clip test of a line's vertices (within the projected
        cube and in front of the camera)."""
        verts = np.asarray(verts, dtype=float).reshape(-1, 3)
        vec = np.dot(self.M, np.vstack([verts.T, np.ones(len(verts))]))
        tx, ty, tz = vec[0] / vec[3], vec[1] / vec[3], vec[2] / vec[3]
        inside = (-1 <= tx) & (tx <= 1) & (-1 <= ty) & (ty <= 1) & (tz <= 0)
        span = VIEW_LIM[1] - VIEW_LIM[0]
        col = self.origin + (tx - VIEW_LIM[0]) / span * self.side
        up = self.origin + (ty - VIEW_LIM[0]) / span * self.side
        return np.stack([col, self.size - up], axis=1), tz, inside

    def px(self, points: float) -> float:
        return points * self.dpi / 72


def draw_order(items, camera: Camera) -> List[int]:
    """Indices of `items` in mplot3d's drawing order."""
    polys = [i for i, it in enumerate(items) if isinstance(it, Polygon)]
    depth = {i: float(np.min(camera.project(items[i].verts)[1])) for i in polys}
    zorder = {}
    for rank, i in enumerate(sorted(polys, key=lambda i: depth[i], reverse=True)):
        zorder[i] = POLY_Z0 + rank
    for i, it in enumerate(items):
        if isinstance(it, Polyline):
            zorder[i] = LINE_Z
        elif isinstance(it, Label):
            zorder[i] = TEXT_Z
    return sorted(range(len(items)), key=lambda i: zorder[i])


# -- coverage ------------------------------------------------------------------

def _snap(runs: List[np.ndarray], width_px: float) -> List[np.ndarray]:
    """Agg's auto snapping: a path whose segments are all horizontal or
    vertical moves its vertices to pixel centres (odd widths) or corners."""
    segs = [np.diff(r, axis=0) for r in runs]
    seg = np.concatenate(segs) if segs else np.zeros((0, 2))
    if sum(map(len, runs)) > 1024 or not (len(seg) and (
            (np.abs(seg[:, 0]) < 1e-4) | (np.abs(seg[:, 1]) < 1e-4)).all()):
        return runs
    half = 0.5 if int(np.floor(width_px + 0.5)) % 2 else 0.0
    return [np.floor(r + 0.5) + half for r in runs]


def _runs(pts: np.ndarray, keep: np.ndarray) -> List[np.ndarray]:
    """The maximal runs of consecutive kept vertices."""
    idx = np.flatnonzero(keep)
    if not len(idx):
        return []
    return [pts[g] for g in np.split(idx, np.flatnonzero(np.diff(idx) > 1) + 1)]


def _box(dist, half):
    """Coverage of a unit pixel at distance `dist` from the centre of a band
    of half-width `half` (a box filter across the band)."""
    return np.clip(np.minimum(dist + 0.5, half) - np.maximum(dist - 0.5, -half), 0.0, 1.0)


def _segments_cover(a: np.ndarray, b: np.ndarray, hw: float, clip):
    """(rows, cols, coverage) of the bands of half-width hw along the
    segments a[k] -> b[k] ([K, 2] each): a box filter across each band and
    along it. Each segment walks its major axis one pixel at a time and
    takes a window of pixels across it."""
    reach = hw + 1.0
    c0, r0, c1, r1 = clip
    ok = np.isfinite(a).all(axis=1) & np.isfinite(b).all(axis=1)
    a, b = a[ok], b[ok]
    # cut each segment to the clip box and the band's reach (Liang-Barsky):
    # what lies beyond is never drawn
    box = (c0 - reach - 1, r0 - reach - 1, c1 + reach + 1, r1 + reach + 1)
    d = b - a
    t0, t1 = np.zeros(len(a)), np.ones(len(a))
    miss = np.zeros(len(a), bool)
    with np.errstate(divide="ignore", invalid="ignore"):
        for p, q in ((-d[:, 0], a[:, 0] - box[0]), (d[:, 0], box[2] - a[:, 0]),
                     (-d[:, 1], a[:, 1] - box[1]), (d[:, 1], box[3] - a[:, 1])):
            t = q / p
            t0 = np.where(p < 0, np.maximum(t0, t), t0)
            t1 = np.where(p > 0, np.minimum(t1, t), t1)
            miss |= (p == 0) & (q < 0)
    keep = ~miss & (t0 <= t1)
    a, b = a[keep] + t0[keep, None] * d[keep], a[keep] + t1[keep, None] * d[keep]
    d = b - a
    length = np.hypot(d[:, 0], d[:, 1])
    keep = length >= 1e-9
    a, b, d, length = a[keep], b[keep], d[keep], length[keep]
    if not len(a):
        return None
    u = d / length[:, None]
    xmajor = np.abs(u[:, 0]) >= np.abs(u[:, 1])
    am, an = np.where(xmajor, a[:, 0], a[:, 1]), np.where(xmajor, a[:, 1], a[:, 0])
    bm = np.where(xmajor, b[:, 0], b[:, 1])
    um, un = np.where(xmajor, u[:, 0], u[:, 1]), np.where(xmajor, u[:, 1], u[:, 0])
    m0 = np.maximum(np.floor(np.minimum(am, bm) - reach), np.where(xmajor, c0, r0))
    m1 = np.minimum(np.ceil(np.maximum(am, bm) + reach) + 1, np.where(xmajor, c1, r1))
    count = np.maximum(m1 - m0, 0).astype(np.int64)
    seg = np.repeat(np.arange(len(a)), count)
    m = m0[seg] + (np.arange(len(seg)) - np.repeat(np.cumsum(count) - count, count))
    half = reach / np.abs(um)
    start = np.floor(an[seg] + (m + 0.5 - am[seg]) * (un / um)[seg] - half[seg])
    minor = start[:, None] + np.arange(int(np.ceil(2 * reach * np.sqrt(2))) + 2)[None, :]
    major = np.broadcast_to(m[:, None], minor.shape)
    xm = xmajor[seg][:, None]
    rows = np.where(xm, minor, major).astype(np.int64)
    cols = np.where(xm, major, minor).astype(np.int64)
    px, py = cols + 0.5 - a[seg, 0, None], rows + 0.5 - a[seg, 1, None]
    ux, uy = u[seg, 0, None], u[seg, 1, None]
    along = px * ux + py * uy
    cov = _box(np.abs(px * uy - py * ux), hw) * np.clip(
        np.minimum(along + 0.5, length[seg, None]) - np.maximum(along - 0.5, 0.0), 0.0, 1.0)
    keep = (cov > 0) & (rows >= r0) & (rows < r1) & (cols >= c0) & (cols < c1)
    return rows[keep], cols[keep], cov[keep]


def _discs_cover(p: np.ndarray, hw: float, clip):
    """(rows, cols, coverage) of discs of radius hw at the points p [K, 2]
    (round joins)."""
    c0, r0, c1, r1 = clip
    reach = hw + 1.0
    p = p[(p[:, 0] >= c0 - reach) & (p[:, 0] <= c1 + reach)
          & (p[:, 1] >= r0 - reach) & (p[:, 1] <= r1 + reach)]
    if not len(p):
        return None
    side = np.arange(int(np.ceil(2 * reach)) + 1)
    rows = np.floor(p[:, 1] - reach)[:, None, None] + side[None, :, None]
    cols = np.floor(p[:, 0] - reach)[:, None, None] + side[None, None, :]
    rows, cols = np.broadcast_arrays(rows, cols)
    cov = _box(np.hypot(cols + 0.5 - p[:, 0, None, None], rows + 0.5 - p[:, 1, None, None]), hw)
    keep = (cov > 0) & (rows >= r0) & (rows < r1) & (cols >= c0) & (cols < c1)
    return rows[keep].astype(np.int64), cols[keep].astype(np.int64), cov[keep]


class Canvas:
    """A white RGB frame in floats that primitives are blended onto."""

    def __init__(self, size: int):
        self.size = size
        self.rgb = np.ones((size, size, 3), np.float32)

    def blend(self, rows, cols, cov, rgba: RGBA):
        alpha = (rgba[3] * cov).astype(np.float32)[..., None]
        color = np.asarray(rgba[:3], np.float32)
        px = self.rgb[rows, cols]
        self.rgb[rows, cols] = px + (color - px) * alpha

    def fill(self, pts: np.ndarray, rgba: RGBA, clip):
        """Fill the closed polygon `pts` [N, 2] (nonzero rule)."""
        c0, r0, c1, r1 = clip
        if not np.isfinite(pts).all():
            return
        ra = max(int(np.floor(pts[:, 1].min())), r0)
        rb = min(int(np.ceil(pts[:, 1].max())), r1)
        ca = max(int(np.floor(pts[:, 0].min())), c0)
        cb = min(int(np.ceil(pts[:, 0].max())), c1)
        if ra >= rb or ca >= cb or rgba[3] == 0:
            return
        ys = (np.arange(ra, rb)[:, None] + (np.arange(SUB) + 0.5)[None, :] / SUB).ravel()
        p0, p1 = pts, np.roll(pts, -1, axis=0)
        y0, y1 = p0[:, 1][None, :], p1[:, 1][None, :]
        crosses = ((y0 <= ys[:, None]) & (ys[:, None] < y1)) | \
                  ((y1 <= ys[:, None]) & (ys[:, None] < y0))
        with np.errstate(divide="ignore", invalid="ignore"):
            xs = p0[:, 0][None, :] + (ys[:, None] - y0) * (p1[:, 0] - p0[:, 0])[None, :] \
                / (y1 - y0)
        xs = np.where(crosses, xs, np.inf)
        wind = np.where(crosses, np.where(y1 > y0, 1, -1), 0)
        order = np.argsort(xs, axis=1, kind="stable")
        xs = np.take_along_axis(xs, order, axis=1)
        inside = np.cumsum(np.take_along_axis(wind, order, axis=1), axis=1)[:, :-1] != 0
        sub, k = np.nonzero(inside & np.isfinite(xs[:, 1:]))
        a = np.clip(xs[sub, k], ca, cb) - ca
        b = np.clip(xs[sub, k + 1], ca, cb) - ca
        row = sub // SUB
        width = cb - ca
        steps = np.zeros((rb - ra, width + 2))
        frac = np.zeros((rb - ra, width + 2))
        fa, fb = np.floor(a).astype(np.int64), np.floor(b).astype(np.int64)
        np.add.at(steps, (row, fa), 1.0)
        np.add.at(steps, (row, fb), -1.0)
        np.add.at(frac, (row, fb), b - fb)
        np.add.at(frac, (row, fa), -(a - fa))
        cov = np.clip((np.cumsum(steps, axis=1) + frac)[:, :width] / SUB, 0.0, 1.0)
        rr, cc = np.nonzero(cov > 0)
        self.blend(rr + ra, cc + ca, cov[rr, cc], rgba)

    def stroke(self, runs: List[np.ndarray], width_px: float, rgba: RGBA, clip,
               closed: bool):
        """Stroke polylines (lists of [N, 2] vertices) of one path: round
        joins; projecting caps on open ones, none on closed ones."""
        hw = width_px / 2
        starts, ends, joints = [], [], []
        for pts in runs:
            if len(pts) < 2 or rgba[3] == 0 or width_px <= 0:
                continue
            a, b = pts[:-1].copy(), pts[1:].copy()
            if closed:
                a, b = np.vstack([a, pts[-1:]]), np.vstack([b, pts[:1]])
                joints.append(pts)
            else:
                joints.append(pts[1:-1])
                # projecting caps: the end segments reach half a width further
                for end, p, q in ((a, 0, 1), (b, -1, -2)):
                    d = pts[p] - pts[q]
                    norm = np.hypot(*d)
                    if norm > 0:
                        end[p] = pts[p] + d / norm * hw
            starts.append(a)
            ends.append(b)
        if not starts:
            return
        parts = [_segments_cover(np.concatenate(starts), np.concatenate(ends), hw, clip),
                 _discs_cover(np.concatenate(joints), hw, clip)]
        parts = [p for p in parts if p is not None and len(p[0])]
        if not parts:
            return
        rows = np.concatenate([p[0] for p in parts])
        cols = np.concatenate([p[1] for p in parts])
        cov = np.concatenate([p[2] for p in parts])
        flat = rows * self.size + cols
        order = np.lexsort((-cov, flat))
        flat, cov = flat[order], cov[order]
        first = np.ones(len(flat), bool)
        first[1:] = flat[1:] != flat[:-1]            # the largest coverage per pixel
        flat, cov = flat[first], cov[first]
        self.blend(flat // self.size, flat % self.size, cov, rgba)

    def label(self, origin, mask: np.ndarray, rgba: RGBA):
        """Blend a label's coverage `mask` with its first pixel at origin
        (row, col), clipped to the frame (labels are not clipped to the
        axes, as matplotlib's 3D text is not)."""
        r0, c0 = origin
        rows, cols = np.nonzero(mask > 0)
        rr, cc = rows + r0, cols + c0
        keep = (rr >= 0) & (rr < self.size) & (cc >= 0) & (cc < self.size)
        self.blend(rr[keep], cc[keep], mask[rows[keep], cols[keep]], rgba)

    def rgba8(self) -> np.ndarray:
        out = np.empty((self.size, self.size, 4), np.uint8)
        out[..., :3] = np.clip(np.floor(self.rgb * 255 + 0.5), 0, 255)
        out[..., 3] = 255
        return out


# -- labels ----------------------------------------------------------------------

# printable ASCII (32-126), eight glyphs of 5 x 7 to a block of seven rows
_FONT = r"""
..... ..#.. .#.#. .#.#. ..#.. ##... .##.. ..#..
..... ..#.. .#.#. .#.#. .#### ##..# #..#. ..#..
..... ..#.. ..... ##### #.#.. ...#. #.#.. .....
..... ..#.. ..... .#.#. .###. ..#.. .#... .....
..... ..#.. ..... ##### ..#.# .#... #.#.# .....
..... ..... ..... .#.#. ####. #..## #..#. .....
..... ..#.. ..... .#.#. ..#.. ...## .##.# .....
...#. .#... ..... ..... ..... ..... ..... .....
..#.. ..#.. ..#.. ..#.. ..... ..... ..... ....#
.#... ...#. #.#.# ..#.. ..... ..... ..... ...#.
.#... ...#. .###. ##### ..... ##### ..... ..#..
.#... ...#. #.#.# ..#.. .##.. ..... ..... .#...
..#.. ..#.. ..#.. ..#.. ..#.. ..... .##.. #....
...#. .#... ..... ..... .#... ..... .##.. .....
.###. ..#.. .###. ##### ...#. ##### ..##. #####
#...# .##.. #...# ...#. ..##. #.... .#... ....#
#..## ..#.. ....# ..#.. .#.#. ####. #.... ...#.
#.#.# ..#.. ...#. ...#. #..#. ....# ####. ..#..
##..# ..#.. ..#.. ....# ##### ....# #...# .#...
#...# ..#.. .#... #...# ...#. #...# #...# .#...
.###. .###. ##### .###. ...#. .###. .###. .#...
.###. .###. ..... ..... ...#. ..... .#... .###.
#...# #...# .##.. .##.. ..#.. ..... ..#.. #...#
#...# #...# .##.. .##.. .#... ##### ...#. ....#
.###. .#### ..... ..... #.... ..... ....# ...#.
#...# ....# .##.. .##.. .#... ##### ...#. ..#..
#...# ...#. .##.. ..#.. ..#.. ..... ..#.. .....
.###. .##.. ..... .#... ...#. ..... .#... ..#..
.###. .###. ####. .###. ###.. ##### ##### .###.
#...# #...# #...# #...# #..#. #.... #.... #...#
....# #...# #...# #.... #...# #.... #.... #....
.##.# ##### ####. #.... #...# ####. ####. #.###
#.#.# #...# #...# #.... #...# #.... #.... #...#
#.#.# #...# #...# #...# #..#. #.... #.... #...#
.###. #...# ####. .###. ###.. ##### #.... .####
#...# .###. ..### #...# #.... #...# #...# .###.
#...# ..#.. ...#. #..#. #.... ##.## #...# #...#
#...# ..#.. ...#. #.#.. #.... #.#.# ##..# #...#
##### ..#.. ...#. ##... #.... #.#.# #.#.# #...#
#...# ..#.. ...#. #.#.. #.... #...# #..## #...#
#...# ..#.. #..#. #..#. #.... #...# #...# #...#
#...# .###. .##.. #...# ##### #...# #...# .###.
####. .###. ####. .#### ##### #...# #...# #...#
#...# #...# #...# #.... ..#.. #...# #...# #...#
#...# #...# #...# #.... ..#.. #...# #...# #...#
####. #...# ####. .###. ..#.. #...# #...# #.#.#
#.... #.#.# #.#.. ....# ..#.. #...# #...# #.#.#
#.... #..#. #..#. ....# ..#.. #...# .#.#. #.#.#
#.... .##.# #...# ####. ..#.. .###. ..#.. .#.#.
#...# #...# ##### .###. ..... .###. ..#.. .....
#...# #...# ....# .#... #.... ...#. .#.#. .....
.#.#. .#.#. ...#. .#... .#... ...#. #...# .....
..#.. ..#.. ..#.. .#... ..#.. ...#. ..... .....
.#.#. ..#.. .#... .#... ...#. ...#. ..... .....
#...# ..#.. #.... .#... ....# ...#. ..... .....
#...# ..#.. ##### .###. ..... .###. ..... #####
.#... ..... #.... ..... ....# ..... ..##. .....
..#.. ..... #.... ..... ....# ..... .#..# .####
..... .###. #.##. .###. .##.# .###. .#... #...#
..... ....# ##..# #.... #..## #...# ###.. #...#
..... .#### #...# #.... #...# ##### .#... .####
..... #...# #...# #...# #...# #.... .#... ....#
..... .#### ####. .###. .#### .###. .#... .###.
#.... ..#.. ...#. #.... .##.. ..... ..... .....
#.... ..... ..... #.... ..#.. ..... ..... .....
#.##. .##.. ..##. #..#. ..#.. ##.#. #.##. .###.
##..# ..#.. ...#. #.#.. ..#.. #.#.# ##..# #...#
#...# ..#.. ...#. ##... ..#.. #.#.# #...# #...#
#...# ..#.. #..#. #.#.. ..#.. #...# #...# #...#
#...# .###. .##.. #..#. .###. #...# #...# .###.
..... ..... ..... ..... .#... ..... ..... .....
..... ..... ..... ..... .#... ..... ..... .....
####. .##.# #.##. .###. ###.. #...# #...# #...#
#...# #..## ##..# #.... .#... #...# #...# #...#
####. .#### #.... .###. .#... #...# #...# #.#.#
#.... ....# #.... ....# .#..# #..## .#.#. #.#.#
#.... ....# #.... ####. ..##. .##.# ..#.. .#.#.
..... ..... ..... ...#. ..#.. .#... .....
..... ..... ..... ..#.. ..#.. ..#.. .....
#...# #...# ##### ..#.. ..#.. ..#.. .#...
.#.#. #...# ...#. .#... ..#.. ...#. #.#.#
..#.. .#### ..#.. ..#.. ..#.. ..#.. ...#.
.#.#. ....# .#... ..#.. ..#.. ..#.. .....
#...# .###. ##### ...#. ..#.. .#... .....
"""


def _glyphs():
    lines = _FONT.strip("\n").split("\n")
    glyphs = {}
    for b in range(0, len(lines), 7):
        rows = [line.split(" ") for line in lines[b:b + 7]]
        for k in range(len(rows[0])):
            glyphs[chr(32 + 8 * (b // 7) + k)] = np.array(
                [[ch == "#" for ch in r[k]] for r in rows], dtype=np.float32)
    return glyphs


GLYPHS = _glyphs()
_BOX = np.ones((7, 5), np.float32)
_BOX[1:-1, 1:-1] = 0.0                                  # any other character


def _cells(n: int, scale: float, offset: float) -> Tuple[int, np.ndarray]:
    """(first pixel, [pixels, n] 0/1 matrix) of n font cells of `scale`
    pixels from `offset`, each cell's edges rounded to whole pixels (crisp
    glyphs at any size)."""
    edges = np.round(offset + np.arange(n + 1) * scale).astype(np.int64)
    px = edges[0] + np.arange(edges[-1] - edges[0])[:, None]
    return int(edges[0]), ((px >= edges[None, :-1]) & (px < edges[None, 1:])).astype(np.float32)


def label_mask(text: str, size_pt: float, anchor, dpi: float = DPI):
    """((first row, first col), coverage [rows, cols]) of `text` with its
    baseline's left end at image point `anchor`."""
    bitmap = np.concatenate(
        [np.pad(GLYPHS.get(ch, _BOX), ((0, 0), (0, 1))) for ch in text], axis=1)[:, :-1]
    scale = LABEL_CAP * size_pt * dpi / 72 / 7
    r0, ry = _cells(7, scale, anchor[1] - 7 * scale)
    c0, rx = _cells(bitmap.shape[1], scale, anchor[0] + scale)
    return (r0, c0), ry @ bitmap @ rx.T


# -- frames --------------------------------------------------------------------

def rasterize(dl: DisplayList, figsize: float, dpi: float = DPI) -> np.ndarray:
    """The frame of display list `dl` at figsize x figsize inches: uint8
    RGBA [H, W, 4]."""
    camera = Camera(dl.view, figsize, dpi)
    canvas = Canvas(camera.size)
    for i in draw_order(dl.items, camera):
        item = dl.items[i]
        if isinstance(item, Polygon):
            pts, _, _ = camera.project(item.verts)
            width = camera.px(item.width)
            (pts,) = _snap([pts], width)
            canvas.fill(pts, item.face, camera.clip)
            canvas.stroke([pts], width, item.edge, camera.clip, closed=True)
        elif isinstance(item, Polyline):
            pts, _, inside = camera.project(item.verts)
            width = camera.px(item.width)
            # a vertex outside the projected cube breaks the line, as mplot3d
            # masks it
            canvas.stroke(_snap(_runs(pts, inside), width), width, item.color, camera.clip,
                          closed=False)
        else:
            pts, _, _ = camera.project(item.pos)
            if not np.isfinite(pts).all():
                continue
            origin, mask = label_mask(item.text, item.size, pts[0], dpi)
            canvas.label(origin, mask, item.color)
    return canvas.rgba8()


# -- PNG -----------------------------------------------------------------------

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}                 # colour type: RGB, RGBA


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(
        ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def encode_png(img: np.ndarray) -> bytes:
    """8-bit RGB or RGBA [H, W, C] as PNG bytes, every row under the Up
    filter."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, c = img.shape
    ctype = {3: 2, 4: 6}[c]
    rows = img.reshape(h, w * c)
    up = np.diff(rows, axis=0, prepend=np.zeros((1, w * c), np.uint8))
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1).tobytes()
    return (PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))


def write_png(path, img: np.ndarray):
    with open(path, "wb") as f:
        f.write(encode_png(img))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter_row(kind: int, row: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    if kind == 0:
        return row
    if kind == 1:                                        # Sub: a running sum per channel
        return np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).ravel()
    if kind == 2:                                        # Up
        return row + prev
    if kind not in (3, 4):
        raise ValueError(f"png: unknown filter type {kind}")
    out = bytearray(row.tobytes())
    up = prev.tobytes()
    for i in range(len(out)):
        left = out[i - bpp] if i >= bpp else 0
        if kind == 3:                                    # Average
            out[i] = (out[i] + ((left + up[i]) >> 1)) & 0xFF
        else:                                            # Paeth
            corner = up[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + _paeth(left, up[i], corner)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def read_png(path) -> np.ndarray:
    """A non-interlaced 8-bit RGB or RGBA PNG as uint8 [H, W, C]."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"png: {path} is not a PNG file")
    pos, idat, head = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack_from(">I", data, pos)
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if head is None:
        raise ValueError(f"png: {path} has no header")
    w, h, depth, ctype, _, _, interlace = head
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"png: {path}: only non-interlaced 8-bit RGB / RGBA is read "
                         f"(depth {depth}, colour type {ctype}, interlace {interlace})")
    c = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * c)
    out = np.empty((h, w * c), np.uint8)
    prev = np.zeros(w * c, np.uint8)
    for r in range(h):
        prev = out[r] = _unfilter_row(int(raw[r, 0]), raw[r, 1:], prev, c)
    return out.reshape(h, w, c)
