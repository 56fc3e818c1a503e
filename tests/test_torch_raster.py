"""Frames drawn by the port in numpy (mind_tpu_torch/viz/raster.py and the
display list of viz/render.py) against mind_tpu's matplotlib renderer on
frame 2 of the 5-tick run of test_torch_viz.py: the same primitives in the
same order, each vertex within half a pixel of where matplotlib puts it,
mplot3d's painter's order, and the drawn pixels; and the PNG codec against
PIL's. matplotlib and PIL are the reference here; the port imports
neither."""

import struct
import zlib

import numpy as np
import pytest

from mind_tpu_torch.viz import raster
from mind_tpu_torch.viz import render as trender
from test_torch_viz import sim, world  # noqa: F401  (the shared 5-tick run)

FRAME = 2
# a drawn pixel: more than this many levels from white in some channel
DRAWN = 10
TOL_PX = 0.5
MIN_IOU, MAX_MEAN_ABS = 0.8, 8.0


def mpl_axes(sim, figsize):
    """mind_tpu's render_frame on a matplotlib 3D axes, laid out and drawn
    as its render_png draws it."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mind_tpu.viz import render as jrender

    fig = plt.figure(figsize=(figsize, figsize))
    ax = fig.add_subplot(111, projection="3d")
    jrender.render_frame(sim, FRAME, ax)
    plt.tight_layout()
    fig.canvas.draw()
    return fig, ax


def mpl_artists(ax):
    from mpl_toolkits.mplot3d.art3d import Line3D, Poly3DCollection, Text3D

    return [a for a in ax.get_children() if isinstance(a, (Line3D, Poly3DCollection, Text3D))]


def poly_verts(col):
    (sl,) = col._segslices
    return np.asarray(col._vec[:3, sl]).T


def test_display_list_equals_the_matplotlib_primitives(sim):
    """The same count and order of primitives; vertices equal, RGBA within
    1e-6, widths and strings equal."""
    from matplotlib.colors import to_rgba
    from mpl_toolkits.mplot3d.art3d import Line3D, Poly3DCollection, Text3D

    fig, ax = mpl_axes(sim, 4)
    want = mpl_artists(ax)
    got = trender.render_frame(sim, FRAME).items
    kinds = {raster.Polyline: Line3D, raster.Polygon: Poly3DCollection, raster.Label: Text3D}
    assert [kinds[type(g)] for g in got] == [type(w) for w in want]
    assert sum(isinstance(g, raster.Polygon) for g in got) >= 3
    for g, w in zip(got, want):
        if isinstance(g, raster.Polyline):
            np.testing.assert_array_equal(g.verts, np.stack(w.get_data_3d(), axis=1))
            np.testing.assert_allclose(g.color, to_rgba(w.get_color(), w.get_alpha()),
                                       rtol=0, atol=1e-6)
            assert g.width == w.get_linewidth()
        elif isinstance(g, raster.Polygon):
            np.testing.assert_array_equal(g.verts, poly_verts(w))
            np.testing.assert_allclose(g.face, w.get_facecolor()[0], rtol=0, atol=1e-6)
            np.testing.assert_allclose(g.edge, w.get_edgecolor()[0], rtol=0, atol=1e-6)
            assert g.width == w.get_linewidth()[0]
        else:
            np.testing.assert_array_equal(g.pos, w.get_position_3d())
            assert g.text == w.get_text() and g.size == w.get_fontsize()
            np.testing.assert_allclose(g.color, to_rgba(w.get_color()), rtol=0, atol=1e-6)
    import matplotlib.pyplot as plt

    plt.close(fig)


@pytest.mark.parametrize("figsize", [4, 12])
def test_vertices_project_within_half_a_pixel(sim, figsize):
    """Every vertex of every primitive lands within TOL_PX of matplotlib's
    pixel position after canvas.draw(); the lines' vertices that mplot3d
    masks are the ones the port drops."""
    from mpl_toolkits.mplot3d import proj3d

    fig, ax = mpl_axes(sim, figsize)
    camera = raster.Camera(trender.render_frame(sim, FRAME).view, figsize)
    height = fig.bbox.height
    assert camera.size == int(height) == figsize * 100

    def image(xy):
        d = ax.transData.transform(xy)
        return np.stack([d[:, 0], height - d[:, 1]], axis=1)

    checked = 0
    for a in mpl_artists(ax):
        if hasattr(a, "get_data_3d"):
            got, _, inside = camera.project(np.stack(a.get_data_3d(), axis=1))
            xy = np.ma.getdata(a.get_xydata()), np.ma.getmaskarray(a.get_xdata(orig=False))
            assert (inside == ~xy[1]).all()
            want = image(xy[0][inside])
            got = got[inside]
        elif hasattr(a, "get_position_3d"):
            got, _, _ = camera.project(np.asarray(a.get_position_3d()))
            x, y, _ = proj3d.proj_transform(*a.get_position_3d(), ax.M)
            want = image(np.array([[x, y]]))
        else:
            got, _, _ = camera.project(poly_verts(a))
            want = image(a.get_paths()[0].vertices[:-1])
        assert np.abs(got - want).max() <= TOL_PX
        checked += len(got)
    assert checked > 100
    import matplotlib.pyplot as plt

    plt.close(fig)


def test_painters_order_is_mplot3d_computed_zorder(sim):
    """The port draws its primitives in the order of matplotlib's stable
    sort by the z-orders mplot3d computed."""
    fig, ax = mpl_axes(sim, 4)
    want = mpl_artists(ax)
    mpl_order = sorted(range(len(want)), key=lambda i: want[i].zorder)
    dl = trender.render_frame(sim, FRAME)
    assert raster.draw_order(dl.items, raster.Camera(dl.view, 4)) == mpl_order
    import matplotlib.pyplot as plt

    plt.close(fig)


def text_boxes(sim, ax, dl, camera, height):
    """[(r0, c0, r1, c1)] around every label, matplotlib's and the port's,
    two pixels wider on each side."""
    from mpl_toolkits.mplot3d import proj3d

    renderer = ax.figure.canvas.get_renderer()
    boxes = []
    for t in [a for a in mpl_artists(ax) if hasattr(a, "get_position_3d")]:
        x, y, _ = proj3d.proj_transform(*t.get_position_3d(), ax.M)
        (dx, dy), = ax.transData.transform([[x, y]])
        w, h, d = renderer.get_text_width_height_descent(t.get_text(), t.get_fontproperties(),
                                                         ismath=False)
        boxes.append((height - dy - (h - d), dx, height - dy + d, dx + w))
    for item in dl.items:
        if isinstance(item, raster.Label):
            (r0, c0), mask = raster.label_mask(item.text, item.size,
                                               camera.project(item.pos)[0][0])
            boxes.append((r0, c0, r0 + mask.shape[0], c0 + mask.shape[1]))
    return [(int(np.floor(r0)) - 2, int(np.floor(c0)) - 2, int(np.ceil(r1)) + 2,
             int(np.ceil(c1)) + 2) for r0, c0, r1, c1 in boxes]


def test_frame_pixels_against_render_png(sim, tmp_path):
    """Against mind_tpu's render_png at figsize 4: the drawn-pixel masks,
    outside the text boxes, overlap with IoU >= MIN_IOU, and the per-channel
    mean absolute difference over the frame is <= MAX_MEAN_ABS levels."""
    from PIL import Image
    from mind_tpu.viz import render as jrender

    jrender.render_png(sim, FRAME, str(tmp_path), figsize=4)
    with Image.open(tmp_path / f"frame_{FRAME:03d}.png") as im:
        want = np.asarray(im.convert("RGBA")).astype(np.int64)
    dl = trender.render_frame(sim, FRAME)
    got = raster.rasterize(dl, 4).astype(np.int64)
    assert got.shape == want.shape == (400, 400, 4)
    fig, ax = mpl_axes(sim, 4)
    outside = np.ones((400, 400), bool)
    for r0, c0, r1, c1 in text_boxes(sim, ax, dl, raster.Camera(dl.view, 4), 400):
        outside[max(r0, 0):max(r1, 0), max(c0, 0):max(c1, 0)] = False
    import matplotlib.pyplot as plt

    plt.close(fig)
    drawn_got = ((255 - got[..., :3]).max(-1) > DRAWN) & outside
    drawn_want = ((255 - want[..., :3]).max(-1) > DRAWN) & outside
    iou = (drawn_got & drawn_want).sum() / (drawn_got | drawn_want).sum()
    mean_abs = np.abs(got - want)[..., :3].mean(axis=(0, 1))
    assert drawn_want.sum() > 1000
    assert iou >= MIN_IOU, (iou, drawn_got.sum(), drawn_want.sum())
    assert (mean_abs <= MAX_MEAN_ABS).all(), mean_abs


def test_png_written_by_the_port_reads_in_pil(sim, tmp_path):
    from PIL import Image

    trender.render_png(sim, FRAME, str(tmp_path), figsize=3)
    want = raster.rasterize(trender.render_frame(sim, FRAME), 3)
    with Image.open(tmp_path / f"frame_{FRAME:03d}.png") as im:
        assert im.mode == "RGBA"
        np.testing.assert_array_equal(np.asarray(im), want)
    np.testing.assert_array_equal(raster.read_png(tmp_path / f"frame_{FRAME:03d}.png"), want)


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_png_written_by_pil_reads_in_the_port(tmp_path, mode):
    from PIL import Image

    rng = np.random.default_rng(5)
    smooth = np.add.outer(np.arange(90), np.arange(70)) % 256
    img = np.stack([smooth, 255 - smooth, smooth * 3 % 256, 255 - smooth // 2], -1)
    img[40:60] = rng.integers(0, 256, (20, 70, 4))
    img = img[..., :len(mode)].astype(np.uint8)
    for optimize in (False, True):
        Image.fromarray(img, mode).save(tmp_path / "pil.png", optimize=optimize)
        with Image.open(tmp_path / "pil.png") as im:
            np.testing.assert_array_equal(raster.read_png(tmp_path / "pil.png"), np.asarray(im))


def _filtered_png(img, kind):
    """A PNG of `img` with every row under filter `kind`, filtered here by
    the definitions of the PNG specification."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int64)
    rows = []
    for r in range(h):
        up = x[r - 1] if r else np.zeros(w * c, np.int64)
        left = np.concatenate([np.zeros(c, np.int64), x[r, :-c]])
        corner = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        if kind == 0:
            pred = 0 * up
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - corner
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - corner)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, corner))
        rows.append(bytes([kind]) + ((x[r] - pred) % 256).astype(np.uint8).tobytes())

    def chunk(k, d):
        return struct.pack(">I", len(d)) + k + d + struct.pack(">I", zlib.crc32(k + d))

    return (raster.PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, {3: 2, 4: 6}[c], 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_png_filter_types(tmp_path, kind):
    """Each of the five filter types, as PIL decodes the same file."""
    from PIL import Image

    rng = np.random.default_rng(kind)
    img = rng.integers(0, 256, (13, 17, 3), dtype=np.uint8)
    (tmp_path / "f.png").write_bytes(_filtered_png(img, kind))
    with Image.open(tmp_path / "f.png") as im:
        np.testing.assert_array_equal(np.asarray(im), img)
    np.testing.assert_array_equal(raster.read_png(tmp_path / "f.png"), img)
