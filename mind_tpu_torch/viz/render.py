"""Visualization: per-frame 3D scenes -> PNGs -> video (the port's copy of
mind_tpu/viz/render.py, with matplotlib's axes replaced by a display list:
the drawing functions emit the primitives the JAX package's give its 3D
axes, and viz/raster.py draws them in numpy with the same camera and
painter's order, and writes the PNG).

Re-creates the reference's rendering surface (common/visualization.py,
simulator.py:109-219): map lane boundaries, agent footprints with heading
triangles, scenario-tree uncertainty hulls (convex hulls of per-step circles
— shapely replaced by a small monotone-chain hull), trajectory-tree bands,
and history trails. Frames render in a spawn-context process pool sized by
the sim config's `num_threads` (reference simulator.py:122-124) and ffmpeg
assembles the video when available; without it the workers JPEG-encode
their frames and viz/video.py wraps them into an MJPEG AVI.
`num_threads <= 1` renders serially.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from dataclasses import dataclass
from typing import List

import numpy as np

from mind_tpu_torch.viz.raster import DisplayList, rasterize, write_png
from mind_tpu_torch.viz.video import jpeg_frame

AVI_QUALITY = 85   # write_mjpeg_avi's default quality

EXO_COLOR = ("lightcoral", "indianred")


def convex_hull(points: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain; replaces shapely's Polygon.convex_hull."""
    pts = np.unique(points.round(6), axis=0)
    if len(pts) < 3:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def cross2(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    def half(iterable):
        out = []
        for p in iterable:
            while len(out) >= 2 and cross2(out[-2], out[-1], p) <= 0:
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    return np.array(lower[:-1] + upper[:-1])


def circle_points(center, radius, n=24):
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.stack([center[0] + radius * np.cos(t),
                     center[1] + radius * np.sin(t)], axis=1)


def vehicle_vertices(x, y, z, yaw, length, width, height):
    """8 cube vertices of a rotated footprint (common/geometry.py:59-67)."""
    dx, dy = length / 2, width / 2
    base = np.array([[-dx, -dy], [dx, -dy], [dx, dy], [-dx, dy]])
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, -s], [s, c]])
    b = base @ rot.T + np.array([x, y])
    low = np.concatenate([b, np.full((4, 1), z)], axis=1)
    high = np.concatenate([b, np.full((4, 1), z + height)], axis=1)
    return np.concatenate([low, high], axis=0)


def draw_map(ax, lane_boundaries, z=0.0):
    for bound in lane_boundaries:
        ax.plot(bound[:, 0], bound[:, 1], z, color="gray",
                linewidth=0.6, alpha=0.6)


@dataclass
class RenderScene:
    """Picklable snapshot of everything a render worker needs — the analog
    of the reference pickling (frame, config) tuples into its spawn pool
    (reference simulator.py:118-124)."""

    frames: List[dict]
    config: object           # SimConfig (plain dataclasses, picklable)
    lane_boundaries: List[np.ndarray]

    @classmethod
    def from_sim(cls, sim) -> "RenderScene":
        bounds = []
        for seg in sim.smp.map_data.vector_lane_segments.values():
            bounds.append(np.asarray(seg.left_lane_boundary))
            bounds.append(np.asarray(seg.right_lane_boundary))
        return cls(frames=sim.frames, config=sim.config,
                   lane_boundaries=bounds)


def _scene_of(sim_or_scene) -> RenderScene:
    if isinstance(sim_or_scene, RenderScene):
        return sim_or_scene
    return RenderScene.from_sim(sim_or_scene)


def draw_agent(ax, obs, z=0.1):
    v = vehicle_vertices(obs.state[0], obs.state[1], z, obs.state[3],
                         obs.bbox[0], obs.bbox[1], obs.bbox[2])
    ax.polygon(v[:4], facecolor=obs.clr[0], edgecolor=obs.clr[1],
               linewidth=2, alpha=0.5)
    # heading triangle
    lon = np.array([np.cos(obs.state[3]), np.sin(obs.state[3]), 0.0])
    lat = np.array([-np.sin(obs.state[3]), np.cos(obs.state[3]), 0.0])
    ctr = np.array([obs.state[0], obs.state[1], z])
    L, W = obs.bbox[0], obs.bbox[1]
    tri = np.array([ctr + 0.5 * L * lon,
                    ctr + 0.15 * L * lon + 0.5 * W * lat,
                    ctr + 0.15 * L * lon - 0.5 * W * lat,
                    ctr + 0.5 * L * lon])
    ax.plot(tri[:, 0], tri[:, 1], tri[:, 2], color=obs.clr[1], linewidth=1)


def draw_scen_trees(ax, scen_trees, z=0.05):
    """Uncertainty hulls per agent per scenario node
    (visualization.py:218-258 semantics via our own hull)."""
    for tree in scen_trees:
        for node in tree.nodes.values():
            prob, traj, cov = node.data[0], node.data[1], node.data[2]
            for a in range(traj.shape[0]):
                pts = []
                for t in range(0, traj.shape[1], 2):
                    r = max(float(cov[a, t]), 0.05)
                    pts.append(circle_points(traj[a, t], r))
                if not pts:
                    continue
                hull = convex_hull(np.concatenate(pts))
                if len(hull) < 3:
                    continue
                face = np.concatenate(
                    [hull, np.full((len(hull), 1), z)], axis=1)
                color = "deepskyblue" if a == 0 else "salmon"
                ax.polygon(face, facecolor=color, edgecolor=color,
                           alpha=min(0.08 + 0.4 * float(prob), 0.5))


def draw_traj_trees(ax, traj_trees, z=0.12, width=1.2):
    for tree in traj_trees:
        for node in tree.nodes.values():
            if node.parent_key is None:
                continue
            parent = tree.get_node(node.parent_key)
            p0, p1 = parent.data[0][:2], node.data[0][:2]
            ax.plot([p0[0], p1[0]], [p0[1], p1[1]], [z, z],
                    color="blue", linewidth=3, alpha=0.8)


def draw_traj(ax, history, z=0.05):
    h = np.asarray(history)
    ax.plot(h[:, 0], h[:, 1], z, color="white", linewidth=2, alpha=0.7)


def render_frame(sim, frame_idx) -> DisplayList:
    """One frame (reference simulator.py:148-219) as a display list,
    carrying forward the last available trees for frames between plans.
    Accepts a Simulator or a RenderScene."""
    scene = _scene_of(sim)
    frames = scene.frames
    cfg = scene.config

    def latest(key):
        for i in range(frame_idx, -1, -1):
            if key in frames[i]:
                return frames[i][key]
        return None

    scen_tree_vis = latest("scen_tree")
    traj_tree_vis = latest("traj_tree")

    range_3d = 15.0
    ax = DisplayList()
    center = np.array([cfg.render_config.camera_x, cfg.render_config.camera_y])
    ax.set_view([center[0] - range_3d, center[0] + range_3d],
                [center[1] - range_3d, center[1] + range_3d], [0, 2 * range_3d],
                elev=cfg.render_config.camera_elev,
                azim=180 + np.rad2deg(cfg.render_config.camera_yaw))

    draw_map(ax, scene.lane_boundaries)
    if scen_tree_vis is not None:
        draw_scen_trees(ax, scen_tree_vis)
    if traj_tree_vis is not None:
        draw_traj_trees(ax, traj_tree_vis)

    for obs in frames[frame_idx]["agents"]:
        draw_agent(ax, obs)
        if np.linalg.norm(obs.state[:2] - center) < 2 * range_3d:
            ax.text(obs.state[0], obs.state[1], 1.0,
                    f"No.{obs.id}:{obs.state[2]:.2f}m/s", fontsize=10)

    # history trails
    history = {}
    for obs in frames[frame_idx]["agents"]:
        history[obs.id] = [obs.state[:2]]
    for i in range(1, 100):
        if frame_idx - i < 0:
            break
        for obs in frames[frame_idx - i]["agents"]:
            if obs.id in history:
                history[obs.id].append(obs.state[:2])
    for h in history.values():
        h.reverse()
        if np.linalg.norm(h[0] - h[-1]) >= 0.1:
            draw_traj(ax, h)
    return ax


def render_png(sim, frame_idx, img_dir, figsize=12):
    """Draw frame `frame_idx` at figsize x figsize inches (100 dpi) into
    img_dir/frame_%03d.png."""
    write_png(os.path.join(img_dir, f"frame_{frame_idx:03d}.png"),
              rasterize(render_frame(sim, frame_idx), figsize))


def _render_chunk(scene: RenderScene, indices, img_dir, figsize, jpeg_quality=None):
    """Draw frames `indices` into img_dir: PNGs, or with `jpeg_quality` the
    JPEGs an MJPEG AVI holds (video.jpeg_frame, frame_%03d.jpg), encoded
    here in the worker. Returns the JPEGs' (width, height), or None."""
    size = None
    for idx in indices:
        if jpeg_quality is None:
            render_png(scene, idx, img_dir, figsize)
            continue
        data, size = jpeg_frame(rasterize(render_frame(scene, idx), figsize)[..., :3],
                                jpeg_quality)
        with open(os.path.join(img_dir, f"frame_{idx:03d}.jpg"), "wb") as f:
            f.write(data)
    return size


def render_frames_to_video(sim, figsize=12):
    """PNG-per-frame + ffmpeg assembly (reference simulator.py:109-132).

    Renders frames in a spawn-context process pool of `num_threads` workers
    (the sim-config knob, reference simulator.py:122-124); serially when
    num_threads <= 1 or only a handful of frames exist. Falls back to leaving
    PNGs in place when ffmpeg is unavailable.

    Spawn re-imports the caller's __main__ (standard multiprocessing
    semantics — the reference's spawn pool has the same requirement), so
    calling scripts must be import-safe; interactive/stdin callers are
    detected and rendered serially.
    """
    out_dir = sim.config.output_dir
    os.makedirs(out_dir, exist_ok=True)
    img_dir = os.path.join(out_dir, "imgs")
    os.makedirs(img_dir, exist_ok=True)

    scene = RenderScene.from_sim(sim)
    n = len(scene.frames)
    # without ffmpeg the workers encode the AVI's JPEGs themselves
    ffmpeg = shutil.which("ffmpeg")
    quality = None if ffmpeg else AVI_QUALITY
    workers = min(int(getattr(sim.config, "num_threads", 1)), n)
    # spawn re-imports __main__; interactive/stdin parents have no file to
    # re-import, so fall back to serial rendering there
    import sys
    main_file = getattr(sys.modules.get("__main__"), "__file__", None)
    if main_file is None or not os.path.exists(main_file):
        workers = 1
    if workers > 1:
        import multiprocessing as mp

        # one pickled scene per worker (interleaved chunks balance the
        # trailing frames' longer history trails)
        chunks = [list(range(w, n, workers)) for w in range(workers)]
        ctx = mp.get_context("spawn")
        with ctx.Pool(workers) as pool:
            sizes = pool.starmap(_render_chunk,
                                 [(scene, c, img_dir, figsize, quality) for c in chunks])
    else:
        sizes = [_render_chunk(scene, list(range(n)), img_dir, figsize, quality)]

    if ffmpeg:
        video = os.path.join(out_dir, f"{sim.seq_id}_{sim.sim_name}.mov")
        subprocess.run(
            ["ffmpeg", "-r", "25", "-i",
             os.path.join(img_dir, "frame_%03d.png"),
             "-vcodec", "mpeg4", "-y", video],
            check=False, capture_output=True)
        shutil.rmtree(img_dir)
        return video
    # no ffmpeg: assemble a playable MJPEG AVI in pure Python (reference
    # simulator.py:128-131's deliverable, without the dependency) from the
    # workers' JPEGs
    from mind_tpu_torch.viz.video import numeric_frame_sort, write_mjpeg_avi_frames

    video = os.path.join(out_dir, f"{sim.seq_id}_{sim.sim_name}.avi")
    jpegs = numeric_frame_sort((os.path.join(img_dir, f) for f in os.listdir(img_dir)
                                if f.startswith("frame_") and f.endswith(".jpg")),
                               suffix=".jpg")
    frames = []
    for path in jpegs:
        with open(path, "rb") as f:
            frames.append(f.read())
    width, height = next(size for size in sizes if size is not None)
    write_mjpeg_avi_frames(frames, width, height, video, fps=25)
    shutil.rmtree(img_dir)
    return video
