"""Rendering of the PyTorch port (mind_tpu_torch/viz) against mind_tpu's:
the hull and footprint helpers equal, the same frame of one port Simulator
drawn by both packages' render_png to equal pixels, the same PNGs to the
same AVI bytes, and Simulator.render_video on a 5-tick run with the planner
on (Agg backend, small figures)."""

import numpy as np
import pytest
import torch

from mind_tpu_torch.config import ClAgentConfig as TClAgentConfig, SimConfig as TSimConfig
from mind_tpu_torch.sim.simulator import Simulator as TSimulator
from mind_tpu_torch.synthetic import AV2_ORIGIN
from mind_tpu_torch.viz import render as trender
from mind_tpu_torch.viz import video as tvideo
from test_torch_data import SEQ_ID
from test_torch_planner import CL_AGENT, CPU, World, planner_cfgs

pytest.importorskip("matplotlib")
pytest.importorskip("PIL")
torch.set_num_threads(2)
TICKS = 5


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return World(tmp_path_factory.mktemp("av2"))


@pytest.fixture(scope="module")
def sim(world, tmp_path_factory):
    """A 5-tick port run on the CPU with the AV planning from tick 0, so the
    frames carry its scenario and trajectory trees; rendering on, one
    render process."""
    _, tcfg = planner_cfgs(world.n_lanes, "float32", "float32")
    cfg = TSimConfig(sim_name="demo_1", seq_id=SEQ_ID, data_root=str(world.root), render=True,
                     num_threads=1, output_dir=str(tmp_path_factory.mktemp("out")),
                     cl_agents=[TClAgentConfig(enable_timestep=0.0, **CL_AGENT)])
    cfg.render_config.camera_x, cfg.render_config.camera_y = AV2_ORIGIN
    s = TSimulator(cfg, planner_cfg=tcfg, max_steps=TICKS, device=CPU,
                   scenario=world.syn.scenario)
    s.init_sim()
    s.run_sim()
    assert s.metrics["plan_calls"] >= 1 and "scen_tree" in s.frames[0]
    return s


def test_hull_and_vertices_equal():
    from mind_tpu.viz import render as jrender

    rng = np.random.default_rng(0)
    for n in (2, 3, 7, 60):
        pts = rng.normal(0, 5, (n, 2))
        np.testing.assert_array_equal(trender.convex_hull(pts), jrender.convex_hull(pts))
    np.testing.assert_array_equal(trender.circle_points((1.0, 2.0), 0.7),
                                  jrender.circle_points((1.0, 2.0), 0.7))
    for args in ((1.0, 2.0, 0.0, 0.3, 4.0, 2.0, 1.5), (-3.0, 7.5, 0.1, -2.0, 12.0, 2.6, 3.2)):
        np.testing.assert_array_equal(trender.vehicle_vertices(*args),
                                      jrender.vehicle_vertices(*args))


def pixels(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))


def test_render_png_equal(sim, tmp_path):
    """Frame 2 of the port's run (it carries the trees of the plan at tick 0
    forward) drawn by both packages' render_png."""
    from mind_tpu.viz import render as jrender

    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jrender.render_png(sim, 2, str(tmp_path / "j"), figsize=4)
    trender.render_png(sim, 2, str(tmp_path / "t"), figsize=4)
    got, want = pixels(tmp_path / "t" / "frame_002.png"), pixels(tmp_path / "j" / "frame_002.png")
    assert got.shape == want.shape == (400, 400, 4)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got.reshape(-1, 4), axis=0)) > 10   # something was drawn


def test_mjpeg_avi_bytes_equal(sim, tmp_path):
    from mind_tpu.viz import video as jvideo

    for i in range(3):
        trender.render_png(sim, i, str(tmp_path), figsize=3)
    pngs = tvideo.numeric_frame_sort(str(p) for p in tmp_path.glob("frame_*.png"))
    assert pngs == jvideo.numeric_frame_sort(str(p) for p in tmp_path.glob("frame_*.png"))
    tvideo.write_mjpeg_avi(pngs, str(tmp_path / "t.avi"), fps=25)
    jvideo.write_mjpeg_avi(pngs, str(tmp_path / "j.avi"), fps=25)
    assert (tmp_path / "t.avi").read_bytes() == (tmp_path / "j.avi").read_bytes()
    assert tvideo.probe_avi(str(tmp_path / "t.avi")) == jvideo.probe_avi(str(tmp_path / "j.avi"))


def test_render_video(sim, monkeypatch):
    """Simulator.render_video renders every frame in this process
    (num_threads = 1) and, without ffmpeg, writes an MJPEG AVI."""
    monkeypatch.setattr(trender.shutil, "which", lambda name: None)
    video = sim.render_video()
    assert video.endswith(f"{SEQ_ID}_demo_1.avi")
    info = tvideo.probe_avi(video)
    assert info["frames"] == info["index_entries"] == TICKS and info["jpeg_ok"]
    assert info["width"] > 0 and info["height"] > 0
