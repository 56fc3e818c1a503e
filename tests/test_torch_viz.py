"""Rendering of the PyTorch port (mind_tpu_torch/viz) against mind_tpu's:
the hull and footprint helpers equal, the port's JPEG encoder against PIL's
(tables, quality), its AVI against mind_tpu's writer, Simulator.render_video
on a 5-tick run with the planner on, and run_sim with rendering in a
process where pandas, pyarrow, matplotlib, PIL and cv2 cannot be imported,
as on the card's machine. The frames themselves are held against
matplotlib's in test_torch_raster.py."""

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
CLI_TICKS = 10


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


def frame_rgb(sim, figsize=4, idx=2):
    from mind_tpu_torch.viz import raster

    return raster.rasterize(trender.render_frame(sim, idx), figsize)[..., :3]


def psnr(a, b):
    return 10 * np.log10(255.0 ** 2 / np.mean((a.astype(np.float64) - b) ** 2))


@pytest.mark.parametrize("quality", [50, 85, 95])
def test_jpeg_quant_tables_equal_pil(quality):
    """The IJG-scaled Annex K tables, in natural order as PIL reports them,
    and the standard Huffman tables PIL writes."""
    import io

    from PIL import Image

    from mind_tpu_torch.viz import jpeg

    buf = io.BytesIO()
    Image.new("RGB", (16, 16), (200, 30, 90)).save(buf, format="JPEG", quality=quality)
    with Image.open(io.BytesIO(buf.getvalue())) as im:
        tables = im.quantization
    luma, chroma = jpeg.quant_tables(quality)
    assert list(tables[0]) == luma.tolist() and list(tables[1]) == chroma.tolist()
    ours = jpeg.encode_jpeg(np.full((16, 16, 3), 128, np.uint8), quality)
    assert header_segments(ours)[0xC4] == header_segments(buf.getvalue())[0xC4]


def header_segments(data):
    """{marker byte: its segments' payloads joined} before the scan."""
    out, pos = {}, 2
    while data[pos + 1] != 0xDA:
        n = int.from_bytes(data[pos + 2:pos + 4], "big")
        out[data[pos + 1]] = out.get(data[pos + 1], b"") + data[pos + 4:pos + 2 + n]
        pos += 2 + n
    return out


@pytest.mark.parametrize("figsize", [4, 12])
def test_jpeg_within_1db_of_pil(sim, figsize):
    """PIL decodes the port's JPEG of a drawn frame (quality 85, 4:2:0) to
    within 1 dB PSNR of PIL's own encoding of the same frame."""
    import io

    from PIL import Image

    from mind_tpu_torch.viz import jpeg

    rgb = frame_rgb(sim, figsize)
    with Image.open(io.BytesIO(jpeg.encode_jpeg(rgb, 85))) as im:
        assert im.format == "JPEG" and im.size == (figsize * 100,) * 2
        ours = np.asarray(im.convert("RGB"))
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="JPEG", quality=85)
    with Image.open(io.BytesIO(buf.getvalue())) as im:
        theirs = np.asarray(im.convert("RGB"))
    assert abs(psnr(ours, rgb) - psnr(theirs, rgb)) <= 1.0, (psnr(ours, rgb), psnr(theirs, rgb))


def test_jpeg_odd_sizes_and_stuffing():
    """Sizes that are no multiple of 16 (edge-padded MCUs) and noise that
    makes 0xFF bytes: PIL decodes them to the encoded size and close to the
    input."""
    import io

    from PIL import Image

    from mind_tpu_torch.viz import jpeg

    rng = np.random.default_rng(1)
    for h, w in ((8, 8), (17, 33), (50, 21)):
        rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        data = jpeg.encode_jpeg(rgb, 85)
        with Image.open(io.BytesIO(data)) as im:
            assert im.size == (w, h)
            got = np.asarray(im.convert("RGB"))
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, format="JPEG", quality=85)
        with Image.open(io.BytesIO(buf.getvalue())) as im:
            theirs = np.asarray(im.convert("RGB"))
        assert abs(psnr(got, rgb) - psnr(theirs, rgb)) <= 1.0


def avi_fps(path):
    data = open(path, "rb").read()
    i = data.index(b"avih")
    return 1_000_000 / int.from_bytes(data[i + 8:i + 12], "little")


def test_mjpeg_avi_probes_as_the_jax_writer(sim, tmp_path):
    """The port's AVI of three drawn frames against mind_tpu's writer on
    the same PNGs: the same frames, size, index entries and frame rate."""
    from mind_tpu.viz import video as jvideo

    for i in range(3):
        trender.render_png(sim, i, str(tmp_path), figsize=3)
    pngs = tvideo.numeric_frame_sort(str(p) for p in tmp_path.glob("frame_*.png"))
    assert pngs == jvideo.numeric_frame_sort(str(p) for p in tmp_path.glob("frame_*.png"))
    tvideo.write_mjpeg_avi(pngs, str(tmp_path / "t.avi"), fps=25)
    jvideo.write_mjpeg_avi(pngs, str(tmp_path / "j.avi"), fps=25)
    got = tvideo.probe_avi(str(tmp_path / "t.avi"))
    assert got == jvideo.probe_avi(str(tmp_path / "j.avi"))
    assert got["frames"] == got["index_entries"] == 3 and got["jpeg_ok"]
    assert (got["width"], got["height"]) == (300, 300)
    assert avi_fps(tmp_path / "t.avi") == avi_fps(tmp_path / "j.avi") == 25


def test_render_video(sim, monkeypatch):
    """Simulator.render_video renders every frame in this process
    (num_threads = 1) and, without ffmpeg, writes an MJPEG AVI."""
    monkeypatch.setattr(trender.shutil, "which", lambda name: None)
    video = sim.render_video()
    assert video.endswith(f"{SEQ_ID}_demo_1.avi")
    info = tvideo.probe_avi(video)
    assert info["frames"] == info["index_entries"] == TICKS and info["jpeg_ok"]
    assert info["width"] > 0 and info["height"] > 0


# installed by a sitecustomize on the subprocess's PYTHONPATH: the packages the
# card's machine lacks cannot be imported, and ffmpeg is not found
BLOCKING_SITE = """
import importlib.abc
import shutil
import sys

BLOCKED = {"pandas", "pyarrow", "matplotlib", "mpl_toolkits", "PIL", "cv2"}


class Blocked(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked in this process")
        return None


sys.meta_path.insert(0, Blocked())
_which = shutil.which
shutil.which = lambda cmd, *a, **kw: None if cmd == "ffmpeg" else _which(cmd, *a, **kw)
"""


def test_run_sim_renders_on_the_cards_installation(world, tmp_path):
    """python -m mind_tpu_torch.run_sim --device cpu with rendering on, on a
    log written here by pandas, the planner on from tick 0, 10 ticks, two
    spawn render workers: in a process (and its children) where pandas,
    pyarrow, matplotlib, mpl_toolkits, PIL and cv2 raise on import. It exits
    0 and writes an AVI that probe_avi accepts."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from test_torch_data import scenario_frame

    pytest.importorskip("pandas")
    pytest.importorskip("pyarrow")
    scenario_frame(world.syn.scenario).to_parquet(
        world.root / SEQ_ID / f"scenario_{SEQ_ID}.parquet")
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(BLOCKING_SITE)
    out_dir = tmp_path / "out"
    cfg = tmp_path / "sim.json"
    cfg.write_text('{"sim_name": "demo_1", "seq_id": "%s", "render": true, "num_threads": 2, '
                   '"output_dir": "%s", "render_config": {"camera_position": {"x": %r, '
                   '"y": %r, "yaw": 0.62, "elev": 90}}, "cl_agents": [{"id": "AV", '
                   '"enable_timestep": 0.0, "target_velocity": 8.0, "agent": "agent:MINDAgent"}]}'
                   % (SEQ_ID, out_dir, *map(float, AV2_ORIGIN)))
    root = Path(__file__).resolve().parent.parent
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(site), *filter(None, [os.environ.get("PYTHONPATH")])])}
    p = subprocess.run(
        [sys.executable, "-c", "import pandas", ], env=env, cwd=root, capture_output=True,
        text=True, timeout=60)
    assert p.returncode != 0 and "blocked" in p.stderr          # the hook is in place
    p = subprocess.run(
        [sys.executable, "-m", "mind_tpu_torch.run_sim", "--config", str(cfg), "--data-root",
         str(world.root), "--device", "cpu", "--max-steps", str(CLI_TICKS)],
        env=env, cwd=root, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "'plan_calls': 2" in p.stdout, p.stdout
    info = tvideo.probe_avi(str(out_dir / f"{SEQ_ID}_demo_1.avi"))
    assert info["frames"] == info["index_entries"] == CLI_TICKS and info["jpeg_ok"]
    assert (info["width"], info["height"]) == (1200, 1200)
