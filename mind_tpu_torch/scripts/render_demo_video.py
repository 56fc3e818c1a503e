"""A full-horizon demo video (counterpart of the JAX package's
scripts/render_demo_video.py; the reference assembles one video per demo
run, simulator.py:109-132).

    python -m mind_tpu_torch.scripts.render_demo_video --synthetic [--demo 1]
        [--max-steps 500] [--figsize 8] [--out outputs/torch/demo_1_full.avi]

Runs the Simulator loop over --max-steps ticks, draws every frame with
viz/render.py::render_frames_to_video (numpy; PNG frames under the
output's folder, removed once assembled) and checks the result with
viz/video.py::probe_avi: JPEG frames, at least max_steps - 1 of them. The
default figsize 8 gives 800x800 frames (the JAX script's size budget). Where
ffmpeg is installed the renderer writes a .mov, which this driver refuses.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
from pathlib import Path

from mind_tpu_torch.scripts import (OUT, add_scene_args, artifact, check_scene_args, demo_sim,
                                    scene_root)


def _parse(argv):
    ap = argparse.ArgumentParser(prog="python -m mind_tpu_torch.scripts.render_demo_video",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--demo", type=int, default=1)
    ap.add_argument("--max-steps", type=int, default=500)
    ap.add_argument("--figsize", type=int, default=8)
    ap.add_argument("--out", default=None, help="default outputs/torch/demo_<k>_full.avi")
    add_scene_args(ap)
    opts = ap.parse_args(argv)
    check_scene_args(ap, opts)
    return opts


def main(argv=None) -> int:
    opts = _parse(argv)
    from mind_tpu_torch.common.device import resolve_device
    from mind_tpu_torch.viz.render import render_frames_to_video
    from mind_tpu_torch.viz.video import probe_avi

    resolve_device(opts.device)
    demo = f"demo_{opts.demo}"
    out = artifact(opts.out or OUT / f"{demo}_full.avi")
    with scene_root(opts) as root:
        sim = demo_sim(opts, demo, root, ticks=opts.max_steps)
        print("sim metrics:", sim.run_sim(), flush=True)
        sim.config.output_dir = str(out.parent / f"{demo}_render")
        video = Path(render_frames_to_video(sim, figsize=opts.figsize))
    if video.suffix != ".avi":
        raise RuntimeError(f"the renderer wrote {video}, not an MJPEG .avi")
    if video.resolve() != out:
        shutil.move(video, out)
    os.rmdir(video.parent)
    info = probe_avi(str(out))
    print("video:", out, info, flush=True)
    if not info.get("jpeg_ok", False) or info.get("frames", 0) < opts.max_steps - 1:
        raise RuntimeError(f"{out}: {info}, expected JPEG frames >= {opts.max_steps - 1}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
