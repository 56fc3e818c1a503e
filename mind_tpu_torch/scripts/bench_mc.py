"""The Monte-Carlo episode sweep: K perturbed-ego closed loops of one demo
(counterpart of the JAX package's scripts/bench_mc.py; BASELINE.json's
"64-way Monte-Carlo rollout with perturbed agent initial states").

    python -m mind_tpu_torch.scripts.bench_mc --synthetic [--k 64] [--chunk 4] [--seg 10]
        [--demo demo_1] [--horizon TICKS] [--tiny-net] [--out outputs/torch/mc64.json]

sim/episode.py::run_episode_monte_carlo in chunks of --chunk copies planned
as one batch, each in segments of --seg cycles. One chunk's worth of copies
runs first, untimed: its wall is `compile_wall_s` (kernel builds, CUDA
graph captures and the allocator's first requests; nothing compiles a
program here). Then the K copies are timed with each chunk's wall; the
first timed chunk is reported apart (cold) from the steady rate of the
others (warm). --tiny-net (one fusion layer, two FPN scales, seeded
weights) is for smoke runs only.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from mind_tpu_torch.scripts import (OUT, add_scene_args, check_scene_args, demo_sim,
                                    device_name, launched_since, launches, scene_root,
                                    write_json)

BASELINE = 500.0 / 600.0


def sweep(sim, k: int, chunk: int, seg: int, horizon=None) -> dict:
    from mind_tpu_torch.sim.episode import run_episode_monte_carlo

    launched_before = launches()
    t0 = time.perf_counter()
    run_episode_monte_carlo(sim, chunk, chunk=chunk, seg_cycles=seg, horizon=horizon)
    compile_s = time.perf_counter() - t0
    walls = []
    t0 = time.perf_counter()
    res = run_episode_monte_carlo(sim, k, chunk=chunk, seg_cycles=seg, horizon=horizon,
                                  chunk_walls=walls)
    wall = time.perf_counter() - t0
    total = sum(len(r.ego_states) for r in res)
    out = {"copies": k, "chunk": chunk, "seg_cycles": seg,
           "survived": sum(1 for r in res if r.fail_cycle < 0),
           "fail_cycles": sorted(r.fail_cycle for r in res if r.fail_cycle >= 0),
           "total_steps": total, "eff_steps_per_s": total / wall,
           "vs_baseline_0p83": total / wall / BASELINE, "wall_s": wall,
           "compile_wall_s": compile_s, "chunk_walls_s": [w for _, _, w in walls],
           "launches": launched_since(launched_before)}
    if len(walls) > 1:
        warm_wall = sum(w for _, _, w in walls[1:])
        warm_steps = sum(len(r.ego_states) for r in res[walls[0][1]:])
        out.update(cold_first_chunk_s=walls[0][2], warm_steps_per_s=warm_steps / warm_wall,
                   warm_vs_baseline_0p83=warm_steps / warm_wall / BASELINE)
    return out


def _parse(argv):
    ap = argparse.ArgumentParser(prog="python -m mind_tpu_torch.scripts.bench_mc",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=4)
    ap.add_argument("--seg", type=int, default=10)
    ap.add_argument("--demo", default="demo_1")
    ap.add_argument("--out", default=str(OUT / "mc64.json"))
    ap.add_argument("--horizon", type=int, default=None,
                    help="sim ticks (default: the configuration's full horizon)")
    ap.add_argument("--tiny-net", action="store_true",
                    help="1-layer seeded network: smoke runs only")
    add_scene_args(ap)
    opts = ap.parse_args(argv)
    check_scene_args(ap, opts)
    return opts


def main(argv=None) -> int:
    from mind_tpu_torch.common.device import resolve_device
    from mind_tpu_torch.config import planner_config_for_demo

    opts = _parse(argv)
    device = resolve_device(opts.device)
    pcfg = None
    if opts.tiny_net:
        pcfg = planner_config_for_demo(opts.demo)
        pcfg.net.n_scene_layer = 1
        pcfg.net.n_fpn_scale = 2
        pcfg.ckpt_path = None
    with scene_root(opts) as root:
        sim = demo_sim(opts, opts.demo, root, ticks=opts.horizon, planner_cfg=pcfg)
        out = sweep(sim, opts.k, opts.chunk, opts.seg, opts.horizon)
    out = {"demo": opts.demo, **out, "device": device_name(device)}
    print(json.dumps(out, indent=1))
    write_json(opts.out, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
