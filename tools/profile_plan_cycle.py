"""Where a plan cycle's time goes on the GPU: torch.profiler over steady
plan cycles of the port on chip_smoke.py's synthetic scene.

    python3 tools/profile_plan_cycle.py [--cycles 2] [--demo] [--episode] [--out plan_profile.json]
    python3 tools/profile_plan_cycle.py --episode --time [--demo] [--root DIR]

`--demo` profiles the demo planner configuration (bf16 network) instead of
the float32 defaults. `--episode` profiles steady planning cycles of the
episode runner (sim/episode.py, its eager cycles) instead: chip_smoke.py's closed-loop
scenario (synthetic_av2(0), planner enabled after 1 s), a whole warm
episode first, then the cycles from cycle 12 on with the carry of the
cycles before them. `--episode --time` runs no profiler: it times
run_episode_timed over 150 ticks (a warm call, then the timed one) and
prints the ticks per second and the planning cycle's mean phase times in
ms, with mind_tpu_torch imported from `--root DIR` (default: this
checkout), to compare two checkouts in one call.

Runs one warm-up cycle, then profiles `--cycles` cycles (CPU + CUDA
activities) and prints one JSON object: per cycle the host wall time and
phase times, the number of device kernels launched, the device busy time
(union of kernel intervals) and its share of the wall time; and the device
time by kernel name, largest first, and the fusion core's kernels apart.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


busy_us = cs.busy_us


def device_kernels(prof):
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def summary(by_name, n_cycles):
    """The device time by kernel name, largest first, and the fusion core's
    three launches per call apart, per cycle."""
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    fusion = {k: v for k, v in by_name.items()
              if any(s in k for s in ("edge_attention", "token_proj", "out_proj"))}
    return {
        "fusion_kernels": [{"name": k[:80], "ms": v[0] / n_cycles, "count": v[1] / n_cycles}
                           for k, v in sorted(fusion.items())],
        "fusion_ms_per_cycle": sum(v[0] for v in fusion.values()) / n_cycles,
        "device_ms_by_kernel": [{"name": k[:80], "ms": v[0] / n_cycles,
                                 "count": v[1] / n_cycles} for k, v in top],
    }


def emit(result, out):
    text = json.dumps(result, indent=1)
    print(text)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(text)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())


def episode_sim(demo: bool, ticks: int, data_root):
    """chip_smoke.py's closed-loop Simulator (synthetic_av2(0), the planner
    on after 1 s, the AV asked for 8 m/s), its map written under
    data_root, initialized; and its planner configuration."""
    from mind_tpu_torch.config import (DEFAULT_WEIGHTS, ClAgentConfig, PlannerConfig, SimConfig,
                                       planner_config_for_demo)
    from mind_tpu_torch.sim.simulator import Simulator
    from mind_tpu_torch.synthetic import synthetic_av2, write_synthetic_map

    if demo:
        cfg = planner_config_for_demo("demo_1")
    else:
        cfg = PlannerConfig()
        cfg.ckpt_path = str(DEFAULT_WEIGHTS)
    syn = synthetic_av2(cs.SEED)
    write_synthetic_map(syn.map_json, data_root, cs.SEQ_ID)
    sim = Simulator(SimConfig(sim_name="demo_1", seq_id=cs.SEQ_ID, data_root=data_root,
                              cl_agents=[ClAgentConfig(id="AV", enable_timestep=1.0,
                                                       target_velocity=cs.TARGET_VELOCITY)]),
                    planner_cfg=cfg, max_steps=ticks, scenario=syn.scenario)
    sim.init_sim()
    return sim, cfg


def time_episode(args) -> int:
    """run_episode_timed over 150 ticks: ticks per second and the planning
    cycle's mean phase times."""
    import numpy as np

    from mind_tpu_torch.sim import episode

    with tempfile.TemporaryDirectory() as root:
        sim, _ = episode_sim(args.demo, 150, root)
        phases = []
        res, wall = episode.run_episode_timed(sim, phases=phases)
    planning = [p for p in phases if "solve" in p]
    keys = ("obs", "aime", "cost_topology", "solve", "selection", "propagate")
    print(json.dumps({
        "root": args.root, "device": torch.cuda.get_device_name(0),
        "ticks_per_s": len(res.ego_states) / wall, "plan_calls": res.plan_calls,
        "planning_cycle_ms": {k: float(np.mean([p[k] * 1e3 for p in planning])) for k in keys}}))
    return 0


def profile_episode(args) -> int:
    """Steady planning cycles of the episode runner under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from mind_tpu_torch.sim import episode

    first = 12   # two cycles after the planner is enabled (cycle 10)
    with tempfile.TemporaryDirectory() as root:
        sim, cfg = episode_sim(args.demo, 5 * (first + args.cycles), root)
        episode.run_episode(sim, graphed=False)   # warm: kernel builds, graph captures
        ego, pl, inp, statics = episode._episode_setup(sim, None, None)
        run = episode.episode_fn_for(pl, ego.veh_param, sim.sim_step, batch="single_seg")
        carry = episode._init_episode_carry(inp.types.shape[-2],
                                            getattr(torch, pl.cfg.pipeline_dtype), pl.device)
        carry, _ = run(pl.net, episode._slice_cycles(inp, 0, first), statics, inp.enable_tick, 0,
                       carry, graphed=False)
        cycles, by_name = [], {}
        for c in range(first, first + args.cycles):
            phases = []
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                carry, _ = run(pl.net, episode._slice_cycles(inp, c, c + 1), statics,
                               inp.enable_tick, c, carry, phases=phases)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            kernels = device_kernels(prof)
            busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
            for e in kernels:
                ms, n = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
            (rec,) = phases
            cycles.append({"cycle": c, "wall_ms": wall * 1e3, "rounds": rec.get("rounds"),
                           "phases_ms": {k: v * 1e3 for k, v in rec.items()
                                         if isinstance(v, float)},
                           "device_kernels": len(kernels), "device_busy_ms": busy / 1e3,
                           "device_busy_share": busy / 1e3 / (wall * 1e3)})
    emit({"device": torch.cuda.get_device_name(0), "path": "episode",
          "compute_dtype": cfg.net.compute_dtype, "cycles": cycles,
          **summary(by_name, args.cycles)}, args.out)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cycles", type=int, default=2)
    ap.add_argument("--demo", action="store_true",
                    help="planner_config_for_demo('demo_1'): the bf16 network")
    ap.add_argument("--episode", action="store_true",
                    help="profile planning cycles of the episode runner")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--time", action="store_true",
                    help="with --episode: time run_episode_timed, no profiler")
    ap.add_argument("--root", default=str(ROOT),
                    help="with --time: import mind_tpu_torch from this checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_plan_cycle: needs a CUDA device", file=sys.stderr)
        return 2
    if args.time and not args.episode:
        ap.error("--time times the episode runner: pass --episode")
    if args.time:
        sys.path.insert(0, str(Path(args.root).resolve()))
        return time_episode(args)
    if args.episode:
        return profile_episode(args)
    from torch.profiler import ProfilerActivity, profile

    from mind_tpu_torch.common.kinematics import kine_propagate
    from mind_tpu_torch.config import DEFAULT_WEIGHTS, PlannerConfig, planner_config_for_demo
    from mind_tpu_torch.models.weights import load_scene_pred
    from mind_tpu_torch.ops import fusion_attention as fa
    from mind_tpu_torch.planner import aime_device as aime
    from mind_tpu_torch.planner import planner as tplanner
    from mind_tpu_torch.planner.trajectory_tree import make_cost_params
    from mind_tpu_torch.synthetic import scene_statics, synthetic_scene

    dev = torch.device("cuda")
    cfg = planner_config_for_demo("demo_1") if args.demo else PlannerConfig()
    scene = synthetic_scene(cs.SEED, cfg.max_actors, cfg.max_lanes, n_agents=40)
    net = load_scene_pred(cfg.net, DEFAULT_WEIGHTS, dev)
    pdt = getattr(torch, cfg.pipeline_dtype)
    world = cs.World(scene)
    buf = cs.fill_buffer(aime, scene, pdt, dev)
    statics = scene_statics(scene, pdt, dev)
    mods = (tplanner, make_cost_params)

    def cycle(report):
        nonlocal buf
        t = time.perf_counter()
        out = cs.plan_once(mods, net, cfg, world, buf, statics, dev, report)
        wall = time.perf_counter() - t
        world.step(out[:2], kine_propagate)
        buf = aime.obs_buffer_update(buf, torch.tensor(world.state, device=dev),
                                     torch.tensor(scene.present, device=dev))
        return out, wall

    cycle({})  # warm-up: kernel build, allocator, cuBLAS handles
    cycles, by_name = [], {}
    for _ in range(args.cycles):
        report = {}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            before = fa.fused_edge_attention.launches
            out, wall = cycle(report)
            torch.cuda.synchronize()
        kernels = device_kernels(prof)
        busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
        for e in kernels:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
        cycles.append({
            "out": [float(x) for x in out], "wall_ms": wall * 1e3,
            "phases_ms": {k: report[k] * 1e3 for k in ("aime", "cost_topology", "solve",
                                                       "selection")},
            "rounds": report["rounds"], "trees": int(report["trees"].n_trees),
            "fusion_launches": fa.fused_edge_attention.launches - before,
            "warm_iterations": report["warm_iterations"], "iterations": report["iterations"],
            "device_kernels": len(kernels), "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / 1e3 / (wall * 1e3),
        })
    emit({"device": torch.cuda.get_device_name(0), "compute_dtype": cfg.net.compute_dtype,
          "cycles": cycles, **summary(by_name, args.cycles)}, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
