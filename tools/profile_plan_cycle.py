"""Where a plan cycle's time goes on the GPU: torch.profiler over steady
plan cycles of the port on chip_smoke.py's synthetic scene.

    python3 tools/profile_plan_cycle.py [--cycles 2] [--out plan_profile.json]

Runs one warm-up cycle, then profiles `--cycles` cycles (CPU + CUDA
activities) and prints one JSON object: per cycle the host wall time and
phase times, the number of device kernels launched, the device busy time
(union of kernel intervals) and its share of the wall time; and the device
time by kernel name, largest first. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def busy_us(intervals):
    """Total length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cycles", type=int, default=2)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_plan_cycle: needs a CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from mind_tpu_torch.common.kinematics import kine_propagate
    from mind_tpu_torch.config import DEFAULT_WEIGHTS, PlannerConfig
    from mind_tpu_torch.models.weights import load_scene_pred
    from mind_tpu_torch.ops import fusion_attention as fa
    from mind_tpu_torch.planner import aime_device as aime
    from mind_tpu_torch.planner import planner as tplanner
    from mind_tpu_torch.planner.trajectory_tree import make_cost_params
    from mind_tpu_torch.synthetic import scene_statics, synthetic_scene

    dev = torch.device("cuda")
    cfg = PlannerConfig()
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
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
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
            "device_kernels": len(kernels), "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / 1e3 / (wall * 1e3),
        })
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    result = {
        "device": torch.cuda.get_device_name(0),
        "cycles": cycles,
        "device_ms_by_kernel": [{"name": k[:80], "ms": v[0] / args.cycles,
                                 "count": v[1] / args.cycles} for k, v in top],
    }
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
