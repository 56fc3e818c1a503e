"""Episode throughput in strict float64 solve mode (counterpart of the JAX
package's scripts/bench_strict.py).

Strict mode (`TrajTreeConfig.solve_dtype="float64"` under each demo's
configuration, the same rel_tol) is the configuration whose free-run
trajectory follows the float64 mirror to ~1e-7 (PARITY_TRACES.md section 3).
This driver prices it: sim/episode.py::run_episode_segmented per demo, one
warm pass, then the timed one; `clears_50x` says whether the worst demo
still reaches 50x the reference's 0.83 steps/s.

On the TPU float64 is emulated, and the whole strict episode outlived the
runtime's execution watchdog, hence the segments there. The H100 computes
float64 natively, at half its float32 rate outside the tensor cores, and
the port's solve is bound by graph replays with a host read each, not by
arithmetic: on an H100 80GB HBM3 (700 W) the strict episode ran the four
synthetic demo scenes at 0.77-0.89x the float32 episode's steps/s, with
the same plans and no failed cycle (worst demo 20.1 against 24.8 steps/s;
PERF.md), where on the TPU it could not approach float32 at all. Neither
clears 50x. The card has no watchdog; --seg-cycles only bounds a segment,
with the same result to the bit for any length.

    python -m mind_tpu_torch.scripts.bench_strict --synthetic [--demos 1,2,3,4]
        [--steps 500] [--seg-cycles 5] [--out outputs/torch/strict_episode.json]

A plan failure is written into its row and makes the exit non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from mind_tpu_torch.scripts import (OUT, add_scene_args, check_scene_args, demo_names, demo_sim,
                                    device_name, launched_since, launches, scene_root,
                                    write_json)

BASELINE = 500.0 / 600.0


def strict_config(demo: str):
    from mind_tpu_torch.config import planner_config_for_demo

    pcfg = planner_config_for_demo(demo)
    pcfg.traj_tree.solve_dtype = "float64"
    return pcfg


def strict_row(demo: str, sim, steps=None, seg_cycles: int = 5):
    """(row, EpisodeResult): a warm segmented pass absorbs the kernel builds
    and graph captures, the second pass is timed."""
    from mind_tpu_torch.sim.episode import build_episode_inputs, run_episode_segmented

    launched_before = launches()
    inp = build_episode_inputs(sim, steps)
    run_episode_segmented(sim, steps, seg_cycles=seg_cycles, inputs=inp)
    t0 = time.perf_counter()
    res = run_episode_segmented(sim, steps, seg_cycles=seg_cycles, inputs=inp)
    wall = time.perf_counter() - t0
    sps = len(res.ego_states) / wall
    return {"demo": demo, "ticks": len(res.ego_states), "plan_calls": res.plan_calls,
            "fail_cycle": res.fail_cycle, "steps_per_s": sps, "vs_baseline": sps / BASELINE,
            "wall_s": wall, "launches": launched_since(launched_before)}, res


def _parse(argv):
    ap = argparse.ArgumentParser(prog="python -m mind_tpu_torch.scripts.bench_strict",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--demos", default="1,2,3,4")
    ap.add_argument("--steps", type=int, default=None, help="ticks (default: the demos' 500)")
    ap.add_argument("--seg-cycles", type=int, default=5, help="plan cycles per segment")
    ap.add_argument("--out", default=str(OUT / "strict_episode.json"))
    add_scene_args(ap)
    opts = ap.parse_args(argv)
    check_scene_args(ap, opts)
    return opts


def main(argv=None) -> int:
    from mind_tpu_torch.common.device import resolve_device

    opts = _parse(argv)
    device = resolve_device(opts.device)
    rows = []
    with scene_root(opts) as root:
        for demo in demo_names(opts.demos):
            sim = demo_sim(opts, demo, root, ticks=opts.steps, planner_cfg=strict_config(demo))
            rows.append(strict_row(demo, sim, opts.steps, opts.seg_cycles)[0])
            if rows[-1]["fail_cycle"] >= 0:
                print(f"{demo}: strict-mode plan failure at cycle {rows[-1]['fail_cycle']}; "
                      "its row times the cut rollout", file=sys.stderr)
            print(json.dumps(rows[-1]), flush=True)
    worst = min(rows, key=lambda r: r["steps_per_s"])
    out = {"mode": "strict solve_dtype=float64 episode (segmented)",
           "seg_cycles": opts.seg_cycles, "device": device_name(device),
           "worst_steps_per_s": worst["steps_per_s"], "worst_vs_baseline": worst["vs_baseline"],
           "clears_50x": worst["vs_baseline"] >= 50.0, "per_demo": rows}
    print(json.dumps(out, indent=1))
    write_json(opts.out, out)
    return 1 if any(r["fail_cycle"] >= 0 for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
