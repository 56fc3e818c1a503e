"""Closed-loop acceptance of the port: every demo over its horizon with zero
plan failures (counterpart of the JAX package's scripts/run_all_demos.py),
with the per-demo rows and the markdown report in DEMOS_TPU.md's layout.

    python -m mind_tpu_torch.scripts.run_all_demos --synthetic [--mode host|episode|both]
        [--steps 500] [--demos 1,2,3,4] [--report outputs/torch/DEMOS_H100.md]
        [--json-out ...] [--episode-json ...] [--data-root DIR] [--device cpu]

- episode mode: sim/episode.py::run_episode_timed per demo (a warm run, then
  the timed one); writes --episode-json stamped with the horizon and demos;
- host mode: the Simulator loop per demo, warmed by 12 ticks with the
  planner on and rewound to tick 0 (bench.py::_warm_host_loop), then timed;
  merges the episode rows of --episode-json into the report only when that
  file holds the same horizon and demo list.

A row counts its plans from the timed run alone (the JAX script's host rows
also count the warm-up's). Unlike the JAX script, FAIL exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from mind_tpu_torch.scripts import (OUT, add_scene_args, check_scene_args, demo_names, demo_sim,
                                    device_name, launched_since, launches, scene_root,
                                    write_json, write_text)

BASELINE = 500.0 / 600.0  # the reference's ~10 min per 500-step demo


def episode_row(demo: str, sim, steps=None) -> dict:
    """One demo on the episode runner: a warm run, then the timed one."""
    from mind_tpu_torch.sim.episode import run_episode_timed

    launched_before = launches()
    res, wall = run_episode_timed(sim, steps)
    n = len(res.ego_states)
    return {"demo": demo, "ticks": n, "plan_calls": res.plan_calls,
            "plan_failures": 0 if res.fail_cycle < 0 else 1, "fail_cycle": res.fail_cycle,
            "steps_per_sec": n / wall, "vs_baseline": n / wall / BASELINE, "wall_s": wall,
            "final_ego_v": float(res.ego_states[-1, 2]),
            "launches": launched_since(launched_before)}


def host_row(demo: str, sim) -> dict:
    """One demo on the Simulator loop, warmed and rewound, then timed, with
    the planner's mean phase times."""
    from mind_tpu_torch.bench import _av, _warm_host_loop

    av = _av(sim)
    av.planner.export_trees = False
    launched_before = launches()
    _warm_host_loop(sim, av)
    t0 = time.perf_counter()
    m = sim.run_sim()
    wall = time.perf_counter() - t0
    counters = av.planner.metrics.counters
    return {"demo": demo, "backend": sim.device.type, "device": device_name(sim.device),
            "ticks": m["ticks"], "plan_calls": m["plan_calls"],
            "plan_failures": int(counters.get("plan_failures", 0)),
            "plans_ok": int(counters.get("plans", 0)), "steps_per_sec": m["ticks"] / wall,
            "wall_s": wall, "final_ego_v": float(av.state[2]),
            "phase_mean_ms": {k: v["mean_ms"]
                              for k, v in av.planner.metrics.timer.summary().items()},
            "launches": launched_since(launched_before)}


def passed(rows, steps: int) -> bool:
    return all(r["ticks"] == steps and r["plan_failures"] == 0 for r in rows)


def saved_episode_rows(path, steps: int, demos: str):
    """The rows of an earlier episode run, if it had the same horizon and
    demo list; a file from another run is ignored, as it would misstate the
    acceptance."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        saved = json.load(f)
    if isinstance(saved, dict) and saved.get("steps") == steps and saved.get("demos") == demos:
        return saved["rows"]
    print(f"ignoring stale {path} (horizon/demos mismatch)")
    return []


def report_lines(rows, ep_rows, steps: int, device: str, scenes: str) -> list:
    """The report in DEMOS_TPU.md's layout: its section headings and table
    columns."""
    ok, ep_ok = passed(rows, steps), (passed(ep_rows, steps) if ep_rows else None)
    lines = [
        f"# DEMOS — closed-loop acceptance (mind_tpu_torch, {scenes})",
        "",
        "Acceptance bar (reference README.md:54-59): every demo completes its horizon"
        f" with zero plan failures. Device: {device}; horizon {steps} steps @ 50 Hz;"
        " plans at 10 Hz after the enable point.",
    ]
    if ep_rows:
        lines += [
            "",
            "## Fused-episode mode (the production/benched path)",
            "",
            "The episode runner (`sim/episode.py`, the cycles' state on the device);"
            " warm — the second call is timed, so kernel builds and CUDA graph captures"
            " are excluded.",
            "",
            "| demo | ticks | plans | plan failures | steps/s | vs 0.83 steps/s reference |",
            "|---|---|---|---|---|---|",
        ]
        lines += [f"| {r['demo']} | {r['ticks']} | {r['plan_calls']} | {r['plan_failures']} |"
                  f" {r['steps_per_sec']:.2f} | {r['vs_baseline']:.1f}× |" for r in ep_rows]
    lines += [
        "",
        "## Host-loop mode (reference-shaped 50 Hz Simulator loop)",
        "",
        "The planner is warmed on a 12-tick planning burst and the sim rewound to t=0"
        " via a state checkpoint before timing, so steps/s is steady-state host-loop"
        " throughput; plans count the timed run only.",
        "",
        "| demo | ticks | plans | plan failures | steps/s | wall (s) |",
        "|---|---|---|---|---|---|",
    ]
    lines += [f"| {r['demo']} | {r['ticks']} | {r['plan_calls']} | {r['plan_failures']} |"
              f" {r['steps_per_sec']:.2f} | {r['wall_s']:.2f} |" for r in rows]
    both_ok = ok and ep_ok is not False
    lines += ["", f"**Result: {'PASS' if both_ok else 'FAIL'}** — every demo"
              f"{' completes' if both_ok else ' must complete'} the horizon with zero plan"
              f" failures{' in both modes' if ep_rows else ''}."]
    return lines


def _parse(argv):
    ap = argparse.ArgumentParser(prog="python -m mind_tpu_torch.scripts.run_all_demos",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--demos", default="1,2,3,4")
    ap.add_argument("--report", default=None, help="markdown report (e.g. "
                    "outputs/torch/DEMOS_H100.md)")
    ap.add_argument("--json-out", default=str(OUT / "demos_metrics.json"))
    ap.add_argument("--mode", choices=["host", "episode", "both"], default="host")
    ap.add_argument("--episode-json", default=str(OUT / "episode_demos.json"))
    add_scene_args(ap)
    opts = ap.parse_args(argv)
    check_scene_args(ap, opts)
    return opts


def main(argv=None) -> int:
    from mind_tpu_torch.common.device import resolve_device

    opts = _parse(argv)
    device = resolve_device(opts.device)
    demos = demo_names(opts.demos)
    ep_rows, rows = [], []
    with scene_root(opts) as root:
        if opts.mode in ("episode", "both"):
            for demo in demos:
                ep_rows.append(episode_row(demo, demo_sim(opts, demo, root, ticks=opts.steps),
                                           opts.steps))
                print(json.dumps(ep_rows[-1]), flush=True)
            write_json(opts.episode_json, {"steps": opts.steps, "demos": opts.demos,
                                           "rows": ep_rows})
            if opts.mode == "episode":
                ok = passed(ep_rows, opts.steps)
                print(f"EPISODE DEMOS {'PASS' if ok else 'FAIL'}")
                return 0 if ok else 1
        if not ep_rows:
            ep_rows = saved_episode_rows(opts.episode_json, opts.steps, opts.demos)
        for demo in demos:
            rows.append(host_row(demo, demo_sim(opts, demo, root, ticks=opts.steps)))
            print(json.dumps(rows[-1]), flush=True)
    write_json(opts.json_out, rows)
    ok = passed(rows, opts.steps)
    print(f"ALL DEMOS {'PASS' if ok else 'FAIL'}")
    ep_ok = passed(ep_rows, opts.steps) if ep_rows else None
    if opts.report:
        scenes = "synthetic_av2 seeds 0-3" if opts.synthetic else "AV2 demo logs"
        write_text(opts.report, "\n".join(report_lines(rows, ep_rows, opts.steps,
                                                       device_name(device), scenes)) + "\n")
    return 0 if ok and ep_ok is not False else 1


if __name__ == "__main__":
    sys.exit(main())
