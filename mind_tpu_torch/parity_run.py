"""End-to-end trajectory parity of the port: its planner against the float64
host mirror, closed loop on the demo scenarios (counterpart of the JAX
package's scripts/parity_run.py; the BASELINE.json north star).

Usage: python -m mind_tpu_torch.parity_run [--demos 1,2,3,4] [--steps 500]
       [--report FILE] [--skip free|resync|playback ...]
       [--free-modes production,fast_f32,strict] [--data-root PATH | --synthetic]
       [--device cpu]

Three certifications per demo, all against the mirror
(mind_tpu_torch.parity.HostRefPlanner) sharing the device planner's network,
on the demo planner configuration (bf16 network):

1. episode playback (run_parity_episode_playback): the episode runner's
   recorded controls replayed per cycle against the mirror from identical
   inputs. Criterion: mean per-cycle rollout deviation <= 1e-3 m, zero
   plan-success flips.
2. resynced per-cycle (run_parity_demo_resync): one closed-loop sim driven
   by the staged planner with the mirror planning in tandem from identical
   inputs every 10 Hz cycle, the whole horizon. Same criterion.
3. free-run lockstep (run_parity_demo): two independent closed-loop sims
   for 60 closed-loop steps past enable, once per --free-modes entry;
   criterion max ego deviation <= 1e-3 m.

The demos' AV2 map and scenario files are read under --data-root
(<seq_id>/log_map_archive_<seq_id>.json and scenario_<seq_id>.parquet,
read by data/parquet.py); with --synthetic,
synthetic_av2 seeds 0-3 stand in for demo_1..4's logs (their maps written
in a temporary directory, the scenarios passed in memory). The planners run on
the CUDA card unless --device names another device. The report (--report)
has the layout of the JAX package's PARITY_TRACES.md.
"""

from __future__ import annotations

import argparse

CL_STEPS = 60  # free-run closed-loop segment past enable

# free-run dtype-policy modes: label -> run_parity_demo overrides
FREE_MODES = {
    # whatever planner_config_for_demo ships
    "production": {},
    # f32 pipeline/solve + f64 polish re-solve of the winner tree
    "polish": {"exec_solve_dtype": "float64", "exec_resolve_mode": "polish"},
    # f32 pipeline/solve + f64 two-phase scratch re-solve of the winner
    "scratch": {"exec_solve_dtype": "float64", "exec_resolve_mode": "scratch"},
    # f32 everything, exec re-solve off
    "fast_f32": {"exec_solve_dtype": "float32"},
    # f64 bulk pipeline, f32 solve, exec off
    "balanced": {"pipeline_dtype": "float64", "exec_solve_dtype": "float32"},
    # f64 bulk pipeline + f64 scratch exec re-solve
    "exec_bal": {"pipeline_dtype": "float64", "exec_solve_dtype": "float64",
                 "exec_resolve_mode": "scratch"},
    # 'scratch' semantics computed in C++ on the host (mind_tpu_torch/native)
    "native": {"exec_resolve_mode": "native"},
    "native_bal": {"pipeline_dtype": "float64", "exec_resolve_mode": "native"},
    # strict: pure f64 solver
    "strict": {"solve_dtype": "float64"},
}

FREE_MODE_LABELS = {
    "production": "production (f32 + f64 polish exec)",
    "polish": "f64 polish exec",
    "scratch": "f64 scratch exec",
    "fast_f32": "fast f32 (exec off)",
    "balanced": "balanced (pipe f64)",
    "strict": "strict f64",
}


def _passes(rows, key="mean_cycle_dev"):
    return all(r[key] <= 1e-3 and r.get("ok_mismatches", 0) == 0 for r in rows)


def verdicts(play_rows, sync_rows, free_rows):
    """One line per certification: PASS / FAIL and the worst number."""
    out = []
    if play_rows:
        out.append(f"episode playback {'PASS' if _passes(play_rows) else 'FAIL'} (worst mean "
                   f"{max(p['mean_cycle_dev'] for p in play_rows):.2e})")
    if sync_rows:
        out.append(f"resynced {'PASS' if _passes(sync_rows) else 'FAIL'} (worst mean "
                   f"{max(s['mean_cycle_dev'] for s in sync_rows):.2e})")
    for mode, rows in free_rows.items():
        out.append(f"free-run {mode} {'PASS' if _passes(rows, 'max_dev_cl') else 'FAIL'} "
                   f"(max {max(r['max_dev_cl'] for r in rows):.2e})")
    return out


def write_report(path, play_rows, sync_rows, free_rows, steps, device_name):
    lines = [
        "# PARITY_TRACES — end-to-end trajectory parity of mind_tpu_torch",
        "",
        "Demo planner configuration (bf16 network) vs the float64 host mirror",
        "with reference control flow (`mind_tpu_torch.parity.HostRefPlanner`),",
        "shared network, on the demo scenarios. Deviation = ego position",
        f"distance. Device: {device_name}.",
        "",
        f"## 1. Episode playback, {steps}-step horizon",
        "",
        "The episode runner (`sim/episode.py`) replayed per cycle against the",
        "mirror from identical inputs. Criterion: per-cycle MEAN <= 1e-3,",
        "zero ok flips.",
        "",
        "| demo | plans | ok flips | max cycle dev (m) | mean cycle dev (m)"
        " | max ctrl dev | mirror wall (s) |",
        "|---|---|---|---|---|---|---|",
    ]
    for p in play_rows:
        lines.append(
            f"| {p['demo']} | {p['plans_compared']} | {p['ok_mismatches']} |"
            f" {p['max_cycle_dev']:.2e} | {p['mean_cycle_dev']:.2e} |"
            f" {p['max_ctrl_dev']:.2e} | {p['mirror_wall_s']:.0f} |")
    lines += [
        "",
        f"## 2. Staged path: resynced per-cycle, {steps}-step horizon",
        "",
        "One closed-loop sim driven by the staged planner; the mirror plans",
        "in tandem from IDENTICAL inputs every 10 Hz cycle.",
        "",
        "| demo | plans compared | ok flips | max cycle dev (m) |"
        " mean cycle dev (m) | max ctrl dev | wall (s) |",
        "|---|---|---|---|---|---|---|",
    ]
    for s in sync_rows:
        lines.append(
            f"| {s['demo']} | {s['plans_compared']} | {s['ok_mismatches']} |"
            f" {s['max_cycle_dev']:.2e} | {s['mean_cycle_dev']:.2e} |"
            f" {s['max_ctrl_dev']:.2e} | {s['wall_s']:.0f} |")
    lines += [
        "",
        f"## 3. Free-run lockstep ({CL_STEPS} closed-loop steps past enable)",
        "",
        "Two independent closed-loop sims; whole-trajectory deviation, per",
        "dtype policy (`mind_tpu_torch/parity_run.py:FREE_MODES`).",
        "",
        "| demo | mode | closed-loop steps | max dev (m) | mean dev (m) |"
        " final dev (m) |",
        "|---|---|---|---|---|---|",
    ]
    for mode, rows in free_rows.items():
        label = FREE_MODE_LABELS.get(mode, mode)
        for r in rows:
            lines.append(
                f"| {r['demo']} | {label} | {r['closed_loop_steps']} |"
                f" {r['max_dev_cl']:.2e} | {r['mean_dev_cl']:.2e} |"
                f" {r['final_dev']:.2e} |")
    lines += ["", "**Result: " + "; ".join(verdicts(play_rows, sync_rows, free_rows))
              + "; target <= 1e-3.**"]
    short = [s for s in sync_rows if s["plans_compared"] < s["plans"]]
    flipped = [s for s in short if s["ok_mismatches"] > 0]
    if short and not flipped:
        lines += [
            "",
            f"On {', '.join(s['demo'] for s in short)} the resynced run compared fewer",
            "plans than it made: both sides agreed that a plan failed (zero ok",
            "flips), and the sim ends on a failed plan as the reference's does.",
        ]
    if flipped:
        names = ", ".join(f"{s['demo']} ({s['ok_mismatches']} flips)" for s in flipped)
        lines += ["", f"On {names} the two sides disagreed on plan success: a parity "
                      "defect, counted in the FAIL above."]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {path}")


def main(argv=None):
    ap = argparse.ArgumentParser(description="mind_tpu_torch end-to-end parity")
    ap.add_argument("--demos", default="1,2,3,4")
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--report", default=None)
    ap.add_argument("--skip", nargs="*", default=[], choices=["free", "resync", "playback"])
    ap.add_argument("--free-modes", default="production,fast_f32,strict",
                    help=f"comma list from {sorted(FREE_MODES)}")
    ap.add_argument("--data-root", default="data",
                    help="directory holding the AV2 scenario folders")
    ap.add_argument("--synthetic", action="store_true",
                    help="synthetic_av2 seeds 0-3 in place of demo_1..4's AV2 logs")
    ap.add_argument("--device", default=None,
                    help="torch device of the planners (default: the CUDA card)")
    args = ap.parse_args(argv)

    from mind_tpu_torch.common.device import resolve_device
    from mind_tpu_torch.scripts import scene_root

    device = resolve_device(args.device)
    demos = [f"demo_{d.strip()}" for d in args.demos.split(",")]
    free_modes = [m.strip() for m in args.free_modes.split(",") if m.strip()]
    for m in free_modes:
        if m not in FREE_MODES:
            ap.error(f"unknown free mode {m!r}")
    with scene_root(args) as root:
        args.data_root = root
        return _run(args, device, demos, free_modes)


def _run(args, device, demos, free_modes):
    from mind_tpu_torch.config import CONFIGS, SimConfig
    from mind_tpu_torch.parity.runner import (
        run_parity_demo,
        run_parity_demo_resync,
        run_parity_episode_playback,
    )
    from mind_tpu_torch.scripts import demo_log

    scenarios = {demo: demo_log(args, demo, args.data_root) for demo in demos}

    def show(r):
        print({k: (round(v, 8) if isinstance(v, float) else v)
               for k, v in r.items() if k != "records"}, flush=True)

    play_rows, sync_rows, free_rows = [], [], {}
    if "playback" not in args.skip:
        for demo in demos:
            print(f"=== {demo} episode playback ({args.steps} steps) ===", flush=True)
            r = run_parity_episode_playback(demo, args.steps, args.data_root, device=device,
                                            scenario=scenarios[demo])
            r.pop("records")
            play_rows.append(r)
            show(r)
    if "resync" not in args.skip:
        for demo in demos:
            print(f"=== {demo} resynced per-cycle ({args.steps} steps) ===", flush=True)
            s = run_parity_demo_resync(demo, args.steps, args.data_root, device=device,
                                       scenario=scenarios[demo])
            sync_rows.append(s)
            show(s)
    if "free" not in args.skip:
        for demo in demos:
            cfg = SimConfig.from_json(CONFIGS / f"{demo}.json", data_root=args.data_root)
            free_steps = int(round(cfg.cl_agents[0].enable_timestep / cfg.sim_step)) + CL_STEPS
            for mode in free_modes:
                print(f"=== {demo} free-run, {mode} ===", flush=True)
                r = run_parity_demo(demo, free_steps, args.data_root, device=device,
                                    scenario=scenarios[demo], **FREE_MODES[mode])
                free_rows.setdefault(mode, []).append(r)
                show(r)

    for line in verdicts(play_rows, sync_rows, free_rows):
        print(line)
    if args.report:
        import torch

        name = torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
        write_report(args.report, play_rows, sync_rows, free_rows, args.steps, name)
    return {"playback": play_rows, "resync": sync_rows, "free": free_rows}


if __name__ == "__main__":
    main()
