"""North-star certification of the port: the host closed loop's throughput
under one precision policy over the demos, beside the free-run parity rows
of the same policy (counterpart of the JAX package's
scripts/bench_north_star.py).

BASELINE.json's north star asks for ONE configuration that free-runs within
1e-3 m of the float64 mirror AND sustains >= 50x the reference's ~0.83
steps/s (41.5 steps/s). `python -m mind_tpu_torch.parity_run --skip playback
resync --free-modes POLICY` measures the first half; this driver measures
the second in the same configuration (FREE_MODES[POLICY] over
planner_config_for_demo) and, with --free-log (that run's output), merges
both:

    python -m mind_tpu_torch.scripts.bench_north_star --synthetic [--policy native_bal]
        [--steps 500] [--demos 1,2,3,4] [--free-log LOG] [--out outputs/torch/north_star.json]

The log's row lines are the dicts parity_run prints; each is read with
ast.literal_eval (a line that is no literal raises), where the JAX script
evals them. A verdict of north_star false is a measurement and exits 0;
the exit is non-zero on a plan failure, a run that raised, or a --free-log
without rows.
"""

from __future__ import annotations

import argparse
import ast
import json
import sys

from mind_tpu_torch.scripts import (OUT, add_scene_args, check_scene_args, demo_names, demo_sim,
                                    scene_root, write_json)

BASELINE_SPS = 0.83  # reference host loop, BASELINE.md


def policy_config(demo: str, policy: str):
    """planner_config_for_demo(demo) under FREE_MODES[policy]'s overrides
    (pipeline_dtype on the planner, the rest on the trajectory tree)."""
    from mind_tpu_torch.config import planner_config_for_demo
    from mind_tpu_torch.parity_run import FREE_MODES

    pcfg = planner_config_for_demo(demo)
    for k, v in FREE_MODES[policy].items():
        setattr(pcfg if k == "pipeline_dtype" else pcfg.traj_tree, k, v)
    return pcfg


def throughput_row(demo: str, sim, policy: str) -> dict:
    """run_all_demos.host_row (the Simulator loop warmed, rewound and
    timed; the planner's mean phase times) under `policy`."""
    from mind_tpu_torch.scripts.run_all_demos import host_row

    row = host_row(demo, sim)
    return dict(row, policy=policy, vs_baseline=row["steps_per_sec"] / BASELINE_SPS)


def free_run_rows(path) -> list:
    """The free-run rows of a parity_run log: its lines that open a dict
    and name max_dev_cl, each parsed by ast.literal_eval."""
    rows = []
    with open(path) as f:
        for n, line in enumerate(f, 1):
            line = line.strip()
            if line.startswith("{") and "max_dev_cl" in line:
                try:
                    rows.append(ast.literal_eval(line))
                except (ValueError, SyntaxError) as e:
                    raise ValueError(f"{path}:{n}: not a literal row: {line[:200]}") from e
    return rows


def verdict(throughput, free_run) -> dict:
    """The JAX script's merge: the worst demo's steps/s against 50x the
    baseline, every free-run row's max_dev_cl against 1e-3 (None without
    rows), and both together."""
    worst = min(r["steps_per_sec"] for r in throughput)
    thr_ok = worst / BASELINE_SPS >= 50.0
    par_ok = all(r["max_dev_cl"] <= 1e-3 for r in free_run) if free_run else None
    return {"worst_steps_per_sec": worst, "worst_vs_baseline": worst / BASELINE_SPS,
            "throughput_ok_50x": thr_ok, "parity_ok_1e3": par_ok,
            "north_star": bool(thr_ok and par_ok)}


def _parse(argv):
    from mind_tpu_torch.parity_run import FREE_MODES

    ap = argparse.ArgumentParser(prog="python -m mind_tpu_torch.scripts.bench_north_star",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--policy", default="native_bal", choices=sorted(FREE_MODES))
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--demos", default="1,2,3,4")
    ap.add_argument("--out", default=str(OUT / "north_star.json"))
    ap.add_argument("--free-log", default=None,
                    help="parity_run free-run log to merge parity rows from")
    add_scene_args(ap)
    opts = ap.parse_args(argv)
    check_scene_args(ap, opts)
    return opts


def main(argv=None) -> int:
    from mind_tpu_torch.common.device import resolve_device
    from mind_tpu_torch.parity_run import FREE_MODES

    opts = _parse(argv)
    resolve_device(opts.device)
    free = free_run_rows(opts.free_log) if opts.free_log else []
    if opts.free_log and not free:
        raise ValueError(f"{opts.free_log} holds no free-run rows")
    rows = []
    with scene_root(opts) as root:
        for demo in demo_names(opts.demos):
            sim = demo_sim(opts, demo, root, ticks=opts.steps,
                           planner_cfg=policy_config(demo, opts.policy))
            rows.append(throughput_row(demo, sim, opts.policy))
            print(json.dumps(rows[-1]), flush=True)
    out = {"policy": opts.policy, "overrides": FREE_MODES[opts.policy], "steps": opts.steps,
           "baseline_steps_per_sec": BASELINE_SPS, "throughput": rows}
    if free:
        out["free_run"] = free
    out.update(verdict(rows, free))
    write_json(opts.out, out)
    print(f"worst {out['worst_steps_per_sec']:.2f} steps/s = {out['worst_vs_baseline']:.1f}x; "
          f"throughput>=50x: {out['throughput_ok_50x']}; parity<=1e-3: {out['parity_ok_1e3']}; "
          f"NORTH STAR: {out['north_star']}")
    failed = [r["demo"] for r in rows if r["plan_failures"] or r["ticks"] != opts.steps]
    if failed:
        print(f"plan failures on {failed}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
