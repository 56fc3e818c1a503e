"""The plan pipeline's precision-policy matrix on the card (counterpart of
the JAX package's scripts/bench_exec_ab.py).

Times demo_1's episode (sim/episode.py::run_episode, a warm run, then the
timed one) under each policy of VARIANTS:

  r3_default : pipeline float64, exec re-solve off
  exec       : pipeline float64, exec float64 scratch (two-phase re-solve)
  fast_exec  : pipeline float32, exec float64 scratch
  fast_polish: pipeline float32, exec float64 polish (warm-started winner polish)
  fast       : pipeline float32, exec re-solve off

and merges steps/s and ms per plan cycle into an existing --out, so partial
runs keep the other rows. The JAX package chose its defaults from this
matrix on a v5e; here it is measured and recorded, and changes no default.

    python -m mind_tpu_torch.scripts.bench_exec_ab --synthetic [--steps 500]
        [--variants fast,exec] [--out outputs/torch/exec_ab.json]

A variant whose episode fails a cycle is written and makes the exit
non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from mind_tpu_torch.scripts import (OUT, add_scene_args, check_scene_args, demo_sim,
                                    device_name, launched_since, launches, scene_root,
                                    write_json)

VARIANTS = [
    # (name, pipeline_dtype, exec_solve_dtype, exec_resolve_mode)
    # exec_solve_dtype=None follows solve_dtype (re-solve disabled)
    ("r3_default", "float64", None, "polish"),
    ("exec", "float64", "float64", "scratch"),
    ("fast_exec", "float32", "float64", "scratch"),
    ("fast_polish", "float32", "float64", "polish"),
    ("fast", "float32", None, "polish"),
]


def variant_config(name: str):
    """planner_config_for_demo("demo_1") under variant `name`."""
    from mind_tpu_torch.config import planner_config_for_demo

    _, pdt, edt, mode = next(v for v in VARIANTS if v[0] == name)
    pc = planner_config_for_demo("demo_1")
    pc.pipeline_dtype = pdt
    pc.traj_tree.exec_solve_dtype = edt
    pc.traj_tree.exec_resolve_mode = mode
    return pc


def variant_row(sim, steps=None) -> dict:
    """One variant's sim: a warm episode, then the timed one."""
    from mind_tpu_torch.sim.episode import build_episode_inputs, run_episode

    pl = next(a for a in sim.agents if a.id == "AV").planner
    launched_before = launches()
    inp = build_episode_inputs(sim, steps)
    t0 = time.perf_counter()
    run_episode(sim, steps, inp)
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = run_episode(sim, steps, inp)
    wall = time.perf_counter() - t0
    n = len(res.ego_states)
    edt = pl.cfg.traj_tree.exec_solve_dtype
    return {"pipeline_dtype": pl.cfg.pipeline_dtype, "exec_solve_dtype": edt,
            "exec_resolve_mode": pl.cfg.traj_tree.exec_resolve_mode if edt else None,
            "steps_per_s": n / wall, "plan_cycle_ms": wall / max(res.plan_calls, 1) * 1e3,
            "wall_s": wall, "warm_wall_s": warm, "fail_cycle": res.fail_cycle, "steps": n,
            "plan_calls": res.plan_calls, "device": device_name(pl.device),
            "launches": launched_since(launched_before)}


def _parse(argv):
    names = [v[0] for v in VARIANTS]
    ap = argparse.ArgumentParser(prog="python -m mind_tpu_torch.scripts.bench_exec_ab",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--out", default=str(OUT / "exec_ab.json"))
    ap.add_argument("--variants", default=",".join(names))
    add_scene_args(ap)
    opts = ap.parse_args(argv)
    check_scene_args(ap, opts)
    opts.variants = opts.variants.split(",")
    unknown = sorted(set(opts.variants) - set(names))
    if unknown:
        ap.error(f"unknown variants {unknown}: choose from {names}")
    return opts


def main(argv=None) -> int:
    from mind_tpu_torch.common.device import resolve_device

    opts = _parse(argv)
    resolve_device(opts.device)
    rows = {}
    if os.path.exists(opts.out):  # merge: partial runs keep the other rows
        with open(opts.out) as f:
            rows = json.load(f)
    failed = []
    with scene_root(opts) as root:
        for name, *_ in VARIANTS:
            if name not in opts.variants:
                continue
            sim = demo_sim(opts, "demo_1", root, ticks=opts.steps,
                           planner_cfg=variant_config(name))
            rows[name] = variant_row(sim, opts.steps)
            if rows[name]["fail_cycle"] >= 0:
                failed.append(name)
            print(json.dumps({name: rows[name]}), flush=True)
    write_json(opts.out, rows)
    if failed:
        print(f"plan failures under {failed}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
