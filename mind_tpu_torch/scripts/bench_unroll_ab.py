"""The episode's throughput under a label, for before/after tables of a
solver or scheduling change (counterpart of the JAX package's
scripts/bench_unroll_ab.py).

    python -m mind_tpu_torch.scripts.bench_unroll_ab LABEL [demo_1 demo_2 ...] --synthetic
        [--steps 500] [--out outputs/torch/unroll_ab.json]

One untimed sim/episode.py::run_episode of the first demo warms the runner;
each demo is then timed over 3 runs, and {LABEL: {demo: {steps_per_s of the
median wall, walls_s}}} is added to --out. Run it once per code state. A
failed cycle raises.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

from mind_tpu_torch.scripts import (OUT, add_scene_args, check_scene_args, demo_sim,
                                    device_name, launched_since, launches, scene_root,
                                    write_json)

TIMED_RUNS = 3


def label_row(sims: dict, steps=None) -> dict:
    """{demo: {steps_per_s, walls_s, launches}} over `sims` ({demo: sim})."""
    from mind_tpu_torch.sim.episode import build_episode_inputs, run_episode

    row = {}
    run_episode(next(iter(sims.values())), steps)  # warm
    for demo, sim in sims.items():
        launched_before = launches()
        inp = build_episode_inputs(sim, steps)
        walls = []
        for _ in range(TIMED_RUNS):
            t0 = time.perf_counter()
            res = run_episode(sim, steps, inp)
            walls.append(time.perf_counter() - t0)
        if res.fail_cycle != -1:
            raise RuntimeError(f"{demo}: plan failure at cycle {res.fail_cycle}")
        row[demo] = {"steps_per_s": len(res.ego_states) / statistics.median(walls),
                     "walls_s": walls, "launches": launched_since(launched_before)}
    return row


def _parse(argv):
    ap = argparse.ArgumentParser(prog="python -m mind_tpu_torch.scripts.bench_unroll_ab",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("label")
    ap.add_argument("demos", nargs="*", default=["demo_1", "demo_2"])
    ap.add_argument("--steps", type=int, default=None, help="ticks (default: the demos' 500)")
    ap.add_argument("--out", default=str(OUT / "unroll_ab.json"))
    add_scene_args(ap)
    opts = ap.parse_args(argv)
    check_scene_args(ap, opts)
    return opts


def main(argv=None) -> int:
    from mind_tpu_torch.common.device import resolve_device

    opts = _parse(argv)
    device = resolve_device(opts.device)
    table = {}
    if os.path.exists(opts.out):
        with open(opts.out) as f:
            table = json.load(f)
    with scene_root(opts) as root:
        sims = {d: demo_sim(opts, d, root, ticks=opts.steps) for d in opts.demos}
        row = label_row(sims, opts.steps)
    for demo, r in row.items():
        print(f"{opts.label} {demo}: {r}", flush=True)
    table[opts.label] = dict(row, device=device_name(device))
    write_json(opts.out, table)
    print(json.dumps({"label": opts.label, "result": row}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
