"""Stage-by-stage divergence of the episode-playback parity (counterpart of
the JAX package's scripts/diag_playback.py).

For one demo, parity/runner.py::run_playback_diagnostic replays the
episode per cycle against both the staged planner and the float64 mirror
from identical inputs and dumps, for the worst cycles by 5-tick rollout
deviation, every decision stage: scenario-tree structure, the mirror's
prune / merge / branch margins, per-tree selection costs and margins on
both sides, and the executed control's deviation. This driver prints the
summary line and the worst cycles, and writes the JSON (the JAX field
names: cycle_dev, ctrl_dev, n_trees_dev/host, n_end_nodes_dev/host,
best_dev/host, selection_margin_dev/host, ...).

    python -m mind_tpu_torch.scripts.diag_playback --synthetic [--demo demo_3]
        [--steps 500] [--worst 5] [--out outputs/torch/<demo>_diag.json]
"""

from __future__ import annotations

import argparse
import sys

from mind_tpu_torch.scripts import (OUT, add_scene_args, check_scene_args, demo_log, launches,
                                    launched_since, scene_root, write_json)


def summary_lines(out: dict) -> list:
    """The JAX script's printout of run_playback_diagnostic's result; a run
    that compared no cycle raises."""
    devs = [r["cycle_dev"] for r in out["cycles"] if "cycle_dev" in r]
    if not devs:
        raise RuntimeError(f"{out['demo']}: no cycle compared (fail_cycle {out['fail_cycle']}, "
                           f"{len(out['cycles'])} cycles planned)")
    lines = [f"{out['demo']}: {len(devs)} cycles compared, "
             f"max dev {max(devs):.2e}, mean {sum(devs) / len(devs):.2e}"]
    lines += [f"-- cycle {r['cycle']}: dev {r['cycle_dev']:.2e}, "
              f"ctrl dev {r['ctrl_dev']:.2e}, "
              f"trees {r['n_trees_dev']}/{r['n_trees_host']}, "
              f"end nodes {r['n_end_nodes_dev']}/{r['n_end_nodes_host']}, "
              f"best {r['best_dev']}/{r['best_host']}, "
              f"sel margin {r['selection_margin_dev']:.2e}/{r['selection_margin_host']:.2e}"
              for r in out["worst"]]
    return lines


def _parse(argv):
    ap = argparse.ArgumentParser(prog="python -m mind_tpu_torch.scripts.diag_playback",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--demo", default="demo_3")
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--worst", type=int, default=5)
    ap.add_argument("--out", default=None, help="default outputs/torch/<demo>_diag.json")
    add_scene_args(ap)
    opts = ap.parse_args(argv)
    check_scene_args(ap, opts)
    return opts


def main(argv=None) -> int:
    from mind_tpu_torch.common.device import resolve_device
    from mind_tpu_torch.parity.runner import run_playback_diagnostic

    opts = _parse(argv)
    device = resolve_device(opts.device)
    launched_before = launches()
    with scene_root(opts) as root:
        out = run_playback_diagnostic(opts.demo, opts.steps, root, worst_k=opts.worst,
                                      device=device, scenario=demo_log(opts, opts.demo, root))
    out["launches"] = launched_since(launched_before)
    write_json(opts.out or OUT / f"{opts.demo}_diag.json", out)
    for line in summary_lines(out):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
