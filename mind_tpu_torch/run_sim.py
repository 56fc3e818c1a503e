"""CLI entry: run one closed-loop simulation of the port (counterpart of the
JAX package's run_sim.py).

Usage: python -m mind_tpu_torch.run_sim --config configs/demo_1.json
       [--data-root PATH] [--max-steps N] [--no-render] [--device cpu]
       [--episode]   # the closed loop with its state on the device

The planner runs on the CUDA card unless --device names another device;
without a card and without --device the run fails. Reading a scenario
parquet needs pandas with a parquet engine.
"""

import argparse
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description="mind_tpu_torch closed-loop simulator")
    ap.add_argument("--config", required=True, help="sim config JSON")
    ap.add_argument("--data-root", default="data",
                    help="directory holding the AV2 scenario folders")
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--no-render", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device of the planner (default: the CUDA card)")
    ap.add_argument("--episode", action="store_true",
                    help="run the episode path (sim/episode.py): the closed loop with its "
                         "state on the device, one read of the plan per cycle; implies "
                         "--no-render")
    args = ap.parse_args(argv)

    if not os.path.exists(args.config):
        sys.exit(f"error: config file not found: {args.config}")

    from mind_tpu_torch.config import SimConfig
    from mind_tpu_torch.sim.simulator import Simulator

    cfg = SimConfig.from_json(args.config, data_root=args.data_root)
    if args.no_render or args.episode:
        cfg.render = False
    sim = Simulator(cfg, max_steps=args.max_steps, device=args.device)
    sim.init_sim()
    if args.episode:
        from mind_tpu_torch.sim.episode import run_episode

        t0 = time.perf_counter()
        res = run_episode(sim, args.max_steps)
        metrics = {"ticks": len(res.ego_states), "plan_calls": res.plan_calls,
                   "fail_cycle": res.fail_cycle, "wall_time_s": time.perf_counter() - t0}
        print("metrics:", metrics)
        return metrics
    metrics = sim.run_sim()
    print("metrics:", metrics)
    if cfg.render:
        sim.render_video()
    return metrics


if __name__ == "__main__":
    main()
