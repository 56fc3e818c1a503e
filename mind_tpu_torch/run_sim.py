"""CLI entry: run one closed-loop simulation of the port (counterpart of the
JAX package's run_sim.py).

Usage: python -m mind_tpu_torch.run_sim --config configs/demo_1.json
       [--data-root PATH] [--max-steps N] [--no-render] [--device cpu]

The planner runs on the CUDA card unless --device names another device;
without a card and without --device the run fails. Reading a scenario
parquet needs pandas with a parquet engine.
"""

import argparse
import os
import sys


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
                    help="the whole closed loop as one device program "
                         "(sim/episode.py of the JAX package); not ported")
    args = ap.parse_args(argv)

    if args.episode:
        sys.exit("error: --episode (sim/episode.py, the whole closed loop as one device "
                 "program) is not ported yet: ROADMAP.md queue A item 2")
    if not os.path.exists(args.config):
        sys.exit(f"error: config file not found: {args.config}")

    from mind_tpu_torch.config import SimConfig
    from mind_tpu_torch.sim.simulator import Simulator

    cfg = SimConfig.from_json(args.config, data_root=args.data_root)
    if args.no_render:
        cfg.render = False
    sim = Simulator(cfg, max_steps=args.max_steps, device=args.device)
    sim.init_sim()
    metrics = sim.run_sim()
    print("metrics:", metrics)
    if cfg.render:
        sim.render_video()
    return metrics


if __name__ == "__main__":
    main()
