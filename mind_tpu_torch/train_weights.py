"""Train ScenePredNet weights on the four demo scenarios (counterpart of the
JAX package's scripts/train_demo_weights.py).

Usage: python -m mind_tpu_torch.train_weights --data-root PATH --out DIR
       [--steps 600] [--lr 3e-4] [--device cpu]

One batch of the four configs/demo_{1..4}.json scenarios (their AV2 map and
scenario files under --data-root), each through the data layer and
models/data_pipeline.py::scenario_to_batch with the whole map as lane graph,
its longest semantic lane as target lane and the tracks' first types;
PlannerConfig()'s network (float32, full width) from init_scene_pred with
the config's seed; AdamW from step 0, the winner-takes-all scene loss; the
loss printed every 50 steps. The result is saved as a checkpoint under
--out/<steps>/ (models/checkpoint.py, which MINDPlanner reads from a
directory; checkpoint.save_flax_npz writes the flat flax archive from it).

Training runs on the CUDA card unless --device names another device; there
each step replays the compiled step (models/train_program.py).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

from mind_tpu_torch.common.device import resolve_device
from mind_tpu_torch.config import PlannerConfig, SimConfig
from mind_tpu_torch.data.loader import ArgoAgentLoader, TrajBundle
from mind_tpu_torch.data.semantic_map import SemanticMap, build_lane_graph, lane_graph_features
from mind_tpu_torch.models.checkpoint import save_params
from mind_tpu_torch.models.data_pipeline import scenario_to_batch, stack_batches
from mind_tpu_torch.models.train import Batch, adamw, init_scene_pred, make_train_step
from mind_tpu_torch.planner.planner import type_onehot
from mind_tpu_torch.planner.scene_prep import LaneGraphStatic, TargetLaneStatic

DEMOS = tuple(Path(__file__).resolve().parent.parent / "configs" / f"demo_{d}.json"
              for d in range(1, 5))
TGT_POINTS = 256


def scene_batch(smp: SemanticMap, bundle: TrajBundle, cfg: PlannerConfig, device=None) -> Batch:
    """One scenario's training batch, with the statics the JAX training
    script gives it: the whole map's lane graph (global frame) padded to
    cfg.max_lanes, the longest semantic lane as target lane (256 points,
    zero lane info), and each track's first type, zero-padded to
    cfg.max_actors."""
    graph = build_lane_graph(smp.map_data, np.zeros(2), np.eye(2))
    feats = lane_graph_features(graph)
    L = cfg.max_lanes
    if len(feats) > L:
        raise ValueError(f"{len(feats)} lane-graph segments, more than max_lanes = {L}")
    node_feats = np.zeros((L, 10, 16), np.float32)
    node_feats[:len(feats)] = feats
    anchors = np.zeros((L, 2), np.float32)
    anchors[:len(feats)] = graph["lane_ctrs"]
    vecs = np.tile(np.array([1.0, 0.0], np.float32), (L, 1))
    vecs[:len(feats)] = graph["lane_vecs"]
    lane_static = LaneGraphStatic(torch.from_numpy(node_feats), torch.from_numpy(anchors),
                                  torch.from_numpy(vecs), torch.from_numpy(np.arange(L) < len(feats)))
    lane = max(smp.semantic_lanes.values(), key=len)
    tp = np.full((TGT_POINTS, 2), 1e6, np.float32)
    tp[:len(lane)] = lane
    tgt_static = TargetLaneStatic(torch.from_numpy(tp), torch.zeros(TGT_POINTS, 12),
                                  torch.from_numpy(np.arange(TGT_POINTS) < len(lane)), len(lane))
    types = np.stack([type_onehot(t[0]) for t in bundle.types]
                     + [np.zeros(7, np.float32)] * (cfg.max_actors - len(bundle)))
    return scenario_to_batch(bundle, lane_static, tgt_static, cfg, types, device)


def demo_batch(data_root, cfg: PlannerConfig, device=None, configs=DEMOS, log=print) -> Batch:
    """The four demo scenarios as one batch."""
    batches = []
    for path in configs:
        sim_cfg = SimConfig.from_json(path, data_root=data_root)
        smp = SemanticMap().load_from_argo2(sim_cfg.map_path)
        bundle = ArgoAgentLoader(sim_cfg.scenario_path).get_trajs_info(smp)
        batches.append(scene_batch(smp, bundle, cfg, device))
        log(f"{Path(path).stem}: batch built ({len(bundle)} tracks)")
    return stack_batches(batches)


def train(net, batch: Batch, steps: int, lr: float, log=print):
    """`steps` AdamW steps on one batch (on the card, the compiled step);
    the losses as floats, read every 50 steps and at the last (the others
    stay on the device until then)."""
    optimizer = adamw(net.parameters(), lr)
    step = make_train_step(net, optimizer)
    t0, losses = time.perf_counter(), []
    for i in range(steps):
        losses.append(step(batch))
        if i % 50 == 0 or i == steps - 1:
            log(f"step {i}: loss {float(losses[-1]):.4f} ({time.perf_counter() - t0:.0f}s)")
    return [float(x) for x in losses], optimizer


def main(argv=None):
    ap = argparse.ArgumentParser(description="train ScenePredNet on the demo scenarios")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--data-root", required=True, help="directory holding the AV2 scenario folders")
    ap.add_argument("--out", required=True, help="checkpoint directory (steps below it)")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    for path in DEMOS:
        if not path.is_file():
            sys.exit(f"error: config file not found: {path}")

    cfg = PlannerConfig()
    device = resolve_device(args.device)
    batch = demo_batch(args.data_root, cfg, device, log=lambda s: print(s, flush=True))
    net = init_scene_pred(cfg.net, seed=cfg.seed, device=device)
    losses, optimizer = train(net, batch, args.steps, args.lr,
                              log=lambda s: print(s, flush=True))
    out = save_params(args.out, net, step=args.steps, opt_state=optimizer)
    print("saved:", out, flush=True)
    return losses


if __name__ == "__main__":
    main()
