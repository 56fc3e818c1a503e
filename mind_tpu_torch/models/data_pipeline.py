"""Training data: AV2 scenarios -> network training batches (port of
mind_tpu/models/data_pipeline.py).

The 50-frame 10 Hz history becomes the padded network inputs through the
same scene preparation the planner uses (planner/scene_prep.py, called
with one node), and the 60-frame future becomes per-actor ground truth in
each actor's instance frame, the frame the regression head predicts in.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from mind_tpu_torch.common.device import resolve_device
from mind_tpu_torch.config import PlannerConfig
from mind_tpu_torch.data.loader import TrajBundle
from mind_tpu_torch.models.train import Batch
from mind_tpu_torch.planner.scene_prep import (
    OBS_LEN,
    LaneGraphStatic,
    TargetLaneStatic,
    prepare_node_inputs,
    rot_of,
)

PRED_LEN = 60


def scenario_to_batch(bundle: TrajBundle, lane_static: LaneGraphStatic,
                      tgt_static: TargetLaneStatic, cfg: PlannerConfig,
                      types: np.ndarray, device=None) -> Batch:
    """One scenario -> a single-scene training batch on `device` (the card
    unless the caller passes a CPU device; the statics are moved there).

    History = 10 Hz keyframes 0..49 of the resampled log; future = keyframes
    50..109. Requires the bundle's 110-frame span (546 steps at 50 Hz)."""
    device = resolve_device(device)
    A = cfg.max_actors
    n = len(bundle)
    key_idx = np.arange(110) * 5            # 10 Hz keyframes of the 50 Hz arrays
    key_idx[-1] = bundle.pos.shape[1] - 1
    pos = np.zeros((A, 110, 2), np.float32)
    ang = np.zeros((A, 110), np.float32)
    vel_s = np.zeros((A, 110), np.float32)
    valid = np.zeros((A, 110), bool)
    pos[:n] = bundle.pos[:, key_idx]
    ang[:n] = bundle.ang[:, key_idx]
    vel_s[:n] = bundle.vel[:, key_idx]
    valid[:n] = bundle.has_flag[:, key_idx]

    vel = np.stack([vel_s * np.cos(ang), vel_s * np.sin(ang)], axis=-1)
    actor_mask = np.zeros(A, bool)
    actor_mask[:n] = valid[:n, OBS_LEN - 1]

    t = lambda x: torch.as_tensor(x, device=device)
    one = lambda x: t(x)[None]
    static = lambda s: type(s)(*(t(x) if isinstance(x, (torch.Tensor, np.ndarray)) else x
                                 for x in s))
    inputs = prepare_node_inputs(
        one(pos[:, :OBS_LEN]), one(ang[:, :OBS_LEN]), one(vel[:, :OBS_LEN]),
        one(valid[:, :OBS_LEN].astype(np.float32)), t(types), t(actor_mask),
        static(lane_static), static(tgt_static), cfg.scen_tree.tar_time_ahead)

    # ground-truth futures in each actor's instance frame
    fut = t(pos[:, OBS_LEN:OBS_LEN + PRED_LEN])                          # [A, F, 2]
    fut_s = torch.einsum("afd,de->afe", fut - inputs.orig[0], inputs.rot[0])
    a_theta = torch.atan2(inputs.actor_vecs[0, :, 1], inputs.actor_vecs[0, :, 0])
    gt = torch.einsum("afd,ade->afe", fut_s - inputs.actor_ctrs[0][:, None],
                      rot_of(a_theta))                                   # [A, F, 2]
    gt_mask = t(valid[:, OBS_LEN:OBS_LEN + PRED_LEN] & actor_mask[:, None])

    fields = (inputs.actors, inputs.actor_mask, inputs.lanes, inputs.lane_mask, inputs.rpe,
              inputs.tgt_nodes, inputs.tgt_rpe, gt[None], gt_mask[None])
    return Batch(*(x.contiguous() for x in fields))


def stack_batches(batches: List[Batch]) -> Batch:
    return Batch(*(torch.cat(xs, dim=0) for xs in zip(*batches)))
