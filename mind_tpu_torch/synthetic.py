"""Seeded synthetic driving scene for the plan cycle, made with numpy.

A straight three-lane road along +x: the ego (slot 0) closes on a slow
leader in its lane and `n_agents - 2` other agents drive at constant
speeds, a lane graph of
`max_lanes` straight segments covers the road, and the target lane is the
ego's lane centerline at ~1 m spacing. The AV2 logs the demos use are not
in the repository, so the tests and chip_smoke.py plan on this scene.
`scene_statics` turns it into the planner's tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mind_tpu_torch.common.device import resolve_device
from mind_tpu_torch.planner.scene_prep import OBS_LEN, LaneGraphStatic, TargetLaneStatic

LANE_W = 3.5
DT_OBS = 0.1


class SyntheticScene(NamedTuple):
    history: np.ndarray      # [A, 50, 4] float64 [x, y, v, yaw] per frame
    present: np.ndarray      # [A] bool slots with an agent
    types: np.ndarray        # [A, 7] float32 one-hot
    lane_feats: np.ndarray   # [L, 10, 16] float32 instance-frame features
    lane_anchors: np.ndarray  # [L, 2] float64
    lane_vecs: np.ndarray    # [L, 2] float64 unit directions
    lane_mask: np.ndarray    # [L] bool
    tgt_points: np.ndarray   # [n_tgt, 2] float64 target lane (~1 m)
    tgt_info: np.ndarray     # [n_tgt, 12] float64 per-point features
    target_vel: float


def synthetic_scene(seed: int, max_actors: int, max_lanes: int, n_agents: int,
                    n_lanes: int | None = None, n_tgt: int = 200) -> SyntheticScene:
    rng = np.random.default_rng(seed)
    A, L = max_actors, max_lanes
    n_lanes = L if n_lanes is None else n_lanes
    t = (np.arange(OBS_LEN) - (OBS_LEN - 1)) * DT_OBS       # last frame at t = 0

    history = np.zeros((A, OBS_LEN, 4), np.float64)
    present = np.zeros(A, bool)
    for a in range(n_agents):
        if a <= 1:   # the ego, and a slow leader 12 m ahead in its lane
            lane, x_now, y, v = 0, 12.0 * a, 0.0, 5.0 - 3.0 * a
        else:
            lane = int(rng.integers(-1, 2))
            x_now = float(rng.uniform(-40.0, 60.0))
            y = lane * LANE_W + float(rng.normal(0.0, 0.3))
            v = float(rng.uniform(2.0, 8.0))
        history[a, :, 0] = x_now + v * t
        history[a, :, 1] = y
        history[a, :, 2] = v
        present[a] = True
    types = np.zeros((A, 7), np.float32)
    types[:, 0] = 1.0  # vehicles

    # lane graph: straight 15 m segments of 10 nodes on three lanes
    seg_len, n_node = 15.0, 10
    lane_feats = np.zeros((L, n_node, 16), np.float32)
    anchors = np.zeros((L, 2), np.float64)
    vecs = np.tile(np.array([1.0, 0.0]), (L, 1))
    mask = np.zeros(L, bool)
    node_x = (np.arange(n_node) - (n_node - 1) / 2.0) * seg_len / n_node
    for s in range(n_lanes):
        lane, k = s % 3 - 1, s // 3
        anchors[s] = [-60.0 + seg_len * (k + 0.5), lane * LANE_W]
        lane_feats[s, :, 0] = node_x
        lane_feats[s, :, 2] = seg_len / n_node
        lane_feats[s, :, :4] += rng.normal(0.0, 0.05, (n_node, 4))
        lane_feats[s, :, 4:] = _lane_info(lane)
        mask[s] = True

    tgt_points = np.stack([np.arange(n_tgt) - 50.0, np.zeros(n_tgt)], axis=1)
    tgt_info = np.tile(_lane_info(0), (n_tgt, 1)).astype(np.float64)
    return SyntheticScene(history, present, types, lane_feats, anchors,
                          vecs, mask, tgt_points, tgt_info, target_vel=6.0)


def _lane_info(lane: int) -> np.ndarray:
    """12 feature columns of a lane node [intersect, type3, cross_left3,
    cross_right3, left, right] on the three-lane road (lane -1, 0, 1 from
    right to left): a vehicle lane, dashed boundary towards a neighbour,
    solid at the road edge."""
    has_left, has_right = lane < 1, lane > -1
    edge = lambda n: [1.0, 0.0, 0.0] if n else [0.0, 0.0, 1.0]
    return np.array([0.0, 1.0, 0.0, 0.0, *edge(has_left), *edge(has_right),
                     float(has_left), float(has_right)], np.float32)


class SceneStatics(NamedTuple):
    lane: LaneGraphStatic
    tgt: TargetLaneStatic
    eval_segs: tuple          # (start [S, 2], end [S, 2], mask [S]) float64
    cost_lane: np.ndarray     # [<= 64, 2] float64 target lane every 4 m


def scene_statics(scene: SyntheticScene, pipeline_dtype: torch.dtype,
                  device=None, max_tgt_pts: int = 256) -> SceneStatics:
    """Planner tensors of a scene on `device` (the CUDA card unless the
    caller passes a CPU device): lane graph and target lane at the pipeline
    dtype, float64 evaluation segments, the cost-field lane."""
    device = resolve_device(device)
    n = len(scene.tgt_points)
    P = max_tgt_pts
    tp = np.full((P, 2), 1e6, np.float64)
    tp[:n] = scene.tgt_points
    ti = np.zeros((P, 12), np.float64)
    ti[:n] = scene.tgt_info
    tm = np.arange(P) < n
    pd = dict(dtype=pipeline_dtype, device=device)
    lane = LaneGraphStatic(
        node_feats=torch.tensor(scene.lane_feats, device=device),
        anchors_g=torch.tensor(scene.lane_anchors, **pd),
        anchor_vecs_g=torch.tensor(scene.lane_vecs, **pd),
        mask=torch.tensor(scene.lane_mask, device=device))
    tgt = TargetLaneStatic(points=torch.tensor(tp, **pd), info=torch.tensor(ti, **pd),
                           mask=torch.tensor(tm, device=device), n_points=n)
    f64 = dict(dtype=torch.float64, device=device)
    em = np.zeros(P - 1, bool)
    em[:n - 1] = True
    eval_segs = (torch.tensor(tp[:-1], **f64), torch.tensor(tp[1:], **f64),
                 torch.tensor(em, device=device))
    return SceneStatics(lane, tgt, eval_segs, scene.tgt_points[::4][:64].copy())
