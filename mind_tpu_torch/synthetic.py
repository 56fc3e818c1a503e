"""Seeded synthetic driving scenes, made with numpy. The AV2 logs the demos
use are not in the repository, so the tests and chip_smoke.py run on these.

`synthetic_scene` is one plan cycle's input: a straight three-lane road
along +x on which the ego (slot 0) closes on a slow leader in its lane and
`n_agents - 2` other agents drive at constant speeds, a lane graph of
`max_lanes` straight segments, and the target lane as the ego's lane
centerline at ~1 m spacing. `scene_statics` turns it into the planner's
tensors.

`synthetic_av2` is the same road as an AV2 scenario for the closed loop: a
vector map in the log_map_archive JSON schema and a Scenario of 110 frames
at 10 Hz, which pass through the port's data layer (StaticMap.from_json,
SemanticMap, ArgoAgentLoader.trajs_info_of) like a scenario read from disk.

`demo_scenario` is an initialized Simulator of one demo's configuration,
on this road (from a seed) or on the demo's own AV2 log.

`fusion_inputs` is a seeded random call of the fusion-layer core (weights,
node, edge), for holding its kernels against their plain versions.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from mind_tpu_torch.common.device import resolve_device
from mind_tpu_torch.data.av2 import ObjectState, ObjectType, Scenario, Track, TrackCategory
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


# --------------------------------------------------------------------------
# the road as an AV2 scenario
# --------------------------------------------------------------------------

AV2_ORIGIN = np.array([2300.0, 1200.0])   # the road's x = 0, y = 0 in map coordinates
N_FRAMES = 110


class SyntheticAV2(NamedTuple):
    map_json: dict       # log_map_archive schema, as StaticMap.from_json reads it
    scenario: Scenario   # 110 frames at 10 Hz, the first 50 observed
    n_graph_segments: int  # lane-graph segments build_lane_graph cuts (15 m each)


def synthetic_av2(seed: int, n_tracks: int = 40, seg_len: float = 60.0,
                  segs_a: int = 4, segs_b: int = 2, x_start: float = -60.0) -> SyntheticAV2:
    """A straight three-lane road along +x of (segs_a + segs_b) * seg_len
    metres (360 m by default), built of lane segments with boundaries,
    predecessor / successor and neighbour ids and mark types, and
    `n_tracks` tracks on it.

    The successor links are cut after `segs_a` segments, as at the edge of
    an AV2 map crop: a semantic lane (a maximal successor chain) is then at
    most segs_a * seg_len long, and its ~1 m resampling fits the planner's
    256 target-lane points. The default road gives 3 * 6 * 4 = 72 lane-graph
    segments.

    Tracks: "AV" at 5 m/s in the middle lane, a slow leader 25 m ahead of
    it, a focal track in the left lane, and others of mixed types and
    categories at constant speeds. Some have gaps, start late or end early
    (nearest-neighbour padding and the has_flag threshold have work to do),
    and three are there to be dropped by the loader: one off the road, one
    that starts after the observed part, one unobserved at the last
    observed frame."""
    rng = np.random.default_rng(seed)
    n_seg = segs_a + segs_b
    lanes = {}
    for lane in (-1, 0, 1):
        yc = lane * LANE_W
        for k in range(n_seg):
            x0, x1 = x_start + k * seg_len, x_start + (k + 1) * seg_len
            xs = np.linspace(x0, x1, 5)
            edge = lambda y: [{"x": float(x + AV2_ORIGIN[0]), "y": float(y + AV2_ORIGIN[1]),
                               "z": 0.0} for x in xs]
            lid = _lane_id(lane, k)
            linked = lambda j: 0 <= j < n_seg and (j < segs_a) == (k < segs_a)
            lanes[str(lid)] = {
                "id": lid,
                "is_intersection": False,
                "lane_type": "VEHICLE",
                "left_lane_boundary": edge(yc + LANE_W / 2),
                "right_lane_boundary": edge(yc - LANE_W / 2),
                "left_lane_mark_type": "DASHED_WHITE" if lane < 1 else "SOLID_WHITE",
                "right_lane_mark_type": "DASHED_WHITE" if lane > -1 else "SOLID_WHITE",
                "left_neighbor_id": _lane_id(lane + 1, k) if lane < 1 else None,
                "right_neighbor_id": _lane_id(lane - 1, k) if lane > -1 else None,
                "predecessors": [_lane_id(lane, k - 1)] if linked(k - 1) else [],
                "successors": [_lane_id(lane, k + 1)] if linked(k + 1) else [],
            }
    map_json = {"lane_segments": lanes, "pedestrian_crossings": {}, "drivable_areas": {}}

    x_hi = x_start + segs_a * seg_len
    tracks = [
        _track("AV", ObjectType.VEHICLE, TrackCategory.UNSCORED_TRACK, 0.0, 0.0, 5.0, rng),
        _track("leader", ObjectType.VEHICLE, TrackCategory.SCORED_TRACK, 25.0, 0.0, 3.0, rng),
        _track("focal", ObjectType.VEHICLE, TrackCategory.FOCAL_TRACK, -10.0, LANE_W, 6.0, rng),
        # dropped by the loader: off the road, future-only, unobserved at frame 49
        _track("offroad", ObjectType.VEHICLE, TrackCategory.UNSCORED_TRACK, 10.0, 30.0, 4.0, rng),
        _track("late", ObjectType.VEHICLE, TrackCategory.TRACK_FRAGMENT, 5.0, -LANE_W, 4.0, rng,
               frames=np.arange(60, N_FRAMES)),
        _track("lost", ObjectType.CYCLIST, TrackCategory.TRACK_FRAGMENT, 30.0, -LANE_W, 2.0, rng,
               frames=np.arange(0, 40)),
    ]
    kinds = [ObjectType.VEHICLE] * 5 + [ObjectType.BUS, ObjectType.MOTORCYCLIST,
                                         ObjectType.CYCLIST, ObjectType.PEDESTRIAN,
                                         ObjectType.STATIC]
    cats = [TrackCategory.SCORED_TRACK, TrackCategory.UNSCORED_TRACK,
            TrackCategory.TRACK_FRAGMENT]
    for i in range(len(tracks), n_tracks):
        v = float(rng.uniform(2.0, 8.0))
        # on a lane for the whole observed part (frames 0..49)
        x = float(rng.uniform(x_start + 10.0, x_hi - 10.0 - 4.9 * v))
        y = int(rng.integers(-1, 2)) * LANE_W + float(rng.normal(0.0, 0.3))
        frames = np.arange(N_FRAMES)
        style = i % 4
        if style == 1:     # a gap in the observed part and one in the future
            frames = np.delete(frames, np.r_[20:27, 70:74])
        elif style == 2:   # appears late, still before the last observed frame
            frames = frames[int(rng.integers(5, 40)):]
        elif style == 3:   # vanishes in the future part
            frames = frames[:int(rng.integers(60, 100))]
        tracks.append(_track(f"t{i:03d}", kinds[i % len(kinds)], cats[i % len(cats)],
                             x, y, v, rng, frames=frames))
    scenario = Scenario(scenario_id=f"synthetic-{seed}", focal_track_id="focal",
                        city_name="synthetic", tracks=tracks)
    return SyntheticAV2(map_json, scenario, 3 * n_seg * max(int(seg_len // 15.0), 1))


def _lane_id(lane: int, k: int) -> int:
    return 1000 * (lane + 2) + k


def _track(track_id, obj_type, category, x0, y, v, rng, frames=None) -> Track:
    """Constant speed along +x from road position (x0, y) at frame 0, with a
    small seeded heading wobble; states only at `frames`."""
    frames = np.arange(N_FRAMES) if frames is None else frames
    phase = float(rng.uniform(0.0, 2 * np.pi))
    states = []
    for f in frames:
        t = DT_OBS * float(f)
        yaw = 0.02 * np.sin(0.5 * t + phase)
        states.append(ObjectState(
            observed=bool(f < OBS_LEN), timestep=int(f),
            position=(float(x0 + v * t + AV2_ORIGIN[0]), float(y + AV2_ORIGIN[1])),
            heading=float(yaw),
            velocity=(float(v * np.cos(yaw)), float(v * np.sin(yaw)))))
    return Track(track_id, states, obj_type, category)


def write_synthetic_map(map_json: dict, data_root, seq_id: str) -> Path:
    """Write the map where a SimConfig with this data_root and seq_id looks
    for it (SimConfig.map_path); returns the file's path."""
    path = Path(data_root) / seq_id / f"log_map_archive_{seq_id}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(map_json, f)
    return path


def demo_scenario(demo: str, seed: Optional[int], data_root, *, ticks: Optional[int] = None,
                  planner_cfg=None, enable_timestep: Optional[float] = None,
                  target_velocity: Optional[float] = None, device=None,
                  scenario: Optional[Scenario] = None):
    """An initialized Simulator of configs/<demo>.json with rendering off:
    the demo's own AV binding (target velocity, enable time, seq_id) and
    `planner_config_for_demo(demo)` unless `planner_cfg` is given, over
    `ticks` ticks (the configuration's 500 by default). `enable_timestep`
    and `target_velocity` replace the configuration's where given.

    With a `seed`, synthetic_av2(seed) stands in for the demo's log: its map
    is written under data_root/<seq_id> and the scenario is passed in
    memory. Without one, the map is read from data_root/<seq_id> and the
    tracks from `scenario` or else from the demo's scenario parquet there;
    a missing file raises."""
    return demo_spec(demo, seed, data_root, ticks=ticks, planner_cfg=planner_cfg,
                     enable_timestep=enable_timestep, target_velocity=target_velocity,
                     scenario=scenario).build(device)


def demo_spec(demo: str, seed: Optional[int], data_root, *, ticks: Optional[int] = None,
              planner_cfg=None, enable_timestep: Optional[float] = None,
              target_velocity: Optional[float] = None, scenario: Optional[Scenario] = None):
    """demo_scenario's Simulator as a sim/simulator.py::SimSpec, built by
    no one yet (the map is written already): each rank of a distributed
    run builds it on its own device."""
    from mind_tpu_torch.config import CONFIGS, SimConfig, planner_config_for_demo
    from mind_tpu_torch.sim.simulator import SimSpec

    cfg = SimConfig.from_json(CONFIGS / f"{demo}.json", data_root=str(data_root))
    cfg.render = False
    agent = cfg.cl_agents[0]
    if enable_timestep is not None:
        agent.enable_timestep = enable_timestep
    if target_velocity is not None:
        agent.target_velocity = target_velocity
    if seed is not None:
        syn = synthetic_av2(seed)
        write_synthetic_map(syn.map_json, data_root, cfg.seq_id)
        scenario = syn.scenario
    return SimSpec(cfg, planner_cfg or planner_config_for_demo(demo), ticks, scenario)


def fusion_inputs(B: int, N: int, D: int, device, seed: int = 0, e: int | None = None,
                  fan_in: bool = False):
    """(FusionWeights, node [B, N, D], edge [B, N, N, E]) of float32 random
    values from `seed`, drawn on the CPU and moved to `device`, at node width
    D and edge width E = e (D where not given; then the draws are those of
    every earlier call); the weights at their layer's shapes
    (fusion_attention.weight_shape), LayerNorm gains near 1. The matrices'
    scale is 0.08, or with `fan_in` 0.08 sqrt(128 / fan-in), as a network's
    initialisation keeps activations of one size at any width (the same
    values at a fan-in of 128)."""
    from mind_tpu_torch.ops.fusion_attention import FusionWeights, weight_shape

    E = D if e is None else e
    g = torch.Generator(device="cpu").manual_seed(seed)
    rn = lambda *s, sc=0.08: (torch.randn(*s, generator=g) * sc).to(device)
    wsc = lambda shape: 0.08 * (128 / shape[0]) ** 0.5 if fan_in else 0.08
    w = FusionWeights(**{
        f: (rn(*weight_shape(f, D, E), sc=wsc(weight_shape(f, D, E))) if f.startswith("w") else
            1 + rn(*weight_shape(f, D, E), sc=0.1) if f.endswith("_g") else
            rn(*weight_shape(f, D, E), sc=0.1))
        for f in FusionWeights._fields})
    return w, rn(B, N, D, sc=1.0), rn(B, N, N, E, sc=0.5)
