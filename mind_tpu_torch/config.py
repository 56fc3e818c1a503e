"""Typed configuration tree (PyTorch port of mind_tpu/config.py).

The same dataclasses and defaults as the JAX package, so the reference's
JSON files load unchanged via `SimConfig.from_json` and
`load_planner_config`. One field differs: the JAX `NetConfig` has
`use_pallas_fusion`; here the fusion core takes the CUDA kernel for CUDA
tensors and the plain version for CPU tensors, so no flag selects it.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

DEFAULT_WEIGHTS = Path(__file__).resolve().parent / "weights" / "scene_pred_demo_600.npz"


@dataclass
class NetConfig:
    """Scene-prediction network (reference net_cfg.py)."""

    num_modes: int = 6
    obs_len: int = 50
    pred_len: int = 60
    in_actor: int = 14
    d_actor: int = 128
    n_fpn_scale: int = 4
    in_lane: int = 16
    d_lane: int = 128
    d_rpe_in: int = 5
    d_rpe: int = 128
    d_embed: int = 128
    n_scene_layer: int = 6
    n_scene_head: int = 8
    dropout: float = 0.1
    update_edge: bool = True
    param_out: str = "bezier"
    bezier_order: int = 7
    # inference compute dtype ('float32' | 'bfloat16'); only float32 is
    # ported so far, bfloat16 raises NotImplementedError
    compute_dtype: str = "float32"


@dataclass
class ScenTreeConfig:
    """AIME scenario-tree generation (reference planning/demo_*.py ScenTreeCfg)."""

    max_depth: int = 5
    tar_dist_thres: float = 10.0
    tar_time_ahead: float = 5.0
    seg_length: float = 15.0
    seg_n_node: int = 10
    far_dist_thres: float = 10.0
    # fixed-width limits for the batched tree (<= 6 modes per expansion)
    max_branch_nodes: int = 8      # simultaneously expanded nodes per round
    max_tree_nodes: int = 64       # total scenario-tree node slots
    prune_prob: float = 0.001
    merge_thres: float = float(np.pi / 6)
    cov_change_rate: float = 9.0


@dataclass
class OptPhaseConfig:
    """One optimization phase (warm start or full) of the trajectory tree."""

    w_des_velocity: float = 0.1
    w_des_accel: float = 1.0
    w_des_steer: float = 10.0
    w_con_velocity: float = 50.0
    w_con_accel: float = 50.0
    w_con_steer: float = 500.0
    state_upper_bound: Tuple[float, ...] = (1e5, 1e5, 8.0, 10.0, 4.0, 0.2)
    state_lower_bound: Tuple[float, ...] = (-1e5, -1e5, 0.0, -10.0, -6.0, -0.2)
    w_ctrl: float = 5.0
    w_tgt: float = 1.0
    smooth_grid_res: float = 0.4
    smooth_grid_size: Tuple[int, int] = (256, 256)
    # full-phase only (ignored in warm start)
    w_ego: float = 1.0
    w_ego_cov_offset: float = 1.0
    w_exo: float = 10.0
    w_exo_cov_offset: float = 2.5
    w_exo_cost_offset: float = 10.0

    def w_des_state(self) -> np.ndarray:
        w = np.zeros((6, 6))
        w[2, 2] = self.w_des_velocity
        w[4, 4] = self.w_des_accel
        w[5, 5] = self.w_des_steer
        return w

    def w_state_con(self) -> np.ndarray:
        w = np.zeros((6, 6))
        w[2, 2] = self.w_con_velocity
        w[4, 4] = self.w_con_accel
        w[5, 5] = self.w_con_steer
        return w


@dataclass
class TrajTreeConfig:
    """Trajectory-tree optimizer (reference planning/demo_*.py TrajTreeCfg)."""

    dt: float = 0.2
    state_size: int = 6
    action_size: int = 2
    wheelbase: float = 2.5
    warm: OptPhaseConfig = field(default_factory=OptPhaseConfig)
    full: OptPhaseConfig = field(default_factory=OptPhaseConfig)
    # iLQR solver budget (1e-5 relative tolerance: in float32 the reference's
    # 1e-6 is below cost-sum resolution)
    max_iterations: int = 100
    # warm-start phase budget (it only initializes the full solve)
    warm_max_iterations: int = 40
    rel_tol: float = 1e-5
    # iLQR solve precision: "float32" or "float64"
    solve_dtype: str = "float32"
    # execution re-solve precision; None follows `solve_dtype`, which
    # disables the re-solve. A re-solve is not ported yet and raises.
    exec_solve_dtype: Optional[str] = None
    # exec re-solve strategy: "polish" | "scratch" | "native" (not ported)
    exec_resolve_mode: str = "polish"
    exec_polish_iterations: int = 100
    n_line_search: int = 10
    max_reg: float = 1e10
    # fixed-width limits for the batched tree solve
    max_cost_nodes: int = 192
    max_depth_levels: int = 32
    max_width_hint: int = 16   # max cost nodes per depth level (= max leaves)


@dataclass
class PlannerConfig:
    """One MIND planner instance (reference planners/mind/configs/demo_*.json)."""

    net: NetConfig = field(default_factory=NetConfig)
    scen_tree: ScenTreeConfig = field(default_factory=ScenTreeConfig)
    traj_tree: TrajTreeConfig = field(default_factory=TrajTreeConfig)
    ckpt_path: Optional[str] = None
    seed: int = 20240121  # weight init seed when no checkpoint is available
    obs_len: int = 50
    plan_len: int = 50
    # best-tree selection weights (reference planner.py:180-198)
    comfort_acc_weight: float = 0.1
    comfort_str_weight: float = 5.0
    efficiency_weight: float = 0.01
    target_weight: float = 0.01
    # fixed paddings (cover all four bundled demos)
    max_actors: int = 48
    max_lanes: int = 80
    # AIME pipeline precision of the observation window, scene prep and
    # decoded trajectory slots; probabilities, covariance accumulation,
    # renormalization and the selection cost stay float64 either way
    pipeline_dtype: str = "float32"


@dataclass
class ClAgentConfig:
    """One closed-loop agent binding (sim JSON `cl_agents` entry)."""

    id: str = "AV"
    enable_timestep: float = 4.0
    semantic_lane: int = -1       # -1 => auto-select closest
    target_velocity: float = -1.0  # -1 => mean log speed
    agent: str = "MINDAgent"
    planner_config: Optional[str] = None


@dataclass
class RenderConfig:
    mode: str = "fixed"
    camera_x: float = 0.0
    camera_y: float = 0.0
    camera_yaw: float = 0.0
    camera_elev: float = 90.0


@dataclass
class SimConfig:
    """Top-level simulation config (reference configs/demo_*.json)."""

    sim_name: str = "demo"
    seq_id: str = ""
    data_root: str = "data"
    output_dir: str = "outputs"
    num_threads: int = 8
    render: bool = False
    render_config: RenderConfig = field(default_factory=RenderConfig)
    cl_agents: List[ClAgentConfig] = field(default_factory=list)
    sim_step: float = 0.02
    sim_horizon: int = 500

    @classmethod
    def from_json(cls, path: Path | str, data_root: Optional[str] = None) -> "SimConfig":
        """Load a reference-format sim JSON (configs/demo_*.json)."""
        with open(path, "r") as f:
            raw = json.load(f)
        rc = raw.get("render_config", {}).get("camera_position", {})
        cfg = cls(
            sim_name=raw["sim_name"],
            seq_id=raw["seq_id"],
            output_dir=raw.get("output_dir", "outputs"),
            num_threads=raw.get("num_threads", 8),
            render=raw.get("render", False),
            render_config=RenderConfig(
                mode=raw.get("render_config", {}).get("mode", "fixed"),
                camera_x=rc.get("x", 0.0),
                camera_y=rc.get("y", 0.0),
                camera_yaw=rc.get("yaw", 0.0),
                camera_elev=rc.get("elev", 90.0),
            ),
            cl_agents=[
                ClAgentConfig(
                    id=c["id"],
                    enable_timestep=c["enable_timestep"],
                    semantic_lane=c.get("semantic_lane", -1),
                    target_velocity=c.get("target_velocity", -1),
                    agent=c.get("agent", "MINDAgent").split(":")[-1],
                    planner_config=c.get("planner_config"),
                )
                for c in raw.get("cl_agents", [])
            ],
        )
        if data_root is not None:
            cfg.data_root = data_root
        return cfg

    @property
    def seq_path(self) -> Path:
        return Path(self.data_root) / self.seq_id

    @property
    def map_path(self) -> Path:
        return self.seq_path / f"log_map_archive_{self.seq_id}.json"

    @property
    def scenario_path(self) -> Path:
        return self.seq_path / f"scenario_{self.seq_id}.parquet"


def planner_config_for_demo(demo: str) -> PlannerConfig:
    """PlannerConfig equivalent to the reference's planning/demo_*.py modules.

    demo_3 raises the desired-velocity weight to .5 in both phases; all
    other demos share demo_1's values. The demos run the fusion net in
    bfloat16, which the port does not run yet. Picks up the committed
    trained weights."""
    cfg = PlannerConfig()
    cfg.net.compute_dtype = "bfloat16"
    if demo.endswith("3"):
        cfg.traj_tree.warm.w_des_velocity = 0.5
        cfg.traj_tree.full.w_des_velocity = 0.5
    if DEFAULT_WEIGHTS.is_file():
        cfg.ckpt_path = str(DEFAULT_WEIGHTS)
    return cfg


def load_planner_config(path: Path | str) -> PlannerConfig:
    """Load a reference-format planner JSON (planners/mind/configs/demo_*.json),
    mapping its `planning_config` module name onto the typed tree."""
    with open(path, "r") as f:
        raw = json.load(f)
    demo = raw.get("planning_config", "demo_1").rsplit(".", 1)[-1]
    cfg = planner_config_for_demo(demo)
    if raw.get("ckpt_path"):
        cfg.ckpt_path = raw["ckpt_path"]
    return cfg
