"""Monte-Carlo closed-loop rollouts (port of mind_tpu/parallel/monte_carlo.py):
K perturbed egos in one scenario, planned by one batched plan per cycle.

All K copies share the scenario's replay agents, map statics and network;
only the ego state, the rolling observation window and the cost-field
origin are per copy. The K windows are one [K, A, 50, ...] buffer updated
once per plan trigger, and the K egos integrate the kinematic bicycle in
vectorized host numpy between plans.

On a CUDA device the update and the plan are compiled programs
(parallel/programs.py, the JAX package's `_update_fn` and `_batched_fn`):
the update builds the K copies' states on the device from the exo states
and the K egos, and a trigger reads the packed [K, 4] once. `graphed=False`
runs the same bodies eagerly (the bit-exact reference on the card).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from mind_tpu_torch.common.device import resolve_device
from mind_tpu_torch.common.kinematics import VehicleParam
from mind_tpu_torch.config import PlannerConfig, SimConfig, planner_config_for_demo
from mind_tpu_torch.data.loader import ArgoAgentLoader
from mind_tpu_torch.data.semantic_map import SemanticMap
from mind_tpu_torch.parallel.programs import RunnerPrograms, plan_statics
from mind_tpu_torch.planner import programs
from mind_tpu_torch.planner.aime_device import DeviceObsBuffer
from mind_tpu_torch.planner.planner import MINDPlanner, type_onehot
from mind_tpu_torch.planner.trajectory_tree import torch_dtype
from mind_tpu_torch.sim.agents import MINDAgent
from mind_tpu_torch.sim.episode import perturb_ego_starts


class MonteCarloSim:
    """K perturbed ego copies of one scenario, closed loop. `scenario` (an
    in-memory Scenario) takes the place of reading sim_cfg.scenario_path;
    the planner runs on `device` (the CUDA card unless the caller passes
    the CPU). `graphed` (None: on a CUDA device) updates and plans through
    the compiled programs; False runs the same bodies eagerly; True on the
    CPU raises."""

    def __init__(self, sim_cfg: SimConfig, k: int = 64, pos_sigma: float = 0.5,
                 vel_sigma: float = 0.25, planner_cfg: Optional[PlannerConfig] = None,
                 seed: int = 0, max_steps: Optional[int] = None, device=None, scenario=None,
                 graphed: Optional[bool] = None):
        programs.compiled(resolve_device(device), graphed)   # raises for True on the CPU
        self.k = k
        self.sim_cfg = sim_cfg
        self.horizon = max_steps or sim_cfg.sim_horizon
        self.sim_step = sim_cfg.sim_step
        pc = planner_cfg or planner_config_for_demo(sim_cfg.sim_name)
        self.pc = pc

        smp = SemanticMap().load_from_argo2(sim_cfg.map_path)
        self.bundle = (ArgoAgentLoader.trajs_info_of(scenario, smp) if scenario is not None
                       else ArgoAgentLoader(sim_cfg.scenario_path).get_trajs_info(smp))
        self.av_row = self.bundle.track_ids.index("AV")

        # one template agent/planner provides the statics and cost params
        av = MINDAgent()
        c = sim_cfg.cl_agents[0]
        av.init("AV", self.bundle, self.av_row, smp,
                semantic_lane_id=None if c.semantic_lane == -1 else c.semantic_lane,
                target_velocity=None if c.target_velocity == -1 else c.target_velocity)
        av.init_planner(pc, device)
        av.update_target_lane(smp, None if c.semantic_lane == -1 else c.semantic_lane)
        self.planner: MINDPlanner = av.planner
        self.device = self.planner.device
        self.veh = VehicleParam()

        # perturbed ego start states [K, 4], corridor-respecting noise
        # (sim.episode.perturb_ego_starts)
        base = np.array([
            self.bundle.pos[self.av_row, 0, 0], self.bundle.pos[self.av_row, 0, 1],
            self.bundle.vel[self.av_row, 0], self.bundle.ang[self.av_row, 0]])
        self.egos = perturb_ego_starts(base, k, pos_sigma, vel_sigma,
                                       pc.scen_tree.tar_dist_thres, seed)
        self.ctrls = np.zeros((k, 2))

        # slot layout: 0 = ego, then every other track in bundle order
        A = pc.max_actors
        self.exo_rows = [i for i in range(len(self.bundle)) if i != self.av_row][:A - 1]
        types = np.zeros((A, 7), np.float32)
        types[0] = type_onehot(self.bundle.types[self.av_row][0])
        for s, r in enumerate(self.exo_rows, start=1):
            types[s] = type_onehot(self.bundle.types[r][0])
        self._types_d = torch.as_tensor(types, device=self.device)
        self.A = A

        # batched window [K, A, ...]; the plan shares the statics, slot
        # types, actor mask and target velocity among the copies (the body
        # broadcasts them), the ego, window and field origin are per copy
        buf = DeviceObsBuffer.create(A, torch_dtype(pc.pipeline_dtype), self.device)
        p = self.planner
        self.programs = RunnerPrograms(p, p.net, DeviceObsBuffer(
            *(x[None].repeat((k,) + (1,) * x.dim()) for x in buf)), graphed)
        self._statics = plan_statics(p)
        self._tv = torch.tensor(float(np.float32(p.lcl_smp.target_velocity)),
                                dtype=torch.float64, device=self.device)
        self.plan_calls = 0
        self.failed = np.zeros(k, bool)
        self.trajectory = []

    # ------------------------------------------------------------------
    def _exo_state(self, rec: int):
        """Replay states and validity of the exo slots at a 50 Hz step, in
        the planner's local frame (float32, as the JAX package uploads them)."""
        states = np.zeros((self.A, 4), np.float64)
        present = np.zeros(self.A, bool)
        present[0] = True
        for s, r in enumerate(self.exo_rows, start=1):
            states[s] = (self.bundle.pos[r, rec, 0], self.bundle.pos[r, rec, 1],
                         self.bundle.vel[r, rec], self.bundle.ang[r, rec])
            present[s] = self.bundle.has_flag[r, rec]
        states[:, :2] -= self.planner.origin
        return states.astype(np.float32), present

    @property
    def buf(self) -> DeviceObsBuffer:
        """The K windows [K, A, 50, ...] as they stand."""
        return self.programs.current_window()

    def _plan(self, egos_loc: np.ndarray, present: torch.Tensor) -> np.ndarray:
        """The batched plan of the K copies: packed [K, 4] (ctrl, ok, max
        iterations), read once. x0 and the grid origin go up in one float32
        host array [K, 8]; the actor mask is the update's presence (on the
        card its program's buffer, read where it lies)."""
        ph = self.pc.traj_tree.full
        half = 0.5 * (ph.smooth_grid_size[0] - 1) * ph.smooth_grid_res
        host = np.concatenate([egos_loc, self.ctrls, egos_loc[:, :2] - half],
                              axis=1).astype(np.float32)
        keep = ()
        if self.programs.compiled:
            present = self.programs.programs["obs_update"].inputs.present
            keep = (present,)
        return self.programs.plan(self._types_d, present, torch.from_numpy(host), self._tv,
                                  self._statics, keep).cpu().numpy()   # the one read

    @torch.no_grad()
    def run(self):
        plan_every = 5  # 10 Hz at dt=0.02
        t0 = time.perf_counter()

        for tick in range(self.horizon):
            rec = min(tick, self.bundle.pos.shape[1] - 1)
            if tick % plan_every == 0:
                states, present = self._exo_state(rec)
                egos_loc = self.egos.copy()
                egos_loc[:, :2] -= self.planner.origin
                # the K copies' states are built on the device from the exo
                # states and the egos (float32, as the JAX package uploads them)
                present = torch.from_numpy(present)
                self.programs.update(torch.from_numpy(states), present,
                                     torch.from_numpy(egos_loc.astype(np.float32)))
                packed = self._plan(egos_loc, present)
                self.plan_calls += 1
                good = (packed[:, 2] > 0.5) & np.isfinite(packed[:, :2]).all(1)
                self.ctrls[good & ~self.failed] = packed[good & ~self.failed, :2]
                self.failed |= ~good

            # vectorized bicycle step for all K egos
            x, y, v, yaw = (self.egos[:, 0], self.egos[:, 1], self.egos[:, 2], self.egos[:, 3])
            a = np.clip(self.ctrls[:, 0], -self.veh.max_acc, self.veh.max_acc)
            d = np.clip(self.ctrls[:, 1], -self.veh.max_str, self.veh.max_str)
            self.egos = np.stack([
                x + v * np.cos(yaw) * self.sim_step,
                y + v * np.sin(yaw) * self.sim_step,
                np.clip(v + a * self.sim_step, -self.veh.max_spd, self.veh.max_spd),
                yaw + v / self.veh.wb * np.tan(d) * self.sim_step,
            ], axis=1)
            self.trajectory.append(self.egos.copy())

        wall = time.perf_counter() - t0
        return {"ticks": self.horizon, "copies": self.k, "wall_time_s": wall,
                "plan_calls": self.plan_calls, "failed": int(self.failed.sum()),
                "effective_steps_per_s": self.k * self.horizon / wall}
