"""Simulation agents: replay (non-reactive) and closed-loop (MIND) agents
(port of mind_tpu/sim/agents.py).

Host-side twins of the reference's agent classes (agent.py): replay agents
look up resampled 50 Hz logs; the closed-loop ego re-plans at 10 Hz and
integrates the kinematic bicycle between plans. The heavy lifting happens in
the planner on the device; these objects only orchestrate timing,
target-lane selection and state hand-off.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from mind_tpu_torch.common.bbox import bbox_for_type
from mind_tpu_torch.common.geometry import (
    project_point_on_polyline,
    remove_close_points,
    wrap_angle,
)
from mind_tpu_torch.common.kinematics import VehicleParam, kine_propagate_np
from mind_tpu_torch.config import PlannerConfig
from mind_tpu_torch.data.av2 import ObjectType
from mind_tpu_torch.data.loader import TrajBundle
from mind_tpu_torch.data.semantic_map import SemanticMap, LocalSemanticMap


EXO_COLOR = ("lightcoral", "indianred")
EGO_DISABLE_COLOR = ("lightskyblue", "deepskyblue")
EGO_ENABLE_COLOR = ("lime", "blue")


@dataclass
class AgentObservation:
    id: str = ""
    type: Optional[ObjectType] = None
    clr: Tuple[str, str] = EXO_COLOR
    bbox: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    state: Optional[np.ndarray] = None
    timestep: float = 0.0


class NonReactiveAgent:
    """Replays the resampled log (reference agent.py:75-149)."""

    def __init__(self):
        self.id = None
        self.type = None
        self.clr = EXO_COLOR
        self.state = None
        self.ctrl = np.zeros(2)
        self.bbox = (1.0, 1.0, 1.0)
        self.timestep = 0.0
        self.traj_pos = None
        self.traj_ang = None
        self.traj_vel = None
        self.traj_type = None
        self.has_flag = None
        self.rec_step = 0
        self.max_step = 0

    def init(self, agt_id, bundle: TrajBundle, idx: int, smp: SemanticMap,
             clr=EXO_COLOR):
        self.id = agt_id
        self.clr = clr
        self.traj_pos = bundle.pos[idx]
        self.traj_ang = bundle.ang[idx]
        self.traj_vel = bundle.vel[idx]
        self.traj_type = bundle.types[idx]
        self.has_flag = bundle.has_flag[idx]
        self.rec_step = 0
        self.max_step = len(self.traj_pos) - 1
        self._load_state()
        self.timestep = 0.0

    def _load_state(self):
        self.type = self.traj_type[self.rec_step]
        self.bbox = bbox_for_type(self.type)
        self.state = np.array([
            self.traj_pos[self.rec_step][0],
            self.traj_pos[self.rec_step][1],
            self.traj_vel[self.rec_step],
            self.traj_ang[self.rec_step],
        ])
        self.ctrl = np.zeros(2)

    # optional observation noise (the reference carries a disabled noise
    # injection, agent.py:56-58); set to a (sigma, np.random.Generator)
    # tuple to enable
    obs_noise = None

    def observe(self) -> AgentObservation:
        state = self.state
        if self.obs_noise is not None:
            sigma, rng = self.obs_noise
            noise = rng.normal(0.0, sigma, self.state.shape)
            noise[-1] = 0.0
            state = self.state + noise
        return AgentObservation(id=self.id, type=self.type, clr=self.clr,
                                bbox=self.bbox, state=state,
                                timestep=self.timestep)

    def observe_no_noise(self) -> AgentObservation:
        return AgentObservation(id=self.id, type=self.type, clr=self.clr,
                                bbox=self.bbox, state=self.state,
                                timestep=self.timestep)

    def step(self):
        if self.rec_step < self.max_step:
            self.rec_step += 1

    def update_state(self, dt: float):
        self._load_state()
        self.timestep += dt

    def is_valid(self) -> bool:
        return bool(self.has_flag[self.rec_step])


class CustomizedAgent(NonReactiveAgent):
    """Closed-loop shell: 10 Hz plan trigger, target-lane synthesis, bicycle
    integration when enabled (reference agent.py:152-303)."""

    def __init__(self):
        super().__init__()
        self.last_pl_tri = None
        self.plan_rate = 10
        self.plan_step = 1.0 / self.plan_rate - 1e-4
        self.planner = None
        self.veh_param = VehicleParam()
        self.enable_timestep = 1e8
        self.is_enable = False
        self.lcl_smp: Optional[LocalSemanticMap] = None

    def init(self, agt_id, bundle: TrajBundle, idx: int, smp: SemanticMap,
             clr=EGO_DISABLE_COLOR, use_traj=True, semantic_lane_id=None,
             target_velocity=None):
        super().init(agt_id, bundle, idx, smp, clr)
        lane, lane_info = self.get_target_lane(smp, use_traj, semantic_lane_id)
        if target_velocity is None:
            target_velocity = float(np.mean(self.traj_vel))
        self.lcl_smp = LocalSemanticMap(self.id, smp)
        self.lcl_smp.update_target_lane(lane)
        if lane_info is not None:
            self.lcl_smp.update_target_lane_info(lane_info)
        self.lcl_smp.update_target_velocity(target_velocity)
        self.timestep = 0.0
        self.init_state_ctrl()

    # ---------------- target-lane synthesis (agent.py:183-256) -----------
    def get_target_lane(self, smp: SemanticMap, use_traj, semantic_lane_id):
        traj_pos, traj_ang = self.traj_pos, self.traj_ang
        if semantic_lane_id is None:
            semantic_lane_id = self.get_closest_semantic_lane(smp, traj_pos, traj_ang)
            if semantic_lane_id is None:
                lane = self.get_virtual_target_lane(traj_pos)
                ext = lane[-1] + (lane[-1] - lane[-2]) * 10.0
                return np.vstack([lane, ext]), None
            if use_traj:
                lane = self.get_virtual_target_lane(traj_pos)
                sem = smp.semantic_lanes[semantic_lane_id]
                closest = int(np.argmin(np.linalg.norm(sem - traj_pos[-1], axis=1)))
                return np.vstack([lane, sem[closest:]]), None
            return (smp.semantic_lanes[semantic_lane_id],
                    smp.semantic_lanes_infos[semantic_lane_id])
        if semantic_lane_id not in smp.semantic_lanes:
            raise ValueError(f"Semantic lane id {semantic_lane_id} not in map.")
        if use_traj:
            lane = self.get_virtual_target_lane(traj_pos)
            sem = smp.semantic_lanes[semantic_lane_id]
            diff = lane[:, None, :] - sem[None, :, :]
            d2 = np.sum(diff**2, axis=2)
            vi, si = np.unravel_index(np.argmin(d2), d2.shape)
            return np.vstack([lane[:vi + 1], sem[si:]]), None
        return (smp.semantic_lanes[semantic_lane_id],
                smp.semantic_lanes_infos[semantic_lane_id])

    @staticmethod
    def get_closest_semantic_lane(smp: SemanticMap, traj_pos, traj_ang):
        closest, min_d = None, 1e9
        ang_thres, dis_thres = np.pi / 4.0, 5.0
        for lane_id, lane in smp.semantic_lanes.items():
            p0, h0, _ = project_point_on_polyline(traj_pos[0], lane)
            a0 = abs(wrap_angle(abs(h0 - traj_ang[0])))
            if np.linalg.norm(traj_pos[0] - p0) > dis_thres or a0 > ang_thres:
                continue
            p1, h1, _ = project_point_on_polyline(traj_pos[-1], lane)
            a1 = abs(wrap_angle(abs(h1 - traj_ang[-1])))
            d1 = np.linalg.norm(traj_pos[-1] - p1)
            if a1 < ang_thres and d1 < dis_thres and d1 < min_d:
                min_d, closest = d1, lane_id
        return closest

    @staticmethod
    def get_virtual_target_lane(traj_pos):
        return remove_close_points(np.array(traj_pos, np.float64), 0.1)

    # ---------------- triggers / state update ----------------------------
    def set_enable_timestep(self, ts):
        self.enable_timestep = ts

    def check_enable(self, sim_time):
        if sim_time >= self.enable_timestep and not self.is_enable:
            self.is_enable = True
            self.init_state_ctrl()

    def init_state_ctrl(self):
        self.state = np.array([
            self.traj_pos[self.rec_step][0],
            self.traj_pos[self.rec_step][1],
            self.traj_vel[self.rec_step],
            self.traj_ang[self.rec_step],
        ])
        self.ctrl = np.zeros(2)

    def check_trigger(self, sim_time):
        record = not self.is_enable
        plan = (self.last_pl_tri is None
                or (sim_time - self.last_pl_tri) >= self.plan_step)
        if plan:
            self.last_pl_tri = sim_time
        return record, plan

    def plan(self):
        return True, None

    def init_planner(self, planner_cfg: PlannerConfig, device=None):
        pass

    def update_state(self, dt):
        if not self.is_enable:
            super().update_state(dt)
        else:
            self.state = kine_propagate_np(
                self.state, self.ctrl, dt, self.veh_param.wb,
                self.veh_param.max_spd, self.veh_param.max_str)
            self.timestep += dt

    def update_observation(self, agent_obs: List[AgentObservation]):
        self.lcl_smp.update_observation(agent_obs)


class MINDAgent(CustomizedAgent):
    """Binds a MINDPlanner (reference agent.py:306-332)."""

    def __init__(self):
        super().__init__()
        self.gt_tgt_lane = None
        self._smp = None

    def init(self, agt_id, bundle, idx, smp, clr=EGO_DISABLE_COLOR,
             use_traj=False, semantic_lane_id=None, target_velocity=None):
        super().init(agt_id, bundle, idx, smp, clr, use_traj,
                     semantic_lane_id, target_velocity)
        self._smp = smp

    def init_planner(self, planner_cfg: PlannerConfig, device=None):
        """The planner runs on the CUDA card unless `device` names the CPU."""
        from mind_tpu_torch.planner.planner import MINDPlanner

        self.planner = MINDPlanner(planner_cfg, self._smp, self.lcl_smp, device=device)

    def update_target_lane(self, smp, semantic_lane_id):
        self.gt_tgt_lane, _ = self.get_target_lane(smp, True, semantic_lane_id)
        self.gt_tgt_lane = remove_close_points(self.gt_tgt_lane, 4.0)
        self.planner.update_target_lane(self.gt_tgt_lane)

    def plan(self):
        self.planner.update_state_ctrl(self.lcl_smp.ego_agent.state, self.ctrl)
        ok, ctrl, best = self.planner.plan()
        if ok:
            self.ctrl = np.asarray(ctrl)
        return ok, best

    def update_observation(self, agent_obs):
        self.lcl_smp.update_observation(agent_obs)
        # ego first so it lands in buffer slot 0
        ego = self.lcl_smp.ego_agent
        obs = [("AV", ego.state, ego.type)] + [
            (a.id, a.state, a.type) for a in self.lcl_smp.exo_agents]
        self.planner.update_observation(obs)


def load_agents(bundle: TrajBundle, smp: SemanticMap, cl_agents_cfg,
                planner_cfg_fn, device=None) -> List[NonReactiveAgent]:
    """Instantiate agents per the sim config (reference loader.py:14-44).

    `cl_agents_cfg`: list of ClAgentConfig; `planner_cfg_fn(path) ->
    PlannerConfig` resolves each closed-loop agent's planner config;
    `device` is where their planners run (the CUDA card when None).
    """
    cl = {c.id: c for c in cl_agents_cfg}
    agents = []
    for idx, tid in enumerate(bundle.track_ids):
        if tid in cl:
            c = cl[tid]
            agent = MINDAgent()
            agent.init(
                tid, bundle, idx, smp, EGO_DISABLE_COLOR,
                semantic_lane_id=None if c.semantic_lane == -1 else c.semantic_lane,
                target_velocity=None if c.target_velocity == -1 else c.target_velocity,
            )
            agent.set_enable_timestep(c.enable_timestep)
            agent.init_planner(planner_cfg_fn(c.planner_config), device)
            agent.update_target_lane(
                smp, None if c.semantic_lane == -1 else c.semantic_lane)
        else:
            agent = NonReactiveAgent()
            agent.init(tid, bundle, idx, smp, EXO_COLOR)
        agents.append(agent)
    return agents
