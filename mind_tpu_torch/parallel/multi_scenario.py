"""Batched closed-loop simulation (port of mind_tpu/parallel/multi_scenario.py):
several scenarios in lockstep, planned by one batched plan per trigger.

Every scenario is padded to the same shapes, so one `batched_plan_core`
plans for all egos at once. Host-side replay bookkeeping stays per scenario
(numpy); the plan cadence is shared (equal plan rate and enable time), which
the runner checks. The observation windows are one stacked [S, A, 50, ...]
buffer, updated once per trigger for all scenarios.

On a CUDA device the update and the plan are compiled programs
(parallel/programs.py, the JAX package's `_obs_update` and `_batched_fn`):
a trigger copies its small host arrays in, replays the plan's CUDA graph
and reads the packed [S, 4] once; an update reads nothing. `graphed=False`
runs the same bodies eagerly (the bit-exact reference on the card).
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from mind_tpu_torch.common.device import resolve_device
from mind_tpu_torch.config import PlannerConfig, SimConfig, planner_config_for_demo
from mind_tpu_torch.models.weights import load_scene_pred
from mind_tpu_torch.parallel.programs import RunnerPrograms, plan_statics
from mind_tpu_torch.planner import programs
from mind_tpu_torch.planner.planner import MINDPlanner
from mind_tpu_torch.sim.agents import CustomizedAgent, MINDAgent
from mind_tpu_torch.sim.episode import _stack
from mind_tpu_torch.sim.simulator import Simulator


class MultiScenarioSim:
    """Drives S simulators in lockstep with one batched plan per trigger.
    The planners share one network, made from `planner_cfg` (the demo
    configuration by default); each scenario's own planner configuration
    gives its statics and cost parameters. `scenarios` (one in-memory
    Scenario per config, or None) goes to each Simulator; the planners run
    on `device` (the CUDA card unless the caller passes the CPU). `graphed`
    (None: on a CUDA device) updates and plans through the compiled
    programs; False runs the same bodies eagerly; True on the CPU raises.
    The batch plans with the first scenario's planner configuration, in
    which every scenario's must agree (programs.config_signature)."""

    def __init__(self, sim_cfgs: List[SimConfig], planner_cfg: Optional[PlannerConfig] = None,
                 max_steps: Optional[int] = None, device=None, scenarios=None,
                 graphed: Optional[bool] = None):
        self.planner_cfg = planner_cfg or planner_config_for_demo("demo_1")
        cfg = self.planner_cfg
        self.device = resolve_device(device)
        programs.compiled(self.device, graphed)   # raises for True on the CPU
        if cfg.ckpt_path and not str(cfg.ckpt_path).endswith(".npz"):
            raise ValueError(f"ckpt_path {cfg.ckpt_path!r}: the port reads only the .npz "
                             "archive written by tools/export_flax_weights.py")
        net = load_scene_pred(cfg.net, cfg.ckpt_path or None, self.device, seed=cfg.seed)

        def init_planner(agent, pc, device=None):
            agent.planner = MINDPlanner(pc, agent._smp, agent.lcl_smp, export_trees=False,
                                        shared_net=net, device=self.device)

        self.sims: List[Simulator] = []
        self.avs: List[MINDAgent] = []
        scenarios = scenarios or [None] * len(sim_cfgs)
        for sc, scenario in zip(sim_cfgs, scenarios):
            sc.render = False
            sim = Simulator(sc, max_steps=max_steps, device=self.device, scenario=scenario)
            # the agents' planners share the network
            orig = MINDAgent.init_planner
            MINDAgent.init_planner = init_planner
            try:
                sim.init_sim()
            finally:
                MINDAgent.init_planner = orig
            self.sims.append(sim)
            self.avs.append(next(a for a in sim.agents if a.id == "AV"))

        # all egos must share the cadence for lockstep batching
        if len({a.plan_rate for a in self.avs}) != 1 or \
                len({a.enable_timestep for a in self.avs}) != 1:
            raise ValueError("the egos must share the plan rate and the enable time")

        planners = [av.planner for av in self.avs]
        # the batch plans with the first planner's configuration
        if len({p._signature for p in planners}) != 1:
            raise ValueError("the scenarios' planner configurations differ in a value the "
                             "batched plan takes from the first one")
        self.plan_calls = 0
        self.plan_time_s = 0.0

        # statics never change: stacked once, every CostParams leaf per scene
        # but the grid size (the grid origin rides in each trigger's host array)
        dev = self.device
        self._statics = _stack([plan_statics(p) for p in planners], dev)
        self._tvs_b = torch.tensor([float(np.float32(p.lcl_smp.target_velocity))
                                    for p in planners], dtype=torch.float64, device=dev)

        # one stacked window [S, A, 50, ...]: per-planner updates are
        # deferred (ObsBuffer.pending) and applied here, once per trigger
        for p in planners:
            p.obs_buffer.device_updates = False
        self.programs = RunnerPrograms(planners[0], net, _stack(
            [p.obs_buffer.buf for p in planners], dev), graphed)
        self._types_b = None
        self._types_ver = None
        self._amasks_b = None
        self._amasks_key = None

    # ------------------------------------------------------------------
    def _flush_obs(self):
        """Apply the deferred per-scenario observation updates as one
        update. Scenarios without a pending update (terminated) roll their
        window forward unobserved."""
        planners = [av.planner for av in self.avs]
        if not any(p.obs_buffer.pending is not None for p in planners):
            return
        A = planners[0].obs_buffer.A
        # float64: the observations feed the float64 decision path
        states = np.zeros((len(planners), A, 4), np.float64)
        present = np.zeros((len(planners), A), bool)
        for i, p in enumerate(planners):
            if p.obs_buffer.pending is not None:
                states[i], present[i] = p.obs_buffer.pending
                p.obs_buffer.pending = None
        self.programs.update(torch.from_numpy(states), torch.from_numpy(present))

    @property
    def _bufs(self):
        """The stacked window [S, A, 50, ...] as it stands."""
        return self.programs.current_window()

    def _stacked_types(self, planners):
        ver = tuple(p.obs_buffer._ver for p in planners)
        if self._types_ver != ver:
            self._types_b = torch.as_tensor(np.stack([p.obs_buffer.types for p in planners]),
                                            device=self.device)
            self._types_ver = ver
        return self._types_b

    def _stacked_amasks(self, planners):
        masks = np.stack([p.obs_buffer.actor_mask() for p in planners])
        key = masks.tobytes()
        if self._amasks_key != key:
            self._amasks_b = torch.as_tensor(masks, device=self.device)
            self._amasks_key = key
        return self._amasks_b

    def _plan(self, planners) -> np.ndarray:
        """The batched plan of every scenario: packed [S, 4] (ctrl, ok, max
        iterations), read once. x0 and the grid origin go up in one float32
        host array [S, 8], as the JAX package uploads them (local frame)."""
        x0s = np.stack([np.concatenate([p.local_state(), p.ctrl]) for p in planners])
        ph = planners[0].cfg.traj_tree.full
        half = 0.5 * (ph.smooth_grid_size[0] - 1) * ph.smooth_grid_res
        host = np.concatenate([x0s, x0s[:, :2] - half], axis=1).astype(np.float32)
        return self.programs.plan(self._stacked_types(planners), self._stacked_amasks(planners),
                                  torch.from_numpy(host), self._tvs_b,
                                  self._statics).cpu().numpy()   # the one read

    def _batched_plan(self, ready: List[int]):
        """One batched plan per trigger. The batch always covers ALL
        scenarios (a fixed batch, as the JAX package's one compilation);
        only the `ready` egos take their results."""
        t0 = time.perf_counter()
        for i in ready:  # state/ctrl hand-off (MINDAgent.plan semantics)
            av = self.avs[i]
            av.planner.update_state_ctrl(av.lcl_smp.ego_agent.state, av.ctrl)
        for av in self.avs:  # placeholders for the scenarios not ready
            if av.planner.state is None:
                av.planner.update_state_ctrl(av.state, av.ctrl)
        planners = [av.planner for av in self.avs]
        with torch.no_grad():
            packed = self._plan(planners)
        self.plan_calls += 1
        self.plan_time_s += time.perf_counter() - t0

        ok = []
        for i in ready:
            ctrl = packed[i, :2].astype(np.float64)
            good = bool(packed[i, 2] > 0.5 and np.isfinite(ctrl).all())
            if good:
                self.avs[i].ctrl = ctrl
            ok.append(good)
        return ok

    def run(self, horizon: Optional[int] = None):
        horizon = horizon or min(s.sim_horizon for s in self.sims)
        terminated = [False] * len(self.sims)
        t_start = time.perf_counter()

        for tick in range(horizon):
            ready = []
            for si, sim in enumerate(self.sims):
                if terminated[si]:
                    continue
                agent_obs = [a.observe() for a in sim.agents
                             if isinstance(a, CustomizedAgent) or a.is_valid()]
                for agent in sim.agents:
                    if isinstance(agent, CustomizedAgent):
                        agent.check_enable(sim.sim_time)
                        rec_tri, pl_tri = agent.check_trigger(sim.sim_time)
                        if rec_tri:
                            agent.step()
                        if pl_tri:
                            agent.update_observation(agent_obs)
                            if agent.is_enable and agent.id == "AV":
                                ready.append(si)
                    else:
                        agent.step()

            self._flush_obs()
            if ready:
                for ok, si in zip(self._batched_plan(ready), ready):
                    if not ok:
                        terminated[si] = True

            for si, sim in enumerate(self.sims):
                if terminated[si]:
                    continue
                for agent in sim.agents:
                    agent.update_state(sim.sim_step)
                sim.sim_time += sim.sim_step

        wall = time.perf_counter() - t_start
        return {"ticks": horizon, "scenarios": len(self.sims), "wall_time_s": wall,
                "plan_calls": self.plan_calls, "plan_time_s": self.plan_time_s,
                "terminated": terminated}

    def ego_states(self) -> np.ndarray:
        return np.stack([a.state for a in self.avs])
