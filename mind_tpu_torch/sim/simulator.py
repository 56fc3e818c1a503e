"""Closed-loop simulator (reference simulator.py; port of
mind_tpu/sim/simulator.py).

The 50 Hz loop: observe -> (closed-loop agents: enable/trigger/plan) ->
replay step -> state update, recording frames for visualization. Plan calls
run the planner on the device; everything else is cheap host bookkeeping. A
device-resident replay rollout of the logs lives in
mind_tpu_torch.sim.replay.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from mind_tpu_torch.common.device import resolve_device
from mind_tpu_torch.config import (PlannerConfig, SimConfig, load_planner_config,
                                   planner_config_for_demo)
from mind_tpu_torch.data.av2 import Scenario
from mind_tpu_torch.data.loader import ArgoAgentLoader
from mind_tpu_torch.data.semantic_map import SemanticMap
from mind_tpu_torch.sim.agents import CustomizedAgent, NonReactiveAgent, load_agents


class Simulator:
    """Runs one scenario closed-loop (reference simulator.py:18-107). The
    planners run on the CUDA card unless `device` names the CPU. With
    `scenario` (a Scenario built in memory) the tracks come from it, through
    the loader's filtering and resampling, and config.scenario_path is not
    read; the map is always read from config.map_path."""

    def __init__(self, config: SimConfig | str | Path,
                 planner_cfg: Optional[PlannerConfig] = None,
                 max_steps: Optional[int] = None, device=None,
                 scenario: Optional[Scenario] = None):
        self.device = resolve_device(device)
        self._scenario = scenario
        if not isinstance(config, SimConfig):
            config = SimConfig.from_json(config)
        self.config = config
        self.sim_name = config.sim_name
        self.seq_id = config.seq_id
        self.sim_step = config.sim_step
        self.sim_horizon = max_steps or config.sim_horizon
        self._planner_cfg_override = planner_cfg

        self.smp = SemanticMap().load_from_argo2(config.map_path)
        self.agents: List[NonReactiveAgent] = []
        self.frames: List[dict] = []
        self.sim_time = 0.0
        self.metrics = {"plan_calls": 0, "plan_time_s": 0.0, "ticks": 0,
                        "wall_time_s": 0.0}

    # ------------------------------------------------------------------
    def run(self):
        self.init_sim()
        self.run_sim()
        self.render_video()

    def init_sim(self):
        if self._scenario is not None:
            bundle = ArgoAgentLoader.trajs_info_of(self._scenario, self.smp)
        else:
            bundle = ArgoAgentLoader(self.config.scenario_path).get_trajs_info(self.smp)

        def planner_cfg_fn(path):
            if self._planner_cfg_override is not None:
                return self._planner_cfg_override
            if path and Path(path).exists():
                return load_planner_config(path)
            # fall back to the demo-named defaults
            return planner_config_for_demo(self.sim_name)

        self.agents = load_agents(bundle, self.smp, self.config.cl_agents,
                                  planner_cfg_fn, self.device)

    def run_sim(self):
        self.frames = []
        self.sim_time = 0.0
        terminated = False
        t_start = time.perf_counter()

        for tick in range(self.sim_horizon):
            frame = {}
            agent_obs = [
                a.observe() for a in self.agents
                if (isinstance(a, CustomizedAgent)
                    or (isinstance(a, NonReactiveAgent) and a.is_valid()))
            ]
            frame["agents"] = [
                a.observe_no_noise() for a in self.agents
                if (isinstance(a, CustomizedAgent)
                    or (isinstance(a, NonReactiveAgent) and a.is_valid()))
            ]

            for agent in self.agents:
                if isinstance(agent, CustomizedAgent):
                    agent.check_enable(self.sim_time)
                    rec_tri, pl_tri = agent.check_trigger(self.sim_time)
                    if rec_tri:
                        agent.step()
                    if pl_tri:
                        agent.update_observation(agent_obs)
                        if agent.is_enable:
                            t0 = time.perf_counter()
                            ok, res = agent.plan()
                            self.metrics["plan_calls"] += 1
                            self.metrics["plan_time_s"] += time.perf_counter() - t0
                            if not ok:
                                print(f"Agent {agent.id} plan failed!")
                                terminated = True
                                break
                            if agent.id == "AV" and res is not None:
                                frame["scen_tree"] = res[0]
                                frame["traj_tree"] = res[1]
                else:
                    agent.step()
                agent.update_state(self.sim_step)

            self.frames.append(frame)
            self.sim_time += self.sim_step
            self.metrics["ticks"] = tick + 1
            if terminated:
                print("Simulation terminated!")
                break

        self.metrics["wall_time_s"] = time.perf_counter() - t_start
        return self.metrics

    # ------------------------------------------------------------------
    def ego_trajectory(self) -> np.ndarray:
        """[T, 4] recorded ego states (for parity harnesses / benches)."""
        out = []
        for frame in self.frames:
            for obs in frame["agents"]:
                if obs.id == "AV":
                    out.append(obs.state)
        return np.array(out)

    def render_video(self):
        """Render recorded frames; returns the video path (an MJPEG .avi
        where ffmpeg is not installed), None if rendering is off."""
        if not self.config.render:
            return None
        from mind_tpu_torch.viz.render import render_frames_to_video

        return render_frames_to_video(self)


class SimSpec(NamedTuple):
    """What it takes to build the same initialized Simulator in another
    process (a rank of parallel/launch.py): the configuration, the planner
    configuration that overrides the file's, the ticks, the in-memory
    scenario and, per closed-loop agent id, network weights to load over
    its planner's (CPU tensors). All of it pickles; the map is read from
    config.map_path on the same machine."""

    config: SimConfig
    planner_cfg: Optional[PlannerConfig] = None
    max_steps: Optional[int] = None
    scenario: Optional[Scenario] = None
    net_states: Optional[Dict[str, dict]] = None

    @classmethod
    def of(cls, sim: Simulator) -> "SimSpec":
        """The spec of an initialized Simulator, its planners' current
        weights included."""
        states = {a.id: {k: v.detach().cpu() for k, v in a.planner.net.state_dict().items()}
                  for a in sim.agents if isinstance(a, CustomizedAgent) and a.planner is not None}
        return cls(sim.config, sim._planner_cfg_override, sim.sim_horizon, sim._scenario,
                   states or None)

    def build(self, device=None) -> Simulator:
        """An initialized Simulator on `device` (the card unless the caller
        passes the CPU) with the spec's weights loaded."""
        sim = Simulator(self.config, planner_cfg=self.planner_cfg, max_steps=self.max_steps,
                        device=device, scenario=self.scenario)
        sim.init_sim()
        for a in sim.agents:
            state = (self.net_states or {}).get(a.id)
            if state is not None:
                a.planner.net.load_state_dict(state)
                a.planner.net.apply_compute_dtype()
        return sim
