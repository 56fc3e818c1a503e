"""Closed-loop parity runners: the port's planner vs the float64 host mirror
(port of mind_tpu/parity/runner.py).

Each runner builds the port's Simulator for one demo configuration, drives
the ego with the device planner (MINDPlanner, or the episode runner), plans
with HostRefPlanner from the same inputs, sharing the device planner's
network, and reports the deviation of the two (the BASELINE.json 1e-3 m
north star). The planners run on the CUDA card unless `device` names the
CPU; `scenario` is an in-memory Scenario passed to the Simulator in place of
the demo's parquet (the map is always read under `data_root`).

The mirror plans in the global frame and the device planner in its local
frame offset by MINDPlanner.origin: the episode's slot states come back to
the global frame by adding the origin on the host, in float64.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Optional

import numpy as np

DATA_ROOT = "data"
CONFIGS = Path(__file__).resolve().parent.parent.parent / "configs"


def _demo_sim(demo: str, max_steps: int, data_root: str, pcfg, device, scenario,
              enable_timestep: Optional[float] = None):
    """An initialized Simulator of configs/<demo>.json with rendering off."""
    from mind_tpu_torch.config import SimConfig
    from mind_tpu_torch.sim.simulator import Simulator

    cfg = SimConfig.from_json(CONFIGS / f"{demo}.json", data_root=data_root)
    cfg.render = False
    if enable_timestep is not None:  # short-horizon harness testing
        cfg.cl_agents[0].enable_timestep = enable_timestep
    sim = Simulator(cfg, planner_cfg=pcfg, max_steps=max_steps, device=device,
                    scenario=scenario)
    sim.init_sim()
    return sim


def _ego(sim):
    from mind_tpu_torch.sim.agents import MINDAgent

    return next(a for a in sim.agents if isinstance(a, MINDAgent))


def _mirror(dev_pl, ego, record_debug: bool = False):
    """A HostRefPlanner for `ego`, sharing the device planner's network."""
    from mind_tpu_torch.parity import HostRefPlanner

    host_pl = HostRefPlanner(dev_pl.cfg, ego._smp, ego.lcl_smp, shared_net=dev_pl.net,
                             record_debug=record_debug)
    host_pl.update_target_lane(ego.gt_tgt_lane)
    return host_pl


def _rollout_dev(state, ctrl_a, ctrl_b, dt, vp, ticks: int = 5) -> float:
    """Max distance between `ticks`-tick rollouts of two controls from the
    same state."""
    from mind_tpu_torch.common.kinematics import kine_propagate_np

    sa = sb = np.asarray(state, np.float64).copy()
    worst = 0.0
    for _ in range(ticks):
        sa = kine_propagate_np(sa, np.asarray(ctrl_a, np.float64), dt, vp.wb, vp.max_spd,
                               vp.max_str)
        sb = kine_propagate_np(sb, np.asarray(ctrl_b, np.float64), dt, vp.wb, vp.max_spd,
                               vp.max_str)
        worst = max(worst, float(np.linalg.norm(sa[:2] - sb[:2])))
    return worst


def run_parity_demo(demo: str, max_steps: int,
                    data_root: str = DATA_ROOT,
                    solve_dtype: Optional[str] = None,
                    pipeline_dtype: Optional[str] = None,
                    exec_solve_dtype: Optional[str] = None,
                    exec_resolve_mode: Optional[str] = None,
                    device=None, scenario=None) -> dict:
    """Free-run lockstep parity on the demo planner configuration (bf16
    network shared by both sides, production rel_tol). `solve_dtype`
    optionally overrides the iLQR precision ("float64" is the strict mode);
    `pipeline_dtype` the bulk obs-window/scene-prep precision;
    `exec_solve_dtype` / `exec_resolve_mode` the winner-tree exec re-solve
    policy (TrajTreeConfig)."""
    from mind_tpu_torch.config import planner_config_for_demo
    from mind_tpu_torch.sim.agents import MINDAgent

    def make_sim():
        pcfg = planner_config_for_demo(demo)
        if solve_dtype is not None:
            pcfg.traj_tree.solve_dtype = solve_dtype
        if pipeline_dtype is not None:
            pcfg.pipeline_dtype = pipeline_dtype
        if exec_solve_dtype is not None:
            pcfg.traj_tree.exec_solve_dtype = exec_solve_dtype
        if exec_resolve_mode is not None:
            pcfg.traj_tree.exec_resolve_mode = exec_resolve_mode
        return _demo_sim(demo, max_steps, data_root, pcfg, device, scenario)

    sim_dev = make_sim()
    sim_host = make_sim()

    # swap the host sim's ego planners for the reference mirror, sharing the
    # device planner's network
    for a_dev, a_host in zip(sim_dev.agents, sim_host.agents):
        if isinstance(a_host, MINDAgent):
            a_host.planner = _mirror(a_dev.planner, a_host)

    t0 = time.perf_counter()
    sim_dev.run_sim()
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim_host.run_sim()
    t_host = time.perf_counter() - t0

    ego_dev = sim_dev.ego_trajectory()
    ego_host = sim_host.ego_trajectory()
    n = min(len(ego_dev), len(ego_host))
    dev_pos = np.linalg.norm(ego_dev[:n, :2] - ego_host[:n, :2], axis=-1)

    # closed-loop segment starts at the ego enable timestep
    enable = sim_dev.config.cl_agents[0].enable_timestep
    start = int(round(enable / sim_dev.config.sim_step))
    cl = dev_pos[start:] if len(dev_pos) > start else dev_pos

    host_pl = _ego(sim_host).planner
    nan = float("nan")
    return {
        "demo": demo,
        "ticks_dev": sim_dev.metrics["ticks"],
        "ticks_host": sim_host.metrics["ticks"],
        "plans_dev": sim_dev.metrics["plan_calls"],
        "closed_loop_steps": int(len(cl)),
        "max_dev_all": float(dev_pos.max()) if len(dev_pos) else nan,
        "max_dev_cl": float(cl.max()) if len(cl) else nan,
        "mean_dev_cl": float(cl.mean()) if len(cl) else nan,
        "final_dev": float(dev_pos[-1]) if len(dev_pos) else nan,
        "host_failures": host_pl.diagnostics["plan_failures"],
        "branch_overflows": host_pl.diagnostics["branch_overflows"],
        "wall_dev_s": t_dev,
        "wall_host_s": t_host,
    }


def _slot_obj_types(types: np.ndarray):
    """Reverse the one-hot type encoding (round-trips via type_onehot)."""
    from mind_tpu_torch.data.av2 import ObjectType
    from mind_tpu_torch.planner.planner import TYPE_ORDER

    out = []
    for row in types:
        if row.sum() == 0:
            out.append(ObjectType.UNKNOWN)
        else:
            i = int(np.argmax(row))
            out.append(TYPE_ORDER[i] if i < 6 else ObjectType.STATIC)
    return out


class _Playback:
    """The episode's observation stream on the host: per cycle, the
    observations the device program planned from, in the global frame, with
    the episode's recorded ego state in slot 0."""

    def __init__(self, inp, res, origin):
        self.res = res
        self.origin = origin
        self.slot_states = inp.slot_states.cpu().numpy().astype(np.float64)
        self.present = inp.present.cpu().numpy()
        self.active = inp.active.cpu().numpy()
        self.slot_types = _slot_obj_types(inp.types.cpu().numpy())
        self.enable_tick = int(inp.enable_tick)

    def cycles(self):
        """(cycle, ego state, observations) up to the failing cycle: past it
        the episode holds the ego frozen and plans nothing."""
        from mind_tpu_torch.sim.episode import TICKS_PER_PLAN

        res = self.res
        for c in range(self.slot_states.shape[0]):
            if res.fail_cycle >= 0 and c > res.fail_cycle:
                break
            ego_state = res.ego_states[c * TICKS_PER_PLAN].astype(np.float64)
            obs = []
            for s in range(self.slot_states.shape[1]):
                if not (self.active[c, s] and self.present[c, s]):
                    continue
                st = self.slot_states[c, s].copy()
                st[:2] += self.origin
                if s == 0:
                    st = ego_state.copy()
                obs.append((f"slot_{s}", st, self.slot_types[s]))
            yield c, ego_state, obs

    def ctrl_in(self, c: int) -> np.ndarray:
        """The control the ego held when cycle c planned."""
        from mind_tpu_torch.sim.episode import TICKS_PER_PLAN

        if c * TICKS_PER_PLAN <= self.enable_tick:
            return np.zeros(2)
        return self.res.controls[c - 1].astype(np.float64)


def run_parity_episode_playback(demo: str, max_steps: int,
                                data_root: str = DATA_ROOT,
                                enable_timestep: Optional[float] = None,
                                solve_dtype: Optional[str] = None,
                                planner_cfg=None, device=None, scenario=None) -> dict:
    """Per-cycle resynced parity for the benched path: the episode runner
    (sim/episode.py) vs the float64 reference-control-flow mirror.

    The episode runs once and records its per-cycle controls and loop-start
    ego states. The mirror is then driven through the identical observation
    stream (the episode's own replay schedule with its recorded ego states
    in slot 0), planning once per cycle from exactly the state the episode
    planned from. Per-cycle deviation = max distance between 5-tick
    rollouts of the two controls from the same state: the deviation one
    plan cycle contributes before the next re-plan corrects it."""
    from mind_tpu_torch.config import planner_config_for_demo
    from mind_tpu_torch.sim.episode import build_episode_inputs, run_episode

    pcfg = planner_cfg or planner_config_for_demo(demo)
    if solve_dtype is not None:
        pcfg.traj_tree.solve_dtype = solve_dtype
    sim = _demo_sim(demo, max_steps, data_root, pcfg, device, scenario, enable_timestep)
    ego = _ego(sim)
    dev_pl = ego.planner

    inp = build_episode_inputs(sim, max_steps)
    t0 = time.perf_counter()
    res = run_episode(sim, max_steps, inputs=inp)
    t_epi = time.perf_counter() - t0

    host_pl = _mirror(dev_pl, ego)
    play = _Playback(inp, res, dev_pl.origin)
    vp = ego.veh_param
    dt = sim.config.sim_step
    devs, ctrl_devs, records = [], [], []
    ok_flips = 0
    t0 = time.perf_counter()
    for c, ego_state, obs in play.cycles():
        host_pl.update_observation(obs)
        if not res.planned[c]:
            continue
        host_pl.update_state_ctrl(ego_state, play.ctrl_in(c))
        ok_h, ctrl_h, _ = host_pl.plan()
        ok_d = bool(res.plan_ok[c])
        rec = {"cycle": c, "ok_dev": ok_d, "ok_host": bool(ok_h)}
        if ok_d != bool(ok_h):
            ok_flips += 1
        elif ok_d:
            ctrl_d = res.controls[c].astype(np.float64)
            worst = _rollout_dev(ego_state, ctrl_d, ctrl_h, dt, vp)
            devs.append(worst)
            ctrl_devs.append(float(np.abs(ctrl_d - ctrl_h).max()))
            rec["cycle_dev"] = worst
        records.append(rec)
    wall = time.perf_counter() - t0

    nan = float("nan")
    return {
        "demo": demo,
        "ticks": int(len(res.ego_states)),
        "plans_compared": len(devs),
        "ok_mismatches": ok_flips,
        "max_cycle_dev": float(np.max(devs)) if devs else nan,
        "mean_cycle_dev": float(np.mean(devs)) if devs else nan,
        "max_ctrl_dev": float(np.max(ctrl_devs)) if ctrl_devs else nan,
        "fail_cycle": res.fail_cycle,
        "episode_wall_s": t_epi,
        "mirror_wall_s": wall,
        "records": records,
    }


def run_playback_diagnostic(demo: str, max_steps: int,
                            data_root: str = DATA_ROOT,
                            worst_k: int = 5,
                            dev_threshold: float = 1e-3,
                            enable_timestep=None,
                            planner_cfg=None, device=None, scenario=None) -> dict:
    """Stage-by-stage divergence dump for the episode-playback parity: where
    do cm-scale cycles come from?

    Runs the episode, then per plan cycle drives BOTH the staged device
    planner and the f64 mirror (record_debug=True) from the episode's
    identical inputs, comparing every decision stage:

    - scenario-tree structure: node count, per-node (parent, duration,
      norm_prob), device vs mirror;
    - the mirror's decision margins per expansion (prune/merge/branch);
    - per-tree selection costs + the selection margin, device vs mirror;
    - the executed control deviation and its 5-tick rollout deviation.

    Returns {"cycles": [...], "worst": [...]} where `worst` carries the
    full stage dump for the `worst_k` cycles by rollout deviation (plus
    any cycle above `dev_threshold`)."""
    from mind_tpu_torch.config import planner_config_for_demo
    from mind_tpu_torch.sim.episode import build_episode_inputs, run_episode

    pcfg = planner_cfg or planner_config_for_demo(demo)
    sim = _demo_sim(demo, max_steps, data_root, pcfg, device, scenario, enable_timestep)
    ego = _ego(sim)
    dev_pl = ego.planner
    dev_pl.export_trees = True  # staged path exposes meta + tree costs

    inp = build_episode_inputs(sim, max_steps)
    res = run_episode(sim, max_steps, inputs=inp)

    host_pl = _mirror(dev_pl, ego, record_debug=True)
    play = _Playback(inp, res, dev_pl.origin)
    vp = ego.veh_param
    dt = sim.config.sim_step

    cycles = []
    for c, ego_state, obs in play.cycles():
        host_pl.update_observation(obs)
        dev_pl.update_observation(obs)
        if not res.planned[c]:
            continue
        ctrl_in = play.ctrl_in(c)
        host_pl.update_state_ctrl(ego_state, ctrl_in)
        dev_pl.update_state_ctrl(ego_state, ctrl_in)
        ok_h, ctrl_h, _ = host_pl.plan()
        ok_d, ctrl_d, _ = dev_pl.plan()

        rec = {"cycle": c, "ok_dev": bool(ok_d), "ok_host": bool(ok_h)}
        if ok_d and ok_h:
            dbg = host_pl.debug
            dev_meta = dev_pl.last_meta
            end = dev_meta["end_flag"].copy()
            end[0] = False  # slot 0 is the root (the host dump skips key 0)
            dev_nodes = [
                {"slot": int(i), "parent": int(dev_meta["parent"][i]),
                 "duration": int(dev_meta["duration"][i]),
                 "tree": int(dev_meta["tree_id"][i]),
                 "norm_prob": float(dev_meta["norm_prob"][i])}
                for i in np.flatnonzero(end)]
            host_costs = np.asarray(dbg["tree_costs"])
            dev_costs = np.asarray(dev_pl.last_tree_costs)
            rec.update({
                "cycle_dev": _rollout_dev(ego_state, ctrl_d, ctrl_h, dt, vp),
                "ctrl_dev": float(np.abs(np.asarray(ctrl_d) - np.asarray(ctrl_h)).max()),
                "n_trees_dev": int(dev_pl.last_n_trees),
                "n_trees_host": int(host_pl.last_n_trees),
                "n_end_nodes_dev": int(np.count_nonzero(end)),
                "n_end_nodes_host": sum(1 for n in dbg["scen_nodes"] if n["end"]),
                "tree_costs_dev": dev_costs.tolist(),
                "tree_costs_host": host_costs.tolist(),
                "best_dev": int(np.argmin(dev_costs)),
                "best_host": int(np.argmin(host_costs)),
                "selection_margin_dev": float(np.diff(np.sort(dev_costs)[:2])[0])
                if len(dev_costs) > 1 else float("inf"),
                "selection_margin_host": dbg["selection_margin"],
                "host_debug": dbg,
                "dev_nodes": dev_nodes,
            })
        cycles.append(rec)

    full = [r for r in cycles if "cycle_dev" in r]
    full.sort(key=lambda r: -r["cycle_dev"])
    worst = [r for i, r in enumerate(full)
             if i < worst_k or r["cycle_dev"] > dev_threshold]
    summary = [{k: r[k] for k in r if k not in ("host_debug", "dev_nodes")} for r in cycles]
    return {"demo": demo, "fail_cycle": res.fail_cycle,
            "cycles": summary, "worst": worst}


class _TandemPlanner:
    """Delegates the MINDPlanner surface to BOTH the device planner and
    the host mirror, applying the device control while recording each
    cycle's (state, ctrl_dev, ctrl_host). Because both sides receive the
    SAME observations and ego state every cycle, the mirror is re-synced at
    each plan: the per-cycle deviation measures pure implementation
    agreement, free of the closed loop's chaotic amplification."""

    def __init__(self, dev_pl, host_pl):
        self.dev = dev_pl
        self.host = host_pl
        self.records = []
        self._pending = None

    def update_observation(self, obs):
        self.dev.update_observation(obs)
        self.host.update_observation(obs)

    def update_state_ctrl(self, state, ctrl):
        self.dev.update_state_ctrl(state, ctrl)
        self.host.update_state_ctrl(state, ctrl)
        self._pending = (np.asarray(state, float).copy(),
                         np.asarray(ctrl, float).copy())

    def update_target_lane(self, lane):
        self.dev.update_target_lane(lane)
        self.host.update_target_lane(lane)

    def plan(self):
        ok_d, ctrl_d, trees = self.dev.plan()
        ok_h, ctrl_h, _ = self.host.plan()
        state, prev_ctrl = self._pending
        self.records.append({
            "state": state, "prev_ctrl": prev_ctrl,
            "ok_dev": bool(ok_d), "ok_host": bool(ok_h),
            "ctrl_dev": None if ctrl_d is None else np.asarray(ctrl_d, float),
            "ctrl_host": None if ctrl_h is None else np.asarray(ctrl_h, float),
            "n_trees_dev": getattr(self.dev, "last_n_trees", -1),
            "n_trees_host": getattr(self.host, "last_n_trees", -1),
            "n_nodes_dev": getattr(self.dev, "last_n_nodes", -1),
            "n_nodes_host": getattr(self.host, "last_n_nodes", -1),
        })
        return ok_d, ctrl_d, trees


def run_parity_demo_resync(demo: str, max_steps: int,
                           data_root: str = DATA_ROOT,
                           solve_dtype: Optional[str] = None,
                           device=None, scenario=None) -> dict:
    """Per-cycle resynced parity over the full horizon: ONE closed-loop sim
    driven by the device planner, with the float64 mirror planning in
    tandem from identical inputs every cycle. Reports the worst per-cycle
    trajectory deviation = max distance between 5-tick rollouts of the two
    controls from the same state (the deviation one plan cycle contributes
    before the next re-plan corrects it)."""
    from mind_tpu_torch.config import planner_config_for_demo

    pcfg = planner_config_for_demo(demo)
    if solve_dtype is not None:
        pcfg.traj_tree.solve_dtype = solve_dtype
    sim = _demo_sim(demo, max_steps, data_root, pcfg, device, scenario)
    ego = _ego(sim)
    dev_pl = ego.planner
    # the staged (export) path runs the same AIME and solve as the fused and
    # episode paths; run_parity_episode_playback covers the episode
    dev_pl.export_trees = True
    host_pl = _mirror(dev_pl, ego)
    tandem = _TandemPlanner(dev_pl, host_pl)
    ego.planner = tandem

    t0 = time.perf_counter()
    sim.run_sim()
    wall = time.perf_counter() - t0

    vp = ego.veh_param
    dt = sim.config.sim_step
    devs, ctrl_devs = [], []
    for r in tandem.records:
        if not (r["ok_dev"] and r["ok_host"]):
            continue
        devs.append(_rollout_dev(r["state"], r["ctrl_dev"], r["ctrl_host"], dt, vp))
        ctrl_devs.append(float(np.abs(r["ctrl_dev"] - r["ctrl_host"]).max()))

    nan = float("nan")
    return {
        "demo": demo,
        "ticks": sim.metrics["ticks"],
        "plans": len(tandem.records),
        "plans_compared": len(devs),
        "ok_mismatches": sum(1 for r in tandem.records
                             if r["ok_dev"] != r["ok_host"]),
        "max_cycle_dev": float(np.max(devs)) if devs else nan,
        "mean_cycle_dev": float(np.mean(devs)) if devs else nan,
        "max_ctrl_dev": float(np.max(ctrl_devs)) if ctrl_devs else nan,
        "host_failures": host_pl.diagnostics["plan_failures"],
        "wall_s": wall,
    }
