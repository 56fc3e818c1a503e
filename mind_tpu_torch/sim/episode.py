"""The whole closed-loop episode on the device (port of mind_tpu/sim/episode.py).

The JAX package compiles the rollout into one `lax.scan` over plan cycles.
Here the cycles are a Python loop whose state stays on the device: the
observation window, the ego state and its control are tensors carried from
cycle to cycle, each plan is `fused_plan_core` (its tree iLQR one CUDA graph
per iteration on the card), and the 5 ticks of 50 Hz propagation between
plans run as float64 tensor ops. The host reads the plan's 4 numbers once per
planning cycle (besides the reads inside AIME and the solve), and the ego's
recorded states once, at the end.

Exo agents are non-reactive, so their slot states, presence masks and the
observation-buffer slot assignment are known ahead of time and precomputed on
the host (`build_episode_inputs`); only the ego state, its control and the
observation window are carried.

Semantics (those of the JAX package, held by tests/test_torch_episode.py):
- observations recorded at the loop start of each tick (before the update),
  ego in slot 0;
- the observation window updates at every 10 Hz trigger from tick 0; plans
  start once the tick reaches the enable tick (reference agent.py:261-286);
  the host knows that tick, so a cycle before it skips the plan with a Python
  `if` where the JAX package uses `lax.cond`;
- up to and including the enable tick the ego is replayed from its log and
  its control is zero (reference agent.py:208-214 init_state_ctrl);
- between plans the ego integrates the clipped kinematic bicycle at 50 Hz
  with the held control (reference agent.py:297-300);
- a plan failure (no scenario tree, or a non-finite control) latches: the ego
  freezes and the result is cut at the failing cycle (reference
  simulator.py:85-89).

The cycles run L lanes at once, each with its own carry (window, ego,
control, failed latch): S scenarios (`run_episodes_batched`) or K perturbed
copies of one (`run_episode_monte_carlo`), one `batched_plan_core` per
planning cycle for all of them, so the host reads the plan once per cycle
and AIME and the solve read it once per round and per iteration for all
lanes. As in the JAX package the batch always covers every lane: a failed
lane keeps planning in lockstep and its plans are discarded. A single
episode (L = 1) skips the plans after its failure instead; both agree up to
and including the failing cycle.

With `exec_resolve_mode="native"` the episode, like the JAX package's, runs
no exec re-solve: the control is that of the selection solve.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from mind_tpu_torch.common.kinematics import kine_propagate
from mind_tpu_torch.ops.potential import CostParams
from mind_tpu_torch.parallel.mesh import (DistMesh, gather_shards, local_shards, mesh_size,
                                          rank0_decides, tree_map)
from mind_tpu_torch.planner.aime_device import DeviceObsBuffer, obs_buffer_update
from mind_tpu_torch.planner.planner import _PhaseClock, batched_plan_core, type_onehot
from mind_tpu_torch.planner.scene_prep import LaneGraphStatic, TargetLaneStatic
from mind_tpu_torch.planner.trajectory_tree import torch_dtype

TICKS_PER_PLAN = 5  # 50 Hz sim / 10 Hz planner (reference agent.py:156-157)


class EpisodeStatics(NamedTuple):
    """Per-scenario device data that is constant over the episode (with a
    leading scene axis when stacked by run_episodes_batched)."""

    lane_static: LaneGraphStatic
    tgt_static: TargetLaneStatic
    eval_seg_start: torch.Tensor   # [P-1, 2] selection-lane segments
    eval_seg_end: torch.Tensor     # [P-1, 2]
    eval_seg_mask: torch.Tensor    # [P-1]
    warm_params: CostParams        # field_offset re-centred per cycle
    full_params: CostParams


class EpisodeInputs(NamedTuple):
    """Per-cycle schedule, precomputed on the host (all replay-derived); the
    tensors live on the planner's device. Stacked for L lanes, every tensor
    gains a leading lane axis and target_vel becomes a float64 tensor [L]
    where the lanes' differ."""

    slot_states: torch.Tensor  # [C, A, 4] float64 local-frame obs at each trigger tick
    present: torch.Tensor      # [C, A] slot observed at this trigger
    active: torch.Tensor       # [C, A] slot assigned by this trigger
    ego_replay: torch.Tensor   # [C, 5, 4] float64 ego log at ticks t0..t0+4 (local)
    types: torch.Tensor        # [A, 7] float32 one-hot per slot
    enable_tick: int           # first tick with the planner on
    target_vel: float          # selection target velocity, rounded to float32


class EpisodeResult(NamedTuple):
    ego_states: np.ndarray   # [T, 4] loop-start ego states, GLOBAL frame float64
    plan_ok: np.ndarray      # [C] bool (True where a plan ran and succeeded)
    planned: np.ndarray      # [C] bool (a plan ran this cycle)
    iterations: np.ndarray   # [C] iLQR iteration counts
    controls: np.ndarray     # [C, 2] applied [accel, steer] per cycle
    fail_cycle: int          # first failed cycle, or -1
    plan_calls: int


def build_episode_inputs(sim, horizon: Optional[int] = None) -> EpisodeInputs:
    """Precompute the replay/presence schedule from an initialized Simulator
    (exactly the observation stream the host loop would feed the planner)."""
    from mind_tpu_torch.sim.agents import CustomizedAgent, MINDAgent

    egos = [a for a in sim.agents if isinstance(a, MINDAgent)]
    if len(egos) != 1:
        raise ValueError(f"the episode runner takes exactly one MIND ego, got {len(egos)}")
    ego = egos[0]
    pl = ego.planner
    A = pl.cfg.max_actors
    origin = pl.origin
    dt = sim.sim_step
    T = horizon or sim.sim_horizon
    C = T // TICKS_PER_PLAN
    if C * TICKS_PER_PLAN != T:
        raise ValueError(f"horizon {T} is not a multiple of {TICKS_PER_PLAN}")
    enable_tick = int(np.ceil(ego.enable_timestep / dt - 1e-9))

    def log_state(agent, t):
        r = min(t, agent.max_step)
        return np.array([agent.traj_pos[r][0], agent.traj_pos[r][1],
                         agent.traj_vel[r], agent.traj_ang[r]], np.float64)

    exo = [a for a in sim.agents if not isinstance(a, CustomizedAgent)]

    # ObsBuffer's slot assignment: first-seen order over trigger ticks, ego
    # always slot 0, new tracks dropped when the buffer is full
    slots: dict = {}
    types = np.zeros((A, 7), np.float32)

    def assign(track_id, obj_type):
        if track_id in slots:
            return slots[track_id]
        if len(slots) >= A:
            return None
        s = len(slots)
        slots[track_id] = s
        types[s] = type_onehot(obj_type)
        return s

    slot_states = np.zeros((C, A, 4), np.float64)
    present = np.zeros((C, A), bool)
    active = np.zeros((C, A), bool)
    ego_replay = np.zeros((C, TICKS_PER_PLAN, 4), np.float64)

    for c in range(C):
        t0 = c * TICKS_PER_PLAN
        s0 = assign("AV", ego.type)
        slot_states[c, s0] = log_state(ego, t0)
        present[c, s0] = True
        for a in exo:
            r = min(t0, a.max_step)
            if not a.has_flag[r]:
                continue
            s = assign(a.id, a.traj_type[r])
            if s is None:
                continue
            slot_states[c, s] = log_state(a, t0)
            present[c, s] = True
        active[c, : len(slots)] = True
        for i in range(TICKS_PER_PLAN):
            ego_replay[c, i] = log_state(ego, t0 + i)

    slot_states[:, :, :2] -= origin
    ego_replay[:, :, :2] -= origin
    # float64 schedule: the observation stream is the root of the decision
    # pipeline (obs_buffer_update casts it to the window's dtype)
    dev = pl.device
    return EpisodeInputs(
        slot_states=torch.tensor(slot_states, device=dev),
        present=torch.tensor(present, device=dev),
        active=torch.tensor(active, device=dev),
        ego_replay=torch.tensor(ego_replay, device=dev),
        types=torch.tensor(types, device=dev),
        enable_tick=enable_tick,
        target_vel=float(np.float32(ego.lcl_smp.target_velocity)),
    )


def build_episode_statics(planner) -> EpisodeStatics:
    """Collect one planner's per-scenario device statics as episode data."""
    warm_p, full_p = planner._cost_params()
    ev_s, ev_e, ev_m = planner._eval_segs
    return EpisodeStatics(lane_static=planner.lane_static, tgt_static=planner.tgt_static,
                          eval_seg_start=ev_s, eval_seg_end=ev_e, eval_seg_mask=ev_m,
                          warm_params=warm_p, full_params=full_p)


def _init_episode_carry(A: int, pipeline_dtype=torch.float64, device=None, lanes: int = 1):
    """(observation windows, ego states, controls, failed latches) of L
    lanes. The ego state is always float64 (the host loop integrates the ego
    in host float64, reference agent.py:297-300); the window follows the
    pipeline dtype. The latches live on the host: the cycle reads its plan's
    result there anyway."""
    buf = DeviceObsBuffer.create(A, pipeline_dtype, device)
    return (DeviceObsBuffer(*(x[None].repeat((lanes,) + (1,) * x.dim()) for x in buf)),
            torch.zeros((lanes, 4), dtype=torch.float64, device=device),
            torch.zeros((lanes, 2), dtype=torch.float32, device=device),
            np.zeros(lanes, bool))


_PHASES = ("aime", "cost_topology", "solve", "selection")
# the EpisodeInputs fields that gain the lane axis when stacked
_LANE_FIELDS = ("slot_states", "present", "active", "ego_replay", "types")


@torch.no_grad()
def _run_cycles(inp: EpisodeInputs, st: EpisodeStatics, carry, c0: int, *, core, half, wb,
                max_spd, max_str, dt, phases: Optional[list] = None):
    """Plan cycles c0 .. c0 + Cseg - 1 of L lanes from `carry`: inp fields
    [L, Cseg, ...] (types [L, A, 7]), statics with the lane axis (the
    CostParams leaves shared or [L, ...]). Returns (carry, (rec [L, Cseg,
    5, 4] tensor, ok, planned, iterations [L, Cseg] numpy, ctrls [L, Cseg,
    2] tensor)). With `phases` (a list), each cycle appends its wall time
    per phase in seconds ("obs", the plan's phases, "propagate"), each phase
    ended by a device synchronize, its AIME rounds and each lane's selected
    tree ("best")."""
    buf, ego, ctrl, failed = carry
    failed = failed.copy()
    L = ego.shape[0]
    dev = ego.device
    enable = inp.enable_tick
    eval_segs = (st.eval_seg_start, st.eval_seg_end, st.eval_seg_mask)
    recs, oks, planned, iters, ctrls = [], [], [], [], []
    for j in range(inp.slot_states.shape[1]):
        c = c0 + j
        t0 = c * TICKS_PER_PLAN
        rec_c = {"cycle": c} if phases is not None else None
        clock = _PhaseClock(dev, rec_c)
        # the ego's observation: its log up to and including the enable
        # tick, the carried state after
        states = inp.slot_states[:, j]
        if t0 > enable:
            states = torch.cat([ego[:, None], states[:, 1:]], dim=1)
        ego_obs = states[:, 0]
        buf = obs_buffer_update(buf, states, inp.present[:, j])
        amask = inp.active[:, j] & inp.present[:, j]
        ctrl_in = torch.zeros_like(ctrl) if t0 <= enable else ctrl
        clock.lap("obs")

        do_plan = ~failed if t0 >= enable else np.zeros(L, bool)
        ok, its, new_ctrl = np.zeros(L, bool), np.zeros(L), ctrl_in
        # one lane stops planning after its failure; a batch plans all lanes
        plan_now = bool(do_plan[0]) if L == 1 else t0 >= enable
        if plan_now:
            # x0 and the grid origin stay float64 (two_phase_solve casts them
            # to the solve dtype)
            x0 = torch.cat([ego_obs, ctrl_in.to(torch.float64)], dim=-1)
            offset = x0[:, :2] - half
            report = {} if phases is not None else None
            out = core(buf, inp.types, amask, x0, st.warm_params._replace(field_offset=offset),
                       st.full_params._replace(field_offset=offset), inp.target_vel,
                       st.lane_static, st.tgt_static, eval_segs, report=report)
            small = out.cpu().numpy()   # the cycle's one read of the plans
            # a non-finite control fails the plan, as in the host loop
            ok = (small[:, 2] > 0.5) & np.isfinite(small[:, :2]).all(-1)
            its = small[:, 3].astype(np.float64)
            take = do_plan & ok
            if take.any():
                new_ctrl = torch.where(torch.as_tensor(take, device=dev)[:, None], out[:, :2],
                                       ctrl_in)
            failed = failed | (do_plan & ~ok)
            if report is not None:
                rec_c.update({k: report[k] for k in _PHASES}, rounds=report["rounds"],
                             best=report["best"])
                clock.t = time.perf_counter()   # "propagate" starts after the plan's read

        # 5 ticks of 50 Hz propagation in float64, recording loop-start
        # states; a failed lane's ego freezes
        s = ego
        u = new_ctrl.to(torch.float64)
        frozen = torch.as_tensor(failed, device=dev)[:, None] if failed.any() else None
        rec = []
        for i in range(TICKS_PER_PLAN):
            t = t0 + i
            if t <= enable:
                s = inp.ego_replay[:, j, i]
            rec.append(s)
            if t >= enable and not failed.all():
                s_next = kine_propagate(s, u, dt, wb, max_spd, max_str)
                s = s_next if frozen is None else torch.where(frozen, s, s_next)
        ego, ctrl = s, new_ctrl
        clock.lap("propagate")
        if phases is not None:
            phases.append(rec_c)
        recs.append(torch.stack(rec, dim=1))
        oks.append(ok)
        planned.append(do_plan)
        iters.append(its)
        ctrls.append(new_ctrl)
    outs = (torch.stack(recs, dim=1), np.stack(oks, 1), np.stack(planned, 1),
            np.stack(iters, 1).astype(np.float32), torch.stack(ctrls, dim=1))
    return (buf, ego, ctrl, failed), outs


def _make_core(planner, veh_param, dt: float):
    cfg = planner.cfg
    ph = cfg.traj_tree.full
    half = 0.5 * (ph.smooth_grid_size[0] - 1) * ph.smooth_grid_res
    core = functools.partial(batched_plan_core, planner.net, cfg=cfg, ilqr_cfg=planner.ilqr_cfg,
                             warm_ilqr_cfg=planner.warm_ilqr_cfg, weights=planner._weights)
    return functools.partial(_run_cycles, core=core, half=half, wb=veh_param.wb,
                             max_spd=veh_param.max_spd, max_str=veh_param.max_str, dt=dt)


def _to_result(pl, rec, ok, planned, iters, ctrls) -> EpisodeResult:
    rec = np.array(rec, np.float64).reshape(-1, 4)
    rec[:, :2] += pl.origin
    ok = np.asarray(ok)
    planned = np.asarray(planned)
    failed = planned & ~ok
    fail_cycle = int(np.argmax(failed)) if failed.any() else -1
    if fail_cycle >= 0:
        # cut at the failing cycle, as the reference's loop terminates on a
        # plan failure (simulator.py:85-89): the frozen frames after it are
        # neither trajectory nor simulated steps
        rec = rec[: (fail_cycle + 1) * TICKS_PER_PLAN]
    return EpisodeResult(
        ego_states=rec, plan_ok=ok, planned=planned, iterations=np.asarray(iters),
        controls=np.asarray(ctrls), fail_cycle=fail_cycle,
        plan_calls=int(planned.sum()) if fail_cycle < 0
        else int(planned[: fail_cycle + 1].sum()),
    )


def _lanes(inp: EpisodeInputs) -> EpisodeInputs:
    """One episode's schedule as a batch of one lane."""
    return inp._replace(**{f: getattr(inp, f)[None] for f in
                           _LANE_FIELDS})


def _shared_statics(st: EpisodeStatics, L: int) -> EpisodeStatics:
    """One scenario's statics for L lanes that share them: broadcast views
    of the lane graph, target lane and evaluation lane; the CostParams stay
    shared."""
    ex = lambda t: t[None].expand((L,) + t.shape)
    tgt = st.tgt_static
    return st._replace(lane_static=type(st.lane_static)(*(ex(x) for x in st.lane_static)),
                       tgt_static=tgt._replace(points=ex(tgt.points), info=ex(tgt.info),
                                               mask=ex(tgt.mask)),
                       eval_seg_start=ex(st.eval_seg_start), eval_seg_end=ex(st.eval_seg_end),
                       eval_seg_mask=ex(st.eval_seg_mask))


def _episode_setup(sim, horizon, inputs):
    """Locate the MIND ego, build (or reuse) the schedule, and collect the
    per-scenario statics (as one lane) and the cycle runner."""
    from mind_tpu_torch.sim.agents import MINDAgent

    ego = next(a for a in sim.agents if isinstance(a, MINDAgent))
    pl = ego.planner
    inp = inputs if inputs is not None else build_episode_inputs(sim, horizon)
    carry = _init_episode_carry(inp.types.shape[-2], torch_dtype(pl.cfg.pipeline_dtype),
                                pl.device)
    return (pl, _lanes(inp), _shared_statics(build_episode_statics(pl), 1),
            _make_core(pl, ego.veh_param, sim.sim_step), carry)


def _outputs_to_host(segs):
    """Concatenate the segments' outputs along the cycles; the recorded
    states and controls cross to the host here, once."""
    rec = torch.cat([s[0] for s in segs], dim=1).cpu().numpy()
    ctrls = torch.cat([s[4] for s in segs], dim=1).cpu().numpy()
    ok, planned, iters = (np.concatenate([s[k] for s in segs], axis=1) for k in (1, 2, 3))
    return rec, ok, planned, iters, ctrls


def _lane_result(pl, outs, i: int) -> EpisodeResult:
    return _to_result(pl, *(o[i] for o in outs))


def run_episode(sim, horizon: Optional[int] = None, inputs: Optional[EpisodeInputs] = None,
                phases: Optional[list] = None) -> EpisodeResult:
    """Run one scenario's closed loop with its state on the device.

    `sim` must be an initialized Simulator with one MINDAgent ego. The
    returned ego trajectory matches `Simulator.run_sim()` +
    `sim.ego_trajectory()` (tests/test_torch_episode.py holds 1e-3 m).
    `inputs` optionally reuses a schedule from `build_episode_inputs(sim,
    horizon)` (or one copy's of `build_mc_inputs`, taken with
    `lane_inputs`); `phases` (a list) receives per-cycle phase times."""
    pl, inp, statics, run, carry = _episode_setup(sim, horizon, inputs)
    _, out = run(inp, statics, carry, 0, phases=phases)
    return _lane_result(pl, _outputs_to_host([out]), 0)


def run_episode_timed(sim, horizon: Optional[int] = None, phases: Optional[list] = None):
    """(result, wall_s): the first call absorbs warm-up (kernel builds, CUDA
    graph captures, allocator), the second is timed. `phases` goes to the
    timed call."""
    inp = build_episode_inputs(sim, horizon)
    run_episode(sim, horizon, inputs=inp)
    t0 = time.perf_counter()
    res = run_episode(sim, horizon, inputs=inp, phases=phases)
    return res, time.perf_counter() - t0


def run_episode_segmented(sim, horizon: Optional[int] = None, seg_cycles: int = 10,
                          inputs: Optional[EpisodeInputs] = None) -> EpisodeResult:
    """`run_episode` in segments of `seg_cycles` cycles with the carry
    handed from one to the next: the same cycles on the same data, so the
    same result to the bit."""
    if seg_cycles < 1:
        raise ValueError(f"seg_cycles must be >= 1, got {seg_cycles}")
    pl, inp, statics, run, carry = _episode_setup(sim, horizon, inputs)
    return _lane_result(pl, _run_segments(run, inp, statics, carry, seg_cycles), 0)


def _run_segments(run, inp, statics, carry, seg_cycles: int, phases=None):
    """All cycles of `inp` in segments of `seg_cycles`; host outputs."""
    C = int(inp.slot_states.shape[1])
    segs = []
    for s0 in range(0, C, seg_cycles):
        carry, out = run(_slice_cycles(inp, s0, min(s0 + seg_cycles, C)), statics, carry, s0,
                         phases=phases)
        segs.append(out)
    return _outputs_to_host(segs)


def _slice_cycles(inp: EpisodeInputs, s0: int, s1: int) -> EpisodeInputs:
    """The per-cycle fields [L, C, ...] cut to cycles [s0, s1)."""
    return inp._replace(**{f: getattr(inp, f)[:, s0:s1] for f in
                           ("slot_states", "present", "active", "ego_replay")})


def _slice_lanes(inp: EpisodeInputs, lo: int, hi: int) -> EpisodeInputs:
    """Lanes [lo, hi) of a stacked schedule."""
    tv = inp.target_vel
    return inp._replace(**{f: getattr(inp, f)[lo:hi] for f in
                           _LANE_FIELDS},
                        target_vel=tv[lo:hi] if isinstance(tv, torch.Tensor) else tv)


def lane_inputs(inp: EpisodeInputs, i: int) -> EpisodeInputs:
    """Lane i of a stacked schedule as one episode's (for run_episode)."""
    tv = inp.target_vel
    return inp._replace(**{f: getattr(inp, f)[i] for f in
                           _LANE_FIELDS},
                        target_vel=float(tv[i]) if isinstance(tv, torch.Tensor) else tv)


def _stack(items, device):
    """NamedTuples -> one whose tensor leaves are stacked on a new leading
    axis. A non-tensor leaf stays as it is where all items agree, and
    becomes a tensor [N] (long for ints, float64 else) where they differ."""
    first = items[0]
    out = []
    for vals in zip(*items):
        v0 = vals[0]
        if isinstance(v0, torch.Tensor):
            out.append(torch.stack(vals))
        elif isinstance(v0, tuple):
            out.append(_stack(list(vals), device))
        elif all(v == v0 for v in vals):
            out.append(v0)
        else:
            dtype = torch.long if isinstance(v0, int) else torch.float64
            out.append(torch.tensor(vals, dtype=dtype, device=device))
    return tuple(out) if type(first) is tuple else type(first)(*out)


def perturb_ego_starts(base, k: int, pos_sigma: float, vel_sigma: float,
                       tar_dist_thres: float, seed: int,
                       corridor_frac: float = 0.1) -> np.ndarray:
    """Corridor-respecting perturbed ego start states [K, 4] (x, y, v, yaw).

    Position noise is split into lane-frame components: sigma_long along the
    heading, and a lateral sigma capped at `corridor_frac * tar_dist_thres`
    so the perturbation respects the corridor the reference's target-lane
    prune enforces (reference scenario_tree.py:373-379)."""
    rng = np.random.default_rng(seed)
    base = np.asarray(base, np.float64)
    yaw = base[3]
    lat_sigma = min(pos_sigma, corridor_frac * tar_dist_thres)
    d_long = rng.normal(0.0, pos_sigma, k)
    d_lat = rng.normal(0.0, lat_sigma, k)
    dx = d_long * np.cos(yaw) - d_lat * np.sin(yaw)
    dy = d_long * np.sin(yaw) + d_lat * np.cos(yaw)
    dv = rng.normal(0.0, vel_sigma, k)

    starts = np.tile(base, (k, 1))
    starts[:, 0] += dx
    starts[:, 1] += dy
    starts[:, 2] = np.maximum(starts[:, 2] + dv, 0.0)
    return starts


def build_mc_inputs(sim, k: int, pos_sigma: float = 0.5, vel_sigma: float = 0.25,
                    seed: int = 0, horizon: Optional[int] = None,
                    corridor_frac: float = 0.1) -> EpisodeInputs:
    """K perturbed-ego copies of one scenario's episode schedule, stacked
    on a leading copy axis (the JAX package's `_stack`). The ego enables
    immediately (cycle 0) from a perturbed start state; see
    `perturb_ego_starts` for the noise model. `lane_inputs` takes one copy
    out."""
    from mind_tpu_torch.sim.agents import MINDAgent

    ego = next(a for a in sim.agents if isinstance(a, MINDAgent))
    pl = ego.planner
    inp = build_episode_inputs(sim, horizon)
    base = inp.ego_replay[0, 0].cpu().numpy()  # local frame
    starts = perturb_ego_starts(base, k, pos_sigma, vel_sigma,
                                pl.cfg.scen_tree.tar_dist_thres, seed, corridor_frac)
    s = torch.tensor(starts, dtype=torch.float64, device=pl.device)
    rep = lambda t: t[None].repeat((k,) + (1,) * t.dim())
    slot_states, ego_replay = rep(inp.slot_states), rep(inp.ego_replay)
    slot_states[:, 0, 0] = s
    ego_replay[:, 0, 0] = s
    return inp._replace(slot_states=slot_states, ego_replay=ego_replay, present=rep(inp.present),
                        active=rep(inp.active), types=rep(inp.types), enable_tick=0)


def _baked_signature(pl, ego, sim) -> str:
    """What batched_plan_core takes from the first lane's planner for every
    lane: selection weights, grid half size, solver settings, network,
    shapes, vehicle and step. Per-scenario cost weights and targets are
    statics data."""
    ph = pl.cfg.traj_tree.full
    return json.dumps({
        "weights": list(pl._weights),
        "half": 0.5 * (ph.smooth_grid_size[0] - 1) * ph.smooth_grid_res,
        "ilqr": list(pl.ilqr_cfg), "warm": list(pl.warm_ilqr_cfg),
        "cfg": {k: v for k, v in dataclasses.asdict(pl.cfg).items()
                if k in ("net", "scen_tree", "max_actors", "max_lanes", "pipeline_dtype")},
        "traj_tree": {k: v for k, v in dataclasses.asdict(pl.cfg.traj_tree).items()
                      if k not in ("warm", "full")},
        "veh": [ego.veh_param.wb, ego.veh_param.max_spd, ego.veh_param.max_str],
        "dt": sim.sim_step, "device": str(pl.device),
    }, sort_keys=True, default=str)


def run_episodes_batched(sims, horizon: Optional[int] = None,
                         phases: Optional[list] = None) -> List[EpisodeResult]:
    """All S scenarios' closed loops as one batch of S lanes: one
    batched_plan_core per planning cycle, the trees of all scenarios in one
    solve (the JAX package's "4 demos as one batched rollout").

    The sims must share the enable tick, every configuration value the
    batched core takes from the first planner (`_baked_signature`), and the
    network weights; each scenario keeps its own statics and cost
    parameters. `phases` receives the per-cycle phase times of the batch."""
    from mind_tpu_torch.sim.agents import MINDAgent

    egos = [next(a for a in s.agents if isinstance(a, MINDAgent)) for s in sims]
    pls = [e.planner for e in egos]
    inps = [build_episode_inputs(s, horizon) for s in sims]
    ticks = {i.enable_tick for i in inps}
    if len(ticks) != 1:
        raise ValueError(f"the egos must share the enable tick, got {sorted(ticks)}")
    sigs = {_baked_signature(p, e, s) for p, e, s in zip(pls, egos, sims)}
    if len(sigs) != 1:
        raise ValueError("the scenarios' planners differ in a configuration value the batched "
                         "plan takes from the first one")
    # the batch plans every scenario with the first planner's network, so
    # the weights must be the same
    ref = pls[0].net.state_dict()
    for i, p in enumerate(pls[1:], 1):
        if p.net is not pls[0].net and not all(
                torch.equal(t, ref[k]) for k, t in p.net.state_dict().items()):
            raise ValueError(f"scenario {i}'s planner holds other network weights than "
                             f"scenario 0's; run it through run_episode instead")
    dev = pls[0].device
    inp = _stack(inps, dev)
    statics = _stack([build_episode_statics(p) for p in pls], dev)
    run = _make_core(pls[0], egos[0].veh_param, sims[0].sim_step)
    carry = _init_episode_carry(inp.types.shape[-2], torch_dtype(pls[0].cfg.pipeline_dtype),
                                dev, len(sims))
    _, out = run(inp, statics, carry, 0, phases=phases)
    outs = _outputs_to_host([out])
    return [_lane_result(pls[i], outs, i) for i in range(len(sims))]


def run_episode_monte_carlo(sim, k: int = 64, pos_sigma: float = 0.5,
                            vel_sigma: float = 0.25, seed: int = 0,
                            horizon: Optional[int] = None, chunk: int = 4,
                            seg_cycles: int = 10, deadline: Optional[float] = None,
                            mesh=None, chunk_walls: Optional[list] = None,
                            phases: Optional[list] = None) -> List[EpisodeResult]:
    """K Monte-Carlo perturbed closed-loop episodes of one scenario, in
    chunks of `chunk` copies planned as one batch (lanes sharing the
    scenario's statics and cost parameters, each with its own grid origin).

    Each chunk runs in segments of `seg_cycles` cycles with the carry handed
    on: the same result to the bit for any segment length. `deadline`
    (epoch seconds) bounds the sweep: no new chunk starts past it, and the
    copies done are returned. `chunk_walls`, if given, receives one (lo, hi,
    wall_s) per chunk, and `phases` the per-cycle records of run_episode's,
    one per cycle of each chunk (and shard this process runs) in turn.

    `mesh` splits each chunk of `chunk` copies per shard into one shard of
    `chunk` copies per mesh shard (parallel/mesh.py). On a `Mesh` each
    shard is planned on its device with its own replica of the network, one
    after another. On a `DistMesh` every rank builds the same K perturbed
    starts from the seed, plans its own shard of each chunk on its device
    (`sim` built there) at the same time as the others, and gets every
    copy's result, in copy order; rank 0 decides the deadline for all, so
    every rank stops at the same chunk. `chunk_walls` and `phases` are each
    rank's own."""
    from mind_tpu_torch.sim.agents import MINDAgent

    if seg_cycles < 1:
        raise ValueError(f"seg_cycles must be >= 1, got {seg_cycles}")
    ego = next(a for a in sim.agents if isinstance(a, MINDAgent))
    pl = ego.planner
    inp_b = build_mc_inputs(sim, k, pos_sigma, vel_sigma, seed, horizon)
    A = inp_b.types.shape[-2]
    pdt = torch_dtype(pl.cfg.pipeline_dtype)
    if mesh is None:
        n_shards, shards = 1, [(0, pl.device)]
    else:
        n_shards, shards = mesh_size(mesh), local_shards(mesh)
        if isinstance(mesh, DistMesh) and not _same_device(mesh.device, pl.device):
            raise ValueError(f"rank {mesh.rank} runs on {mesh.device}, its planner on {pl.device}")
    chunk = chunk * n_shards
    runs = {}
    for _, d in shards:
        if d not in runs:   # one runner per distinct device
            p = pl if _same_device(d, pl.device) else _planner_on(pl, d)
            runs[d] = (p, _make_core(p, ego.veh_param, sim.sim_step), build_episode_statics(p))
    results: List[EpisodeResult] = []
    for lo in range(0, k, chunk):
        if rank0_decides(mesh, deadline is not None and results and time.time() > deadline):
            break
        t_chunk = time.perf_counter()
        hi = min(lo + chunk, k)
        if (hi - lo) % n_shards:
            raise ValueError(f"a chunk of {hi - lo} copies does not divide over "
                             f"{n_shards} devices; pick k and chunk multiples of the mesh size")
        per = (hi - lo) // n_shards
        parts = []
        for i, d in shards:
            p, run, st = runs[d]
            inp = tree_map(lambda x: x.to(d), _slice_lanes(inp_b, lo + i * per, lo + (i + 1) * per))
            carry = _init_episode_carry(A, pdt, d, per)
            outs = _run_segments(run, inp, _shared_statics(st, per), carry, seg_cycles, phases)
            parts.append([_lane_result(p, outs, j) for j in range(per)])
        results.extend(parts[0] if mesh is None else gather_shards(mesh, parts))
        if chunk_walls is not None:
            chunk_walls.append((lo, hi, time.perf_counter() - t_chunk))
    return results


def _same_device(a, b) -> bool:
    a, b = torch.device(a), torch.device(b)
    index = lambda d: d.index if d.index is not None else (
        torch.cuda.current_device() if d.type == "cuda" else 0)
    return a.type == b.type and index(a) == index(b)


def _planner_on(pl, device):
    """A copy of the planner whose network and device statics live on
    `device` (the episode reads net, statics, cost parameters and origin)."""
    import copy

    p = copy.copy(pl)
    p.device = torch.device(device)
    p.net = copy.deepcopy(pl.net).to(device)
    p.lane_static, p.tgt_static, p._eval_segs, p._cost_params_cache = tree_map(
        lambda x: x.to(device), (pl.lane_static, pl.tgt_static, pl._eval_segs, pl._cost_params()))
    return p
