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
  freezes, later cycles do not plan, and the result is cut at the failing
  cycle (reference simulator.py:85-89). The JAX package keeps planning after
  the failure and discards the results; both agree up to and including the
  failing cycle.

With `exec_resolve_mode="native"` the episode, like the JAX package's, runs
no exec re-solve: the control is that of the selection solve.

The JAX package's batched runners (`run_episodes_batched`,
`run_episode_monte_carlo`) and the batched modes of its `episode_fn_for` are
not ported (ROADMAP.md queue A item 3).
"""

from __future__ import annotations

import functools
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from mind_tpu_torch.common.kinematics import kine_propagate
from mind_tpu_torch.ops.potential import CostParams
from mind_tpu_torch.planner.aime_device import DeviceObsBuffer, obs_buffer_update
from mind_tpu_torch.planner.planner import _PhaseClock, fused_plan_core, type_onehot
from mind_tpu_torch.planner.scene_prep import LaneGraphStatic, TargetLaneStatic
from mind_tpu_torch.planner.trajectory_tree import torch_dtype

TICKS_PER_PLAN = 5  # 50 Hz sim / 10 Hz planner (reference agent.py:156-157)

BATCHED_NOT_PORTED = ("the batched episode runners (run_episodes_batched, "
                      "run_episode_monte_carlo) are not ported: ROADMAP.md queue A item 3")


class EpisodeStatics(NamedTuple):
    """Per-scenario device data that is constant over the episode."""

    lane_static: LaneGraphStatic
    tgt_static: TargetLaneStatic
    eval_seg_start: torch.Tensor   # [P-1, 2] selection-lane segments
    eval_seg_end: torch.Tensor     # [P-1, 2]
    eval_seg_mask: torch.Tensor    # [P-1]
    warm_params: CostParams        # field_offset re-centred per cycle
    full_params: CostParams


class EpisodeInputs(NamedTuple):
    """Per-cycle schedule, precomputed on the host (all replay-derived); the
    tensors live on the planner's device."""

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


def _init_episode_carry(A: int, pipeline_dtype=torch.float64, device=None):
    """(observation window, ego state, control, failed). The ego state is
    always float64 (the host loop integrates the ego in host float64,
    reference agent.py:297-300); the window follows the pipeline dtype."""
    return (DeviceObsBuffer.create(A, pipeline_dtype, device),
            torch.zeros(4, dtype=torch.float64, device=device),
            torch.zeros(2, dtype=torch.float32, device=device), False)


_PHASES = ("aime", "cost_topology", "solve", "selection")


@torch.no_grad()
def _run_cycles(inp: EpisodeInputs, st: EpisodeStatics, carry, c0: int, *, core, half, wb,
                max_spd, max_str, dt, phases: Optional[list] = None):
    """Plan cycles c0 .. c0 + len(inp.slot_states) - 1 from `carry`. Returns
    (carry, (rec [Cseg, 5, 4] tensor, ok, planned, iterations [Cseg] numpy,
    ctrls [Cseg, 2] tensor)). With `phases` (a list), each cycle appends its
    wall time per phase in seconds ("obs", the plan's phases, "propagate"),
    each phase ended by a device synchronize, and its AIME rounds."""
    buf, ego, ctrl, failed = carry
    dev = ego.device
    enable = inp.enable_tick
    eval_segs = (st.eval_seg_start, st.eval_seg_end, st.eval_seg_mask)
    recs, oks, planned, iters, ctrls = [], [], [], [], []
    for j in range(inp.slot_states.shape[0]):
        c = c0 + j
        t0 = c * TICKS_PER_PLAN
        rec_c = {"cycle": c} if phases is not None else None
        clock = _PhaseClock(dev, rec_c)
        # the ego's observation: its log up to and including the enable
        # tick, the carried state after
        states = inp.slot_states[j]
        if t0 <= enable:
            ego_obs = states[0]
        else:
            ego_obs = ego
            states = torch.cat([ego[None], states[1:]])
        buf = obs_buffer_update(buf, states, inp.present[j])
        amask = inp.active[j] & inp.present[j]
        ctrl_in = torch.zeros_like(ctrl) if t0 <= enable else ctrl
        clock.lap("obs")

        do_plan = t0 >= enable and not failed
        ok, its, new_ctrl = False, 0.0, ctrl_in
        if do_plan:
            # x0 and the grid origin stay float64 (two_phase_solve casts them
            # to the solve dtype)
            x0 = torch.cat([ego_obs, ctrl_in.to(torch.float64)])
            offset = x0[:2] - half
            report = {} if phases is not None else None
            out = core(buf, inp.types, amask, x0, st.warm_params._replace(field_offset=offset),
                       st.full_params._replace(field_offset=offset), inp.target_vel,
                       st.lane_static, st.tgt_static, eval_segs, report=report)
            small = out.cpu().numpy()   # the cycle's one read of the plan
            # a non-finite control fails the plan, as in the host loop
            ok = bool(small[2] > 0.5 and np.isfinite(small[:2]).all())
            its = float(small[3])
            if ok:
                new_ctrl = out[:2]
            failed = not ok
            if report is not None:
                rec_c.update({k: report[k] for k in _PHASES}, rounds=report["rounds"])
                clock.t = time.perf_counter()   # "propagate" starts after the plan's read

        # 5 ticks of 50 Hz propagation in float64, recording loop-start
        # states; a failed plan freezes the ego
        s = ego
        u = new_ctrl.to(torch.float64)
        rec = []
        for i in range(TICKS_PER_PLAN):
            t = t0 + i
            if t <= enable:
                s = inp.ego_replay[j, i]
            rec.append(s)
            if t >= enable and not failed:
                s = kine_propagate(s, u, dt, wb, max_spd, max_str)
        ego, ctrl = s, new_ctrl
        clock.lap("propagate")
        if phases is not None:
            phases.append(rec_c)
        recs.append(torch.stack(rec))
        oks.append(ok)
        planned.append(do_plan)
        iters.append(its)
        ctrls.append(new_ctrl)
    outs = (torch.stack(recs), np.array(oks), np.array(planned), np.array(iters, np.float32),
            torch.stack(ctrls))
    return (buf, ego, ctrl, failed), outs


def _make_core(planner, veh_param, dt: float):
    cfg = planner.cfg
    ph = cfg.traj_tree.full
    half = 0.5 * (ph.smooth_grid_size[0] - 1) * ph.smooth_grid_res
    core = functools.partial(fused_plan_core, planner.net, cfg=cfg, ilqr_cfg=planner.ilqr_cfg,
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


def _episode_setup(sim, horizon, inputs):
    """Locate the MIND ego, build (or reuse) the schedule, and collect the
    per-scenario statics and the cycle runner."""
    from mind_tpu_torch.sim.agents import MINDAgent

    ego = next(a for a in sim.agents if isinstance(a, MINDAgent))
    pl = ego.planner
    inp = inputs if inputs is not None else build_episode_inputs(sim, horizon)
    carry = _init_episode_carry(inp.types.shape[0], torch_dtype(pl.cfg.pipeline_dtype),
                                pl.device)
    return pl, inp, build_episode_statics(pl), _make_core(pl, ego.veh_param, sim.sim_step), carry


def _outputs_to_host(segs):
    """Concatenate the segments' outputs; the recorded states and controls
    cross to the host here, once."""
    rec = torch.cat([s[0] for s in segs]).cpu().numpy()
    ctrls = torch.cat([s[4] for s in segs]).cpu().numpy()
    ok, planned, iters = (np.concatenate([s[k] for s in segs]) for k in (1, 2, 3))
    return rec, ok, planned, iters, ctrls


def run_episode(sim, horizon: Optional[int] = None, inputs: Optional[EpisodeInputs] = None,
                phases: Optional[list] = None) -> EpisodeResult:
    """Run one scenario's closed loop with its state on the device.

    `sim` must be an initialized Simulator with one MINDAgent ego. The
    returned ego trajectory matches `Simulator.run_sim()` +
    `sim.ego_trajectory()` (tests/test_torch_episode.py holds 1e-3 m).
    `inputs` optionally reuses a schedule from `build_episode_inputs(sim,
    horizon)`; `phases` (a list) receives per-cycle phase times."""
    pl, inp, statics, run, carry = _episode_setup(sim, horizon, inputs)
    _, out = run(inp, statics, carry, 0, phases=phases)
    return _to_result(pl, *_outputs_to_host([out]))


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
    C = int(inp.slot_states.shape[0])
    segs = []
    for s0 in range(0, C, seg_cycles):
        carry, out = run(_slice_cycles(inp, s0, min(s0 + seg_cycles, C)), statics, carry, s0)
        segs.append(out)
    return _to_result(pl, *_outputs_to_host(segs))


def _slice_cycles(inp: EpisodeInputs, s0: int, s1: int) -> EpisodeInputs:
    """The per-cycle fields [C, ...] cut to cycles [s0, s1)."""
    return inp._replace(slot_states=inp.slot_states[s0:s1], present=inp.present[s0:s1],
                        active=inp.active[s0:s1], ego_replay=inp.ego_replay[s0:s1])


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
                    corridor_frac: float = 0.1) -> List[EpisodeInputs]:
    """K perturbed-ego copies of one scenario's episode schedule, one
    EpisodeInputs each (the JAX package stacks them for its batched runner,
    which is not ported; each copy here runs through `run_episode`). The
    ego enables immediately (cycle 0) from a perturbed start state; see
    `perturb_ego_starts` for the noise model."""
    from mind_tpu_torch.sim.agents import MINDAgent

    ego = next(a for a in sim.agents if isinstance(a, MINDAgent))
    pl = ego.planner
    inp = build_episode_inputs(sim, horizon)
    base = inp.ego_replay[0, 0].cpu().numpy()  # local frame
    starts = perturb_ego_starts(base, k, pos_sigma, vel_sigma,
                                pl.cfg.scen_tree.tar_dist_thres, seed, corridor_frac)

    def one(start):
        s = torch.tensor(start, dtype=torch.float64, device=pl.device)
        slot_states, ego_replay = inp.slot_states.clone(), inp.ego_replay.clone()
        slot_states[0, 0] = s
        ego_replay[0, 0] = s
        return inp._replace(slot_states=slot_states, ego_replay=ego_replay, enable_tick=0)

    return [one(starts[i]) for i in range(k)]


def run_episodes_batched(sims, horizon: Optional[int] = None):
    """All scenarios as one batched program: not ported."""
    raise NotImplementedError(BATCHED_NOT_PORTED)


def run_episode_monte_carlo(sim, k: int = 64, **kw):
    """K perturbed-ego episodes batched on the device: not ported."""
    raise NotImplementedError(BATCHED_NOT_PORTED)
