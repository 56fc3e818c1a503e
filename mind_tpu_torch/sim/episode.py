"""The whole closed-loop episode on the device (port of mind_tpu/sim/episode.py).

The JAX package compiles the rollout into one `lax.scan` over plan cycles,
`episode_fn_for(planner, veh_param, dt, batch)` in four modes. The port's
`episode_fn_for` takes the same modes and runs the cycles of L lanes from
state on the device. One cycle (`_Cycles.cycle`) holds the observation
update, the plan under `graph_control.device_if` on the enable tick, the
failure latch, the 5 ticks of 50 Hz propagation in float64 and the writes
into preallocated [L, C, ...] output buffers, with the cycle index and the
enable tick in device scalars: it reads no host value.

- On the card it is captured once into a CUDA graph
  (`graph_control.GraphProgram`): AIME's rounds are IF nodes and the iLQR
  loops WHILE nodes inside the plan's IF node, their conditions set on the
  device. The host enqueues a segment's replays (with every host
  synchronization an error: torch.cuda.set_sync_debug_mode) and reads the
  outputs once at the segment's end, where the JAX package's segmented
  modes return. A capture that fails raises.
- With `graphed=False`, on the CPU, or with `phases=` (per-phase times need
  a device synchronize each), the same cycle runs eagerly: one host read
  for the enable, one per AIME round and one per solve iteration (on the
  card each iteration a replayed CUDA graph of its own, planner/ilqr.py).

Exo agents are non-reactive, so their slot states, presence masks and the
observation-buffer slot assignment are known ahead of time and precomputed on
the host (`build_episode_inputs`); only the ego state, its control, the
observation window and the failure latch are carried.

Semantics (those of the JAX package's compiled program, held by
tests/test_torch_episode.py and test_torch_episode_program.py):
- observations recorded at the loop start of each tick (before the update),
  ego in slot 0;
- the observation window updates at every 10 Hz trigger from tick 0; plans
  run once the tick reaches the enable tick (reference agent.py:261-286);
- up to and including the enable tick the ego is replayed from its log and
  its control is zero (reference agent.py:208-214 init_state_ctrl);
- between plans the ego integrates the clipped kinematic bicycle at 50 Hz
  with the held control (reference agent.py:297-300);
- a plan failure (no scenario tree, or a non-finite control) latches: the
  lane, a single episode included, keeps planning in lockstep with its plans
  discarded, its ego freezes, and the result is cut at the failing cycle
  (reference simulator.py:85-89).

With `exec_resolve_mode="native"` the episode, like the JAX package's, runs
no exec re-solve: the control is that of the selection solve.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from mind_tpu_torch.common.kinematics import kine_propagate
from mind_tpu_torch.ops import graph_control
from mind_tpu_torch.ops.potential import CostParams
from mind_tpu_torch.parallel.mesh import (DistMesh, gather_shards, local_shards, mesh_size,
                                          rank0_decides, tree_map)
from mind_tpu_torch.planner.aime_device import DeviceObsBuffer, obs_buffer_update
from mind_tpu_torch.planner.planner import _PhaseClock, batched_plan_core, type_onehot
from mind_tpu_torch.planner.programs import ProgramNet, config_signature, signature
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


def _init_episode_carry(A: int, pipeline_dtype=torch.float64, device=None,
                        lanes: Optional[int] = None):
    """(observation window, ego state, control, failed latch) of one
    episode, or of L lanes with a leading lane axis, all on the device. The
    ego state is always float64 (the host loop integrates the ego in host
    float64, reference agent.py:297-300); the window follows the pipeline
    dtype."""
    buf = DeviceObsBuffer.create(A, pipeline_dtype, device)
    carry = (buf, torch.zeros(4, dtype=torch.float64, device=buf.pos.device),
             torch.zeros(2, dtype=torch.float32, device=buf.pos.device),
             torch.zeros((), dtype=torch.bool, device=buf.pos.device))
    if lanes is None:
        return carry
    return tree_map(lambda x: x[None].repeat((lanes,) + (1,) * x.dim()), carry)


_PHASES = ("aime", "cost_topology", "solve", "selection")
# the EpisodeInputs fields with a cycle axis, and those that gain the lane axis when stacked
_CYCLE_FIELDS = ("slot_states", "present", "active", "ego_replay")
_LANE_FIELDS = _CYCLE_FIELDS + ("types",)


class _Data(NamedTuple):
    """What the cycles of L lanes read: the schedule [L, C, ...], the slot
    types, the selection target velocities [L] (float64) and the statics
    with the lane axis (tgt_static.n_points a long tensor [L]): all
    tensors, so that a captured cycle reads them from its own buffers."""

    slot_states: torch.Tensor
    present: torch.Tensor
    active: torch.Tensor
    ego_replay: torch.Tensor
    types: torch.Tensor
    target_vel: torch.Tensor
    statics: EpisodeStatics


def _lane_data(inp: EpisodeInputs, st: EpisodeStatics) -> _Data:
    L, dev = inp.types.shape[0], inp.types.device
    as_lanes = lambda v, dtype: (v.to(dtype) if isinstance(v, torch.Tensor)
                                 else torch.full((L,), v, dtype=dtype, device=dev))
    tgt = st.tgt_static
    st = st._replace(tgt_static=tgt._replace(n_points=as_lanes(tgt.n_points, torch.long)))
    return _Data(*(getattr(inp, f) for f in _LANE_FIELDS),
                 target_vel=as_lanes(inp.target_vel, torch.float64), statics=st)


class _Cycles:
    """The plan cycles of L lanes, computed in place on buffers allocated
    once: the schedule of up to `cap` cycles, the lanes' data and statics,
    the carry, the plan's output and the outputs [L, cap, ...], with the
    cycle index `c`, the position `j` in the buffers and the enable tick as
    long scalars on the device, so that `cycle` reads nothing from the host
    and can be captured whole (`run(compiled=True)`). A compiled one plans
    with a network of its own whose weights each run copies from the
    caller's where they changed (planner/programs.py::ProgramNet; weights
    are data, as the JAX program's params: one program serves every
    planner of its configuration). `rounds` counts the AIME
    rounds its cycles ran, on the device."""

    def __init__(self, fn: "_EpisodeFn", net: Optional[ProgramNet], data: _Data, carry,
                 cap: int):
        dev = data.types.device
        L = data.types.shape[0]
        # a compiled one's own network (ProgramNet); eager cycles plan with
        # the caller's
        self.fn, self.net, self.device, self.cap = fn, net, dev, cap
        self.plan_net = None
        zeros = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device=dev)
        sched = {f: zeros(L, cap, *getattr(data, f).shape[2:], dtype=getattr(data, f).dtype)
                 for f in _CYCLE_FIELDS}
        self.data = graph_control.empty_like(data)._replace(**sched)
        self.carry = graph_control.empty_like(carry)
        self.c, self.j, self.enable, self.rounds = (zeros(dtype=torch.long) for _ in range(4))
        self.out = zeros(L, 4)
        self.rec = zeros(L, cap, TICKS_PER_PLAN, 4, dtype=torch.float64)
        self.ok, self.planned = zeros(L, cap, dtype=torch.bool), zeros(L, cap, dtype=torch.bool)
        self.iters, self.ctrls = zeros(L, cap), zeros(L, cap, 2)
        self.program = None

    def load(self, data: _Data, carry, c0: int, enable: int):
        C = data.slot_states.shape[1]
        for f in _CYCLE_FIELDS:
            getattr(self.data, f)[:, :C].copy_(getattr(data, f))
        graph_control.assign(self.data[len(_CYCLE_FIELDS):], data[len(_CYCLE_FIELDS):])
        graph_control.assign(self.carry, carry)
        self.c.fill_(c0)
        self.j.zero_()
        self.enable.fill_(enable)

    def cycle(self, phase_rec: Optional[dict] = None):
        """One plan cycle of every lane, in place. With `phase_rec` (eager
        only) it records the cycle's wall time per phase ("obs", the plan's
        phases, "propagate"), each phase ended by a device synchronize, its
        AIME rounds and each lane's selected tree ("best")."""
        fn, d, st = self.fn, self.data, self.data.statics
        buf, ego, ctrl, failed = self.carry
        clock = _PhaseClock(self.device, phase_rec)
        t0 = self.c * TICKS_PER_PLAN
        at = lambda x: x.index_select(1, self.j.reshape(1))[:, 0]
        states, present, active, ego_rep = (at(getattr(d, f)) for f in _CYCLE_FIELDS)
        # the ego's observation: its log up to and including the enable
        # tick, the carried state after
        replay = t0 <= self.enable
        ego_obs = torch.where(replay, states[:, 0], ego)
        states = torch.cat([ego_obs[:, None], states[:, 1:]], dim=1)
        graph_control.assign(buf, obs_buffer_update(buf, states, present))
        amask = active & present
        ctrl_in = torch.where(replay, torch.zeros_like(ctrl), ctrl)
        clock.lap("obs")

        # x0 and the grid origin stay float64 (two_phase_solve casts them to
        # the solve dtype)
        x0 = torch.cat([ego_obs, ctrl_in.to(torch.float64)], dim=-1)
        offset = x0[:, :2] - fn.half
        report = {} if phase_rec is not None else None
        out = self.out
        out.zero_()

        def plan():
            out.copy_(fn.core(
                self.plan_net, buf, d.types, amask, x0,
                st.warm_params._replace(field_offset=offset),
                st.full_params._replace(field_offset=offset), d.target_vel, st.lane_static,
                st.tgt_static, (st.eval_seg_start, st.eval_seg_end, st.eval_seg_mask),
                report=report, rounds_out=self.rounds))

        enabled = t0 >= self.enable
        graph_control.device_if(enabled, plan)    # lax.cond on the enable tick
        do_plan = enabled & ~failed
        # a non-finite control fails the plan, as in the host loop
        ok = (out[:, 2] > 0.5) & torch.isfinite(out[:, :2]).all(-1)
        new_ctrl = torch.where((do_plan & ok)[:, None], out[:, :2], ctrl_in)
        failed.copy_(failed | (do_plan & ~ok))
        if report:
            phase_rec.update({k: report[k] for k in _PHASES}, rounds=report["rounds"],
                             best=report["best"])
            clock.t = time.perf_counter()   # "propagate" starts after the plan

        # 5 ticks of 50 Hz propagation in float64, recording loop-start
        # states; a failed lane's ego freezes
        s, u = ego, new_ctrl.to(torch.float64)
        moving = ~failed[:, None]
        recs = []
        for i in range(TICKS_PER_PLAN):
            t = t0 + i
            s = torch.where(t <= self.enable, ego_rep[:, i], s)
            recs.append(s)
            s = torch.where((t >= self.enable) & moving,
                            kine_propagate(s, u, fn.dt, fn.wb, fn.max_spd, fn.max_str), s)
        j = self.j.reshape(1)
        self.rec.index_copy_(1, j, torch.stack(recs, dim=1)[:, None])
        for buf_out, val in ((self.ok, ok), (self.planned, do_plan), (self.iters, out[:, 3]),
                             (self.ctrls, new_ctrl)):
            buf_out.index_copy_(1, j, val[:, None])
        ego.copy_(s)
        ctrl.copy_(new_ctrl)
        self.c.add_(1)
        self.j.add_(1)
        clock.lap("propagate")

    def run(self, net, data: _Data, carry, c0: int, enable: int, compiled: bool,
            phases: Optional[list] = None):
        """Cycles c0 .. c0 + C - 1 of `data` ([L, C, ...]) from `carry` with
        `net`'s weights: captured replays (the first call captures) or
        eager cycles. Returns (outputs (rec [L, C, 5, 4], ok, planned,
        iterations [L, C], ctrls [L, C, 2]) as numpy, read once, and the
        carry after, on the device)."""
        C = data.slot_states.shape[1]
        if compiled:
            self.net.load(net)
        self.plan_net = self.net.net if compiled else net
        if compiled and self.program is None:
            self.load(data, carry, c0, enable)   # the warm-up's inputs
            self.program = graph_control.GraphProgram(self.cycle, self.device)
            self.rounds.zero_()   # count the replays' rounds, not the warm-up's
        with graph_control.no_host_sync() if compiled else contextlib.nullcontext():
            self.load(data, carry, c0, enable)
            for k in range(C):
                if compiled:
                    self.program.replay()
                else:
                    rec = {"cycle": c0 + k} if phases is not None else None
                    self.cycle(rec)
                    if rec is not None:
                        phases.append(rec)
            carry_out = graph_control.clone(self.carry)
        f64 = torch.float64
        L = self.rec.shape[0]
        flat = torch.cat([self.rec[:, :C].reshape(L, C, -1), self.ok[:, :C, None].to(f64),
                          self.planned[:, :C, None].to(f64), self.iters[:, :C, None].to(f64),
                          self.ctrls[:, :C].to(f64)], dim=-1).cpu().numpy()   # the one read
        n = TICKS_PER_PLAN * 4
        outs = (flat[..., :n].reshape(L, C, TICKS_PER_PLAN, 4), flat[..., n] > 0.5,
                flat[..., n + 1] > 0.5, flat[..., n + 2].astype(np.float32),
                flat[..., n + 3:].astype(np.float32))
        return outs, carry_out


def _compiled(device: torch.device, graphed: Optional[bool], phases) -> bool:
    if graphed is None:
        return device.type == "cuda" and phases is None
    if graphed and (device.type != "cuda" or phases is not None):
        raise ValueError(f"a compiled episode runs on a CUDA device and records no phases "
                         f"(they synchronize the device); got {device}, phases "
                         f"{phases is not None}")
    return bool(graphed)


def _cfg_signature(planner, veh_param, dt: float) -> str:
    """The configuration that shapes the episode program (the JAX package's
    `_cfg_signature`): planner/programs.py::config_signature with the
    vehicle and the step."""
    return config_signature(planner.cfg, veh=(veh_param.wb, veh_param.max_spd, veh_param.max_str),
                            dt=dt)


_MODES = ("single", "single_seg", "scenarios", "copies_seg")


class _EpisodeFn:
    """The episode program of one planner configuration in one mode (see
    `episode_fn_for`). Its compiled cycles are kept per shapes, dtypes and
    device (each with the largest segment it has taken), whatever the
    network's weights."""

    def __init__(self, planner, veh_param, dt: float, batch: str):
        cfg = planner.cfg
        ph = cfg.traj_tree.full
        self.batch = batch
        self.core = functools.partial(batched_plan_core, cfg=cfg, ilqr_cfg=planner.ilqr_cfg,
                                      warm_ilqr_cfg=planner.warm_ilqr_cfg,
                                      weights=planner._weights)
        self.half = 0.5 * (ph.smooth_grid_size[0] - 1) * ph.smooth_grid_res
        self.wb, self.max_spd, self.max_str = veh_param.wb, veh_param.max_spd, veh_param.max_str
        self.dt = dt
        self.pipeline_dtype = torch_dtype(cfg.pipeline_dtype)
        self.programs: dict = {}

    def __call__(self, net, inputs: EpisodeInputs, statics: EpisodeStatics, enable_tick,
                 c0: int = 0, carry=None, *, graphed: Optional[bool] = None,
                 phases: Optional[list] = None):
        seg = self.batch.endswith("_seg")
        if seg != (carry is not None):
            raise TypeError(f"mode {self.batch!r} takes (net, inputs, statics, enable_tick"
                            + (", c0, carry)" if seg else ")"))
        one = self.batch.startswith("single")
        inp = _lanes(inputs) if one else inputs
        L, dev = inp.types.shape[0], inp.types.device
        data = _lane_data(inp, statics if self.batch == "scenarios"
                          else _shared_statics(statics, L))
        if carry is None:
            carry = _init_episode_carry(inp.types.shape[-2], self.pipeline_dtype, dev, L)
        elif one:
            carry = tree_map(lambda x: x[None], carry)
        compiled = _compiled(dev, graphed, phases)
        C = data.slot_states.shape[1]
        cycles = (self._program(net, data, carry) if compiled
                  else _Cycles(self, None, data, carry, C))
        outs, carry = cycles.run(net, data, carry, int(c0), int(enable_tick), compiled, phases)
        if one:
            outs = tuple(o[0] for o in outs)
            carry = tree_map(lambda x: x[0], carry)
        return (carry, outs) if seg else outs

    def _program(self, net, data: _Data, carry) -> _Cycles:
        """The compiled cycles for these shapes, dtypes and device, with
        room for data's cycles (a longer segment than any before captures
        anew), and a network of their own like `net`."""
        C = data.slot_states.shape[1]
        shape = data._replace(**{f: getattr(data, f)[:, :0] for f in _CYCLE_FIELDS})
        kept = self.programs.setdefault((signature(shape), signature(carry)), [])
        for cycles in kept:
            if cycles.cap >= C:
                return cycles
        kept.append(_Cycles(self, ProgramNet(net), data, carry, C))
        return kept[-1]


# One episode program per (planner configuration, mode), as the JAX
# package's jit cache: every scenario with the same paddings shares it
_EPISODE_FN_CACHE: dict = {}


def episode_fn_for(planner, veh_param, dt: float, batch: str = "single"):
    """The episode program for one planner configuration (the JAX package's
    `episode_fn_for`, with the network in the place of its params):

    batch='single': fn(net, inputs, statics, enable_tick) -> outputs;
    batch='single_seg': one SEGMENT of cycles with an explicit carry,
        fn(net, inputs, statics, enable_tick, c0, carry) -> (carry, outputs),
        the inputs cut to the segment's cycles;
    batch='scenarios': inputs and statics with a leading scene axis (stacked);
    batch='copies_seg': inputs and carry with a leading copy axis, statics
        shared (Monte-Carlo), one segment as in 'single_seg'.

    The outputs are (rec [C, 5, 4], plan_ok [C], planned [C], iterations
    [C], controls [C, 2]) as numpy (with the leading axis in the batched
    modes), for `_to_result`; the carry (window, ego, control, failed latch)
    stays on the device. Every call takes `graphed` (None: the compiled
    program on a CUDA device, the eager cycles on the CPU) and `phases` (a
    list that receives per-cycle phase records; eager only)."""
    if batch not in _MODES:
        raise ValueError(batch)
    key = (_cfg_signature(planner, veh_param, dt), batch)
    fn = _EPISODE_FN_CACHE.get(key)
    if fn is None:
        fn = _EPISODE_FN_CACHE[key] = _EpisodeFn(planner, veh_param, dt, batch)
    return fn


def programs() -> List[_Cycles]:
    """Every compiled episode program of this process (one CUDA graph
    each, its replays' AIME rounds in `.rounds`, its graph in
    `.program`)."""
    return [c for fn in _EPISODE_FN_CACHE.values() for kept in fn.programs.values()
            for c in kept if c.program is not None]


def program_rounds() -> int:
    """The AIME rounds that the compiled episode programs' replays have run
    in this process (a host read of their device counters; 0 off the card).
    Kernel B runs n_scene_layer times a round."""
    return sum(int(c.rounds) for c in programs())


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
    return inp._replace(**{f: getattr(inp, f)[None] for f in _LANE_FIELDS})


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
    """The MIND ego, its planner, the schedule (built, or `inputs`) and the
    planner's statics."""
    from mind_tpu_torch.sim.agents import MINDAgent

    ego = next(a for a in sim.agents if isinstance(a, MINDAgent))
    pl = ego.planner
    inp = inputs if inputs is not None else build_episode_inputs(sim, horizon)
    return ego, pl, inp, build_episode_statics(pl)


def run_episode(sim, horizon: Optional[int] = None, inputs: Optional[EpisodeInputs] = None,
                phases: Optional[list] = None, graphed: Optional[bool] = None) -> EpisodeResult:
    """Run one scenario's closed loop as the episode program.

    `sim` must be an initialized Simulator with one MINDAgent ego. The
    returned ego trajectory matches `Simulator.run_sim()` +
    `sim.ego_trajectory()` (tests/test_torch_episode.py holds 1e-3 m).
    `inputs` optionally reuses a schedule from `build_episode_inputs(sim,
    horizon)` (or one copy's of `build_mc_inputs`, taken with
    `lane_inputs`); `phases` (a list) receives per-cycle phase times and
    runs the cycles eagerly, as `graphed=False` does."""
    ego, pl, inp, statics = _episode_setup(sim, horizon, inputs)
    fn = episode_fn_for(pl, ego.veh_param, sim.sim_step)
    return _to_result(pl, *fn(pl.net, inp, statics, inp.enable_tick, graphed=graphed,
                              phases=phases))


def run_episode_timed(sim, horizon: Optional[int] = None, phases: Optional[list] = None,
                      graphed: Optional[bool] = None):
    """(result, wall_s): the first call absorbs warm-up (kernel builds, the
    program's capture, allocator), the second is timed. `phases` goes to
    the timed call (and makes both eager)."""
    inp = build_episode_inputs(sim, horizon)
    eager = False if phases is not None else graphed
    run_episode(sim, horizon, inputs=inp, graphed=eager)
    t0 = time.perf_counter()
    res = run_episode(sim, horizon, inputs=inp, phases=phases, graphed=graphed)
    return res, time.perf_counter() - t0


def run_episode_segmented(sim, horizon: Optional[int] = None, seg_cycles: int = 10,
                          inputs: Optional[EpisodeInputs] = None,
                          graphed: Optional[bool] = None) -> EpisodeResult:
    """`run_episode` in segments of `seg_cycles` cycles ('single_seg'),
    the carry handed from one to the next on the device: the same cycles on
    the same data, so the same result to the bit."""
    if seg_cycles < 1:
        raise ValueError(f"seg_cycles must be >= 1, got {seg_cycles}")
    ego, pl, inp, statics = _episode_setup(sim, horizon, inputs)
    fn = episode_fn_for(pl, ego.veh_param, sim.sim_step, batch="single_seg")
    C = inp.slot_states.shape[0]
    carry = _init_episode_carry(inp.types.shape[-2], torch_dtype(pl.cfg.pipeline_dtype), pl.device)
    segs = []
    for s0 in range(0, C, seg_cycles):
        carry, out = fn(pl.net, _slice_cycles(inp, s0, min(s0 + seg_cycles, C)), statics,
                        inp.enable_tick, s0, carry, graphed=graphed)
        segs.append(out)
    return _to_result(pl, *(np.concatenate([s[k] for s in segs]) for k in range(5)))


def _slice_cycles(inp: EpisodeInputs, s0: int, s1: int) -> EpisodeInputs:
    """The per-cycle fields cut to cycles [s0, s1) ([C, ...], or [L, C,
    ...] with a leading lane axis)."""
    ax = inp.slot_states.dim() - 3
    return inp._replace(**{f: getattr(inp, f).narrow(ax, s0, s1 - s0) for f in _CYCLE_FIELDS})


def _slice_lanes(inp: EpisodeInputs, lo: int, hi: int) -> EpisodeInputs:
    """Lanes [lo, hi) of a stacked schedule."""
    tv = inp.target_vel
    return inp._replace(**{f: getattr(inp, f)[lo:hi] for f in _LANE_FIELDS},
                        target_vel=tv[lo:hi] if isinstance(tv, torch.Tensor) else tv)


def lane_inputs(inp: EpisodeInputs, i: int) -> EpisodeInputs:
    """Lane i of a stacked schedule as one episode's (for run_episode)."""
    tv = inp.target_vel
    return inp._replace(**{f: getattr(inp, f)[i] for f in _LANE_FIELDS},
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


def run_episodes_batched(sims, horizon: Optional[int] = None, phases: Optional[list] = None,
                         graphed: Optional[bool] = None) -> List[EpisodeResult]:
    """All S scenarios' closed loops as one batch of S lanes, the
    'scenarios' episode program: one batched_plan_core per planning cycle,
    the trees of all scenarios in one solve (the JAX package's "4 demos as
    one batched rollout").

    The sims must share the enable tick, every configuration value the
    batched core takes from the first planner (`_baked_signature`), and the
    network weights; each scenario keeps its own statics and cost
    parameters. `phases` receives the per-cycle phase times of the batch
    (eager cycles); `graphed` as in run_episode."""
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
    fn = episode_fn_for(pls[0], egos[0].veh_param, sims[0].sim_step, batch="scenarios")
    outs = fn(pls[0].net, _stack(inps, dev), _stack([build_episode_statics(p) for p in pls], dev),
              ticks.pop(), graphed=graphed, phases=phases)
    return [_to_result(pls[i], *(o[i] for o in outs)) for i in range(len(sims))]


def run_episode_monte_carlo(sim, k: int = 64, pos_sigma: float = 0.5,
                            vel_sigma: float = 0.25, seed: int = 0,
                            horizon: Optional[int] = None, chunk: int = 4,
                            seg_cycles: int = 10, deadline: Optional[float] = None,
                            mesh=None, chunk_walls: Optional[list] = None,
                            phases: Optional[list] = None,
                            graphed: Optional[bool] = None) -> List[EpisodeResult]:
    """K Monte-Carlo perturbed closed-loop episodes of one scenario, in
    chunks of `chunk` copies planned as one batch (lanes sharing the
    scenario's statics and cost parameters, each with its own grid origin).

    Each chunk runs in segments of `seg_cycles` cycles ('copies_seg'), the
    carry handed on on the device: the same result to the bit for any
    segment length. `graphed` as in run_episode. `deadline`
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
            runs[d] = (p, build_episode_statics(p))
    fn = episode_fn_for(pl, ego.veh_param, sim.sim_step, batch="copies_seg")
    C = inp_b.slot_states.shape[1]
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
            p, st = runs[d]
            inp = tree_map(lambda x: x.to(d), _slice_lanes(inp_b, lo + i * per, lo + (i + 1) * per))
            carry = _init_episode_carry(A, pdt, d, per)
            segs = []
            for s0 in range(0, C, seg_cycles):
                carry, out = fn(p.net, _slice_cycles(inp, s0, min(s0 + seg_cycles, C)), st,
                                inp.enable_tick, s0, carry, graphed=graphed, phases=phases)
                segs.append(out)
            outs = [np.concatenate([s[k] for s in segs], axis=1) for k in range(5)]
            parts.append([_to_result(p, *(o[j] for o in outs)) for j in range(per)])
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
