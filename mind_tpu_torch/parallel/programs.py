"""The scale-out runners' compiled programs: the JAX package's
`MultiScenarioSim._batched_fn` and `_obs_update`
(mind_tpu/parallel/multi_scenario.py:86-93,123), `MonteCarloSim._batched_fn`
and `_update_fn` (monte_carlo.py:93-111) and `parallel_tree_solve`'s `fn`
(scale.py:136-143).

Each is a body, `body(net, inputs) -> (outputs, rounds)`, that reads
nothing from the host, run through planner/programs.py's `PlanProgram`: on
the card one CUDA graph captured at the first call and replayed after it
(AIME's rounds IF nodes, the iLQR loops WHILE nodes), with static buffers;
on the CPU, or with `graphed=False` on the card, the same body eagerly.

- `obs_update_body`: obs_buffer_update on the stacked window [N, A, 50],
  written back into the window in place; a Monte-Carlo update builds the
  K-fold states on the device from the shared exo states and the K egos.
- `batched_plan_body`: batched_plan_core of N scenes or copies, its packed
  [N, 4] and the AIME rounds counted on the device. A scenario batch has
  every input per scene; a Monte-Carlo batch shares the slot types, actor
  mask, target velocity and statics, which the body broadcasts to the N
  copies as the eager runner always has (stride-0 views of the same
  tensors: the products and reductions see the same layout either way).
- `tree_solve_body`: a shard's tree iLQR from zero controls, inside a
  capture one WHILE node over the iteration.

`RunnerPrograms` runs the first two for a runner. The window they share is
lent by the configuration's program set (`programs.Lent`): the update
program writes it and the plan program reads it where it lies, and one pair
of programs serves every runner of a configuration and batch shape.
"""

from __future__ import annotations

import copy
import functools
from typing import NamedTuple, Optional

import torch

from mind_tpu_torch.ops import graph_control
from mind_tpu_torch.ops.potential import CostParams, NodeCostData
from mind_tpu_torch.parallel.mesh import tree_map
from mind_tpu_torch.planner import programs
from mind_tpu_torch.planner.aime_device import DeviceObsBuffer, obs_buffer_update
from mind_tpu_torch.planner.ilqr import ILQRConfig, TreeTopology, ilqr_solve
from mind_tpu_torch.planner.planner import batched_plan_core
from mind_tpu_torch.sim.episode import EpisodeStatics, _shared_statics, build_episode_statics


class ObsUpdateInputs(NamedTuple):
    """What an observation update reads."""

    buf: DeviceObsBuffer             # [N, A, 50, ...]: the window, written in place
    states: torch.Tensor             # [N, A, 4]; [A, 4] shared by the copies where egos is given
    present: torch.Tensor            # [N, A] or [A] bool
    egos: Optional[torch.Tensor]     # [N, 4] each copy's ego (slot 0), or None


class BatchedPlanInputs(NamedTuple):
    """What a batched plan reads: N scenes' inputs, or those of N copies
    that share the slot types, actor mask, target velocity and statics
    (types [A, 7] then)."""

    bufs: DeviceObsBuffer            # [N, A, 50, ...]
    types: torch.Tensor              # [N, A, 7], or [A, 7] shared
    amasks: torch.Tensor             # [N, A] bool, or [A] shared
    host: torch.Tensor               # [N, 8] float32: x0 (6) and the grid origin (2), local frame
    target_vels: torch.Tensor        # [N] float64, or [] shared
    statics: EpisodeStatics          # [N, ...] or shared; field_offset None, n_points a tensor


class TreeSolveInputs(NamedTuple):
    """What a shard's tree solve reads: G trees."""

    topo: TreeTopology               # [G, ...]
    nodes: NodeCostData              # [G, MN, ...]
    params: CostParams               # shared, or with per-tree leaves [G, ...]
    x0: torch.Tensor                 # [G, 6]


def obs_update_body(net, inp: ObsUpdateInputs):
    """The stacked window shifted by one frame, in place (the JAX
    `jax.vmap(obs_buffer_update)`, with `in_axes=(0, 0, None)` and the
    ego written into each copy's states for a Monte-Carlo update)."""
    states = inp.states
    if inp.egos is not None:
        K = inp.egos.shape[0]
        states = torch.cat([inp.egos[:, None].to(states.dtype),
                            states[None, 1:].expand(K, -1, -1)], dim=1)
    graph_control.assign(inp.buf, obs_buffer_update(inp.buf, states, inp.present))
    return (), None


def batched_plan_body(net, inp: BatchedPlanInputs, *, cfg, ilqr_cfg, warm_ilqr_cfg, weights):
    """batched_plan_core of the N scenes or copies (the JAX
    `jax.vmap(_fused_core)`): packed float32 [N, 4] (ctrl, ok, max
    iterations) and the AIME rounds run."""
    N = inp.host.shape[0]
    st, types, amasks, tvs = inp.statics, inp.types, inp.amasks, inp.target_vels
    if types.dim() == 2:   # shared by the copies
        st = _shared_statics(st, N)
        st = st._replace(tgt_static=st.tgt_static._replace(
            n_points=st.tgt_static.n_points.expand(N)))
        types = types[None].expand((N,) + types.shape)
        amasks = amasks[None].expand((N,) + amasks.shape)
        tvs = tvs.expand(N)
    x0s, offsets = inp.host[:, :6].contiguous(), inp.host[:, 6:].contiguous()
    rounds = torch.zeros((), dtype=torch.long, device=x0s.device)
    out = batched_plan_core(
        net, inp.bufs, types, amasks, x0s, st.warm_params._replace(field_offset=offsets),
        st.full_params._replace(field_offset=offsets), tvs, st.lane_static, st.tgt_static,
        (st.eval_seg_start, st.eval_seg_end, st.eval_seg_mask), cfg=cfg, ilqr_cfg=ilqr_cfg,
        warm_ilqr_cfg=warm_ilqr_cfg, weights=weights, rounds_out=rounds)
    return out, rounds


def tree_solve_body(net, inp: TreeSolveInputs, *, cfg: ILQRConfig):
    """One shard's solve from zero controls (the JAX `jax.vmap(solve)`):
    us [G, MN, 2], J [G] and the iteration counts [G]."""
    G, MN = inp.topo.parent.shape
    us0 = torch.zeros((G, MN, 2), dtype=inp.x0.dtype, device=inp.x0.device)
    _, us, info = ilqr_solve(inp.topo, inp.x0, us0, inp.nodes, inp.params, cfg)
    return (us, info["J"], info["iterations"]), None


def plan_statics(planner) -> EpisodeStatics:
    """A planner's statics as a batched plan reads them: the grid origin
    left out (it rides in the host array), the target lane's length a long
    tensor (a capture would bake an int)."""
    st = build_episode_statics(planner)
    tgt = st.tgt_static
    return st._replace(
        warm_params=st.warm_params._replace(field_offset=None),
        full_params=st.full_params._replace(field_offset=None),
        tgt_static=tgt._replace(n_points=torch.tensor(tgt.n_points, device=planner.device)))


class RunnerPrograms:
    """A batched runner's observation update and batched plan under one
    planner configuration (`planner`'s; `net` the network that plans),
    compiled on a CUDA device unless `graphed` is False (planner/
    programs.py::compiled; True on the CPU raises), else the same bodies
    run eagerly on the runner's own tensors. `window` is the runner's
    [N, A, 50, ...] window; compiled, it lives in the configuration's lent
    window while the runner runs (`current_window`)."""

    def __init__(self, planner, net, window: DeviceObsBuffer, graphed: Optional[bool] = None):
        self.device = planner.device
        self.compiled = programs.compiled(self.device, graphed)
        self.net, self.window = net, window
        self.bodies = {   # what the plan bakes, kept from later changes of the planner's
            "obs_update": obs_update_body,
            "batched_plan": functools.partial(
                batched_plan_body, cfg=copy.deepcopy(planner.cfg), ilqr_cfg=planner.ilqr_cfg,
                warm_ilqr_cfg=planner.warm_ilqr_cfg, weights=planner._weights)}
        self.set = self.lent = None
        if self.compiled:
            self.set = programs.program_set(planner._signature, net, self.device)
            self.lent = self.set.lent("window", window)
        self.programs: dict = {}   # kind -> the program this runner ran last

    def current_window(self) -> DeviceObsBuffer:
        """The window as it stands (compiled: the lent one while this
        runner holds it)."""
        if self.compiled and self.lent.holds(self):
            return self.lent.tensors
        return self.window

    def _window(self) -> DeviceObsBuffer:
        """The window the programs read and write: the lent one, taken over
        by this runner where another held it; eagerly the runner's own."""
        return self.lent.take(self, self.window) if self.compiled else self.window

    def _run(self, kind: str, inputs, keep=()):
        if self.compiled:
            prog = self.programs[kind] = self.set.program(kind, self.bodies[kind], inputs, keep)
            return prog(self.net, inputs)
        inputs = tree_map(lambda t: t.to(self.device), inputs)
        return self.bodies[kind](self.net, inputs)[0]

    def update(self, states, present, egos=None):
        """One observation update of the window (host tensors: one copy
        each to the device); reads nothing from the device."""
        buf = self._window()
        self._run("obs_update", ObsUpdateInputs(buf, states, present, egos),
                  keep=graph_control.tensors(buf))

    def plan(self, types, amasks, host, target_vels, statics, keep=()) -> torch.Tensor:
        """One batched plan on the window as it stands: the packed [N, 4]
        (on the device: the caller's read). `keep` names inputs that are
        another program's buffers (read where they lie)."""
        buf = self._window()
        return self._run("batched_plan",
                         BatchedPlanInputs(buf, types, amasks, host, target_vels, statics),
                         keep=(*graph_control.tensors(buf), *keep))
