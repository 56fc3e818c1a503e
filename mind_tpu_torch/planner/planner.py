"""MINDPlanner facade (port of mind_tpu/planner/planner.py): the host shell
around the device observation window, AIME tree growth and the batched
two-phase tree iLQR, with one host read on each side of the solve.

Per plan cycle the staged path (`export_trees=True`) runs AIME, reads one
packed vector of tree metadata, builds the cost trees on the host, uploads
them in one tensor, solves, and reads one packed vector with the control;
trajectories cross to the host only for the exported trees. The fused path
(`export_trees=False`, `fused_plan_core`) builds the cost trees on the
device and reads four numbers. With `exec_resolve_mode="native"` the
executed control comes from the float64 C++ re-solve of the winner tree on
the host (mind_tpu_torch/native), fed on the fused path by the packed
payload of `fused_plan_core(return_exec_payload=True)` in the same read.

Each stage is a body that reads nothing from the host (`aime_body`,
`solve_body` with `exec_body`, `fused_body`: the JAX planner's `_aime_fn`,
`_solve_fn` and `_fused_fn`). On the card `plan` runs them as captured
programs (planner/programs.py: one CUDA graph each, AIME's rounds IF nodes
and the iLQR loops WHILE nodes, replayed with no host synchronization);
with `graphed=False` or on the CPU it runs the same bodies eagerly, with one host read per AIME round and per iteration.
"""

from __future__ import annotations

import copy
import functools
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mind_tpu_torch import native
from mind_tpu_torch.common.device import resolve_device
from mind_tpu_torch.common.geometry import resample_polyline
from mind_tpu_torch.common.tree import Node, Tree
from mind_tpu_torch.config import PlannerConfig
from mind_tpu_torch.data.av2 import ObjectType
from mind_tpu_torch.data.semantic_map import (
    LocalSemanticMap,
    SemanticMap,
    build_lane_graph,
    lane_graph_features,
)
from mind_tpu_torch.models.weights import load_scene_pred
from mind_tpu_torch.ops import graph_control
from mind_tpu_torch.ops.potential import CostParams, select_trees
from mind_tpu_torch.planner.aime_device import (
    DeviceObsBuffer,
    aime_grow_tree,
    obs_buffer_update,
    scene_axis,
)
from mind_tpu_torch.parallel.mesh import tree_map
from mind_tpu_torch.planner import programs
from mind_tpu_torch.planner.cost_topology import DeviceCostTrees, device_cost_topology
from mind_tpu_torch.planner.ilqr import ILQRConfig, TreeTopology
from mind_tpu_torch.planner.scenario_tree import NodeSlots
from mind_tpu_torch.planner.scene_prep import OBS_LEN, LaneGraphStatic, TargetLaneStatic
from mind_tpu_torch.planner.trajectory_tree import (
    build_cost_indices,
    evaluate_traj_tree,
    gather_cost_nodes,
    make_cost_params,
    polish_solve,
    torch_dtype,
    two_phase_solve,
)
from mind_tpu_torch.utils.metrics import Metrics

MAX_TREES = 6  # <= num modes root children
MAX_TGT_PTS = 256       # AIME target lane, ~1 m resampled
MAX_COST_TGT_PTS = 64   # cost-field target lane, 4 m simplified

TYPE_ORDER = [
    ObjectType.VEHICLE,
    ObjectType.PEDESTRIAN,
    ObjectType.MOTORCYCLIST,
    ObjectType.CYCLIST,
    ObjectType.BUS,
    ObjectType.UNKNOWN,
]


def type_onehot(obj_type: ObjectType) -> np.ndarray:
    out = np.zeros(7, np.float32)
    if obj_type in TYPE_ORDER:
        out[TYPE_ORDER.index(obj_type)] = 1
    else:
        out[6] = 1  # static / background / construction / riderless
    return out


def ilqr_configs(cfg: PlannerConfig):
    """(full-phase, warm-phase) solver settings of a planner config, as
    the JAX MINDPlanner builds them."""
    tt = cfg.traj_tree
    full = ILQRConfig(dt=tt.dt, wheelbase=tt.wheelbase, max_iterations=tt.max_iterations,
                      rel_tol=tt.rel_tol, n_line_search=tt.n_line_search,
                      mu_max=tt.max_reg, dtype=tt.solve_dtype)
    return full, full._replace(max_iterations=tt.warm_max_iterations)


def selection_weights(cfg: PlannerConfig):
    """Best-tree selection weights (reference planner.py:180-198)."""
    return (cfg.comfort_acc_weight, cfg.comfort_str_weight,
            cfg.efficiency_weight, cfg.target_weight)


def resolve_exec_dtype(tt, solve_dtype: str) -> str:
    """Name of the exec re-solve dtype. TrajTreeConfig.exec_solve_dtype=None
    means 'follow solve_dtype'; the re-solve runs only when the two differ."""
    name = tt.exec_solve_dtype or solve_dtype
    torch_dtype(name)   # raises on an unsupported name
    return name


def resolves(tt, ilqr_cfg: ILQRConfig) -> bool:
    """Whether the winners are solved again on the device: an exec dtype
    other than the solve's, in polish or scratch mode (native runs on the
    host)."""
    return tt.exec_resolve_mode != "native" and resolve_exec_dtype(tt, ilqr_cfg.dtype) \
        != ilqr_cfg.dtype


def exec_resolve_ctrl(slots, norm_prob, amask, dct, best, x0, us_best,
                      warm_params, full_params, ilqr_cfg, warm_ilqr_cfg, tt, scene):
    """Re-solve each scene's SELECTED tree at `tt.exec_solve_dtype` and
    return its first control (float32 [S, 2]). Selection ran on the faster
    solves of all trees; only the winners, whose first controls the
    vehicles execute, pay for the higher precision. In the flat layout of
    solve_and_select, `best` [S] holds each scene's winner, us_best
    [S, MN, 2], x0 [S, 6] and the parameters are the scenes'; the S winners
    run through the batched solver as one batch, so each one's iteration
    path (alpha grid, first-accept rule, LM schedule) is the solver's own.

    Two strategies (TrajTreeConfig.exec_resolve_mode):
    - 'polish': one full-phase solve started from the winner's converged
      controls `us_best`;
    - 'scratch': the full two-phase solve (reference planner.py:174-178),
      the iteration path of a solve that ran at the exec dtype from the
      start."""
    dts = resolve_exec_dtype(tt, ilqr_cfg.dtype)
    idx = best.reshape(-1)
    topo_best = TreeTopology(*(x.index_select(0, idx) for x in dct.topo))
    nodes_e = gather_cost_nodes(slots, norm_prob, dct.cost_slot.index_select(0, idx),
                                dct.cost_step.index_select(0, idx), topo_best.node_mask, amask,
                                scene.index_select(0, idx), dtype=torch_dtype(dts))
    if tt.exec_resolve_mode == "polish":
        xs_e, _, _ = polish_solve(
            topo_best, x0, us_best.reshape((-1,) + us_best.shape[-2:]), nodes_e, full_params,
            ilqr_cfg._replace(dtype=dts, max_iterations=tt.exec_polish_iterations))
    elif tt.exec_resolve_mode == "scratch":
        xs_e, _, _ = two_phase_solve(
            topo_best, x0, nodes_e, warm_params, full_params,
            ilqr_cfg._replace(dtype=dts), warm_ilqr_cfg._replace(dtype=dts))
    else:
        raise ValueError(f"unknown exec_resolve_mode {tt.exec_resolve_mode!r}")
    return xs_e[:, 0, 4:6].to(torch.float32)


def solve_and_select(slots, norm_prob, amask, dct: DeviceCostTrees, x0, warm_params,
                     full_params, target_vel, eval_segs, scene, *, cfg, ilqr_cfg,
                     warm_ilqr_cfg, weights, clock=None, exec_resolve=True):
    """Two-phase solve of the trees of S scenes as one batch, selection
    cost, each scene's argmin and executed control (with the exec re-solve
    of the winners where the configuration asks for one). `scene` [S * T]
    names each tree's scene, scene-major, as device_cost_topology lays out
    S scenes' trees; slots, norm_prob, amask, x0 [S, 6] and eval_segs carry
    the scene axis, target_vel is [S] or a float the scenes share, and the
    CostParams leaves may carry it (per-scene targets, weights, grid
    origins); every tree takes its scene's. Returns (xs, us, info, cost_b,
    best [S], ctrl float32 [S, 2]); `best` holds each scene's winner as an
    index into the flat batch and stays on the device. `clock` (a
    _PhaseClock) takes the laps "solve", "selection" and "exec_resolve".
    `exec_resolve=False` leaves the re-solve out (the caller runs it:
    MINDPlanner's compiled exec program) and returns the selection's
    control."""
    tt = cfg.traj_tree
    clock = clock or _PhaseClock(None, None)
    topo = dct.topo
    S = x0.shape[0]
    x0_t = x0.index_select(0, scene)
    wp_t, fp_t = select_trees(warm_params, scene), select_trees(full_params, scene)
    tv_t = (target_vel.index_select(0, scene) if isinstance(target_vel, torch.Tensor)
            else target_vel)
    segs_t = tuple(x.index_select(0, scene) for x in eval_segs)
    nodes = gather_cost_nodes(slots, norm_prob, dct.cost_slot, dct.cost_step,
                              topo.node_mask, amask, scene, dtype=torch_dtype(ilqr_cfg.dtype))
    xs, us, info = two_phase_solve(topo, x0_t, nodes, wp_t, fp_t,
                                   ilqr_cfg, warm_ilqr_cfg, active=dct.tree_mask)
    clock.lap("solve")
    cost_b = evaluate_traj_tree(xs, us, topo.node_mask, topo.node_mask.sum(-1), x0_t,
                                *segs_t, tv_t, weights)
    cost_b = torch.where(dct.tree_mask, cost_b, torch.full_like(cost_b, float("inf")))
    T = cost_b.shape[0] // S
    best = torch.argmin(cost_b.view(S, T), dim=-1) + T * torch.arange(S, device=cost_b.device)
    # control = first cost node's [accel, steer] (reference planner.py:141-144)
    ctrl = xs[best, 0, 4:6].to(torch.float32)
    clock.lap("selection")
    # the native re-solve runs on the host after the plan's read (MINDPlanner)
    if exec_resolve and resolves(tt, ilqr_cfg):
        ctrl = exec_resolve_ctrl(slots, norm_prob, amask, dct, best, x0, us[best],
                                 warm_params, full_params, ilqr_cfg, warm_ilqr_cfg, tt, scene)
        clock.lap("exec_resolve")
    return xs, us, info, cost_b, best, ctrl


def _masked_max(values, mask, scenes: int):
    """The largest of `values` where `mask` holds, per scene [S] of S
    scenes' scene-major trees (0 where it holds nowhere)."""
    return torch.where(mask, values, torch.zeros_like(values)).view(scenes, -1).amax(-1)


def _plan_cycle(net, bufs, types, amasks, x0s, warm_params, full_params, target_vels,
                lane_statics, tgt_statics, eval_segs, *, cfg, ilqr_cfg, warm_ilqr_cfg,
                weights, clock):
    """The plan cycle of S scenes (the arguments of batched_plan_core).
    Returns (out [S, 4], state, meta, dct, info, cost_b, best [S], rounds)."""
    tt = cfg.traj_tree
    S = amasks.shape[0]
    state, meta, rounds = aime_grow_tree(net, cfg, bufs, types, amasks, lane_statics, tgt_statics)
    clock.lap("aime")
    dct = device_cost_topology(
        state.parent, state.depth, state.duration, state.start_t,
        state.end_flag, meta.tree_id, MAX_TREES, tt.max_cost_nodes,
        tt.max_depth_levels, tt.max_width_hint)
    clock.lap("cost_topology")
    scene = torch.arange(S, device=amasks.device).repeat_interleave(MAX_TREES)
    _, _, info, cost_b, best, ctrl = solve_and_select(
        state.slots, meta.norm_prob, amasks, dct, x0s, warm_params, full_params,
        target_vels, eval_segs, scene, cfg=cfg, ilqr_cfg=ilqr_cfg,
        warm_ilqr_cfg=warm_ilqr_cfg, weights=weights, clock=clock)
    ok = (dct.n_trees > 0).to(torch.float32)
    its = _masked_max(info["iterations"], dct.tree_mask, S)
    out = torch.cat([ctrl, ok[:, None], its.to(torch.float32)[:, None]], dim=-1)
    return out, state, meta, dct, info, cost_b, best, rounds


def batched_plan_core(net, bufs, types, amasks, x0s, warm_params, full_params, target_vels,
                      lane_statics, tgt_statics, eval_segs, *, cfg, ilqr_cfg, warm_ilqr_cfg,
                      weights, report=None, rounds_out=None):
    """The plan cycle of S scenes at once (the port's counterpart of the JAX
    package's `jax.vmap(fused_plan_core)`): every argument of
    fused_plan_core with a leading scene axis S (bufs, types, amasks, x0s
    [S, 6], target_vels [S], the lane, target-lane and evaluation statics),
    and CostParams whose leaves are shared or [S, ...] (a Monte-Carlo sweep
    shares all but field_offset; a batch of scenarios has every leaf per
    scene). AIME runs the network once per round over all scenes' nodes,
    the S * MAX_TREES trees are one solve, and each scene takes the argmin
    over its own trees (inf on masked ones), with the polish/scratch exec
    re-solve of the S winners as one batch where the configuration asks for
    one (none with 'native'). Eagerly the host reads one flag per AIME
    round and one per solve iteration for all scenes together; without a
    report nothing here reads the host otherwise, so the whole cycle can be
    captured into a graph program (ops/graph_control.py), where those loops
    and branches are conditional nodes.

    Returns float32 [S, 4]: ctrl(2), ok, max iterations. `report` as in
    fused_plan_core, with per-scene lists for "best", "iterations" and
    "warm_iterations". `rounds_out`, a long tensor [] on the device, has
    the cycle's AIME rounds added to it (the episode program's count)."""
    clock = _PhaseClock(amasks.device, report)
    out, _, _, dct, info, cost_b, best, rounds = _plan_cycle(
        net, bufs, types, amasks, x0s, warm_params, full_params, target_vels, lane_statics,
        tgt_statics, eval_segs, cfg=cfg, ilqr_cfg=ilqr_cfg, warm_ilqr_cfg=warm_ilqr_cfg,
        weights=weights, clock=clock)
    if rounds_out is not None:
        rounds_out.add_(rounds)
    if report is not None:
        S = len(best)
        report.update(rounds=int(rounds), trees=dct, tree_cost=cost_b,
                      best=(best - MAX_TREES * torch.arange(S, device=best.device)).tolist(),
                      iterations=_masked_max(info["iterations"], dct.tree_mask, S).tolist(),
                      warm_iterations=_masked_max(info["warm_iterations"], dct.tree_mask,
                                                  S).tolist())
    return out


def fused_plan_core(net, buf, types, amask, x0, warm_params, full_params,
                    target_vel, lane_static, tgt_static, eval_segs, *,
                    cfg, ilqr_cfg, warm_ilqr_cfg, weights,
                    return_exec_payload=False, report=None, rounds_out=None, best_out=None):
    """The whole plan cycle of one scene: AIME + cost topology + two-phase
    solve + selection (+ the polish/scratch exec re-solve where configured),
    the S = 1 case of batched_plan_core. `net` is the batched ScenePredNet
    (it takes the place of the JAX version's params and batched_apply).
    Returns a float32 tensor [ctrl(2), ok, max_iterations]; with
    `return_exec_payload`, the float64 vector of `native.pack_exec_payload`
    instead: those 4 numbers, then the winner tree's parent row, node mask
    and float64 cost-node data, for the native re-solve on the host (one
    read for both).

    With `report` (a dict), the cycle also records the wall time of each
    phase in seconds under "aime", "cost_topology", "solve", "selection"
    and, where it ran, "exec_resolve" (with a device synchronize ending each
    phase), the AIME rounds run ("rounds"), the cost trees ("trees", a
    DeviceCostTrees), the per-tree selection costs ("tree_cost"), the
    selected tree ("best") and the largest iteration count over the active
    trees of the warm and the full solve ("warm_iterations", "iterations").
    `rounds_out` as in batched_plan_core; `best_out`, a long tensor [] on
    the device, receives the selected tree."""
    clock = _PhaseClock(buf.pos.device, report)
    bufs, types_s, amasks, lane_s, tgt_s = scene_axis(buf, types, amask, lane_static, tgt_static)
    out, state, meta, dct, info, cost_b, best, rounds = _plan_cycle(
        net, bufs, types_s, amasks, x0[None], warm_params, full_params, target_vel, lane_s,
        tgt_s, tuple(x[None] for x in eval_segs), cfg=cfg, ilqr_cfg=ilqr_cfg,
        warm_ilqr_cfg=warm_ilqr_cfg, weights=weights, clock=clock)
    out, best = out[0], best[0]
    if rounds_out is not None:
        rounds_out.add_(rounds)
    if best_out is not None:
        best_out.copy_(best)
    if report is not None:
        report.update(rounds=int(rounds), trees=dct._replace(n_trees=dct.n_trees[0]),
                      tree_cost=cost_b,
                      best=best, iterations=int(_masked_max(info["iterations"], dct.tree_mask, 1)),
                      warm_iterations=int(_masked_max(info["warm_iterations"],
                                                      dct.tree_mask, 1)))
    if not return_exec_payload:
        return out
    one = best.reshape(1)
    topo_best = TreeTopology(*(x.index_select(0, one) for x in dct.topo))
    nodes_e = gather_cost_nodes(state.slots, meta.norm_prob, dct.cost_slot.index_select(0, one),
                                dct.cost_step.index_select(0, one), topo_best.node_mask, amasks,
                                torch.zeros_like(one), dtype=torch.float64)
    return native.pack_exec_payload(out, topo_best.parent, topo_best.node_mask, *nodes_e)


class _PhaseClock:
    """Host wall time per phase, each ended by a device synchronize; does
    nothing without a report dict."""

    def __init__(self, device, report):
        self.device, self.report = device, report
        self.t = time.perf_counter() if report is not None else None

    def lap(self, name):
        if self.report is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.report[name] = now - self.t
        self.t = now


# ---------------------------------------------------------------------------
# The plan's programs (the JAX MINDPlanner's jitted _aime_fn, _solve_fn,
# _fused_fn): bodies that read nothing from the host, run eagerly or captured
# (planner/programs.py). Each returns (outputs, AIME rounds or None).
# ---------------------------------------------------------------------------

class AimeInputs(NamedTuple):
    """What the AIME program reads: one scene's window and statics."""

    buf: DeviceObsBuffer
    types: torch.Tensor             # [A, 7]
    amask: torch.Tensor             # [A] bool
    lane_static: LaneGraphStatic
    tgt_static: TargetLaneStatic    # n_points a long tensor []


class SolveInputs(NamedTuple):
    """What the staged solve program reads. On the card slots, norm_prob
    and amask are the AIME program's buffers."""

    slots: NodeSlots                # [1, MN + 1, ...]
    norm_prob: torch.Tensor         # [1, MN] float64
    amask: torch.Tensor             # [A] bool
    trees: torch.Tensor             # [MAX_TREES, K] long: the host-built cost trees (pack_trees)
    host: torch.Tensor              # [9] float64: x0 (6), grid origin (2), target velocity
    warm: CostParams                # field_offset None: the grid origin is host[6:8]
    full: CostParams
    eval_segs: tuple                # the selection lane's segments (start, end, mask)
    scene: torch.Tensor             # [MAX_TREES] long zeros: every tree is the scene's


class ExecInputs(NamedTuple):
    """What the exec re-solve program reads: the solve program's inputs and
    outputs."""

    solve: SolveInputs
    best: torch.Tensor              # [1] long
    us: torch.Tensor                # [MAX_TREES, MN, 2]
    small: torch.Tensor             # the solve's packed read


class FusedInputs(NamedTuple):
    """What the fused program reads."""

    buf: DeviceObsBuffer
    types: torch.Tensor
    amask: torch.Tensor
    host: torch.Tensor              # as SolveInputs.host
    warm: CostParams                # field_offset None
    full: CostParams
    lane_static: LaneGraphStatic
    tgt_static: TargetLaneStatic    # n_points a long tensor []
    eval_segs: tuple


def pack_trees(trees, n_real: int) -> np.ndarray:
    """The host-built cost trees (MAX_TREES of them, the padding repeats
    tree 0) as one int64 array [T, K]: parent, node mask, level table, cost
    slot and step, and the real-tree flag, each flattened; the plan
    uploads it in one copy and `split_trees` takes it apart on the
    device."""
    T = len(trees)
    parts = [np.stack([t[0].parent for t in trees]),
             np.stack([t[0].node_mask for t in trees]).astype(np.int64),
             np.stack([t[0].level_table for t in trees]),
             np.stack([t[1] for t in trees]), np.stack([t[2] for t in trees]),
             (np.arange(T) < n_real).astype(np.int64)[:, None]]
    return np.concatenate([p.reshape(T, -1) for p in parts], axis=1)


def split_trees(flat: torch.Tensor, tt) -> DeviceCostTrees:
    """pack_trees' array, on the device, as DeviceCostTrees (views, and
    the tree mask and count computed here)."""
    MN, LV = tt.max_cost_nodes, tt.max_depth_levels
    T, K = flat.shape
    W = (K - 4 * MN - 1) // LV
    parent, mask, table, cs, st, tm = flat.split([MN, MN, LV * W, MN, MN, 1], dim=1)
    tree_mask = tm[:, 0] > 0
    return DeviceCostTrees(
        topo=TreeTopology(parent=parent, node_mask=mask > 0, level_table=table.reshape(T, LV, W)),
        cost_slot=cs, cost_step=st, tree_mask=tree_mask, n_trees=tree_mask.sum())


def _host_parts(host: torch.Tensor):
    """(x0 [6], grid origin [2], target velocity [1]) of a host vector."""
    return host[:6], host[6:8], host[8:9]


def aime_body(net, inp: AimeInputs, *, cfg):
    """AIME on one scene (the JAX `_aime_fn`). Outputs: the state's slots
    [1, ...], meta.norm_prob [1, MN] and the packed float64 vector the plan
    reads after AIME: parent, duration, end_flag, tree_id, norm_prob (MN
    each), n_nodes and the rounds run."""
    state, meta, rounds = aime_grow_tree(net, cfg, *scene_axis(*inp))
    f64 = torch.float64
    packed = torch.cat([
        meta.parent[0].to(f64), meta.duration[0].to(f64), meta.end_flag[0].to(f64),
        meta.tree_id[0].to(f64), meta.norm_prob[0], meta.n_nodes.to(f64), rounds.to(f64)[None]])
    return (state.slots, meta.norm_prob, packed), rounds


def solve_body(net, inp: SolveInputs, *, cfg, ilqr_cfg, warm_ilqr_cfg, weights,
               exec_resolve=True, clock=None):
    """The staged solve (the JAX `_solve_fn`): the two-phase solve of the
    host-built trees, selection, the polish/scratch exec re-solve unless
    `exec_resolve` is False. Outputs: xs [T, MN, 6], us [T, MN, 2], best
    [1] and the packed float64 vector the plan reads: control (2), best,
    the largest warm + full iteration count over the real trees, the T
    selection costs (float64, so that near-tie margins survive)."""
    x0, offset, tv = _host_parts(inp.host)
    dct = split_trees(inp.trees, cfg.traj_tree)
    xs, us, info, cost_b, best, ctrl = solve_and_select(
        inp.slots, inp.norm_prob, inp.amask[None], dct, x0[None],
        inp.warm._replace(field_offset=offset), inp.full._replace(field_offset=offset), tv,
        tuple(x[None] for x in inp.eval_segs), inp.scene, cfg=cfg, ilqr_cfg=ilqr_cfg,
        warm_ilqr_cfg=warm_ilqr_cfg, weights=weights, clock=clock, exec_resolve=exec_resolve)
    f64 = torch.float64
    its = _masked_max(info["iterations"] + info["warm_iterations"], dct.tree_mask, 1)
    small = torch.cat([ctrl[0].to(f64), best.to(f64), its.to(f64), cost_b])
    return (xs, us, best, small), None


def exec_body(net, inp: ExecInputs, *, cfg, ilqr_cfg, warm_ilqr_cfg):
    """The staged solve's exec re-solve of the winner (the part of the JAX
    `_solve_fn` after the selection), as a program of its own replayed
    right after the solve's. Output: the solve's packed vector with the
    re-solved control."""
    s = inp.solve
    x0, offset, _ = _host_parts(s.host)
    ctrl = exec_resolve_ctrl(
        s.slots, s.norm_prob, s.amask[None], split_trees(s.trees, cfg.traj_tree), inp.best,
        x0[None], inp.us[inp.best], s.warm._replace(field_offset=offset),
        s.full._replace(field_offset=offset), ilqr_cfg, warm_ilqr_cfg, cfg.traj_tree, s.scene)
    return torch.cat([ctrl[0].to(torch.float64), inp.small[2:]]), None


def fused_body(net, inp: FusedInputs, *, cfg, ilqr_cfg, warm_ilqr_cfg, weights, native):
    """The whole plan in one program (the JAX `_fused_fn`): fused_plan_core,
    with the exec payload in native mode. Output: its result, then the
    selected tree and the AIME rounds run (in its dtype), for the one read."""
    x0, offset, tv = _host_parts(inp.host)
    rounds = torch.zeros((), dtype=torch.long, device=x0.device)
    best = torch.zeros((), dtype=torch.long, device=x0.device)
    out = fused_plan_core(
        net, inp.buf, inp.types, inp.amask, x0, inp.warm._replace(field_offset=offset),
        inp.full._replace(field_offset=offset), tv, inp.lane_static, inp.tgt_static,
        inp.eval_segs, cfg=cfg, ilqr_cfg=ilqr_cfg, warm_ilqr_cfg=warm_ilqr_cfg,
        weights=weights, return_exec_payload=native, rounds_out=rounds, best_out=best)
    return torch.cat([out, best.to(out.dtype)[None], rounds.to(out.dtype)[None]]), rounds


class ObsBuffer:
    """Host shell around the device observation window: tracks id->slot
    assignment and presence; the rolling [A, 50] tensors live on `device`
    and are updated once per plan trigger.

    With `device_updates=False` the device update is deferred: update()
    only records (states, present) in `.pending`, and a batched runner
    (parallel/multi_scenario.py) applies one update to all scenarios'
    stacked windows per trigger instead of S."""

    def __init__(self, max_actors: int, origin: Optional[np.ndarray] = None,
                 dtype: str = "float64", device=None, device_updates: bool = True):
        self.device = resolve_device(device)
        self.device_updates = device_updates
        self.pending = None
        self.A = max_actors
        self.origin = origin  # local planning frame (see MINDPlanner)
        self.slots: Dict[str, int] = {}
        self.types = np.zeros((max_actors, 7), np.float32)
        self.active = np.zeros(max_actors, bool)
        self.last_present = np.zeros(max_actors, bool)
        self.buf = DeviceObsBuffer.create(max_actors, torch_dtype(dtype), self.device)
        # device copies of `types` and of the last actor mask, uploaded again
        # only after they changed
        self._types_d = None
        self._types_ver = -1
        self._ver = 0
        self._mask_d = None
        self._mask_key = None

    def _slot(self, track_id: str, obj_type: ObjectType) -> Optional[int]:
        if track_id in self.slots:
            return self.slots[track_id]
        free = np.flatnonzero(~self.active)
        if len(free) == 0:
            return None  # buffer full: ignore new tracks
        s = int(free[0])
        self.slots[track_id] = s
        self.active[s] = True
        self.types[s] = type_onehot(obj_type)
        self._ver += 1
        return s

    def update(self, observations):
        """observations: list of (track_id, state[x,y,v,yaw], obj_type);
        the ego must be first with track_id 'AV' (slot 0)."""
        states = np.zeros((self.A, 4), np.float64)
        present = np.zeros(self.A, bool)
        for track_id, state, obj_type in observations:
            s = self._slot(track_id, obj_type)
            if s is None:
                continue
            states[s] = state
            present[s] = True
        if self.origin is not None:
            states[:, :2] -= self.origin
        # float64 on the way in: the observation window is the root of the
        # decision pipeline; obs_buffer_update casts to the window's dtype
        self.last_present = present
        if not self.device_updates:
            self.pending = (states, present)
            return
        self.buf = obs_buffer_update(self.buf, torch.as_tensor(states, device=self.device),
                                     torch.as_tensor(present, device=self.device))

    def actor_mask(self) -> np.ndarray:
        """Agents predicted this plan: active and observed at the last frame
        (reference utils.py:274-276)."""
        return self.active & self.last_present

    def types_device(self):
        if self._types_ver != self._ver:
            self._types_d = torch.tensor(self.types, device=self.device)
            self._types_ver = self._ver
        return self._types_d

    def mask_device(self, mask: np.ndarray):
        key = mask.tobytes()
        if self._mask_key != key:
            self._mask_d = torch.tensor(mask, device=self.device)
            self._mask_key = key
        return self._mask_d


class MINDPlanner:
    """One ego agent's planner. Mirrors the reference's public surface:
    update_observation / update_state_ctrl / update_target_lane / plan.
    Runs on the CUDA card unless the caller passes a CPU `device`.
    `shared_net` is a ScenePredNet in eval mode on that device, shared
    between planners in place of loading one here. `graphed` (None: on a
    CUDA device) plans through the compiled programs (planner/programs.py);
    False runs the same bodies eagerly, the bit-exact reference on the card;
    True on the CPU raises."""

    def __init__(self, cfg: PlannerConfig, smp: SemanticMap,
                 lcl_smp: LocalSemanticMap, export_trees: bool = True,
                 shared_net=None, device=None, graphed: Optional[bool] = None):
        self.device = resolve_device(device)
        programs.compiled(self.device, graphed)   # raises for True on the CPU
        self.graphed = graphed
        self.cfg = cfg
        self.obs_len = cfg.obs_len
        self.smp = smp
        self.lcl_smp = lcl_smp
        self.state: Optional[np.ndarray] = None
        self.ctrl: Optional[np.ndarray] = None
        self.gt_tgt_lane: Optional[np.ndarray] = None
        self.metrics = Metrics()
        self.export_trees = export_trees

        self._init_statics()
        self.obs_buffer = ObsBuffer(cfg.max_actors, origin=self.origin,
                                    dtype=cfg.pipeline_dtype, device=self.device)
        self.net = shared_net if shared_net is not None else self._init_network()
        self._init_programs()

    # ------------------------------------------------------------------
    def _init_statics(self):
        cfg, dev = self.cfg, self.device
        # Plan in a per-scenario LOCAL frame: AV2 global coordinates sit
        # ~6500 m from the map origin, where float32 resolution is ~8e-4 m,
        # above the 1e-3 trajectory-parity budget (BASELINE.json). A fixed
        # 100 m-rounded origin is subtracted on the host, in float64, from
        # every position before it reaches the device (exactly
        # representable, so the shift itself is lossless), bringing
        # on-device coordinates to O(100) m with ~6e-6 m resolution.
        # Controls are frame-independent.
        self.origin = np.round(
            np.asarray(self.lcl_smp.target_lane, float).mean(axis=0)
            / 100.0) * 100.0
        # lane graph (static per scenario): instance-frame node features plus
        # global anchors (see scene_prep docstring)
        graph = build_lane_graph(self.smp.map_data, np.zeros(2), np.eye(2),
                                 cfg.scen_tree.seg_length,
                                 cfg.scen_tree.seg_n_node)
        feats = lane_graph_features(graph)  # [L, 10, 16]
        L = cfg.max_lanes
        n = feats.shape[0]
        if n > L:
            raise ValueError(f"{n} lane segments exceed max_lanes={L}")
        node_feats = np.zeros((L, 10, 16), np.float32)
        node_feats[:n] = feats
        # anchors at the PIPELINE dtype: under 'float64' they enter the scene
        # prep (and through it the network-input float32 cast and the
        # decision pipeline) unrounded
        pd = dict(dtype=torch_dtype(cfg.pipeline_dtype), device=dev)
        anchors = np.zeros((L, 2), np.float64)
        anchors[:n] = graph["lane_ctrs"] - self.origin
        vecs = np.tile(np.array([1.0, 0.0], np.float64), (L, 1))
        vecs[:n] = graph["lane_vecs"]
        mask = np.zeros(L, bool)
        mask[:n] = True
        self.lane_static = LaneGraphStatic(
            node_feats=torch.tensor(node_feats, device=dev),
            anchors_g=torch.tensor(anchors, **pd),
            anchor_vecs_g=torch.tensor(vecs, **pd),
            mask=torch.tensor(mask, device=dev),
        )

        # resampled target lane (~1 m) + info (reference planner.py:147-171)
        lane = self.lcl_smp.target_lane
        info = self.lcl_smp.target_lane_info
        pts, src = resample_polyline(lane, 1.0)
        info_rows = np.concatenate([
            info[0][:, None], info[1], info[2], info[3],
            info[4][:, None], info[5][:, None],
        ], axis=-1).astype(np.float64)[src]  # [P, 12]
        P = MAX_TGT_PTS
        if len(pts) > P:
            raise ValueError(f"target lane too long: {len(pts)} points > {P}")
        tp = np.full((P, 2), 1e6, np.float64)
        tp[:len(pts)] = pts - self.origin
        ti = np.zeros((P, 12), np.float64)
        ti[:len(pts)] = info_rows
        tm = np.zeros(P, bool)
        tm[:len(pts)] = True
        self.tgt_static = TargetLaneStatic(
            points=torch.tensor(tp, **pd), info=torch.tensor(ti, **pd),
            mask=torch.tensor(tm, device=dev), n_points=len(pts))

        # evaluation lane (unresampled target lane, reference
        # planner.py:200-205), always float64: tree selection is a discrete
        # decision (PARITY.md)
        ev = np.asarray(lane, np.float64) - self.origin
        S = MAX_TGT_PTS
        evp = np.full((S, 2), 1e6, np.float64)
        evp[:len(ev)] = ev
        evm = np.zeros(S - 1, bool)
        evm[:len(ev) - 1] = True
        f64 = dict(dtype=torch.float64, device=dev)
        self._eval_segs = (torch.tensor(evp[:-1], **f64), torch.tensor(evp[1:], **f64),
                           torch.tensor(evm, device=dev))

    def _init_network(self):
        """ScenePredNet in eval mode on the planner's device, its weights
        picked by cfg.ckpt_path as the JAX planner picks them: a directory
        is the port's checkpoints (models/checkpoint.py), an `.npz` the flax
        archive, any other path a reference torch checkpoint, whose absence
        leaves the weights seeded from cfg.seed, as no path does
        (models/weights.py::load_scene_pred)."""
        cfg = self.cfg
        return load_scene_pred(cfg.net, cfg.ckpt_path or None, self.device, seed=cfg.seed)

    def _init_programs(self):
        """Solver settings, selection weights and the program bodies of the
        configuration as it is now (call again after changing it), and
        the device tensors the programs read besides the statics."""
        cfg = copy.deepcopy(self.cfg)   # what the bodies bake, kept from later changes
        self.ilqr_cfg, self.warm_ilqr_cfg = ilqr_configs(cfg)
        self._weights = selection_weights(cfg)
        self._exec_native = cfg.traj_tree.exec_resolve_mode == "native"
        self._resolves = resolves(cfg.traj_tree, self.ilqr_cfg)
        solver = dict(cfg=cfg, ilqr_cfg=self.ilqr_cfg, warm_ilqr_cfg=self.warm_ilqr_cfg)
        self._bodies = {
            "aime": functools.partial(aime_body, cfg=cfg),
            "solve": functools.partial(solve_body, weights=self._weights, exec_resolve=False,
                                       **solver),
            "exec": functools.partial(exec_body, **solver),
            "fused": functools.partial(fused_body, weights=self._weights,
                                       native=self._exec_native, **solver)}
        self._signature = programs.config_signature(cfg)
        # the target lane's length as data, and the trees' scene index
        self._n_points = torch.tensor(self.tgt_static.n_points, device=self.device)
        self._scene = torch.zeros(MAX_TREES, dtype=torch.long, device=self.device)
        if self._exec_native:
            native.load()   # build the C++ solver now, not in the middle of a run

    def program_set(self) -> programs.ProgramSet:
        """The compiled programs of this planner's configuration and device,
        shared with every planner of both."""
        return programs.program_set(self._signature, self.net, self.device)

    def _run(self, kind: str, inputs, compiled: bool, keep=(), **kw):
        """The body `kind` on `inputs`: its program (copy in, replay) or
        eagerly (host tensors uploaded first). Returns (outputs, the program
        or None)."""
        if compiled:
            prog = self.program_set().program(kind, self._bodies[kind], inputs, keep)
            return prog(self.net, inputs), prog
        inputs = tree_map(lambda t: t.to(self.device), inputs)
        return self._bodies[kind](self.net, inputs, **kw)[0], None

    def _cost_params(self):
        """Static parts of the warm/full CostParams (built once; only the
        state-centered grid origin changes per plan)."""
        if not hasattr(self, "_cost_params_cache"):
            cfg = self.cfg
            tv = float(self.lcl_smp.target_velocity)
            zero = np.zeros(6)
            lane_local = self.gt_tgt_lane - self.origin
            self._cost_params_cache = tuple(
                make_cost_params(phase, zero, lane_local, tv, MAX_COST_TGT_PTS,
                                 warm=warm, device=self.device)
                for phase, warm in ((cfg.traj_tree.warm, True), (cfg.traj_tree.full, False)))
        return self._cost_params_cache

    def _field_offset(self, state: np.ndarray):
        """Grid origin from a LOCAL-frame state, float64 (two_phase_solve
        casts cost params to the solve dtype)."""
        ph = self.cfg.traj_tree.full
        n, _ = ph.smooth_grid_size
        half = 0.5 * (n - 1) * ph.smooth_grid_res
        return torch.tensor([state[0] - half, state[1] - half], dtype=torch.float64,
                            device=self.device)

    # ------------------------------------------------------------------
    # NATIVE execution re-solve (TrajTreeConfig.exec_resolve_mode="native"):
    # the winner tree's two-phase float64 solve runs as C++ on the host
    # (mind_tpu_torch/native/exec_ilqr.cpp), the semantics of the device
    # 'scratch' re-solve (reference planner.py:174-178).
    # ------------------------------------------------------------------
    def _native_cost_params(self):
        """Flat phase-parameter blocks + target-lane points for the C++
        solver (built once; only the grid origin changes per plan)."""
        if not hasattr(self, "_native_params_cache"):
            warm_p, full_p = self._cost_params()
            wf, pts = native.pack_cost_params(warm_p)
            ff, _ = native.pack_cost_params(full_p)  # the phases share the lane
            self._native_params_cache = (wf, ff, pts)
        return self._native_params_cache

    def _native_exec_ctrl(self, parent, node_mask, nodes, s_loc) -> Optional[np.ndarray]:
        """Staged-path entry: the winner tree's parent row, node mask [MN]
        and float64 NodeCostData (tensors on the device) go to the host in
        one packed read, then through the native re-solve."""
        zeros = torch.zeros(4, dtype=torch.float64, device=parent.device)
        flat = native.pack_exec_payload(zeros, parent, node_mask, *nodes).cpu().numpy()
        return self._native_exec_ctrl_flat(flat, s_loc)

    def _native_exec_ctrl_flat(self, flat: np.ndarray, s_loc) -> Optional[np.ndarray]:
        """Fused-path entry: unpack the one-read payload written by
        fused_plan_core (layout and size check: native.unpack_exec_payload)
        and run the native re-solve."""
        pl = native.unpack_exec_payload(flat, self.cfg.traj_tree.max_cost_nodes,
                                        self.cfg.max_actors - 1)
        return self._native_solve_arrays(pl.parent, pl.node_mask, pl.prob, pl.ego_mean,
                                         pl.ego_cov, pl.exo_mean, pl.exo_cov, pl.exo_mask,
                                         s_loc)

    def _native_solve_arrays(self, parent, mask, prob, ego_mean, ego_cov, exo_mean, exo_cov,
                             exo_mask, s_loc) -> Optional[np.ndarray]:
        """The native two-phase re-solve of the winner tree; returns its
        first control (xs[0, 4:6], planner.py:141-144 semantics), or None
        when the tree is empty."""
        n = int(mask.sum())
        if n <= 0:
            return None
        tt = self.cfg.traj_tree
        wf, ff, pts = self._native_cost_params()
        off = self._field_offset_np(s_loc)
        wf, ff = wf.copy(), ff.copy()
        wf[0:2] = off
        ff[0:2] = off
        x0 = np.concatenate([np.asarray(s_loc, np.float64), np.asarray(self.ctrl, np.float64)])
        xs, _us, _info = native.two_phase_solve(
            parent[:n], prob[:n], ego_mean[:n], ego_cov[:n], exo_mean[:n], exo_cov[:n],
            exo_mask[:n], pts, x0, wf, ff, dt=tt.dt, wb=tt.wheelbase,
            warm_max_iterations=tt.warm_max_iterations, max_iterations=tt.max_iterations,
            rel_tol=tt.rel_tol, n_line_search=tt.n_line_search, mu_max=tt.max_reg)
        return xs[0, 4:6]

    def _field_offset_np(self, state: np.ndarray) -> np.ndarray:
        """Numpy twin of _field_offset (the same float64 arithmetic)."""
        ph = self.cfg.traj_tree.full
        n, _ = ph.smooth_grid_size
        half = 0.5 * (n - 1) * ph.smooth_grid_res
        return np.array([state[0] - half, state[1] - half], np.float64)

    def local_state(self) -> np.ndarray:
        """Current ego state in the local planning frame (float64 host)."""
        s = np.asarray(self.state, np.float64).copy()
        s[:2] -= self.origin
        return s

    def _host_vector(self, s_loc: np.ndarray) -> torch.Tensor:
        """The plan's host values in one float64 CPU tensor [9]: x0 (the
        local state and the control, float64: two_phase_solve casts to the
        solve dtype, and the exec re-solve sees the unrounded state), the
        grid origin (the one cost parameter that follows the state) and the
        selection's target velocity, rounded to float32 as the JAX package
        passes it."""
        return torch.from_numpy(np.concatenate([
            s_loc, np.asarray(self.ctrl, np.float64), self._field_offset_np(s_loc),
            [float(np.float32(self.lcl_smp.target_velocity))]]))

    def _statics(self):
        """(warm, full CostParams without the grid origin, the target-lane
        static with its length as a tensor)."""
        warm_p, full_p = self._cost_params()
        return (warm_p._replace(field_offset=None), full_p._replace(field_offset=None),
                self.tgt_static._replace(n_points=self._n_points))

    # ------------------------------------------------------------------
    # reference public surface
    # ------------------------------------------------------------------
    def update_observation(self, observations):
        self.obs_buffer.update(observations)

    def update_state_ctrl(self, state, ctrl):
        self.state = np.asarray(state, np.float64)
        self.ctrl = np.asarray(ctrl, np.float64)

    def update_target_lane(self, gt_tgt_lane):
        self.gt_tgt_lane = np.asarray(gt_tgt_lane, np.float64)

    @torch.no_grad()
    def plan(self) -> Tuple[bool, Optional[np.ndarray], Optional[list]]:
        """One plan: (ok, control, [[scenario tree], [trajectory tree]] on
        the staged path or None). Compiled (graphed None on the card, or
        True) it copies the inputs into the programs and replays them; it
        reads the device once after AIME and once after the solve, then
        what it exports (the fused path: once)."""
        cfg = self.cfg
        MN = cfg.scen_tree.max_tree_nodes
        actor_mask = self.obs_buffer.actor_mask()
        if not actor_mask[0]:
            return False, None, None  # no ego observation yet
        amask_d = self.obs_buffer.mask_device(actor_mask)
        compiled = programs.compiled(self.device, self.graphed)

        if not self.export_trees:
            return self._plan_fused(amask_d, compiled)

        warm_p, full_p, tgt = self._statics()
        with self.metrics.timer.phase("aime"):
            (slots, norm_prob, packed), aime = self._run("aime", AimeInputs(
                self.obs_buffer.buf, self.obs_buffer.types_device(), amask_d, self.lane_static,
                tgt), compiled)
            packed_np = packed.cpu().numpy()  # the one AIME-side read after the rounds
        self.last_rounds = int(packed_np[5 * MN + 1])

        parent = packed_np[0:MN].astype(np.int64)
        duration = packed_np[MN:2 * MN].astype(np.int64)
        end_flag = packed_np[2 * MN:3 * MN] > 0.5
        tree_id = packed_np[3 * MN:4 * MN].astype(np.int64)
        norm_prob_np = packed_np[4 * MN:5 * MN]
        n_nodes = int(packed_np[5 * MN])

        if not end_flag.any():
            self.metrics.incr("plan_failures")
            return False, None, None
        self.metrics.incr("plans")
        self.last_n_nodes = n_nodes
        # AIME meta kept for stage-by-stage diagnostics
        self.last_meta = {"parent": parent, "duration": duration, "end_flag": end_flag,
                          "tree_id": tree_id, "norm_prob": norm_prob_np}

        with self.metrics.timer.phase("flatten"):
            trees = build_cost_indices(parent, duration, end_flag, tree_id,
                                       cfg.traj_tree)[:MAX_TREES]
            n_real = len(trees)
            packed_trees = pack_trees(trees + [trees[0]] * (MAX_TREES - n_real), n_real)
            self.last_n_trees = n_real
            self.metrics.observe("scen_trees", n_real)
            self.metrics.observe("scen_nodes", n_nodes)

        s_loc = self.local_state()
        host = self._host_vector(s_loc)
        # on the card the solve reads the AIME program's buffers in place
        amask = aime.inputs.amask if aime is not None else amask_d
        solve_in = SolveInputs(slots, norm_prob, amask, torch.from_numpy(packed_trees), host,
                               warm_p, full_p, self._eval_segs, self._scene)
        laps = {}
        with self.metrics.timer.phase("solve"):
            if compiled:
                (xs_b, us_b, best_d, small_d), solve = self._run(
                    "solve", solve_in, True, keep=(*slots, norm_prob, amask))
                if self._resolves:
                    # the one synchronize, which splits the re-solve's lap off
                    torch.cuda.synchronize(self.device)
                    t_exec = time.perf_counter()
                    exec_in = ExecInputs(solve.inputs, best_d, us_b, small_d)
                    small_d, _ = self._run("exec", exec_in, True,
                                           keep=graph_control.tensors(exec_in))
            else:
                clock = _PhaseClock(self.device, laps) if self._resolves else None
                (xs_b, us_b, best_d, small_d), _ = self._run(
                    "solve", solve_in, False, exec_resolve=True, clock=clock)
                solve = None
            small = small_d.cpu().numpy()   # the one solve-side read
            if compiled and self._resolves:
                laps["exec_resolve"] = time.perf_counter() - t_exec
        if self._resolves:   # a part of "solve", kept apart as well
            self.metrics.timer.totals["exec_resolve"] += laps["exec_resolve"]
            self.metrics.timer.counts["exec_resolve"] += 1
        ctrl = small[:2].copy()
        best = int(small[2])
        self.last_best = best
        self.metrics.observe("ilqr_iterations", float(small[3]))
        self.last_tree_costs = small[4:4 + n_real]

        if self._exec_native and np.isfinite(ctrl).all():
            with self.metrics.timer.phase("exec_native"):
                # the winner's float64 cost nodes (the JAX `_exec_gather_fn`),
                # eagerly after the read, on the buffers the solve read
                dct = split_trees(solve.inputs.trees if solve is not None
                                  else solve_in.trees.to(self.device), cfg.traj_tree)
                w = slice(best, best + 1)
                nodes_e = gather_cost_nodes(slots, norm_prob, dct.cost_slot[w],
                                            dct.cost_step[w], dct.topo.node_mask[w], amask[None],
                                            self._scene[w], dtype=torch.float64)
                nat = self._native_exec_ctrl(dct.topo.parent[best], dct.topo.node_mask[best],
                                             nodes_e, s_loc)
            if nat is not None:
                ctrl = np.asarray(nat, np.float64)

        if not np.isfinite(ctrl).all():
            self.metrics.incr("plan_failures")
            return False, None, None

        with self.metrics.timer.phase("export"):
            scen_tree = self._export_scen_tree(
                NodeSlots(*(x[0] for x in slots)), parent, duration, end_flag, tree_id,
                norm_prob_np, actor_mask, best)
            traj_tree = self._export_traj_tree(
                trees[best][0], xs_b[best].cpu().numpy(), us_b[best].cpu().numpy(),
                host[:6].numpy())
        return True, ctrl, [[scen_tree], [traj_tree]]

    def _plan_fused(self, amask_d, compiled: bool):
        """Plan without exported trees: the cost trees are built on the
        device and the host reads four numbers."""
        with self.metrics.timer.phase("plan_fused"):
            s_loc = self.local_state()
            warm_p, full_p, tgt = self._statics()
            out, _ = self._run("fused", FusedInputs(
                self.obs_buffer.buf, self.obs_buffer.types_device(), amask_d,
                self._host_vector(s_loc), warm_p, full_p, self.lane_static, tgt,
                self._eval_segs), compiled)
            flat = out.cpu().numpy()  # the one read (with the payload in native mode)
            small = flat[:4]
        self.last_best, self.last_rounds = int(flat[-2]), int(flat[-1])
        ctrl = small[:2].astype(np.float64)
        self.metrics.observe("ilqr_iterations", float(small[3]))
        if small[2] < 0.5 or not np.isfinite(ctrl).all():
            self.metrics.incr("plan_failures")
            return False, None, None
        if self._exec_native:
            with self.metrics.timer.phase("exec_native"):
                nat = self._native_exec_ctrl_flat(flat[:-2], s_loc)
            if nat is not None:
                ctrl = np.asarray(nat, np.float64)
                if not np.isfinite(ctrl).all():
                    self.metrics.incr("plan_failures")
                    return False, None, None
        self.metrics.incr("plans")
        return True, ctrl, None

    # ------------------------------------------------------------------
    def _export_scen_tree(self, slots: NodeSlots, parent, duration, end_flag,
                          tree_id, norm_prob, actor_mask, best: int) -> Tree:
        """Pull the best tree's node trajectories for visualization
        (reference get_scenario_tree export, scenario_tree.py:243-272).
        `best` indexes the sorted root-child slots, the order in which both
        build_cost_indices and device_cost_topology number the trees."""
        roots = sorted({int(t) for t in np.unique(tree_id) if t >= 0})
        rc = roots[best]
        members = [int(i) for i in np.flatnonzero(end_flag) if tree_id[i] == rc]
        tree = Tree()
        if not members:
            return tree
        ids = torch.tensor(members, dtype=torch.long, device=self.device)
        pos = slots.pos[ids].cpu().numpy() + self.origin  # back to global
        cov = slots.cov[ids].cpu().numpy()
        tgt = slots.tgt_pts[ids].cpu().numpy() + self.origin
        row = {k: i for i, k in enumerate(members)}

        # BFS insertion: root child first, then children by parent links
        inserted = {rc}
        queue = [rc]
        tree.add_node(Node(rc, None, self._payload(rc, row, pos, cov, tgt, duration,
                                                   norm_prob, actor_mask)))
        while queue:
            k = queue.pop(0)
            for c in members:
                if int(parent[c]) == k and c not in inserted:
                    tree.add_node(Node(c, k, self._payload(
                        c, row, pos, cov, tgt, duration, norm_prob, actor_mask)))
                    inserted.add(c)
                    queue.append(c)
        return tree

    @staticmethod
    def _payload(i, row, pos, cov, tgt, duration, norm_prob, actor_mask):
        d = int(duration[i])
        r = row[i]
        traj = pos[r][actor_mask, OBS_LEN:OBS_LEN + d]
        cv = cov[r][actor_mask, OBS_LEN:OBS_LEN + d]
        return [float(norm_prob[i]), traj, cv, tgt[r]]

    def _export_traj_tree(self, topo, xs, us, x0) -> Tree:
        xs = np.asarray(xs, np.float64).copy()
        xs[:, :2] += self.origin  # back to global for visualization
        x0 = np.asarray(x0, np.float64).copy()
        x0[:2] += self.origin
        tree = Tree()
        tree.add_node(Node(-1, None, [x0, np.zeros(2)]))
        parent = np.asarray(topo.parent)
        mask = np.asarray(topo.node_mask)
        for i in range(int(mask.sum())):
            p = int(parent[i])
            tree.add_node(Node(i, p if p >= 0 else -1, [xs[i], us[i]]))
        return tree
