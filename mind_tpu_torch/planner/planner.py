"""One MIND plan cycle (port of mind_tpu/planner/planner.py::fused_plan_core).

AIME tree growth + cost topology + two-phase tree iLQR + best-tree
selection, for one scene on one device. The MINDPlanner facade, the host
observation buffer and the exec re-solve modes are not ported yet.
"""

from __future__ import annotations

import time
from enum import Enum

import numpy as np
import torch

from mind_tpu_torch.config import PlannerConfig
from mind_tpu_torch.planner.aime_device import aime_grow_tree
from mind_tpu_torch.planner.cost_topology import device_cost_topology
from mind_tpu_torch.planner.ilqr import ILQRConfig
from mind_tpu_torch.planner.trajectory_tree import (
    evaluate_traj_tree,
    gather_cost_nodes,
    torch_dtype,
    two_phase_solve,
)

MAX_TREES = 6  # <= num modes root children
MAX_COST_TGT_PTS = 64   # cost-field target lane, 4 m simplified


class ObjectType(str, Enum):
    """AV2 object types (a copy of mind_tpu/data/av2.py's enum)."""

    VEHICLE = "vehicle"
    PEDESTRIAN = "pedestrian"
    MOTORCYCLIST = "motorcyclist"
    CYCLIST = "cyclist"
    BUS = "bus"
    STATIC = "static"
    BACKGROUND = "background"
    CONSTRUCTION = "construction"
    RIDERLESS_BICYCLE = "riderless_bicycle"
    UNKNOWN = "unknown"


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


def fused_plan_core(net, buf, types, amask, x0, warm_params, full_params,
                    target_vel, lane_static, tgt_static, eval_segs, *,
                    cfg, ilqr_cfg, warm_ilqr_cfg, weights,
                    return_exec_payload=False, report=None):
    """The whole plan cycle: AIME + cost topology + two-phase solve +
    selection. `net` is the batched ScenePredNet (it takes the place of the
    JAX version's params and batched_apply). Returns a float32 tensor
    [ctrl(2), ok, max_iterations].

    With `report` (a dict), the cycle also records the wall time of each
    phase in seconds under "aime", "cost_topology", "solve" and "selection"
    (with a device synchronize ending each phase), the AIME rounds run
    ("rounds"), the cost trees ("trees", a DeviceCostTrees), the per-tree
    selection costs ("tree_cost") and the selected tree ("best")."""
    tt = cfg.traj_tree
    if return_exec_payload or tt.exec_resolve_mode == "native":
        raise NotImplementedError("the native exec re-solve payload is not ported")
    if (tt.exec_solve_dtype or ilqr_cfg.dtype) != ilqr_cfg.dtype:
        raise NotImplementedError("the exec re-solve (polish/scratch) is not ported")
    dev = buf.pos.device
    clock = _PhaseClock(dev, report)

    state, meta, rounds = aime_grow_tree(net, cfg, buf, types, amask, lane_static, tgt_static)
    clock.lap("aime")
    dct = device_cost_topology(
        state.parent, state.depth, state.duration, state.start_t,
        state.end_flag, meta.tree_id, MAX_TREES, tt.max_cost_nodes,
        tt.max_depth_levels, tt.max_width_hint)
    clock.lap("cost_topology")
    sd = torch_dtype(ilqr_cfg.dtype)
    topo = dct.topo
    nodes = gather_cost_nodes(state.slots, meta.norm_prob, dct.cost_slot,
                              dct.cost_step, topo.node_mask, amask, dtype=sd)
    xs, us, info = two_phase_solve(topo, x0, nodes, warm_params, full_params,
                                   ilqr_cfg, warm_ilqr_cfg, active=dct.tree_mask)
    clock.lap("solve")
    cost_b = evaluate_traj_tree(xs, us, topo.node_mask, topo.node_mask.sum(-1), x0,
                                *eval_segs, target_vel, weights)
    cost_b = torch.where(dct.tree_mask, cost_b, torch.full_like(cost_b, float("inf")))
    best = torch.argmin(cost_b)
    ctrl = xs[best, 0, 4:6].to(torch.float32)
    ok = (dct.n_trees > 0).to(torch.float32)
    its = torch.where(dct.tree_mask, info["iterations"], torch.zeros_like(info["iterations"]))
    out = torch.cat([ctrl, ok[None], its.max().to(torch.float32)[None]])
    clock.lap("selection")
    if report is not None:
        report.update(rounds=rounds, trees=dct, tree_cost=cost_b, best=best)
    return out


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
