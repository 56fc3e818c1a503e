"""Trajectory-tree optimizer pieces of the plan cycle (port of
mind_tpu/planner/trajectory_tree.py): cost-node gather, per-phase cost
parameters, the two-phase solve and the best-tree selection cost. Every
function takes a leading axis of trees where the JAX package vmaps.
"""

from __future__ import annotations

import numpy as np
import torch

from mind_tpu_torch.common.device import resolve_device
from mind_tpu_torch.common.geometry import point_segments_dist
from mind_tpu_torch.config import OptPhaseConfig
from mind_tpu_torch.ops.potential import CostParams, NodeCostData
from mind_tpu_torch.planner.ilqr import ILQRConfig, TreeTopology, ilqr_solve

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}")
    return _DTYPES[name]


def gather_cost_nodes(slots, norm_prob, cost_slot, cost_step, node_mask,
                      actor_mask, dtype=torch.float32) -> NodeCostData:
    """Per-cost-node data gathered from the tree slots. cost_slot,
    cost_step, node_mask [T, MNC]; scenario-node step i maps to hist index
    OBS_LEN + i. Slots hold float64 covariances; `dtype` is the solve
    precision."""
    OBS = 50
    t = OBS + cost_step
    pos_t = slots.pos[cost_slot, :, t].to(dtype)     # [T, MNC, A, 2]
    cov_t = slots.cov[cost_slot, :, t].to(dtype)     # [T, MNC, A]
    return NodeCostData(
        prob=(norm_prob[cost_slot] * node_mask).to(dtype),
        ego_mean=pos_t[:, :, 0],
        ego_cov=cov_t[:, :, 0],
        exo_mean=pos_t[:, :, 1:],
        exo_cov=cov_t[:, :, 1:],
        exo_mask=node_mask[..., None] & actor_mask[1:],
    )


def make_cost_params(phase: OptPhaseConfig, x0: np.ndarray, tgt_lane: np.ndarray,
                     target_vel: float, max_tgt_pts: int, warm: bool,
                     device=None) -> CostParams:
    """Per-phase CostParams, stored in float64 (two_phase_solve casts them
    to the solve dtype); the warm phase zeroes the ego/exo disc fields."""
    device = resolve_device(device)
    n, _ = phase.smooth_grid_size
    res = phase.smooth_grid_res
    field_size = (n - 1) * res
    f64 = dict(dtype=torch.float64, device=device)
    offset = np.array([x0[0] - 0.5 * field_size, x0[1] - 0.5 * field_size], np.float64)

    P = max_tgt_pts
    pts = np.full((P, 2), 1e6, np.float64)
    m = min(len(tgt_lane), P)
    pts[:m] = tgt_lane[:m]
    seg_mask = np.zeros(P - 1, bool)
    seg_mask[:m - 1] = True

    t = lambda x: torch.tensor(x, **f64)
    return CostParams(
        field_offset=t(offset),
        res=t(res),
        grid_n=n,
        tgt_seg_start=t(pts[:-1]),
        tgt_seg_end=t(pts[1:]),
        tgt_seg_mask=torch.tensor(seg_mask, device=device),
        w_tgt=t(phase.w_tgt),
        w_ego=t(0.0 if warm else phase.w_ego),
        w_ego_cov_offset=t(phase.w_ego_cov_offset),
        w_exo=t(0.0 if warm else phase.w_exo),
        w_exo_cov_offset=t(phase.w_exo_cov_offset),
        w_exo_cost_offset=t(phase.w_exo_cost_offset),
        w_des_state=t(np.diag(phase.w_des_state())),
        des_state=t([0, 0, target_vel, 0, 0, 0]),
        w_state_con=t(np.diag(phase.w_state_con())),
        state_lb=t(phase.state_lower_bound),
        state_ub=t(phase.state_upper_bound),
        w_ctrl=t([phase.w_ctrl, phase.w_ctrl]),
    )


def _cast(t, dtype):
    return type(t)(*(x.to(dtype) if isinstance(x, torch.Tensor) and x.is_floating_point()
                     else x for x in t))


def two_phase_solve(topo: TreeTopology, x0, nodes: NodeCostData,
                    warm_params: CostParams, full_params: CostParams,
                    ilqr_cfg: ILQRConfig, warm_cfg: ILQRConfig = None, active=None):
    """Warm-start solve (target-lane cost only), then the full solve from
    the warm controls (reference planner.py:174-178), for a batch of trees.
    Float inputs are cast to `ilqr_cfg.dtype` here; results stay in it."""
    sd = torch_dtype(ilqr_cfg.dtype)
    x0 = x0.to(sd)
    nodes = _cast(nodes, sd)
    warm_params, full_params = _cast(warm_params, sd), _cast(full_params, sd)
    G, MN = topo.parent.shape
    us0 = torch.zeros((G, MN, 2), dtype=sd, device=x0.device)
    _, us_warm, info_w = ilqr_solve(topo, x0, us0, nodes, warm_params,
                                    warm_cfg or ilqr_cfg, active)
    xs, us, info = ilqr_solve(topo, x0, us_warm, nodes, full_params, ilqr_cfg, active)
    info["warm_iterations"] = info_w["iterations"]
    return xs, us, info


def evaluate_traj_tree(xs, us, node_mask, n_nodes, x0, eval_seg_start,
                       eval_seg_end, eval_seg_mask, target_vel, cfg_weights):
    """Best-tree selection cost per tree (reference planner.py:180-198):
    mean over tree nodes (including the x0 root) of comfort + efficiency +
    target distance terms, at the eval-segment dtype (float64 in
    production: the argmin over trees is a discrete decision).
    xs [T, MN, 6], us [T, MN, 2], node_mask [T, MN], n_nodes [T]."""
    dtype = eval_seg_start.dtype
    xs, us, x0 = xs.to(dtype), us.to(dtype), x0.to(dtype)
    target_vel = torch.as_tensor(target_vel, dtype=dtype, device=xs.device)
    comfort_acc_w, comfort_str_w, eff_w, tgt_w = cfg_weights

    def node_cost(x, u):
        d = point_segments_dist(x[..., :2], eval_seg_start, eval_seg_end, eval_seg_mask)
        return (comfort_acc_w * u[..., 0] ** 2 + comfort_str_w * u[..., 1] ** 2
                + eff_w * (target_vel - x[..., 2]) ** 2 + tgt_w * d)

    costs = torch.where(node_mask, node_cost(xs, us), torch.zeros((), dtype=dtype,
                                                                  device=xs.device))
    root_cost = node_cost(x0, torch.zeros(2, dtype=dtype, device=xs.device))
    return (costs.sum(-1) + root_cost) / (n_nodes + 1)
