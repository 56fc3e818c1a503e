"""Trajectory-tree optimizer pieces of the plan cycle (port of
mind_tpu/planner/trajectory_tree.py): scenario trees flattened to cost
trees on the host, cost-node gather, per-phase cost parameters, the
two-phase and polish solves and the best-tree selection cost. The device
functions take a leading axis of trees where the JAX package vmaps; the
host-side constructors return one tree each, without that axis.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from mind_tpu_torch.common.device import resolve_device
from mind_tpu_torch.common.geometry import point_segments_dist
from mind_tpu_torch.common.tree import Tree
from mind_tpu_torch.config import OptPhaseConfig, TrajTreeConfig
from mind_tpu_torch.ops.potential import CostParams, NodeCostData
from mind_tpu_torch.planner.ilqr import ILQRConfig, TreeTopology, build_topology, ilqr_solve

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}")
    return _DTYPES[name]


class CostTreeArrays(NamedTuple):
    """One scenario tree flattened to cost-node arrays (padded to MN)."""

    topo: TreeTopology
    nodes: NodeCostData
    n_nodes: np.ndarray  # [] int32 real cost-node count


def flatten_scen_tree(scen_tree: Tree, actor_mask: np.ndarray, cfg: TrajTreeConfig,
                      max_exo: int, device=None) -> CostTreeArrays:
    """DFS over the nodes of an exported scenario tree, one cost node per
    even step (reference trajectory_tree.py:28-54,66-122). Node data is
    [prob, trajs [n, d, 2], covs [n, d], target points]; `actor_mask` marks
    the buffer slots the n trajectories belong to (ego first)."""
    device = resolve_device(device)
    MN = cfg.max_cost_nodes
    parents: List[int] = []
    probs: List[float] = []
    ego_means: List[np.ndarray] = []
    ego_covs: List[float] = []
    exo_means: List[np.ndarray] = []
    exo_covs: List[np.ndarray] = []

    exo_valid = np.asarray(actor_mask)[1:]
    n_exo = exo_valid.shape[0]

    last_index = {}
    stack = [scen_tree.get_root()]
    while stack:
        node = stack.pop()
        prob, trajs, covs, _tgt = node.data
        last = last_index[node.parent_key] if node.parent_key is not None else -1
        duration = trajs.shape[1]
        for i in range(0, duration, 2):
            parents.append(last)
            last = len(parents) - 1
            probs.append(float(prob))
            ego_means.append(trajs[0, i])
            ego_covs.append(float(covs[0, i]))
            em = np.full((max_exo, 2), 1e6, np.float32)
            ec = np.zeros(max_exo, np.float32)
            em[:n_exo] = trajs[1:, i]
            ec[:n_exo] = covs[1:, i]
            exo_means.append(em)
            exo_covs.append(ec)
        last_index[node.key] = len(parents) - 1
        for ck in node.children_keys:
            stack.append(scen_tree.get_node(ck))

    n = len(parents)
    topo = build_topology(parents, MN, cfg.max_depth_levels,
                          max_width=cfg.max_width_hint, device=device)

    def pad1(vals, fill=0.0):
        out = np.full(MN, fill, np.float32)
        out[:n] = vals
        return out

    exo_mask = np.zeros((MN, max_exo), bool)
    exo_mask[:n] = exo_valid[None, :]
    em = np.full((MN, max_exo, 2), 1e6, np.float32)
    em[:n] = np.stack(exo_means)
    ec = np.zeros((MN, max_exo), np.float32)
    ec[:n] = np.stack(exo_covs)
    egm = np.zeros((MN, 2), np.float32)
    egm[:n] = np.stack(ego_means)

    t = lambda x: torch.as_tensor(x, device=device)
    nodes = NodeCostData(prob=t(pad1(probs)), ego_mean=t(egm), ego_cov=t(pad1(ego_covs)),
                         exo_mean=t(em), exo_cov=t(ec), exo_mask=t(exo_mask))
    return CostTreeArrays(topo=topo, nodes=nodes, n_nodes=np.int32(n))


def build_cost_indices(parent: np.ndarray, duration: np.ndarray, end_flag: np.ndarray,
                       tree_id: np.ndarray, cfg: TrajTreeConfig):
    """Host-side: AIME meta arrays -> per-tree cost-node index arrays.

    The construction of flatten_scen_tree without touching trajectories:
    cost node k of a tree references a (scenario slot, even step) pair, and
    gather_cost_nodes reads the means and covariances on the device. Returns
    a list of (topo, cost_slot [MN], cost_step [MN]) per scenario tree, in
    the order of the sorted root-child slots, all numpy."""
    MN = cfg.max_cost_nodes
    roots = sorted({int(t) for t in np.unique(tree_id) if t >= 0})
    # children lists over end-flagged nodes
    kids = {}
    for i in np.flatnonzero(end_flag):
        p = int(parent[i])
        if p >= 0:
            kids.setdefault(p, []).append(int(i))

    out = []
    for rc in roots:
        parents_c, slots_c, steps_c = [], [], []
        stack = [(rc, -1)]
        while stack:
            node, last = stack.pop()
            d = int(duration[node])
            for s in range(0, d, 2):
                parents_c.append(last)
                last = len(parents_c) - 1
                slots_c.append(node)
                steps_c.append(s)
            for c in kids.get(node, []):
                stack.append((c, last))
        topo = build_topology(parents_c, MN, cfg.max_depth_levels,
                              max_width=cfg.max_width_hint, as_numpy=True)
        cs = np.zeros(MN, np.int64)
        cs[:len(slots_c)] = slots_c
        st = np.zeros(MN, np.int64)
        st[:len(steps_c)] = steps_c
        out.append((topo, cs, st))
    return out


def gather_cost_nodes(slots, norm_prob, cost_slot, cost_step, node_mask,
                      actor_mask, scene, dtype=torch.float32) -> NodeCostData:
    """Per-cost-node data gathered from the tree slots of S scenes. slots,
    norm_prob and actor_mask carry a leading scene axis [S, ...]; cost_slot,
    cost_step, node_mask are [T, MNC] and `scene` [T] names each tree's
    scene, whose slots cost_slot indexes: the trees of S scenes stay one
    flat batch, the form the solver, the selection cost and the re-solve's
    index_select take. Scenario-node step i maps to hist index OBS_LEN + i.
    Slots hold float64 covariances; `dtype` is the solve precision."""
    OBS = 50
    t = OBS + cost_step
    MN = norm_prob.shape[-1]
    cost_slot = cost_slot + MN * scene[:, None]
    slots = type(slots)(*(x.flatten(0, 1) for x in slots))
    norm_prob = norm_prob.reshape(-1)
    exo_valid = actor_mask.index_select(0, scene)[:, None, 1:]   # [T, 1, A-1]
    pos_t = slots.pos[cost_slot, :, t].to(dtype)     # [T, MNC, A, 2]
    cov_t = slots.cov[cost_slot, :, t].to(dtype)     # [T, MNC, A]
    return NodeCostData(
        prob=(norm_prob[cost_slot] * node_mask).to(dtype),
        ego_mean=pos_t[:, :, 0],
        ego_cov=cov_t[:, :, 0],
        exo_mean=pos_t[:, :, 1:],
        exo_cov=cov_t[:, :, 1:],
        exo_mask=node_mask[..., None] & exo_valid,
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
                    ilqr_cfg: ILQRConfig, warm_cfg: ILQRConfig = None, active=None,
                    graphed=None):
    """Warm-start solve (target-lane cost only), then the full solve from
    the warm controls (reference planner.py:174-178), for a batch of trees.
    Float inputs are cast to `ilqr_cfg.dtype` here; results stay in it.
    `graphed` goes to ilqr_solve (None: a CUDA graph on the card)."""
    sd = torch_dtype(ilqr_cfg.dtype)
    x0 = x0.to(sd)
    nodes = _cast(nodes, sd)
    warm_params, full_params = _cast(warm_params, sd), _cast(full_params, sd)
    G, MN = topo.parent.shape
    us0 = torch.zeros((G, MN, 2), dtype=sd, device=x0.device)
    _, us_warm, info_w = ilqr_solve(topo, x0, us0, nodes, warm_params,
                                    warm_cfg or ilqr_cfg, active, graphed)
    xs, us, info = ilqr_solve(topo, x0, us_warm, nodes, full_params, ilqr_cfg, active,
                              graphed)
    info["warm_iterations"] = info_w["iterations"]
    return xs, us, info


def polish_solve(topo: TreeTopology, x0, us_init, nodes: NodeCostData,
                 full_params: CostParams, ilqr_cfg: ILQRConfig, active=None):
    """One full-phase solve at `ilqr_cfg.dtype` started from `us_init` (the
    selected tree's converged controls of the selection solve): the
    `TrajTreeConfig.exec_resolve_mode="polish"` re-solve. It descends the
    full cost surface from the lower-precision optimum, so it ends on
    rel_tol after a few iterations where two_phase_solve walks the whole
    warm + full path. Float inputs are cast to the solve dtype here."""
    sd = torch_dtype(ilqr_cfg.dtype)
    return ilqr_solve(topo, x0.to(sd), us_init.to(sd), _cast(nodes, sd),
                      _cast(full_params, sd), ilqr_cfg, active)


def evaluate_traj_tree(xs, us, node_mask, n_nodes, x0, eval_seg_start,
                       eval_seg_end, eval_seg_mask, target_vel, cfg_weights):
    """Best-tree selection cost per tree (reference planner.py:180-198):
    mean over tree nodes (including the x0 root) of comfort + efficiency +
    target distance terms, at the eval-segment dtype (float64 in
    production: the argmin over trees is a discrete decision).
    xs [T, MN, 6], us [T, MN, 2], node_mask [T, MN], n_nodes [T]; x0
    [T, 6] and the lane [T, P-1, ...] per tree, target_vel [T] or a float
    the trees share."""
    dtype = eval_seg_start.dtype
    xs, us, x0 = xs.to(dtype), us.to(dtype), x0.to(dtype)
    # [..., 1]: a node axis against the nodes' [T, MN] and the root's [T, 1]
    target_vel = torch.as_tensor(target_vel, dtype=dtype, device=xs.device)[..., None]
    # a node axis before the segments
    eval_seg_start, eval_seg_end, eval_seg_mask = (
        s[:, None] for s in (eval_seg_start, eval_seg_end, eval_seg_mask))
    comfort_acc_w, comfort_str_w, eff_w, tgt_w = cfg_weights

    def node_cost(x, u):
        d = point_segments_dist(x[..., :2], eval_seg_start, eval_seg_end, eval_seg_mask)
        return (comfort_acc_w * u[..., 0] ** 2 + comfort_str_w * u[..., 1] ** 2
                + eff_w * (target_vel - x[..., 2]) ** 2 + tgt_w * d)

    costs = torch.where(node_mask, node_cost(xs, us), torch.zeros((), dtype=dtype,
                                                                  device=xs.device))
    root_cost = node_cost(x0[..., None, :], torch.zeros(2, dtype=dtype, device=xs.device))[..., 0]
    return (costs.sum(-1) + root_cost) / (n_nodes + 1)
