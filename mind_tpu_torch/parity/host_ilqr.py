"""Host-numpy (float64) tree-structured iLQR with reference semantics (the
port's own copy of mind_tpu/parity/host_ilqr.py, equal to it to the bit:
tests/test_torch_parity_host.py).

Independent mirror of the reference solver (reference planners/ilqr/
solver.py:80-240) used by the parity harness: recursive-tree forward rollout,
leaf-to-root Riccati backward pass with the child V_x/V_xx SUM
(solver.py:349-350), sequential first-accept backtracking line search over
alpha = 1.1**(-i^2) (solver.py:124-125,180-240) and the Levenberg-Marquardt
mu/delta schedule (solver.py:40-49,153-158). Shares no code with
mind_tpu_torch/planner/ilqr.py (the batched level-scan solver) beyond the
problem definition; agreement between the two is what
tests/test_torch_parity.py checks.

Costs follow the reference potential stack (planners/ilqr/potential.py,
cost.py:326-446): a 3x3-smoothed biquadratic-Bezier-interpolated grid field
plus closed-form state/control potentials. The raw grid-cell values are
evaluated on demand at the 9 cells a query touches — mathematically identical
to rasterizing the 256x256 grid first (the reference's gen_dist_field +
per-node disc stamping) and reading the same 9 cells;
tests/test_potential.py proves that grid equivalence against a full
rasterized mirror.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


# --------------------------------------------------------------------------
# cost model (numpy twin of ops/potential.py, reference potential.py)
# --------------------------------------------------------------------------

@dataclass
class HostCostParams:
    """Per-phase cost parameters (reference planning/demo_*.py TrajTreeCfg)."""

    field_offset: np.ndarray    # [2] grid origin (reference ilqr/utils.py:5-11)
    res: float
    grid_n: int
    tgt_lane: np.ndarray        # [P, 2] cost-field target lane (4 m simplified)
    w_tgt: float
    w_ego: float
    w_ego_cov_offset: float
    w_exo: float
    w_exo_cov_offset: float
    w_exo_cost_offset: float
    w_des_state: np.ndarray     # [6] diagonal
    des_state: np.ndarray       # [6]
    w_state_con: np.ndarray     # [6] diagonal
    state_lb: np.ndarray        # [6]
    state_ub: np.ndarray        # [6]
    w_ctrl: np.ndarray          # [2]


@dataclass
class HostCostNode:
    """One cost node (one even scenario-tree timestep)."""

    parent: int                 # index into the cost-node list, -1 = root x0
    prob: float
    ego_mean: np.ndarray        # [2]
    ego_cov: float
    exo_mean: np.ndarray        # [X, 2]
    exo_cov: np.ndarray         # [X]


def _point_segments_dist(p: np.ndarray, lane: np.ndarray) -> float:
    seg = lane[1:] - lane[:-1]
    len_sq = np.sum(seg * seg, axis=-1)
    len_sq = np.where(len_sq > 0, len_sq, 1.0)
    t = np.clip(np.sum((p - lane[:-1]) * seg, axis=-1) / len_sq, 0.0, 1.0)
    proj = lane[:-1] + t[:, None] * seg
    return float(np.min(np.linalg.norm(p - proj, axis=-1)))


def _cell_value(cell_xy: np.ndarray, node: HostCostNode,
                p: HostCostParams) -> float:
    """Raw cost-field value at one grid-cell center (reference
    trajectory_tree.py:80-106: target-lane quadratic + ego containment +
    exo inflation discs)."""
    d_tgt = _point_segments_dist(cell_xy, p.tgt_lane)
    val = p.w_tgt * node.prob * d_tgt * d_tgt

    if p.w_ego != 0.0:
        ego_d = np.linalg.norm(cell_xy - node.ego_mean)
        val += p.w_ego * max(ego_d - (node.ego_cov + p.w_ego_cov_offset), 0.0)

    if p.w_exo != 0.0 and len(node.exo_mean):
        exo_d = np.linalg.norm(cell_xy - node.exo_mean, axis=-1)
        exo_f = np.maximum((node.exo_cov + p.w_exo_cov_offset) - exo_d, 0.0)
        exo_f = np.where(exo_f > 0, exo_f + p.w_exo_cost_offset, 0.0)
        val += p.w_exo * float(np.sum(exo_f))
    return float(val)


def _smooth_3x3(g: np.ndarray) -> np.ndarray:
    """2x2-mean smoothing of a 3x3 patch (reference potential.py:146-155)."""
    return np.array([
        [(g[0, 0] + g[0, 1] + g[1, 0] + g[1, 1]) / 4,
         (g[0, 1] + g[1, 1]) / 2,
         (g[0, 1] + g[0, 2] + g[1, 1] + g[1, 2]) / 4],
        [(g[1, 0] + g[1, 1]) / 2,
         g[1, 1],
         (g[1, 1] + g[1, 2]) / 2],
        [(g[1, 0] + g[1, 1] + g[2, 0] + g[2, 1]) / 4,
         (g[1, 1] + g[2, 1]) / 2,
         (g[1, 1] + g[1, 2] + g[2, 1] + g[2, 2]) / 4],
    ])


def potential_field_eval_np(pos: np.ndarray, node: HostCostNode,
                            p: HostCostParams):
    """(value, grad [2], hess [2,2]) of the smoothed biquadratic field at
    `pos` (reference potential.py:72-264).

    Out-of-domain queries project onto the grid box and add a convex
    pull-back term, matching ops/potential.py:potential_field_eval (the
    reference's cell-index-only clamp extrapolates the border Bezier patch
    negatively — a latent bug its in-grid CPU trajectories never hit)."""
    lo = np.asarray(p.field_offset, float)
    hi = lo + p.res * (p.grid_n - 1)
    pos_c = np.clip(np.asarray(pos, float), lo, hi)
    delta = np.asarray(pos, float) - pos_c
    pos = pos_c

    fx = (pos[0] - p.field_offset[0]) / p.res
    fy = (pos[1] - p.field_offset[1]) / p.res
    x_idx = int(np.clip(np.round(fx), 0, p.grid_n - 1))
    y_idx = int(np.clip(np.round(fy), 0, p.grid_n - 1))

    local = np.zeros((3, 3))
    for r, dy in enumerate((-1, 0, 1)):
        for c, dx in enumerate((-1, 0, 1)):
            ix, iy = x_idx + dx, y_idx + dy
            if 0 <= ix < p.grid_n and 0 <= iy < p.grid_n:
                cell_xy = p.field_offset + p.res * np.array([ix, iy], float)
                local[r, c] = _cell_value(cell_xy, node, p)
    grid = _smooth_3x3(local)

    grid_ori = p.field_offset + p.res * np.array([x_idx, y_idx], float)
    u = (pos[0] - grid_ori[0]) / p.res + 0.5
    v = (pos[1] - grid_ori[1]) / p.res + 0.5

    def basis(t):
        return np.array([(1 - t) ** 2, 2 * (1 - t) * t, t ** 2])

    def dbasis(t):
        return np.array([-2 + 2 * t, 2 - 4 * t, 2 * t])

    ddb = np.array([2.0, -4.0, 2.0])
    bu, bv = basis(u), basis(v)
    dbu, dbv = dbasis(u), dbasis(v)

    val = bv @ grid @ bu
    gx = (bv @ grid @ dbu) / p.res
    gy = (dbv @ grid @ bu) / p.res
    hxx = (bv @ grid @ ddb) / p.res ** 2
    hyy = (ddb @ grid @ bu) / p.res ** 2
    hxy = (dbv @ grid @ dbu) / p.res ** 2
    grad = np.array([gx, gy])
    hess = np.array([[hxx, hxy], [hxy, hyy]])

    # convex pull-back outside the domain (see ops/potential.py)
    k = p.w_tgt * node.prob
    out_axis = (delta != 0.0).astype(float)
    in_axis = 1.0 - out_axis
    val = val + k * float(delta @ delta)
    grad = grad * in_axis + 2.0 * k * delta
    hess = hess * np.outer(in_axis, in_axis) + 2.0 * k * np.diag(out_axis)
    return val, grad, hess


def cost_node_eval_np(x: np.ndarray, u: np.ndarray, node: HostCostNode,
                      p: HostCostParams):
    """(l, l_x, l_u, l_xx, l_uu) at one cost node; l_ux is identically zero
    (reference cost.py:416-428)."""
    f_val, f_grad, f_hess = potential_field_eval_np(x[:2], node, p)

    w_des = p.w_des_state * node.prob
    diff = x - p.des_state
    sp_val = float(np.sum(w_des * diff * diff))
    sp_grad = 2.0 * w_des * diff
    sp_hess = 2.0 * w_des

    w_con = p.w_state_con * node.prob
    over = np.maximum(x - p.state_ub, 0.0)
    under = np.maximum(p.state_lb - x, 0.0)
    viol = over + under
    sc_val = float(np.sum(w_con * viol * viol))
    sc_grad = 2.0 * w_con * np.where(over > 0, over, -under)
    sc_hess = np.where(viol > 0, 2.0 * w_con, 0.0)

    w_ctrl = p.w_ctrl * node.prob
    cp_val = float(np.sum(w_ctrl * u * u))

    l = f_val + sp_val + sc_val + cp_val
    l_x = sp_grad + sc_grad
    l_x[:2] += f_grad
    l_u = 2.0 * w_ctrl * u
    l_xx = np.diag(sp_hess + sc_hess)
    l_xx[:2, :2] += f_hess
    l_uu = np.diag(2.0 * w_ctrl)
    return l, l_x, l_u, l_xx, l_uu


# --------------------------------------------------------------------------
# dynamics (extended bicycle, reference trajectory_tree.py:149-177)
# --------------------------------------------------------------------------

def ext_bicycle_step_np(x: np.ndarray, u: np.ndarray, dt: float,
                        wb: float) -> np.ndarray:
    px, py, v, q, a, s = x
    da, ds = u
    return np.array([
        px + v * np.cos(q) * dt,
        py + v * np.sin(q) * dt,
        v + a * dt,
        q + v / wb * np.tan(s) * dt,
        a + da * dt,
        s + ds * dt,
    ])


def ext_bicycle_jacobians_np(x: np.ndarray, dt: float, wb: float):
    """Analytic (f_x [6,6], f_u [6,2]) of the step above — the derivatives
    the reference compiles through Theano (dynamics.py:245-285)."""
    _, _, v, q, _, s = x
    f_x = np.eye(6)
    f_x[0, 2] = np.cos(q) * dt
    f_x[0, 3] = -v * np.sin(q) * dt
    f_x[1, 2] = np.sin(q) * dt
    f_x[1, 3] = v * np.cos(q) * dt
    f_x[2, 4] = dt
    f_x[3, 2] = np.tan(s) / wb * dt
    f_x[3, 5] = v / (wb * np.cos(s) ** 2) * dt
    f_u = np.zeros((6, 2))
    f_u[4, 0] = dt
    f_u[5, 1] = dt
    return f_x, f_u


# --------------------------------------------------------------------------
# solver
# --------------------------------------------------------------------------

@dataclass
class HostILQRResult:
    xs: np.ndarray        # [N, 6]
    us: np.ndarray        # [N, 2]
    J: float
    iterations: int
    converged: bool


def _tree_rollout(parents: List[int], x0, us, dt, wb):
    """xs[n] = f(xs[parent[n]] or x0, us[n]); nodes are in topological order
    (the reference's BFS rollout, solver.py:255-330)."""
    n = len(parents)
    xs = np.zeros((n, 6))
    for i in range(n):
        xp = x0 if parents[i] < 0 else xs[parents[i]]
        xs[i] = ext_bicycle_step_np(xp, us[i], dt, wb)
    return xs


def _tree_rollout_policy(parents, x0, xs_nom, us_nom, k, K, alpha, dt, wb):
    """Closed-loop re-rollout u = u_nom + alpha*k + K (x_par_new - x_par_nom)
    (reference solver.py:202-240)."""
    n = len(parents)
    xs = np.zeros((n, 6))
    us = np.zeros((n, 2))
    for i in range(n):
        if parents[i] < 0:
            xp_new = xp_nom = x0
        else:
            xp_new = xs[parents[i]]
            xp_nom = xs_nom[parents[i]]
        us[i] = us_nom[i] + alpha * k[i] + K[i] @ (xp_new - xp_nom)
        xs[i] = ext_bicycle_step_np(xp_new, us[i], dt, wb)
    return xs, us


def _tree_cost(xs, us, nodes: List[HostCostNode], params):
    return sum(cost_node_eval_np(xs[i], us[i], nodes[i], params)[0]
               for i in range(len(nodes)))


def host_ilqr_solve(nodes: List[HostCostNode], x0: np.ndarray,
                    us_init: np.ndarray, params: HostCostParams,
                    dt: float = 0.2, wb: float = 2.5,
                    max_iterations: int = 100, rel_tol: float = 1e-6,
                    n_line_search: int = 10, mu_init: float = 1.0,
                    mu_min: float = 1e-6, mu_max: float = 1e10,
                    delta_0: float = 2.0) -> HostILQRResult:
    """Reference-semantics tree iLQR (solver.py:80-167).

    `nodes` carry topology (node.parent) and per-node cost data; derivatives
    and costs are evaluated at the propagated state (x_new, u), as the
    reference does (solver.py:255-330).
    """
    parents = [nd.parent for nd in nodes]
    n = len(nodes)
    children: List[List[int]] = [[] for _ in range(n)]
    for i, p in enumerate(parents):
        if p >= 0:
            children[p].append(i)

    alphas = 1.1 ** (-np.arange(n_line_search, dtype=float) ** 2)
    mu, delta = mu_init, delta_0

    xs = _tree_rollout(parents, x0, us_init, dt, wb)
    us = us_init.copy()
    J_opt = _tree_cost(xs, us, nodes, params)
    accepted = True  # derivatives are fresh for the first iteration
    converged = False
    it = 0

    F_x = np.zeros((n, 6, 6))
    F_u = np.zeros((n, 6, 2))
    L_x = np.zeros((n, 6))
    L_u = np.zeros((n, 2))
    L_xx = np.zeros((n, 6, 6))
    L_uu = np.zeros((n, 2, 2))

    for it in range(1, max_iterations + 1):
        if accepted:
            for i in range(n):
                F_x[i], F_u[i] = ext_bicycle_jacobians_np(xs[i], dt, wb)
                _, L_x[i], L_u[i], L_xx[i], L_uu[i] = cost_node_eval_np(
                    xs[i], us[i], nodes[i], params)

        # backward pass: leaf -> root, children V summed into the parent
        # (reference solver.py:332-373 recursion, iterated in reverse
        # topological order — identical traversal)
        V_x = np.zeros((n, 6))
        V_xx = np.zeros((n, 6, 6))
        k = np.zeros((n, 2))
        K = np.zeros((n, 2, 6))
        pd_ok = True
        for i in range(n - 1, -1, -1):
            v_x = sum((V_x[c] for c in children[i]), np.zeros(6))
            v_xx = sum((V_xx[c] for c in children[i]), np.zeros((6, 6)))
            Q_x = L_x[i] + F_x[i].T @ v_x
            Q_u = L_u[i] + F_u[i].T @ v_x
            Q_xx = L_xx[i] + F_x[i].T @ v_xx @ F_x[i]
            V_reg = v_xx + mu * np.eye(6)
            Q_ux = F_u[i].T @ V_reg @ F_x[i]
            Q_uu = L_uu[i] + F_u[i].T @ V_reg @ F_u[i]
            if not (Q_uu[0, 0] > 0
                    and Q_uu[0, 0] * Q_uu[1, 1] - Q_uu[0, 1] * Q_uu[1, 0] > 0):
                pd_ok = False
            k[i] = -np.linalg.solve(Q_uu, Q_u)
            K[i] = -np.linalg.solve(Q_uu, Q_ux)
            V_x[i] = (Q_x + K[i].T @ Q_uu @ k[i] + K[i].T @ Q_u
                      + Q_ux.T @ k[i])
            vxx = (Q_xx + K[i].T @ Q_uu @ K[i] + K[i].T @ Q_ux
                   + Q_ux.T @ K[i])
            V_xx[i] = 0.5 * (vxx + vxx.T)

        # sequential first-accept line search (solver.py:124-125,180-199)
        accepted = False
        if pd_ok:
            for alpha in alphas:
                xs_new, us_new = _tree_rollout_policy(
                    parents, x0, xs, us, k, K, alpha, dt, wb)
                J_new = _tree_cost(xs_new, us_new, nodes, params)
                if J_new < J_opt:
                    converged = abs((J_opt - J_new) / J_opt) < rel_tol
                    xs, us, J_opt = xs_new, us_new, J_new
                    accepted = True
                    break

        # Levenberg-Marquardt schedule (solver.py:40-49,153-158,194-198)
        if accepted:
            delta = min(1.0, delta) / delta_0
            mu *= delta
            if mu <= mu_min:
                mu = 0.0
        else:
            delta = max(1.0, delta) * delta_0
            mu = max(mu_min, mu * delta)
            if mu >= mu_max:
                break
        if converged:
            break

    return HostILQRResult(xs=xs, us=us, J=J_opt, iterations=it,
                          converged=converged)
