"""Batched tree-structured iLQR (port of mind_tpu/planner/ilqr.py).

The JAX package vmaps a `lax.while_loop` solver over trees; here a batch
axis G of trees is written out and the loop runs in Python until no tree is
active, with one host read of the active mask per iteration. Finished trees
keep their state while the others iterate, as under vmap.

- topology as index arrays: `level_table[g, l]` lists the node slots at
  tree depth l (padded with -1); `parent[g, n]` is each node's parent slot
  (-1 = attached to the root state x0);
- forward rollout: a Python loop over depth levels (trimmed to the deepest
  level in use, read once per solve: empty levels are no-ops), each level
  one batched dynamics step gathered from parents, with a dump slot MN for
  the -1 ids;
- derivatives: the analytic jacobians of the bicycle step and the cost
  expansion of ops/potential.py at (x_new, u) per node;
- backward pass: reverse level loop with the children's value sums added
  into their parents (the contingency sum of solver.py:349-350) through a
  one-hot product, so the sum order is fixed (no atomics);
- line search: all alphas rolled out in parallel, first improving alpha
  taken (the reference's first-accept backtrack);
- Levenberg-Marquardt schedule per tree; a non-PD Quu is a rejected step.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mind_tpu_torch.common.kinematics import ext_bicycle_jacobians, ext_bicycle_step
from mind_tpu_torch.ops.potential import CostParams, NodeCostData, cost_node_eval


class TreeTopology(NamedTuple):
    parent: torch.Tensor       # [..., MN] long, -1 = child of the root state x0
    node_mask: torch.Tensor    # [..., MN] bool
    level_table: torch.Tensor  # [..., LV, W] long node ids per depth level, -1 pad


class ILQRConfig(NamedTuple):
    dt: float = 0.2
    wheelbase: float = 2.5
    max_iterations: int = 100
    rel_tol: float = 1e-6
    n_line_search: int = 10
    mu_init: float = 1.0
    mu_min: float = 1e-6
    mu_max: float = 1e10
    delta_0: float = 2.0
    # solve precision ("float32" | "float64"), applied at two_phase_solve entry
    dtype: str = "float32"


def _rows(a, ids):
    """a [G, R, ...] gathered at ids [G, W] -> [G, W, ...]."""
    g = torch.arange(a.shape[0], device=a.device)[:, None]
    return a[g, ids]


def _levels_in_use(topo: TreeTopology) -> int:
    """Number of leading levels that hold a node in any tree (one host read)."""
    used = (topo.level_table >= 0).any(-1).any(0)   # [LV]
    return int(used.nonzero().max()) + 1 if bool(used.any()) else 0


def _rollout(topo: TreeTopology, x0, us, dt, wb, n_levels=None):
    """Tree forward rollout: xs[n] = f(xs[parent[n]] or x0, us[n]).
    topo [G, ...], x0 [G, 6], us [G, MN, 2] -> xs [G, MN, 6]."""
    G, MN = us.shape[:2]
    n_levels = _levels_in_use(topo) if n_levels is None else n_levels
    xs = x0.new_zeros((G, MN + 1, x0.shape[-1]))
    for lv in range(n_levels):
        ids = topo.level_table[:, lv]                           # [G, W]
        valid = ids >= 0
        safe = torch.clamp(ids, 0, MN - 1)
        par = torch.where(valid, _rows(topo.parent, safe), torch.full_like(ids, -1))
        has_par = (par >= 0)[..., None]
        x_prev = torch.where(has_par, _rows(xs, torch.clamp(par, min=0)), x0[:, None])
        x_new = ext_bicycle_step(x_prev, _rows(us, safe), dt, wb)
        write = torch.where(valid, ids, torch.full_like(ids, MN))
        g = torch.arange(G, device=xs.device)[:, None]
        xs[g, write] = x_new
    return xs[:, :MN]


def _rollout_policy(topo: TreeTopology, x0, xs_nom, us_nom, k, K, alpha, dt, wb,
                    n_levels):
    """Closed-loop tree re-rollout under the affine policy
    u = u_nom + alpha*k + K (x_parent_new - x_parent_nom) (solver.py:202-240).
    All tensors carry the batch axis G; alpha [G]."""
    G, MN = us_nom.shape[:2]
    xs = x0.new_zeros((G, MN + 1, x0.shape[-1]))
    us = us_nom.new_zeros((G, MN + 1, us_nom.shape[-1]))
    g = torch.arange(G, device=xs.device)[:, None]
    for lv in range(n_levels):
        ids = topo.level_table[:, lv]
        valid = ids >= 0
        safe = torch.clamp(ids, 0, MN - 1)
        par = torch.where(valid, _rows(topo.parent, safe), torch.full_like(ids, -1))
        has_par = (par >= 0)[..., None]
        safe_par = torch.clamp(par, min=0)
        x_prev_new = torch.where(has_par, _rows(xs, safe_par), x0[:, None])
        x_prev_nom = torch.where(has_par, _rows(xs_nom, safe_par), x0[:, None])
        du = (_rows(K, safe) @ (x_prev_new - x_prev_nom)[..., None])[..., 0]
        u_new = _rows(us_nom, safe) + alpha[:, None, None] * _rows(k, safe) + du
        x_new = ext_bicycle_step(x_prev_new, u_new, dt, wb)
        write = torch.where(valid, safe, torch.full_like(ids, MN))
        xs[g, write] = x_new
        us[g, write] = u_new
    return xs[:, :MN], us[:, :MN]


def _derivatives(xs, us, nodes: NodeCostData, params: CostParams, node_mask, dt, wb):
    """Dynamics jacobians + cost expansion at (x_new, u) per node."""
    F_x, F_u = ext_bicycle_jacobians(xs, dt, wb)
    L, L_x, L_u, L_xx, L_uu = cost_node_eval(xs, us, nodes, params)
    m = node_mask
    zero = torch.zeros((), dtype=L.dtype, device=L.device)
    L = torch.where(m, L, zero)
    L_x = torch.where(m[..., None], L_x, zero)
    L_u = torch.where(m[..., None], L_u, zero)
    L_xx = torch.where(m[..., None, None], L_xx, zero)
    L_uu = torch.where(m[..., None, None], L_uu,
                       torch.eye(L_uu.shape[-1], dtype=L_uu.dtype, device=L_uu.device))
    return F_x, F_u, L, L_x, L_u, L_xx, L_uu


def _tree_cost(topo: TreeTopology, xs, us, nodes, params):
    l = cost_node_eval(xs, us, nodes, params)[0]
    return torch.where(topo.node_mask, l, torch.zeros_like(l)).sum(-1)


def _backward(topo: TreeTopology, derivs, mu, n_levels):
    """Leaf-to-root Riccati sweep with child-value aggregation. Returns
    (k [G, MN, 2], K [G, MN, 2, 6], pd_ok [G]). Parent V accumulates the
    SUM of its children's V (solver.py:344-350)."""
    F_x, F_u, _, L_x, L_u, L_xx, L_uu = derivs
    G, MN, n_x = F_x.shape[:3]
    n_u = F_u.shape[-1]
    dt_, dev = F_x.dtype, F_x.device
    V_x = torch.zeros((G, MN + 1, n_x), dtype=dt_, device=dev)
    V_xx = torch.zeros((G, MN + 1, n_x, n_x), dtype=dt_, device=dev)
    # dump row MN: padded level entries (-1) must not alias a real slot
    k = torch.zeros((G, MN + 1, n_u), dtype=dt_, device=dev)
    K = torch.zeros((G, MN + 1, n_u, n_x), dtype=dt_, device=dev)
    eye = torch.eye(n_x, dtype=dt_, device=dev)
    pd_ok = torch.ones(G, dtype=torch.bool, device=dev)
    g = torch.arange(G, device=dev)[:, None]
    slots = torch.arange(MN + 1, device=dev)
    mu = mu[:, None, None, None]

    for lv in reversed(range(n_levels)):
        ids = topo.level_table[:, lv]                           # [G, W]
        valid = ids >= 0
        safe = torch.clamp(ids, 0, MN - 1)
        f_x, f_u = _rows(F_x, safe), _rows(F_u, safe)
        v_x, v_xx = _rows(V_x, safe), _rows(V_xx, safe)
        f_xT, f_uT = f_x.transpose(-1, -2), f_u.transpose(-1, -2)

        Q_x = _rows(L_x, safe) + (f_xT @ v_x[..., None])[..., 0]
        Q_u = _rows(L_u, safe) + (f_uT @ v_x[..., None])[..., 0]
        Q_xx = _rows(L_xx, safe) + f_xT @ v_xx @ f_x
        V_reg = v_xx + mu * eye
        Q_ux = f_uT @ V_reg @ f_x
        Q_uu = _rows(L_uu, safe) + f_uT @ V_reg @ f_u

        # PD check for 2x2 Quu: leading minor > 0 and det > 0
        a, b = Q_uu[..., 0, 0], Q_uu[..., 0, 1]
        c, d = Q_uu[..., 1, 0], Q_uu[..., 1, 1]
        det = a * d - b * c
        pd = (a > 0) & (det > 0)
        pd_ok = pd_ok & torch.where(valid, pd, torch.ones_like(pd)).all(-1)

        # closed-form 2x2 inverse
        inv_det = 1.0 / torch.where(det != 0, det, torch.ones_like(det))
        Quu_inv = torch.stack([torch.stack([d, -b], -1),
                               torch.stack([-c, a], -1)], -2) * inv_det[..., None, None]
        k_n = -(Quu_inv @ Q_u[..., None])[..., 0]
        K_n = -(Quu_inv @ Q_ux)

        Kt = K_n.transpose(-1, -2)
        Q_uxT = Q_ux.transpose(-1, -2)
        v_x_new = (Q_x
                   + (Kt @ (Q_uu @ k_n[..., None]))[..., 0]
                   + (Kt @ Q_u[..., None])[..., 0]
                   + (Q_uxT @ k_n[..., None])[..., 0])
        v_xx_new = Q_xx + Kt @ Q_uu @ K_n + Kt @ Q_ux + Q_uxT @ K_n
        v_xx_new = 0.5 * (v_xx_new + v_xx_new.transpose(-1, -2))

        write_kK = torch.where(valid, safe, torch.full_like(ids, MN))
        k[g, write_kK] = k_n
        K[g, write_kK] = K_n

        # add into parents (root children into the dump slot MN) as a one-hot
        # product over the level's W entries: a fixed-order sum
        par = torch.where(valid, _rows(topo.parent, safe), torch.full_like(ids, -1))
        write = torch.where(par >= 0, par, torch.full_like(par, MN))
        onehot = (write[..., None] == slots).to(dt_) * valid[..., None].to(dt_)  # [G, W, MN+1]
        oh_t = onehot.transpose(1, 2)                                            # [G, MN+1, W]
        V_x = V_x + oh_t @ v_x_new
        V_xx = V_xx + (oh_t @ v_xx_new.reshape(G, -1, n_x * n_x)).reshape(V_xx.shape)
    return k[:, :MN], K[:, :MN], pd_ok


def ilqr_solve(topo: TreeTopology, x0, us_init, nodes: NodeCostData,
               params: CostParams, cfg: ILQRConfig = ILQRConfig(), active=None):
    """Fit the tree iLQR on a batch of G trees. topo fields [G, ...], x0
    [6] or [G, 6], us_init [G, MN, 2], nodes fields [G, MN, ...]; `active`
    [G] bool leaves trees out whose result is not needed (they keep their
    start). Returns (xs [G, MN, 6], us [G, MN, 2], info dict of [G])."""
    dt, wb = cfg.dt, cfg.wheelbase
    G, MN = us_init.shape[:2]
    dt_, dev = us_init.dtype, us_init.device
    x0 = x0.expand(G, x0.shape[-1])
    n_levels = _levels_in_use(topo)

    xs = _rollout(topo, x0, us_init, dt, wb, n_levels)
    derivs = _derivatives(xs, us_init, nodes, params, topo.node_mask, dt, wb)
    us = us_init
    J_opt = derivs[2].sum(-1)
    mu = torch.full((G,), cfg.mu_init, dtype=dt_, device=dev)
    delta = torch.full((G,), cfg.delta_0, dtype=dt_, device=dev)
    accepted = torch.zeros(G, dtype=torch.bool, device=dev)
    converged = torch.zeros(G, dtype=torch.bool, device=dev)
    diverged = torch.zeros(G, dtype=torch.bool, device=dev)
    it = torch.zeros(G, dtype=torch.long, device=dev)
    if active is None:
        active = torch.ones(G, dtype=torch.bool, device=dev)

    NA = cfg.n_line_search
    alphas = torch.tensor(1.1 ** (-np.arange(NA, dtype=np.float64) ** 2),
                          dtype=dt_, device=dev)
    rep = lambda t: t.repeat_interleave(NA, dim=0)     # [G, ...] -> [G*NA, ...]
    topo_r = TreeTopology(*(rep(t) for t in topo))
    nodes_r = NodeCostData(*(rep(t) for t in nodes))
    alpha_r = alphas.repeat(G)
    sel = lambda m, new, old: torch.where(m.view((-1,) + (1,) * (new.dim() - 1)), new, old)

    while True:
        run = active & ~converged & ~diverged & (it < cfg.max_iterations)
        if not bool(run.any()):          # one host read per iteration
            break
        # refresh derivatives where the previous step was accepted
        if bool(accepted.any()):
            fresh = _derivatives(xs, us, nodes, params, topo.node_mask, dt, wb)
            derivs = tuple(sel(accepted, n, o) for n, o in zip(fresh, derivs))

        k, K, pd_ok = _backward(topo, derivs, mu, n_levels)

        # parallel line search over all alphas
        xs_c, us_c = _rollout_policy(topo_r, rep(x0), rep(xs), rep(us), rep(k), rep(K),
                                     alpha_r, dt, wb, n_levels)
        J_c = _tree_cost(topo_r, xs_c, us_c, nodes_r, params).view(G, NA)
        improved = (J_c < J_opt[:, None]) & pd_ok[:, None]
        any_improved = improved.any(-1)
        first = torch.argmax(improved.to(torch.uint8), dim=-1)  # first improving alpha
        pick = torch.arange(G, device=dev) * NA + first
        xs_new, us_new = xs_c[pick], us_c[pick]
        J_new = J_c.gather(1, first[:, None])[:, 0]

        conv_new = any_improved & (((J_opt - J_new) / J_opt).abs() < cfg.rel_tol)

        # LM schedule (solver.py:153-158, 194-198)
        delta_acc = torch.clamp(delta, max=1.0) / cfg.delta_0
        mu_acc = mu * delta_acc
        mu_acc = torch.where(mu_acc <= cfg.mu_min, torch.zeros_like(mu_acc), mu_acc)
        delta_rej = torch.clamp(delta, min=1.0) * cfg.delta_0
        mu_rej = torch.clamp(mu * delta_rej, min=cfg.mu_min)

        acc = any_improved
        upd = lambda new, old: sel(run, new, old)
        xs = upd(sel(acc, xs_new, xs), xs)
        us = upd(sel(acc, us_new, us), us)
        J_opt = upd(torch.where(acc, J_new, J_opt), J_opt)
        mu = upd(torch.where(acc, mu_acc, mu_rej), mu)
        delta = upd(torch.where(acc, delta_acc, delta_rej), delta)
        accepted = upd(acc, accepted)
        converged = upd(conv_new, converged)
        diverged = upd(~acc & (mu_rej >= cfg.mu_max), diverged)
        it = it + run.long()

    info = {"iterations": it, "J": J_opt, "converged": converged, "diverged": diverged}
    return xs, us, info


def build_topology(parent_list, max_nodes: int, max_levels: int,
                   max_width: int | None = None, device=None) -> TreeTopology:
    """Host helper: parent indices (-1 root-attached) -> padded TreeTopology
    of one tree. Nodes must be indexed parents before children. Pass
    `max_width` to stack trees of different shapes."""
    n = len(parent_list)
    if n > max_nodes:
        raise ValueError(f"{n} cost nodes exceed max_nodes={max_nodes}")
    parent = np.full(max_nodes, -1, np.int64)
    parent[:n] = parent_list
    mask = np.zeros(max_nodes, bool)
    mask[:n] = True
    depth = np.zeros(max_nodes, np.int64)
    for i, p in enumerate(parent_list):
        depth[i] = 0 if p < 0 else depth[p] + 1
    levels = [[] for _ in range(max_levels)]
    for i in range(n):
        levels[depth[i]].append(i)
    width = max_width or max((len(l) for l in levels), default=1) or 1
    if any(len(l) > width for l in levels):
        raise ValueError("level width exceeds max_width")
    table = np.full((max_levels, width), -1, np.int64)
    for l, ids in enumerate(levels):
        table[l, :len(ids)] = ids
    return TreeTopology(parent=torch.as_tensor(parent, device=device),
                        node_mask=torch.as_tensor(mask, device=device),
                        level_table=torch.as_tensor(table, device=device))
