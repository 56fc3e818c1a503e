"""Cost potentials of the trajectory-tree optimizer, evaluated on the fly
(port of mind_tpu/ops/potential.py), batched over cost nodes.

The reference rasterizes a 256x256 cost grid per cost node and queries it
through a 3x3-smoothed biquadratic Bezier interpolation; here, as in the
JAX package, the 9 raw cell values around a query are computed
analytically from the target-lane polyline and the per-node agent discs,
with the same integer grid, smoothing and polynomials.

Kept from the JAX package as they are: the uniform boundary rule
local[r, c] = field[y + r - 1, x + c - 1], zero outside the grid, and the
convex out-of-grid pull-back (see potential_field_eval).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mind_tpu_torch.common.geometry import point_segments_dist


class NodeCostData(NamedTuple):
    """Per-cost-node data; every field has the same leading axes [...]."""

    prob: torch.Tensor      # [...]       path probability
    ego_mean: torch.Tensor  # [..., 2]    predicted ego position
    ego_cov: torch.Tensor   # [...]       max-sigma ego covariance
    exo_mean: torch.Tensor  # [..., X, 2] predicted exo positions
    exo_cov: torch.Tensor   # [..., X]    max-sigma exo covariances
    exo_mask: torch.Tensor  # [..., X] bool valid exo agents


class CostParams(NamedTuple):
    """Shared (per-phase) cost parameters."""

    field_offset: torch.Tensor   # [2] grid origin (x0-centered)
    res: torch.Tensor            # [] grid resolution
    grid_n: int                  # grid size (256)
    tgt_seg_start: torch.Tensor  # [S, 2] target-lane segments
    tgt_seg_end: torch.Tensor    # [S, 2]
    tgt_seg_mask: torch.Tensor   # [S] bool
    w_tgt: torch.Tensor
    w_ego: torch.Tensor          # 0 in warm-start phase
    w_ego_cov_offset: torch.Tensor
    w_exo: torch.Tensor          # 0 in warm-start phase
    w_exo_cov_offset: torch.Tensor
    w_exo_cost_offset: torch.Tensor
    w_des_state: torch.Tensor    # [6]
    des_state: torch.Tensor      # [6] (target velocity in slot 2)
    w_state_con: torch.Tensor    # [6]
    state_lb: torch.Tensor       # [6]
    state_ub: torch.Tensor       # [6]
    w_ctrl: torch.Tensor         # [2]


def _cell_value(cell_xy, node: NodeCostData, p: CostParams):
    """Raw cost-field value at grid-cell centers cell_xy [..., 3, 3, 2]
    (trajectory_tree.py:80-106); node fields have the leading axes [...]."""
    d_tgt = point_segments_dist(cell_xy, p.tgt_seg_start, p.tgt_seg_end, p.tgt_seg_mask)
    e = lambda t: t[..., None, None]   # node scalar -> patch
    val = p.w_tgt * e(node.prob) * d_tgt ** 2

    ego_d = torch.linalg.vector_norm(cell_xy - node.ego_mean[..., None, None, :], dim=-1)
    ego_field = torch.clamp(ego_d - (e(node.ego_cov) + p.w_ego_cov_offset), min=0.0)
    val = val + p.w_ego * ego_field

    exo_d = torch.linalg.vector_norm(
        cell_xy[..., None, :] - node.exo_mean[..., None, None, :, :], dim=-1)  # [..., 3, 3, X]
    exo_f = torch.clamp((node.exo_cov[..., None, None, :] + p.w_exo_cov_offset) - exo_d,
                        min=0.0)
    exo_f = torch.where(exo_f > 0, exo_f + p.w_exo_cost_offset, torch.zeros_like(exo_f))
    exo_f = torch.where(node.exo_mask[..., None, None, :], exo_f, torch.zeros_like(exo_f))
    return val + p.w_exo * exo_f.sum(-1)


def _smooth_3x3(g):
    """2x2-mean smoothing of 3x3 patches [..., 3, 3] (reference
    potential.py:146-155)."""
    return torch.stack([
        torch.stack([(g[..., 0, 0] + g[..., 0, 1] + g[..., 1, 0] + g[..., 1, 1]) / 4,
                     (g[..., 0, 1] + g[..., 1, 1]) / 2,
                     (g[..., 0, 1] + g[..., 0, 2] + g[..., 1, 1] + g[..., 1, 2]) / 4], -1),
        torch.stack([(g[..., 1, 0] + g[..., 1, 1]) / 2,
                     g[..., 1, 1],
                     (g[..., 1, 1] + g[..., 1, 2]) / 2], -1),
        torch.stack([(g[..., 1, 0] + g[..., 1, 1] + g[..., 2, 0] + g[..., 2, 1]) / 4,
                     (g[..., 1, 1] + g[..., 2, 1]) / 2,
                     (g[..., 1, 1] + g[..., 1, 2] + g[..., 2, 1] + g[..., 2, 2]) / 4], -1),
    ], -2)


def _quad(a, grid, b):
    """a @ grid @ b for [..., 3] row/column weights and [..., 3, 3] grids."""
    return ((a[..., None, :] @ grid) @ b[..., :, None])[..., 0, 0]


def potential_field_eval(pos, node: NodeCostData, p: CostParams):
    """Value [...], gradient [..., 2] and Hessian [..., 2, 2] of the smoothed
    biquadratic potential at pos [..., 2] (reference potential.py:72-264).

    Queries outside the grid evaluate the polynomial at the projected
    boundary point plus a convex quadratic pull-back term: clamping only the
    cell index, as the reference does, would extrapolate the border patch's
    Bezier polynomial, whose middle basis term turns negative outside
    [0, 1], and a far-out rollout would win the line search. In-grid
    queries follow the reference formula."""
    lo = p.field_offset
    hi = p.field_offset + p.res * (p.grid_n - 1)
    pos_c = torch.maximum(torch.minimum(pos, hi), lo)
    delta = pos - pos_c  # zero inside the domain
    pos = pos_c
    dt, dev = pos.dtype, pos.device

    # integer cell of the query, clamped (potential.py:104-110)
    fx = (pos[..., 0] - p.field_offset[0]) / p.res
    fy = (pos[..., 1] - p.field_offset[1]) / p.res
    x_idx = torch.clamp(torch.round(fx).long(), 0, p.grid_n - 1)
    y_idx = torch.clamp(torch.round(fy).long(), 0, p.grid_n - 1)

    # 3x3 raw patch [..., 3(y), 3(x)], zero outside the grid
    offs = torch.tensor([-1, 0, 1], device=dev)
    ix = x_idx[..., None, None] + offs[None, :]     # [..., 1, 3] -> columns
    iy = y_idx[..., None, None] + offs[:, None]     # [..., 3, 1] -> rows
    ix, iy = torch.broadcast_tensors(ix, iy)
    inside = (ix >= 0) & (ix < p.grid_n) & (iy >= 0) & (iy < p.grid_n)
    cell_xy = p.field_offset + p.res * torch.stack([ix.to(dt), iy.to(dt)], -1)
    local = torch.where(inside, _cell_value(cell_xy, node, p),
                        torch.zeros((), dtype=dt, device=dev))
    grid = _smooth_3x3(local)

    # fractional offsets (potential.py:161-167)
    grid_ori = p.field_offset + p.res * torch.stack([x_idx.to(dt), y_idx.to(dt)], -1)
    u = (pos[..., 0] - grid_ori[..., 0]) / p.res + 0.5
    v = (pos[..., 1] - grid_ori[..., 1]) / p.res + 0.5

    def basis(t):
        return torch.stack([(1 - t) ** 2, 2 * (1 - t) * t, t ** 2], -1)

    def dbasis(t):
        return torch.stack([-2 + 2 * t, 2 - 4 * t, 2 * t], -1)

    ddbasis = torch.tensor([2.0, -4.0, 2.0], dtype=dt, device=dev).expand(u.shape + (3,))
    bu, bv = basis(u), basis(v)
    dbu, dbv = dbasis(u), dbasis(v)

    # grid[row = v index, col = u index] per the reference's indexing
    val = _quad(bv, grid, bu)
    gx = _quad(bv, grid, dbu) / p.res
    gy = _quad(dbv, grid, bu) / p.res
    hxx = _quad(bv, grid, ddbasis) / p.res ** 2
    hyy = _quad(ddbasis, grid, bu) / p.res ** 2
    hxy = _quad(dbv, grid, dbu) / p.res ** 2
    grad = torch.stack([gx, gy], -1)
    hess = torch.stack([torch.stack([hxx, hxy], -1), torch.stack([hxy, hyy], -1)], -2)

    # convex out-of-domain pull-back at the target-parabola scale; on a
    # clamped axis the polynomial is constant, so its grad/hess components
    # there are zeroed
    k = p.w_tgt * node.prob
    out_axis = (delta != 0.0).to(dt)
    in_axis = 1.0 - out_axis
    val = val + k * (delta * delta).sum(-1)
    grad = grad * in_axis + 2.0 * k[..., None] * delta
    hess = (hess * in_axis[..., :, None] * in_axis[..., None, :]
            + 2.0 * k[..., None, None] * torch.diag_embed(out_axis))
    return val, grad, hess


def cost_node_eval(x, u, node: NodeCostData, p: CostParams):
    """Cost expansion at nodes x [..., 6], u [..., 2]: (l, l_x [..., 6],
    l_u [..., 2], l_xx [..., 6, 6], l_uu [..., 2, 2]); l_ux is identically
    zero. Sums the four reference potentials (PotentialField on the
    position slice, StatePotential, StateConstraint, ControlPotential), all
    prob-weighted."""
    f_val, f_grad, f_hess = potential_field_eval(x[..., :2], node, p)
    prob = node.prob[..., None]

    # StatePotential: prob * w_des * (x - x*)^2
    w_des = p.w_des_state * prob
    diff = x - p.des_state
    sp_val = (w_des * diff * diff).sum(-1)
    sp_grad = 2.0 * w_des * diff
    sp_hess = 2.0 * w_des

    # StateConstraint: one-sided quadratic bound penalty
    w_con = p.w_state_con * prob
    over = torch.clamp(x - p.state_ub, min=0.0)
    under = torch.clamp(p.state_lb - x, min=0.0)
    viol = over + under
    sc_val = (w_con * viol * viol).sum(-1)
    sc_grad = 2.0 * w_con * torch.where(over > 0, over, -under)
    sc_hess = torch.where(viol > 0, 2.0 * w_con, torch.zeros_like(w_con))

    # ControlPotential
    w_ctrl = p.w_ctrl * prob
    cp_val = (w_ctrl * u * u).sum(-1)
    cp_grad = 2.0 * w_ctrl * u
    cp_hess = 2.0 * w_ctrl

    l = f_val + sp_val + sc_val + cp_val
    l_x = sp_grad + sc_grad
    l_x = torch.cat([l_x[..., :2] + f_grad, l_x[..., 2:]], -1)
    l_u = cp_grad
    l_xx = torch.diag_embed((sp_hess + sc_hess).to(x.dtype))
    l_xx[..., :2, :2] += f_hess
    l_uu = torch.diag_embed(cp_hess.to(u.dtype))
    return l, l_x, l_u, l_xx, l_uu
