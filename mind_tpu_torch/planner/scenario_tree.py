"""Decode of one AIME round (port of mind_tpu/planner/scenario_tree.py).

`_decode_node` turns the network outputs of B branch nodes into their M
candidate child hists and flags: denormalization to the global frame,
covariance accumulation, probability and target-lane prune, greedy
bearing-topology merge and the branch-time rule (reference
scenario_tree.py:281-412,592-611). The JAX package vmaps it over nodes;
here B is a leading axis. The host-side ScenarioTreeGenerator is not
ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mind_tpu_torch.common.geometry import points_polyline_dist
from mind_tpu_torch.planner.scene_prep import OBS_LEN, SceneInputs, TargetLaneStatic, rot_of

SEQ_LEN = 110  # obs 50 + pred 60
PRED_LEN = 60


class NodeSlots(NamedTuple):
    """Fixed-width storage for scenario-tree nodes."""

    pos: torch.Tensor      # [MN, A, 110, 2] global
    ang: torch.Tensor      # [MN, A, 110]
    vel: torch.Tensor      # [MN, A, 110, 2]
    cov: torch.Tensor      # [MN, A, 110] float64
    tgt_pts: torch.Tensor  # [MN, 11, 2]


class RoundOutputs(NamedTuple):
    pos: torch.Tensor      # [B, M, A, 110, 2]
    ang: torch.Tensor      # [B, M, A, 110]
    vel: torch.Tensor      # [B, M, A, 110, 2]
    cov: torch.Tensor      # [B, M, A, 110] float64
    tgt_pts: torch.Tensor  # [B, 11, 2]
    prob: torch.Tensor     # [B, M] float64 joint path probability
    keep: torch.Tensor     # [B, M] bool survived prune+merge
    t_b: torch.Tensor      # [B, M] branch time (== PRED_LEN if none)
    mode_prob: torch.Tensor  # [B, M] raw cls prob (diagnostics)


def _wrap(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


def _rotate(v, r):
    """v [..., 2] -> r v, i.e. out_e = sum_d r[e, d] v_d."""
    return (r @ v.unsqueeze(-1)).squeeze(-1)


def _decode_node(cls, reg, vel_pred, inputs: SceneInputs,
                 win_pos, win_ang, win_vel, win_cov,
                 parent_prob, cur_t, actor_mask,
                 tgt_static: TargetLaneStatic, cfg) -> RoundOutputs:
    """Decode B branch nodes' M modes.

    cls [B, M], reg [B, A, M, 60, 5], vel_pred [B, A, M, 60, 2]; windows
    [B, A, 50, ...] in the global frame; parent_prob [B]; cur_t [B].
    Bulk arithmetic runs at the window dtype (pipeline dtype);
    probabilities and covariance accumulation always run in float64."""
    dtype = win_pos.dtype
    f64 = torch.float64
    cls64 = cls.to(f64)
    cls = cls.to(dtype)
    cov_p64 = torch.maximum(reg[..., 2], reg[..., 3]).to(f64)   # [B, A, M, 60]
    reg = reg.to(dtype)
    vel_pred = vel_pred.to(dtype)
    B, A, M = reg.shape[:3]
    dev = reg.device
    orig, rot, theta = inputs.orig, inputs.rot, inputs.theta
    a_ctrs, a_vecs = inputs.actor_ctrs, inputs.actor_vecs
    a_theta = torch.atan2(a_vecs[..., 1], a_vecs[..., 0])        # [B, A]
    a_rot = rot_of(a_theta)[:, :, None, None]                     # [B, A, 1, 1, 2, 2]
    g_rot = rot[:, None, None, None]                              # [B, 1, 1, 1, 2, 2]

    # instance -> scene -> global for all modes at once
    pos_p = _rotate(reg[..., :2], a_rot) + a_ctrs[:, :, None, None]
    pos_g = _rotate(pos_p, g_rot) + orig[:, None, None, None]     # [B, A, M, 60, 2]
    vel_g = _rotate(_rotate(vel_pred, a_rot), g_rot)
    ang_g = (torch.atan2(vel_pred[..., 1], vel_pred[..., 0])
             + a_theta[:, :, None, None] + theta[:, None, None, None])

    # [B, A, M, 60] max sigma, accumulated in f64 onto the last window cov
    cov_g = cov_p64 + win_cov.to(f64)[:, :, None, -1:]

    # new 110-frame hists per mode -> [B, M, A, 110, ...]
    def cat(win, pred):
        win = win[:, None].expand((B, M) + win.shape[1:])
        return torch.cat([win, pred.transpose(1, 2)], dim=3)

    hist_pos = cat(win_pos, pos_g)
    hist_ang = cat(win_ang, ang_g)
    hist_vel = cat(win_vel, vel_g)
    hist_cov = cat(win_cov.to(f64), cov_g)

    prob = cls64 * parent_prob.to(f64)[:, None]                   # [B, M]

    # prune: improbable scenes (scenario_tree.py:369-370)
    keep = prob >= cfg.prune_prob

    # prune: ego diverging from the target lane (scenario_tree.py:373-379)
    ego_mean = hist_pos[:, :, 0, -1]                              # [B, M, 2]
    ego_cov = hist_cov[:, :, 0, -1]                               # [B, M]
    d_tgt = points_polyline_dist(ego_mean, tgt_static.points, tgt_static.mask)
    keep &= (d_tgt - ego_cov) <= cfg.tar_dist_thres

    # bearing-topology signature per exo (scenario_tree.py:382-394)
    rel = pos_g - pos_g[:, :1]                                    # [B, A, M, 60, 2]
    rel = rel / (torch.linalg.vector_norm(rel, dim=-1, keepdim=True) + 1e-12)
    bear = torch.atan2(rel[..., 1], rel[..., 0])                  # [B, A, M, 60]
    topo = _wrap(bear[..., 1:] - bear[..., :-1]).sum(-1)          # [B, A, M]
    topo = topo[:, 1:].transpose(1, 2)                            # [B, M, A-1]
    exo_valid = actor_mask[1:]

    # greedy merge in descending-probability order (scenario_tree.py:397-410);
    # the sort is stable, as jnp.argsort is
    order = torch.argsort(-cls, dim=-1, stable=True)              # [B, M]
    keep_sorted = torch.gather(keep, 1, order)
    topo_sorted = torch.gather(topo, 1, order[..., None].expand_as(topo))
    sel = torch.zeros((B, M), dtype=torch.bool, device=dev)
    for i in range(M):
        diff = _wrap(topo_sorted - topo_sorted[:, i:i + 1])       # [B, M, A-1]
        differs = (((diff.abs() - cfg.merge_thres) > 0) & exo_valid).any(-1)
        ok = torch.where(sel, differs, torch.ones_like(differs)).all(-1)
        sel[:, i] = keep_sorted[:, i] & ok
    keep_final = torch.zeros_like(sel).scatter(1, order, sel)

    # branch time (scenario_tree.py:592-611), index arithmetic replicated
    cur_t = cur_t.long()
    compare_t = OBS_LEN + cur_t + (cur_t == 0).long()             # [B]
    # an unused branch slot can carry cur_t = 60; its index is clamped, as
    # a jnp gather clamps it
    compare_t = torch.clamp(compare_t, 0, SEQ_LEN - 1)
    ts = torch.arange(SEQ_LEN, device=dev)
    in_range = (ts[None] >= cur_t[:, None] + 1) & (ts[None] < PRED_LEN) & (ts[None] % 2 == 0)
    idx = torch.clamp(OBS_LEN + ts, 0, SEQ_LEN - 1)
    denom = torch.gather(hist_cov, 3, compare_t[:, None, None, None].expand(B, M, A, 1))
    ratio = hist_cov[..., idx] / denom                            # [B, M, A, 110]
    trig = ((ratio > cfg.cov_change_rate) & actor_mask[None, None, :, None]).any(2)
    trig &= in_range[:, None]
    any_trig = trig.any(-1)
    first_t = torch.argmax(trig.to(torch.uint8), dim=-1)          # first True
    t_b = torch.where(any_trig, first_t, torch.full_like(first_t, PRED_LEN))

    return RoundOutputs(
        pos=hist_pos, ang=hist_ang, vel=hist_vel, cov=hist_cov,
        tgt_pts=inputs.tgt_pts,
        prob=prob, keep=keep_final, t_b=t_b, mode_prob=cls,
    )
