"""Scene preparation: observation windows -> network inputs (port of
mind_tpu/planner/scene_prep.py).

Every function takes a leading batch axis of AIME branch nodes where the
JAX package vmaps: windows arrive as [B, A, 50, ...] in the GLOBAL frame;
each node derives its target-centric scene frame from the ego (actor 0)
and per-actor instance frames. Lane features are static per scenario and
their global anchors are moved into each node's frame.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

OBS_LEN = 50


class LaneGraphStatic(NamedTuple):
    """Per-scenario static lane-graph tensors (padded to L segments)."""

    node_feats: torch.Tensor     # [L, 10, 16] instance-frame features
    anchors_g: torch.Tensor      # [L, 2] global anchor positions
    anchor_vecs_g: torch.Tensor  # [L, 2] global anchor directions
    mask: torch.Tensor           # [L] bool


class TargetLaneStatic(NamedTuple):
    """Resampled (~1 m) target lane + per-point features (padded to P)."""

    points: torch.Tensor   # [P, 2] global
    info: torch.Tensor     # [P, 12] rows [intersect, type3, cl3, cr3, l, r]
    mask: torch.Tensor     # [P] bool
    n_points: int          # actual count


class SceneInputs(NamedTuple):
    """Everything the network consumes for a batch of nodes."""

    actors: torch.Tensor      # [B, A, 48, 14]
    actor_mask: torch.Tensor  # [B, A]
    lanes: torch.Tensor       # [B, L, 10, 16]
    lane_mask: torch.Tensor   # [B, L]
    rpe: torch.Tensor         # [B, N, N, 5]
    tgt_nodes: torch.Tensor   # [B, 10, 16]
    tgt_rpe: torch.Tensor     # [B, 20]
    # frame bookkeeping needed to denormalize predictions
    orig: torch.Tensor        # [B, 2]
    rot: torch.Tensor         # [B, 2, 2]
    theta: torch.Tensor       # [B]
    actor_ctrs: torch.Tensor  # [B, A, 2] anchor positions (scene frame)
    actor_vecs: torch.Tensor  # [B, A, 2] anchor headings (scene frame)
    tgt_pts: torch.Tensor     # [B, 11, 2] global high-level-command window


def rot_of(theta):
    """[..., 2, 2] rotation matrices [[c, -s], [s, c]]."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)


def make_rpe(ctrs, vecs, radius: float = 100.0):
    """Pairwise relative positional encoding [..., N, N, 5]
    (reference utils.py:193-212): [cos/sin heading diff, cos/sin bearing,
    scaled distance]; entry [i, j] relates source i to target j."""
    d = ctrs[..., None, :, :] - ctrs[..., :, None, :]   # v_pos[i, j] = c_j - c_i
    dist = torch.linalg.vector_norm(d, dim=-1) * 2.0 / radius

    def cos_sin(v1, v2):
        n1 = torch.linalg.vector_norm(v1, dim=-1)
        n2 = torch.linalg.vector_norm(v2, dim=-1)
        denom = n1 * n2 + 1e-10
        cos = (v1[..., 0] * v2[..., 0] + v1[..., 1] * v2[..., 1]) / denom
        sin = (v1[..., 0] * v2[..., 1] - v1[..., 1] * v2[..., 0]) / denom
        return cos, sin

    v_a = vecs[..., None, :, :].expand(d.shape)  # v_j
    v_b = vecs[..., :, None, :].expand(d.shape)  # v_i
    cos_a1, sin_a1 = cos_sin(v_a, v_b)
    cos_a2, sin_a2 = cos_sin(v_a, d)
    return torch.stack([cos_a1, sin_a1, cos_a2, sin_a2, dist], dim=-1)


def prepare_node_inputs(pos, ang, vel, observed, actor_type, actor_mask,
                        lane_static: LaneGraphStatic,
                        tgt_static: TargetLaneStatic,
                        tar_time_ahead: float) -> SceneInputs:
    """Observation windows of B nodes -> padded network inputs.
    pos [B, A, 50, 2], ang [B, A, 50], vel [B, A, 50, 2], observed
    [B, A, 50] float 0/1, actor_type [A, 7] one-hot, actor_mask [A]."""
    B, A = pos.shape[:2]
    dtype = pos.dtype
    # scene frame from ego's last window frame (utils.py:180-190)
    orig = pos[:, 0, OBS_LEN - 1]                     # [B, 2]
    theta = ang[:, 0, OBS_LEN - 1]                    # [B]
    rot = rot_of(theta)                               # [B, 2, 2]

    pos_s = (pos - orig[:, None, None]) @ rot[:, None]
    ang_s = ang - theta[:, None, None]
    vel_s = vel @ rot[:, None]

    # per-actor instance frames from each actor's last frame
    a_orig = pos_s[:, :, OBS_LEN - 1]                 # [B, A, 2]
    a_theta = ang_s[:, :, OBS_LEN - 1]                # [B, A]
    a_rot = rot_of(a_theta)                           # [B, A, 2, 2]
    pos_n = (pos_s - a_orig[:, :, None]) @ a_rot
    ang_n = ang_s - a_theta[..., None]
    vel_n = vel_s @ a_rot
    a_vecs = torch.stack([torch.cos(a_theta), torch.sin(a_theta)], dim=-1)

    # 14-dim actor features, first two timesteps dropped (utils.py:114-139)
    disp = torch.zeros_like(pos_n)
    disp[:, :, 1:] = pos_n[:, :, 1:] - pos_n[:, :, :-1]
    ang_cs = torch.stack([torch.cos(ang_n), torch.sin(ang_n)], dim=-1)
    # the type one-hot is zeroed at unobserved steps (utils.py:312-313)
    type_feat = actor_type[None, :, None, :] * observed[..., None]
    feats = torch.cat([disp, ang_cs, vel_n, type_feat.to(dtype),
                       observed[..., None].to(dtype)], dim=-1)
    actors = feats[:, :, 2:, :]                       # [B, A, 48, 14]

    # lane anchors into the scene frame
    lane_ctrs = (lane_static.anchors_g[None] - orig[:, None]) @ rot
    lane_vecs = lane_static.anchor_vecs_g[None] @ rot

    # scene RPE over [actors; lanes]
    scene_ctrs = torch.cat([a_orig, lane_ctrs], dim=1)
    scene_vecs = torch.cat([a_vecs, lane_vecs], dim=1)
    rpe = make_rpe(scene_ctrs, scene_vecs)

    # high-level command (scenario_tree.py:613-652)
    cur_vel = torch.linalg.vector_norm(vel[:, 0, OBS_LEN - 1], dim=-1)
    tgt_pts, tgt_nodes, tgt_anch_pos, tgt_anch_vec = high_level_command(
        tgt_static, orig, rot, cur_vel, tar_time_ahead)

    # target RPE between the command anchor and the ego anchor
    tgt_ctrs = torch.stack([tgt_anch_pos, a_orig[:, 0]], dim=1)
    tgt_vecs = torch.stack([tgt_anch_vec, a_vecs[:, 0]], dim=1)
    tgt_rpe = make_rpe(tgt_ctrs, tgt_vecs).reshape(B, -1)  # [B, 20]

    L = lane_static.mask.shape[0]
    return SceneInputs(
        actors=actors,
        actor_mask=actor_mask[None].expand(B, A),
        lanes=lane_static.node_feats[None].expand((B,) + lane_static.node_feats.shape),
        lane_mask=lane_static.mask[None].expand(B, L),
        rpe=rpe,
        tgt_nodes=tgt_nodes,
        tgt_rpe=tgt_rpe,
        orig=orig,
        rot=rot,
        theta=theta,
        actor_ctrs=a_orig,
        actor_vecs=a_vecs,
        tgt_pts=tgt_pts,
    )


def high_level_command(tgt: TargetLaneStatic, orig, rot, cur_vel,
                       tar_time_ahead: float, min_vel: float = 0.5):
    """11-point target-lane window ahead of each ego by cur_vel * t_ahead
    (reference scenario_tree.py:613-652), as a masked search. orig [B, 2],
    rot [B, 2, 2], cur_vel [B]. The window start is clamped so the slice
    fits, as jax.lax.dynamic_slice_in_dim clamps it."""
    P = tgt.points.shape[0]
    n = int(tgt.n_points)
    dev = orig.device

    dists = torch.linalg.vector_norm(tgt.points[None] - orig[:, None], dim=-1)
    dists = torch.where(tgt.mask[None], dists,
                        torch.full((), 1e9, dtype=dists.dtype, device=dev))
    closest = torch.argmin(dists, dim=-1)               # [B], first minimum

    travel = torch.clamp(cur_vel, min=min_vel) * tar_time_ahead
    seg_len = torch.linalg.vector_norm(
        torch.roll(tgt.points, -1, dims=0) - tgt.points, dim=-1)  # seg i: i -> i+1
    idx = torch.arange(P, device=dev)
    ahead = (idx[None] >= closest[:, None]) & (idx[None] < n - 1)
    cum = torch.cumsum(torch.where(ahead, seg_len[None], torch.zeros_like(seg_len)), dim=-1)
    prev = torch.gather(cum, 1, torch.clamp(closest - 1, min=0)[:, None])[:, 0]
    base = torch.where(closest > 0, prev, torch.zeros_like(prev))
    rel_cum = cum - base[:, None]
    reached = ahead & (rel_cum >= travel[:, None])
    any_reach = reached.any(dim=-1)
    first = torch.argmax(reached.to(torch.uint8), dim=-1)   # first True
    j = torch.where(any_reach, first + 1, torch.full_like(first, n - 1))
    j = torch.where(j >= n - 1, torch.full_like(j, n - 2), j)
    j = torch.clamp(j, 5, max(n - 6, 5))

    start = j - 5
    pts_idx = torch.clamp(start, 0, P - 11)[:, None] + torch.arange(11, device=dev)
    info_idx = torch.clamp(start + 1, 0, P - 10)[:, None] + torch.arange(10, device=dev)
    pts = tgt.points[pts_idx]                          # [B, 11, 2]
    info = tgt.info[info_idx]                          # [B, 10, 12]

    ctrln = (pts - orig[:, None]) @ rot                # scene frame
    anch_pos = ctrln.mean(dim=1)
    span = ctrln[:, -1] - ctrln[:, 0]
    anch_vec = span / torch.linalg.vector_norm(span, dim=-1, keepdim=True)
    vx, vy = anch_vec[:, 0], anch_vec[:, 1]
    anch_rot = torch.stack([torch.stack([vx, -vy], -1), torch.stack([vy, vx], -1)], -2)
    ctrln_i = (ctrln - anch_pos[:, None]) @ anch_rot
    ctrs = (ctrln_i[:, :-1] + ctrln_i[:, 1:]) / 2.0
    vecs = ctrln_i[:, 1:] - ctrln_i[:, :-1]
    tgt_nodes = torch.cat([ctrs, vecs, info.to(ctrs.dtype)], dim=-1)  # [B, 10, 16]
    return pts, tgt_nodes, anch_pos, anch_vec
