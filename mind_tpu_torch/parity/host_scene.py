"""Host-numpy (float64) mirrors of the AIME data plumbing and mode decode
(the port's own copy of mind_tpu/parity/host_scene.py, equal to it to the
bit: tests/test_torch_parity_host.py).

Follows the reference's per-node processing (reference planners/mind/
scenario_tree.py process_data/update_obser/prune_merge/get_branch_time/
get_high_level_command and planners/mind/utils.py actor_gather/get_rpe),
with the same index arithmetic as the port's device path
(mind_tpu_torch/planner/scene_prep.py, scenario_tree.py:_decode_node) so the
two can be compared end to end. Only the network forward itself is shared:
both sides call the same ScenePredNet with the same weights.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

OBS_LEN = 50
PRED_LEN = 60
SEQ_LEN = 110


def rot_of(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s], [s, c]])


def wrap(a):
    return np.arctan2(np.sin(a), np.cos(a))


def make_rpe_np(ctrs: np.ndarray, vecs: np.ndarray,
                radius: float = 100.0) -> np.ndarray:
    """Pairwise RPE [N, N, 5] (reference utils.py:193-212)."""
    d = ctrs[None, :, :] - ctrs[:, None, :]
    dist = np.linalg.norm(d, axis=-1) * 2.0 / radius

    def cos_sin(v1, v2):
        n1 = np.linalg.norm(v1, axis=-1)
        n2 = np.linalg.norm(v2, axis=-1)
        denom = n1 * n2 + 1e-10
        cos = (v1[..., 0] * v2[..., 0] + v1[..., 1] * v2[..., 1]) / denom
        sin = (v1[..., 0] * v2[..., 1] - v1[..., 1] * v2[..., 0]) / denom
        return cos, sin

    v_a = np.broadcast_to(vecs[None, :, :], d.shape)
    v_b = np.broadcast_to(vecs[:, None, :], d.shape)
    cos_a1, sin_a1 = cos_sin(v_a, v_b)
    cos_a2, sin_a2 = cos_sin(v_a, d)
    return np.stack([cos_a1, sin_a1, cos_a2, sin_a2, dist], axis=-1)


def high_level_command_np(tgt_points: np.ndarray, tgt_info: np.ndarray,
                          n_points: int, orig, rot, cur_vel: float,
                          tar_time_ahead: float, min_vel: float = 0.5):
    """11-point target-lane window ahead by cur_vel * t_ahead
    (reference scenario_tree.py:613-652; same clipping as
    scene_prep.high_level_command)."""
    pts_valid = tgt_points[:n_points]
    closest = int(np.argmin(np.linalg.norm(pts_valid - orig, axis=-1)))

    travel = max(cur_vel, min_vel) * tar_time_ahead
    seg_len = np.linalg.norm(pts_valid[1:] - pts_valid[:-1], axis=-1)
    # first j > closest with cumulative length (closest..j-1] >= travel
    cum = np.cumsum(seg_len[closest:])  # cum[m] = length closest..closest+m
    reached = np.flatnonzero(cum >= travel)
    n = n_points
    if len(reached):
        j = closest + int(reached[0]) + 1
    else:
        j = n - 1
    if j >= n - 1:
        j = n - 2
    j = int(np.clip(j, 5, max(n - 6, 5)))

    start = j - 5
    pts = tgt_points[start:start + 11].astype(float)        # [11, 2]
    info = tgt_info[start + 1:start + 11].astype(float)     # [10, 12]

    ctrln = (pts - orig) @ rot
    anch_pos = np.mean(ctrln, axis=0)
    span = ctrln[-1] - ctrln[0]
    anch_vec = span / np.linalg.norm(span)
    anch_rot = np.array([[anch_vec[0], -anch_vec[1]],
                         [anch_vec[1], anch_vec[0]]])
    ctrln_i = (ctrln - anch_pos) @ anch_rot
    ctrs = (ctrln_i[:-1] + ctrln_i[1:]) / 2.0
    vecs = ctrln_i[1:] - ctrln_i[:-1]
    tgt_nodes = np.concatenate([ctrs, vecs, info], axis=-1)  # [10, 16]
    return pts, tgt_nodes, anch_pos, anch_vec


@dataclass
class HostSceneInputs:
    """Numpy twin of scene_prep.SceneInputs for one AIME node."""

    actors: np.ndarray
    lanes: np.ndarray
    rpe: np.ndarray
    tgt_nodes: np.ndarray
    tgt_rpe: np.ndarray
    orig: np.ndarray
    rot: np.ndarray
    theta: float
    actor_ctrs: np.ndarray
    actor_vecs: np.ndarray
    tgt_pts: np.ndarray


def prepare_node_inputs_np(pos, ang, vel, observed, actor_type,
                           lane_node_feats, lane_anchors_g, lane_vecs_g,
                           tgt_points, tgt_info, tgt_n_points,
                           tar_time_ahead: float) -> HostSceneInputs:
    """One node's global-frame obs window [A, 50, ...] -> padded network
    inputs (reference scenario_tree.py:122-206 + utils.py:114-139,193-212).
    Arrays keep the production paddings ([A] actors, [L] lanes) so the shared
    network sees identical shapes."""
    A = pos.shape[0]
    orig = pos[0, OBS_LEN - 1].copy()
    theta = float(ang[0, OBS_LEN - 1])
    rot = rot_of(theta)

    pos_s = (pos - orig) @ rot
    ang_s = ang - theta
    vel_s = vel @ rot

    a_orig = pos_s[:, OBS_LEN - 1]
    a_theta = ang_s[:, OBS_LEN - 1]
    a_rot = np.stack([rot_of(t) for t in a_theta])           # [A, 2, 2]
    pos_n = np.einsum("atd,ade->ate", pos_s - a_orig[:, None], a_rot)
    ang_n = ang_s - a_theta[:, None]
    vel_n = np.einsum("atd,ade->ate", vel_s, a_rot)
    a_vecs = np.stack([np.cos(a_theta), np.sin(a_theta)], axis=-1)

    disp = np.zeros_like(pos_n)
    disp[:, 1:] = pos_n[:, 1:] - pos_n[:, :-1]
    ang_cs = np.stack([np.cos(ang_n), np.sin(ang_n)], axis=-1)
    type_feat = actor_type[:, None, :] * observed[..., None]
    feats = np.concatenate(
        [disp, ang_cs, vel_n,
         np.broadcast_to(type_feat, (A, OBS_LEN, 7)),
         observed[..., None]], axis=-1)
    actors = feats[:, 2:, :]

    lane_ctrs = (lane_anchors_g - orig) @ rot
    lane_vecs = lane_vecs_g @ rot

    scene_ctrs = np.concatenate([a_orig, lane_ctrs], axis=0)
    scene_vecs = np.concatenate([a_vecs, lane_vecs], axis=0)
    rpe = make_rpe_np(scene_ctrs, scene_vecs)

    cur_vel = float(np.linalg.norm(vel[0, OBS_LEN - 1]))
    tgt_pts, tgt_nodes, anch_pos, anch_vec = high_level_command_np(
        tgt_points, tgt_info, tgt_n_points, orig, rot, cur_vel,
        tar_time_ahead)

    tgt_ctrs = np.stack([anch_pos, a_orig[0]])
    tgt_vecs = np.stack([anch_vec, a_vecs[0]])
    tgt_rpe = make_rpe_np(tgt_ctrs, tgt_vecs).reshape(-1)

    return HostSceneInputs(
        actors=actors, lanes=lane_node_feats, rpe=rpe, tgt_nodes=tgt_nodes,
        tgt_rpe=tgt_rpe, orig=orig, rot=rot, theta=theta, actor_ctrs=a_orig,
        actor_vecs=a_vecs, tgt_pts=tgt_pts)


@dataclass
class HostDecoded:
    """Per-mode candidate children of one branch node."""

    pos: np.ndarray       # [M, A, 110, 2]
    ang: np.ndarray       # [M, A, 110]
    vel: np.ndarray       # [M, A, 110, 2]
    cov: np.ndarray       # [M, A, 110]
    tgt_pts: np.ndarray   # [11, 2]
    prob: np.ndarray      # [M]
    keep: np.ndarray      # [M] bool
    t_b: np.ndarray       # [M] int
    # decision margins (diagnostics — how close each mode sat to the
    # prune/merge boundaries; see parity/runner.py::run_playback_diagnostic)
    prune_margin: np.ndarray = None  # [M] prob - prune_prob (drop if < 0)
    tgt_margin: np.ndarray = None    # [M] thres - (d_tgt - cov) (drop if < 0)
    merge_gap: np.ndarray = None     # [M] closest-signature gap - merge_thres
    #    (merged into an earlier mode if <= 0; +inf when nothing to merge to)


def _points_polyline_dist_np(points, polyline, n_valid):
    lane = polyline[:n_valid]
    seg = lane[1:] - lane[:-1]
    len_sq = np.sum(seg * seg, axis=-1)
    len_sq = np.where(len_sq > 0, len_sq, 1.0)
    t = np.clip(
        np.einsum("psd,sd->ps", points[:, None, :] - lane[None, :-1], seg)
        / len_sq, 0.0, 1.0)
    proj = lane[None, :-1] + t[..., None] * seg[None]
    d = np.linalg.norm(points[:, None, :] - proj, axis=-1)
    return np.min(d, axis=-1)


def decode_node_np(cls, reg, vel_pred, inputs: HostSceneInputs,
                   win_pos, win_ang, win_vel, win_cov,
                   parent_prob: float, cur_t: int, actor_mask,
                   tgt_points, tgt_n_points, scen_cfg) -> HostDecoded:
    """Numpy twin of scenario_tree._decode_node (reference prune_merge +
    get_branch_time, scenario_tree.py:281-412,592-611). cls [M],
    reg [A, M, 60, 5], vel_pred [A, M, 60, 2]; windows [A, 50, ...]."""
    M = cls.shape[0]
    orig, rot, theta = inputs.orig, inputs.rot, inputs.theta
    a_ctrs, a_vecs = inputs.actor_ctrs, inputs.actor_vecs
    a_theta = np.arctan2(a_vecs[:, 1], a_vecs[:, 0])
    a_rot = np.stack([rot_of(t) for t in a_theta])

    pos_p = np.einsum("amtd,aed->amte", reg[..., :2], a_rot) \
        + a_ctrs[:, None, None]
    pos_g = np.einsum("amtd,ed->amte", pos_p, rot) + orig
    vel_s = np.einsum("amtd,aed->amte", vel_pred, a_rot)
    vel_g = np.einsum("amtd,ed->amte", vel_s, rot)
    ang_g = np.arctan2(vel_pred[..., 1], vel_pred[..., 0]) \
        + a_theta[:, None, None] + theta

    cov_p = np.maximum(reg[..., 2], reg[..., 3])
    cov_g = cov_p + win_cov[:, None, -1:]

    hist_pos = np.concatenate(
        [np.broadcast_to(win_pos[:, None], (win_pos.shape[0], M, OBS_LEN, 2)
                         ).swapaxes(0, 1),
         pos_g.swapaxes(0, 1)], axis=2)
    hist_ang = np.concatenate(
        [np.broadcast_to(win_ang[:, None], win_ang.shape[:1] + (M, OBS_LEN)
                         ).swapaxes(0, 1),
         ang_g.swapaxes(0, 1)], axis=2)
    hist_vel = np.concatenate(
        [np.broadcast_to(win_vel[:, None], (win_vel.shape[0], M, OBS_LEN, 2)
                         ).swapaxes(0, 1),
         vel_g.swapaxes(0, 1)], axis=2)
    hist_cov = np.concatenate(
        [np.broadcast_to(win_cov[:, None], win_cov.shape[:1] + (M, OBS_LEN)
                         ).swapaxes(0, 1),
         cov_g.swapaxes(0, 1)], axis=2)

    prob = cls * parent_prob
    keep = prob >= scen_cfg.prune_prob                      # scenario_tree.py:369-370

    # target-lane prune (scenario_tree.py:373-379)
    ego_mean = hist_pos[:, 0, -1]
    ego_cov = hist_cov[:, 0, -1]
    d_tgt = _points_polyline_dist_np(ego_mean, tgt_points, tgt_n_points)
    keep &= (d_tgt - ego_cov) <= scen_cfg.tar_dist_thres

    # bearing-topology signature (scenario_tree.py:382-394)
    rel = pos_g - pos_g[:1]
    rel = rel / (np.linalg.norm(rel, axis=-1, keepdims=True) + 1e-12)
    bear = np.arctan2(rel[..., 1], rel[..., 0])
    topo = np.sum(wrap(bear[:, :, 1:] - bear[:, :, :-1]), axis=-1)  # [A, M]
    topo = topo[1:].T                                       # [M, A-1]
    exo_valid = np.asarray(actor_mask)[1:]

    # greedy merge, descending mode probability (scenario_tree.py:397-410)
    order = np.argsort(-cls, kind="stable")
    sel = np.zeros(M, bool)
    merge_gap = np.full(M, np.inf)
    for i in order:
        diff = wrap(topo - topo[i])
        # per-candidate signature distance = the largest per-exo bearing
        # change difference vs each other mode (the reference merges when
        # NO valid exo differs by more than the threshold)
        sig_dist = np.max(np.where(exo_valid[None, :], np.abs(diff), -np.inf),
                          axis=-1)
        differs = sig_dist - scen_cfg.merge_thres > 0
        if sel.any():
            merge_gap[i] = float(np.min(sig_dist[sel])
                                 - scen_cfg.merge_thres)
        if keep[i] and np.all(differs[sel]):
            sel[i] = True
    keep_final = sel

    # branch time (scenario_tree.py:592-611), index arithmetic as in
    # scenario_tree._decode_node
    compare_t = OBS_LEN + cur_t + (1 if cur_t == 0 else 0)
    ts = np.arange(SEQ_LEN)
    in_range = (ts >= cur_t + 1) & (ts < PRED_LEN) & (ts % 2 == 0)
    idx = np.clip(OBS_LEN + ts, 0, SEQ_LEN - 1)
    amask = np.asarray(actor_mask)
    ratio = hist_cov[:, :, idx] / hist_cov[:, :, compare_t][..., None]
    trig = np.any((ratio > scen_cfg.cov_change_rate) & amask[None, :, None],
                  axis=1)                                   # [M, T]
    trig &= in_range[None, :]
    t_b = np.where(trig.any(axis=-1),
                   np.argmax(trig, axis=-1), PRED_LEN).astype(int)

    return HostDecoded(pos=hist_pos, ang=hist_ang, vel=hist_vel,
                       cov=hist_cov, tgt_pts=inputs.tgt_pts, prob=prob,
                       keep=keep_final, t_b=t_b,
                       prune_margin=prob - scen_cfg.prune_prob,
                       tgt_margin=(scen_cfg.tar_dist_thres
                                   - (d_tgt - ego_cov)),
                       merge_gap=merge_gap)


class HostObsBuffer:
    """Rolling 50-frame observation window with nearest-neighbor fill —
    numpy twin of aime_device.DeviceObsBuffer/nn_fill_window (reference
    planner.py:66-95, utils.py:315-325)."""

    def __init__(self, max_actors: int):
        self.A = max_actors
        self.slots: Dict[str, int] = {}
        self.types = np.zeros((max_actors, 7), float)
        self.active = np.zeros(max_actors, bool)
        self.last_present = np.zeros(max_actors, bool)
        self.pos = np.zeros((max_actors, OBS_LEN, 2))
        self.ang = np.zeros((max_actors, OBS_LEN))
        self.vel = np.zeros((max_actors, OBS_LEN, 2))
        self.observed = np.zeros((max_actors, OBS_LEN), bool)

    def _slot(self, track_id: str, onehot: np.ndarray) -> Optional[int]:
        if track_id in self.slots:
            return self.slots[track_id]
        free = np.flatnonzero(~self.active)
        if len(free) == 0:
            return None
        s = int(free[0])
        self.slots[track_id] = s
        self.active[s] = True
        self.types[s] = onehot
        return s

    def update(self, observations, type_onehot_fn):
        present = np.zeros(self.A, bool)
        self.pos[:, :-1] = self.pos[:, 1:]
        self.ang[:, :-1] = self.ang[:, 1:]
        self.vel[:, :-1] = self.vel[:, 1:]
        self.observed[:, :-1] = self.observed[:, 1:]
        self.observed[:, -1] = False
        for track_id, state, obj_type in observations:
            s = self._slot(track_id, type_onehot_fn(obj_type))
            if s is None:
                continue
            x, y, v, yaw = state
            self.pos[s, -1] = (x, y)
            self.ang[s, -1] = yaw
            self.vel[s, -1] = (v * np.cos(yaw), v * np.sin(yaw))
            present[s] = True
        # repeat previous frame for absent-but-known slots (unobserved)
        absent = self.active & ~present
        self.pos[absent, -1] = self.pos[absent, -2]
        self.ang[absent, -1] = self.ang[absent, -2]
        self.vel[absent, -1] = self.vel[absent, -2]
        self.observed[:, -1] = present
        self.last_present = present

    def window(self):
        """NN-filled window: forward fill + leading-edge backfill of pos/ang,
        zero velocity at unobserved frames."""
        idx = np.arange(OBS_LEN)[None, :]
        prev = np.maximum.accumulate(np.where(self.observed, idx, -1), axis=1)
        first = np.argmax(self.observed, axis=1)
        fill = np.where(prev >= 0, prev, first[:, None])
        pos = np.take_along_axis(self.pos, fill[..., None], axis=1)
        ang = np.take_along_axis(self.ang, fill, axis=1)
        vel = np.where(self.observed[..., None], self.vel, 0.0)
        return pos, ang, vel, self.observed.astype(float)

    def actor_mask(self) -> np.ndarray:
        return self.active & self.last_present
