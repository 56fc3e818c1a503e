"""Scenario → agent trajectories: classification, filtering, NN-padding and
10 Hz → 50 Hz resampling (reference loader.py).

Output is a `TrajBundle` of dense numpy arrays ready to become device-resident
replay buffers; agent instantiation itself lives in mind_tpu_torch.sim.agents.
Port of mind_tpu/data/loader.py; `trajs_info_of` takes a Scenario object, so
a scenario built in memory passes through the same filtering and resampling
as one read from a parquet file.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List

import numpy as np

from mind_tpu_torch.data.av2 import (
    ObjectType,
    TrackCategory,
    Scenario,
    load_scenario,
)
from mind_tpu_torch.data.semantic_map import SemanticMap
from mind_tpu_torch.common.geometry import wrap_angle

OBS_LEN = 50  # 10 Hz frames of history in the source log
ORI_SIM_STEP = 0.1
SIM_STEP = 0.02


def _points_polyline_min_dist(points: np.ndarray, polyline: np.ndarray) -> np.ndarray:
    """Min distance of each point [N,2] to a polyline [P,2], vectorized."""
    starts = polyline[:-1]  # [S, 2]
    segs = polyline[1:] - starts  # [S, 2]
    len_sq = np.sum(segs * segs, axis=-1)  # [S]
    rel = points[:, None, :] - starts[None, :, :]  # [N, S, 2]
    t = np.clip(np.einsum("nsd,sd->ns", rel, segs) / len_sq, 0.0, 1.0)
    proj = rel - t[..., None] * segs[None]
    return np.sqrt(np.sum(proj * proj, axis=-1)).min(axis=1)


def padding_traj_nn(traj: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Nearest-neighbor fill of invalid rows, forward then backward
    (reference common/data.py:24-44, minus the object-dtype round trip)."""
    out = np.array(traj, copy=True, dtype=np.float64)
    n = len(out)
    buff = None
    for i in range(n):
        if valid[i]:
            buff = out[i]
        elif buff is not None:
            out[i] = buff
    buff = None
    for i in reversed(range(n)):
        if valid[i]:
            buff = out[i]
        elif buff is not None:
            out[i] = buff
    return out


@dataclass
class TrajBundle:
    """Dense per-track arrays at 50 Hz (546 steps for a 110-frame log)."""

    pos: np.ndarray        # [N, T, 2] float32
    ang: np.ndarray        # [N, T]    float32
    vel: np.ndarray        # [N, T]    float32 (scalar speed)
    has_flag: np.ndarray   # [N, T]    bool
    types: List[List[ObjectType]]  # [N][T]
    track_ids: List[str]
    categories: List[str]  # focal / av / score / unscore / frag

    def __len__(self):
        return self.pos.shape[0]


class ArgoAgentLoader:
    """Parses, filters and resamples an AV2 scenario (reference loader.py)."""

    def __init__(self, data_path: Path | str):
        self.data_path = data_path

    def get_trajs_info(self, smp: SemanticMap) -> TrajBundle:
        return self.trajs_info_of(load_scenario(self.data_path), smp)

    @classmethod
    def trajs_info_of(cls, scenario: Scenario, smp: SemanticMap) -> TrajBundle:
        """Classify, filter, pad and resample the tracks of `scenario`."""
        obs_len = OBS_LEN

        focal_idx = av_idx = None
        scored, unscored, fragment = [], [], []
        for idx, tr in enumerate(scenario.tracks):
            if tr.track_id == scenario.focal_track_id and tr.category == TrackCategory.FOCAL_TRACK:
                focal_idx = idx
            elif tr.track_id == "AV":
                av_idx = idx
            elif tr.category == TrackCategory.SCORED_TRACK:
                scored.append(idx)
            elif tr.category == TrackCategory.UNSCORED_TRACK:
                unscored.append(idx)
            elif tr.category == TrackCategory.TRACK_FRAGMENT:
                fragment.append(idx)

        assert av_idx is not None, "[ERROR] Wrong av_idx"
        assert focal_idx is not None, "[ERROR] Wrong focal_idx"

        sorted_idcs = [focal_idx, av_idx] + scored + unscored + fragment
        sorted_cat = (["focal", "av"] + ["score"] * len(scored)
                      + ["unscore"] * len(unscored) + ["frag"] * len(fragment))

        ts = np.arange(0, 110)
        ts_obs = obs_len - 1  # 49

        pos_list, ang_list, vel_list, type_list, flag_list = [], [], [], [], []
        tid_list, cat_list = [], []
        for k, ind in enumerate(sorted_idcs):
            track = scenario.tracks[ind]
            traj_ts = np.array([s.timestep for s in track.object_states], dtype=np.int64)
            traj_pos = np.array([s.position for s in track.object_states], dtype=np.float64)
            traj_ang = np.array([s.heading for s in track.object_states], dtype=np.float64)
            traj_vel = np.linalg.norm(
                np.array([s.velocity for s in track.object_states], dtype=np.float64), axis=1)

            # only-future or unobserved-at-t49 tracks are dropped (loader.py:112-116)
            if traj_ts[0] > ts_obs or ts_obs not in traj_ts:
                continue

            # drop tracks whose observed part strays >5 m from every semantic
            # lane (loader.py:119-132); vectorized over points × segments
            on_lane_thres = 5.0
            obs_pts = traj_pos[:obs_len]
            on_lane = np.zeros(len(obs_pts), dtype=bool)
            for lane in smp.semantic_lanes.values():
                rem = ~on_lane
                if not rem.any():
                    break
                on_lane[rem] |= (
                    _points_polyline_min_dist(obs_pts[rem], lane) < on_lane_thres
                )
            if not on_lane.all():
                continue

            valid = np.zeros(len(ts), dtype=bool)
            valid[traj_ts] = True

            pos_pad = np.zeros((len(ts), 2))
            pos_pad[traj_ts] = traj_pos
            pos_pad = padding_traj_nn(pos_pad, valid)
            ang_pad = np.zeros(len(ts))
            ang_pad[traj_ts] = traj_ang
            ang_pad = padding_traj_nn(ang_pad[:, None], valid)[:, 0]
            vel_pad = np.zeros(len(ts))
            vel_pad[traj_ts] = traj_vel

            pos_list.append(pos_pad)
            ang_list.append(ang_pad)
            vel_list.append(vel_pad)
            flag_list.append(valid)
            type_list.append([track.object_type] * len(ts))
            tid_list.append(track.track_id)
            cat_list.append(sorted_cat[k])

        return cls._resample(pos_list, ang_list, vel_list, type_list,
                              tid_list, cat_list, flag_list)

    @staticmethod
    def _resample(pos_list, ang_list, vel_list, type_list, tid_list, cat_list,
                  flag_list) -> TrajBundle:
        """10 Hz → 50 Hz: linear interp of pos/vel, angle-wrapped interp of
        heading, >0.5 threshold on interpolated has_flag (loader.py:173-215)."""
        interp = int(round(ORI_SIM_STEP / SIM_STEP))
        res_pos, res_ang, res_vel, res_flag, res_type = [], [], [], [], []
        for pos, ang, vel, flag, typ in zip(pos_list, ang_list, vel_list, flag_list, type_list):
            T = len(pos)
            rp, ra, rv, rf, rt = [], [], [], [], []
            for t in range(T):
                if t == T - 1:
                    rp.append(pos[t]); ra.append(ang[t]); rv.append(vel[t])
                    rf.append(bool(flag[t])); rt.append(typ[t])
                else:
                    for j in range(interp):
                        r = j / interp
                        rp.append(pos[t] * (1 - r) + pos[t + 1] * r)
                        dd = wrap_angle(ang[t + 1] - ang[t])
                        ra.append(wrap_angle(ang[t] + dd * r))
                        rv.append(vel[t] * (1 - r) + vel[t + 1] * r)
                        rf.append(flag[t] * (1 - r) + flag[t + 1] * r > 0.5)
                        rt.append(typ[t])
            res_pos.append(np.array(rp)); res_ang.append(np.array(ra))
            res_vel.append(np.array(rv)); res_flag.append(np.array(rf))
            res_type.append(rt)

        return TrajBundle(
            pos=np.array(res_pos, dtype=np.float32),
            ang=np.array(res_ang, dtype=np.float32),
            vel=np.array(res_vel, dtype=np.float32),
            has_flag=np.array(res_flag, dtype=bool),
            types=res_type,
            track_ids=tid_list,
            categories=cat_list,
        )
