"""Semantic map: maximal predecessor→successor lane chains with per-point
features, plus the per-agent local view.

Re-derives the reference's SemanticMap/LocalSemanticMap
(common/semantic_map.py:7-231) on top of the native StaticMap (a copy of
mind_tpu/data/semantic_map.py). Also hosts the
lane-graph segmentation used as network input
(reference planners/mind/utils.py:345-483), with the shapely LineString
arclength interpolation replaced by a small numpy routine.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from mind_tpu_torch.data.av2 import (
    StaticMap,
    LaneType,
    CROSSABLE_MARKS,
    NOT_CROSSABLE_MARKS,
)


def _mark_onehot(mark) -> np.ndarray:
    out = np.zeros(3, np.float32)
    if mark in CROSSABLE_MARKS:
        out[0] = 1
    elif mark in NOT_CROSSABLE_MARKS:
        out[1] = 1
    else:
        out[2] = 1
    return out


def _lane_type_onehot(lane_type: LaneType) -> np.ndarray:
    out = np.zeros(3, np.float32)
    if lane_type == LaneType.VEHICLE:
        out[0] = 1
    elif lane_type == LaneType.BIKE:
        out[1] = 1
    elif lane_type == LaneType.BUS:
        out[2] = 1
    else:
        raise ValueError("Wrong lane type")
    return out


class SemanticMap:
    """Semantic lanes = all maximal lane-ID chains, concatenated centerlines.

    semantic_lanes[idx] : [P, 2] float32 centerline points
    semantic_lanes_infos[idx] : [intersect [P], lane_type [P,3],
                                 cross_left [P,3], cross_right [P,3],
                                 left [P], right [P]]
    """

    def __init__(self):
        self.map_data: Optional[StaticMap] = None
        self.limits = None
        self.semantic_lanes: Dict[int, np.ndarray] = {}
        self.semantic_lanes_infos: Dict[int, list] = {}

    def load_from_argo2(self, path) -> "SemanticMap":
        self.map_data = StaticMap.from_json(path)
        self._build_semantic_lanes()
        return self

    def _build_semantic_lanes(self):
        segs = self.map_data.vector_lane_segments

        # seed chains at lanes with no in-map predecessor, then extend by all
        # successors until fixpoint (reference semantic_map.py:22-51)
        chains: List[List[int]] = []
        for lane_id, lane in segs.items():
            if not any(p in segs for p in lane.predecessors):
                chains.append([lane_id])

        while True:
            extended = False
            new_chains: List[List[int]] = []
            for chain in chains:
                succs = [s for s in segs[chain[-1]].successors if s in segs]
                if succs:
                    extended = True
                    new_chains.extend(chain + [s] for s in succs)
                else:
                    new_chains.append(chain)
            chains = new_chains
            if not extended:
                break

        self.semantic_lanes = {}
        self.semantic_lanes_infos = {}
        all_pts = []
        for idx, chain in enumerate(chains):
            cls, intersects, ltypes, c_lefts, c_rights, lefts, rights = ([] for _ in range(7))
            for lane_id in chain:
                # drop the last centerline point of each segment to avoid
                # duplicating the successor's first point (semantic_map.py:63)
                cl = self.map_data.get_lane_segment_centerline(lane_id)[:-1, 0:2]
                lane = segs[lane_id]
                n = cl.shape[0]
                cls.append(cl)
                intersects.append(np.full(n, float(lane.is_intersection), np.float32))
                ltypes.append(np.tile(_lane_type_onehot(lane.lane_type), (n, 1)))
                c_lefts.append(np.tile(_mark_onehot(lane.left_mark_type), (n, 1)))
                c_rights.append(np.tile(_mark_onehot(lane.right_mark_type), (n, 1)))
                lefts.append(np.full(n, float(lane.left_neighbor_id is not None), np.float32))
                rights.append(np.full(n, float(lane.right_neighbor_id is not None), np.float32))

            centerline = np.concatenate(cls).astype(np.float32)
            seg_lens = np.linalg.norm(np.diff(centerline, axis=0), axis=1)
            assert np.all(seg_lens > 1e-2), "overlapping semantic-lane points"
            all_pts.append(centerline)
            self.semantic_lanes[idx] = centerline
            self.semantic_lanes_infos[idx] = [
                np.concatenate(intersects),
                np.concatenate(ltypes),
                np.concatenate(c_lefts),
                np.concatenate(c_rights),
                np.concatenate(lefts),
                np.concatenate(rights),
            ]

        pts = np.concatenate(all_pts, axis=0)
        self.limits = [
            [float(pts[:, 0].min()), float(pts[:, 0].max())],
            [float(pts[:, 1].min()), float(pts[:, 1].max())],
        ]

    def get_map_limits(self):
        return self.limits


class LocalSemanticMap:
    """Per-agent view: shared map + target lane/velocity + split observations."""

    def __init__(self, ego_id, semantic_map: SemanticMap):
        self.ego_id = ego_id
        self.map_data = semantic_map.map_data
        self.semantic_lanes = semantic_map.semantic_lanes
        self.semantic_lanes_infos = semantic_map.semantic_lanes_infos
        self.target_lane: Optional[np.ndarray] = None
        self.target_lane_info = None
        self.target_velocity: Optional[float] = None
        self.exo_agents: list = []
        self.ego_agent = None

    def update_target_lane(self, target_lane):
        self.target_lane = np.array(target_lane, copy=True)

    def update_target_lane_info(self, target_lane_info):
        self.target_lane_info = target_lane_info

    def update_target_velocity(self, target_velocity):
        self.target_velocity = target_velocity

    def update_observation(self, agents):
        exo = []
        for agent in agents:
            if agent.id != self.ego_id:
                exo.append(agent)
            else:
                self.ego_agent = agent
        self.exo_agents = exo

    def get_closest_semantic_lane(self, pos, ang, ang_threshold=np.deg2rad(30.0)):
        min_dist, closest = 1e6, None
        heading = np.array([np.cos(ang), np.sin(ang)])
        for lane_id, lane in self.semantic_lanes.items():
            dists = np.linalg.norm(lane - pos, axis=1)
            i = min(int(np.argmin(dists)), len(lane) - 2)
            d = lane[i + 1] - lane[i]
            d = d / np.linalg.norm(d)
            if np.dot(d, heading) > np.cos(ang_threshold):
                dist = float(dists.min())
                if dist < min_dist:
                    min_dist, closest = dist, lane_id
        return closest

    def get_semantic_lane(self, lane_id):
        return self.semantic_lanes[lane_id]


# --------------------------------------------------------------------------
# lane graph for the prediction network
# --------------------------------------------------------------------------

def _polyline_arclength_interp(points: np.ndarray, s: np.ndarray) -> np.ndarray:
    """Points at arclengths `s` along a polyline (shapely interpolate twin)."""
    seg_len = np.linalg.norm(np.diff(points, axis=0), axis=1)
    cum = np.concatenate([[0.0], np.cumsum(seg_len)])
    s = np.clip(s, 0.0, cum[-1])
    idx = np.clip(np.searchsorted(cum, s, side="right") - 1, 0, len(seg_len) - 1)
    denom = np.where(seg_len[idx] > 0, seg_len[idx], 1.0)
    frac = (s - cum[idx]) / denom
    return points[idx] + frac[:, None] * (points[idx + 1] - points[idx])


def build_lane_graph(static_map: StaticMap, orig: np.ndarray, rot: np.ndarray,
                     seg_length: float = 15.0, num_seg_points: int = 10) -> dict:
    """Split lane centerlines into ~15 m chunks of 10 nodes each, in anchor
    instance frames (reference planners/mind/utils.py:345-483).

    Returns a dict of stacked numpy arrays:
      node_ctrs/node_vecs [L, 10, 2], intersect/left/right [L, 10],
      lane_type/cross_left/cross_right [L, 10, 3], lane_ctrs/lane_vecs [L, 2].
    """
    node_ctrs, node_vecs = [], []
    lane_type, intersect, cross_left, cross_right, left, right = [], [], [], [], [], []
    lane_ctrs, lane_vecs = [], []

    for lane_id, lane in static_map.vector_lane_segments.items():
        cl_raw = static_map.get_lane_segment_centerline(lane_id)[:, 0:2]
        assert cl_raw.shape[0] == num_seg_points, f"wrong num points in lane {lane_id}"
        total_len = float(np.linalg.norm(np.diff(cl_raw, axis=0), axis=1).sum())
        num_segs = max(int(np.floor(total_len / seg_length)), 1)
        ds = total_len / num_segs

        lt = _lane_type_onehot(lane.lane_type)
        cl_feat = _mark_onehot(lane.left_mark_type)
        cr_feat = _mark_onehot(lane.right_mark_type)

        for i in range(num_segs):
            s = np.linspace(i * ds, (i + 1) * ds, num_seg_points + 1)
            ctrln = _polyline_arclength_interp(cl_raw, s)  # [11, 2]
            ctrln = (ctrln - orig) @ rot  # scene frame

            anch_pos = ctrln.mean(axis=0)
            anch_vec = ctrln[-1] - ctrln[0]
            anch_vec = anch_vec / np.linalg.norm(anch_vec)
            anch_rot = np.array([[anch_vec[0], -anch_vec[1]],
                                 [anch_vec[1], anch_vec[0]]])
            lane_ctrs.append(anch_pos)
            lane_vecs.append(anch_vec)

            ctrln = (ctrln - anch_pos) @ anch_rot  # instance frame
            node_ctrs.append(((ctrln[:-1] + ctrln[1:]) / 2.0).astype(np.float32))
            node_vecs.append((ctrln[1:] - ctrln[:-1]).astype(np.float32))

            lane_type.append(np.tile(lt, (num_seg_points, 1)))
            intersect.append(np.full(num_seg_points, float(lane.is_intersection), np.float32))
            cross_left.append(np.tile(cl_feat, (num_seg_points, 1)))
            cross_right.append(np.tile(cr_feat, (num_seg_points, 1)))
            left.append(np.full(num_seg_points, float(lane.left_neighbor_id is not None), np.float32))
            right.append(np.full(num_seg_points, float(lane.right_neighbor_id is not None), np.float32))

    graph = {
        "node_ctrs": np.stack(node_ctrs).astype(np.float32),
        "node_vecs": np.stack(node_vecs).astype(np.float32),
        "lane_ctrs": np.array(lane_ctrs, dtype=np.float32),
        "lane_vecs": np.array(lane_vecs, dtype=np.float32),
        "lane_type": np.stack(lane_type).astype(np.float32),
        "intersect": np.stack(intersect).astype(np.float32),
        "cross_left": np.stack(cross_left).astype(np.float32),
        "cross_right": np.stack(cross_right).astype(np.float32),
        "left": np.stack(left).astype(np.float32),
        "right": np.stack(right).astype(np.float32),
    }
    graph["num_lanes"] = graph["lane_ctrs"].shape[0]
    graph["num_nodes"] = graph["node_ctrs"].shape[0] * graph["node_ctrs"].shape[1]
    return graph


def lane_graph_features(graph: dict) -> np.ndarray:
    """Per-node 16-dim feature [ctr2, vec2, intersect, lane_type3, cross_left3,
    cross_right3, left, right] (reference utils.py:103-110)."""
    return np.concatenate([
        graph["node_ctrs"],
        graph["node_vecs"],
        graph["intersect"][..., None],
        graph["lane_type"],
        graph["cross_left"],
        graph["cross_right"],
        graph["left"][..., None],
        graph["right"][..., None],
    ], axis=-1).astype(np.float32)
