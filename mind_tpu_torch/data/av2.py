"""Native Argoverse 2 motion-forecasting ingestion (no `av2` dependency).

Parses the scenario parquet track logs and the log_map_archive JSON vector
maps that ship with each scenario, exposing the same surface the reference
consumes from the `av2` package (reference loader.py:70,
common/semantic_map.py:18): tracks with typed object states,
lane segments with boundaries/topology/mark types, and 10-point interpolated
centerlines computed as the midpoint line of the lane boundaries.

Everything here is host-side numpy executed once per scenario; device code
never sees these objects, only the padded tensors derived from them. A copy
of mind_tpu/data/av2.py whose scenario reader is data/parquet.py (numpy,
zlib and a snappy decoder of its own) in place of pandas and pyarrow.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from enum import Enum, IntEnum
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from mind_tpu_torch.data.parquet import read_parquet

# Number of interpolated waypoints per lane-segment centerline; AV2's map API
# always returns exactly this many (the reference asserts it,
# planners/mind/utils.py:354-355).
NUM_CENTERLINE_INTERP_PTS = 10


class ObjectType(str, Enum):
    VEHICLE = "vehicle"
    PEDESTRIAN = "pedestrian"
    MOTORCYCLIST = "motorcyclist"
    CYCLIST = "cyclist"
    BUS = "bus"
    STATIC = "static"
    BACKGROUND = "background"
    CONSTRUCTION = "construction"
    RIDERLESS_BICYCLE = "riderless_bicycle"
    UNKNOWN = "unknown"


class TrackCategory(IntEnum):
    TRACK_FRAGMENT = 0
    UNSCORED_TRACK = 1
    SCORED_TRACK = 2
    FOCAL_TRACK = 3


@dataclass
class ObjectState:
    """One timestep of one track (reference: av2 data_schema.ObjectState)."""

    observed: bool
    timestep: float
    position: Tuple[float, float]
    heading: float
    velocity: Tuple[float, float]


@dataclass
class Track:
    track_id: str
    object_states: List[ObjectState]
    object_type: ObjectType
    category: TrackCategory


@dataclass
class Scenario:
    scenario_id: str
    focal_track_id: str
    city_name: str
    tracks: List[Track]


def load_scenario(path: Path | str) -> Scenario:
    """Parse an AV2 scenario parquet into typed tracks.

    Mirrors av2 scenario_serialization.load_argoverse_scenario_parquet as the
    reference uses it (loader.py:70), and the JAX package's pandas route
    (`groupby("track_id", sort=False)`, `sort_values("timestep")`): tracks in
    order of first appearance, states sorted by timestep (AV2 logs hold one
    row per track and timestep). The file is read by data/parquet.py.
    """
    df = read_parquet(path)
    scenario_id = str(df["scenario_id"][0])
    focal_track_id = str(df["focal_track_id"][0])
    city = str(df["city"][0]) if "city" in df else ""

    keys, first, inverse = np.unique(df["track_id"], return_index=True, return_inverse=True)
    rows_of = np.argsort(inverse, kind="stable")
    bounds = np.concatenate([[0], np.cumsum(np.bincount(inverse, minlength=len(keys)))])
    tracks: List[Track] = []
    for k in np.argsort(first, kind="stable"):
        rows = rows_of[bounds[k]:bounds[k + 1]]
        rows = rows[np.argsort(df["timestep"][rows], kind="stable")]
        states = [
            ObjectState(
                observed=bool(df["observed"][r]),
                timestep=int(df["timestep"][r]),
                position=(float(df["position_x"][r]), float(df["position_y"][r])),
                heading=float(df["heading"][r]),
                velocity=(float(df["velocity_x"][r]), float(df["velocity_y"][r])),
            )
            for r in rows
        ]
        try:
            obj_type = ObjectType(str(df["object_type"][rows[0]]))
        except ValueError:
            obj_type = ObjectType.UNKNOWN
        cat = TrackCategory(int(df["object_category"][rows[0]]))
        tracks.append(Track(str(keys[k]), states, obj_type, cat))

    return Scenario(scenario_id, focal_track_id, city, tracks)


class LaneType(str, Enum):
    VEHICLE = "VEHICLE"
    BIKE = "BIKE"
    BUS = "BUS"


class LaneMarkType(str, Enum):
    DASH_SOLID_YELLOW = "DASH_SOLID_YELLOW"
    DASH_SOLID_WHITE = "DASH_SOLID_WHITE"
    DASHED_WHITE = "DASHED_WHITE"
    DASHED_YELLOW = "DASHED_YELLOW"
    DOUBLE_SOLID_YELLOW = "DOUBLE_SOLID_YELLOW"
    DOUBLE_SOLID_WHITE = "DOUBLE_SOLID_WHITE"
    DOUBLE_DASH_YELLOW = "DOUBLE_DASH_YELLOW"
    DOUBLE_DASH_WHITE = "DOUBLE_DASH_WHITE"
    SOLID_YELLOW = "SOLID_YELLOW"
    SOLID_WHITE = "SOLID_WHITE"
    SOLID_DASH_WHITE = "SOLID_DASH_WHITE"
    SOLID_DASH_YELLOW = "SOLID_DASH_YELLOW"
    SOLID_BLUE = "SOLID_BLUE"
    NONE = "NONE"
    UNKNOWN = "UNKNOWN"


# mark types an agent may legally cross (reference semantic_map.py:86-102)
CROSSABLE_MARKS = {
    LaneMarkType.DASH_SOLID_YELLOW,
    LaneMarkType.DASH_SOLID_WHITE,
    LaneMarkType.DASHED_WHITE,
    LaneMarkType.DASHED_YELLOW,
    LaneMarkType.DOUBLE_DASH_YELLOW,
    LaneMarkType.DOUBLE_DASH_WHITE,
}
NOT_CROSSABLE_MARKS = {
    LaneMarkType.DOUBLE_SOLID_YELLOW,
    LaneMarkType.DOUBLE_SOLID_WHITE,
    LaneMarkType.SOLID_YELLOW,
    LaneMarkType.SOLID_WHITE,
    LaneMarkType.SOLID_DASH_WHITE,
    LaneMarkType.SOLID_DASH_YELLOW,
    LaneMarkType.SOLID_BLUE,
}


@dataclass
class LaneSegment:
    id: int
    lane_type: LaneType
    left_lane_boundary: np.ndarray  # [P, 3]
    right_lane_boundary: np.ndarray  # [P, 3]
    left_mark_type: LaneMarkType
    right_mark_type: LaneMarkType
    left_neighbor_id: Optional[int]
    right_neighbor_id: Optional[int]
    predecessors: List[int]
    successors: List[int]
    is_intersection: bool
    _centerline: Optional[np.ndarray] = field(default=None, repr=False)


def interp_arc(t: int, points: np.ndarray) -> np.ndarray:
    """Resample a polyline to `t` points uniformly spaced in chordal arclength.

    Same algorithm family as av2's geometry interpolation utilities (used to
    compute lane centerlines the reference consumes via
    get_lane_segment_centerline, common/semantic_map.py:63).
    """
    points = np.asarray(points, dtype=np.float64)
    n = points.shape[0]
    eq_spaced = np.linspace(0.0, 1.0, t)
    chordlen = np.linalg.norm(np.diff(points, axis=0), axis=1)
    total = chordlen.sum()
    if total <= 0:
        return np.repeat(points[:1], t, axis=0)
    chordlen = chordlen / total
    cumarc = np.zeros(len(chordlen) + 1)
    cumarc[1:] = np.cumsum(chordlen)
    tbins = np.digitize(eq_spaced, bins=cumarc).astype(int)
    tbins[(tbins <= 0) | (eq_spaced <= 0)] = 1
    tbins[(tbins >= n) | (eq_spaced >= 1)] = n - 1
    s = (eq_spaced - cumarc[tbins - 1]) / chordlen[tbins - 1]
    anchors = points[tbins - 1]
    offsets = (points[tbins] - points[tbins - 1]) * s.reshape(-1, 1)
    return anchors + offsets


def compute_midpoint_line(
    left_boundary: np.ndarray, right_boundary: np.ndarray, num_interp_pts: int
) -> np.ndarray:
    """Centerline = mean of arclength-resampled left/right boundaries."""
    left = interp_arc(num_interp_pts, left_boundary)
    right = interp_arc(num_interp_pts, right_boundary)
    return (left + right) / 2.0


def _xyz(points: List[dict]) -> np.ndarray:
    return np.array([[p["x"], p["y"], p["z"]] for p in points], dtype=np.float64)


class StaticMap:
    """Vector map parsed from an AV2 log_map_archive JSON.

    Exposes the two methods the reference consumes from
    av2.map.map_api.ArgoverseStaticMap: `vector_lane_segments` and
    `get_lane_segment_centerline` (common/semantic_map.py:24,63;
    planners/mind/utils.py:351-353).
    """

    def __init__(self, lane_segments: Dict[int, LaneSegment]):
        self.vector_lane_segments = lane_segments

    @classmethod
    def from_json(cls, path: Path | str) -> "StaticMap":
        with open(path, "r") as f:
            raw = json.load(f)
        lanes: Dict[int, LaneSegment] = {}
        for key, ls in raw["lane_segments"].items():
            lane_id = int(ls["id"])
            lanes[lane_id] = LaneSegment(
                id=lane_id,
                lane_type=LaneType(ls["lane_type"]),
                left_lane_boundary=_xyz(ls["left_lane_boundary"]),
                right_lane_boundary=_xyz(ls["right_lane_boundary"]),
                left_mark_type=_mark_type(ls.get("left_lane_mark_type")),
                right_mark_type=_mark_type(ls.get("right_lane_mark_type")),
                left_neighbor_id=ls.get("left_neighbor_id"),
                right_neighbor_id=ls.get("right_neighbor_id"),
                predecessors=list(ls.get("predecessors") or []),
                successors=list(ls.get("successors") or []),
                is_intersection=bool(ls["is_intersection"]),
            )
        return cls(lanes)

    def get_lane_segment_centerline(self, lane_id: int) -> np.ndarray:
        """10-point xyz centerline, cached per segment."""
        seg = self.vector_lane_segments[lane_id]
        if seg._centerline is None:
            seg._centerline = compute_midpoint_line(
                seg.left_lane_boundary,
                seg.right_lane_boundary,
                NUM_CENTERLINE_INTERP_PTS,
            )
        return seg._centerline


def _mark_type(value) -> LaneMarkType:
    if value is None:
        return LaneMarkType.NONE
    try:
        return LaneMarkType(str(value))
    except ValueError:
        return LaneMarkType.UNKNOWN


def load_static_map(path: Path | str) -> StaticMap:
    return StaticMap.from_json(path)
