"""The host-side (numpy) layer of the PyTorch port against mind_tpu's on the
same seeded inputs: the AV2 map and scenario parsers, the semantic map, the
lane graph, the agent loader, and the geometry / bbox / tree / kinematics
copies. Both sides are numpy, so results must be array-equal (no tolerance).

Also holds what the other port tests share: the small synthetic AV2 world
and its conversion to mind_tpu's scenario classes.
"""

import json

import numpy as np
import pytest

from mind_tpu_torch.common import geometry as tgeo
from mind_tpu_torch.common.bbox import bbox_for_type as t_bbox_for_type
from mind_tpu_torch.common.kinematics import VehicleParam as TVehicleParam
from mind_tpu_torch.common.kinematics import kine_propagate_np as t_kine_propagate_np
from mind_tpu_torch.common.tree import Node as TNode, Tree as TTree
from mind_tpu_torch.data import av2 as tav2
from mind_tpu_torch.data import loader as tloader
from mind_tpu_torch.data import semantic_map as tsm
from mind_tpu_torch.synthetic import synthetic_av2, write_synthetic_map

SEQ_ID = "synthetic"
# a 120 m road (24 lane-graph segments) with 12 tracks, 9 of which the loader
# keeps: one more than the 8 actor slots of the small planner
SMALL_ROAD = dict(n_tracks=12, seg_len=30.0, segs_a=3, segs_b=1, x_start=-20.0)


def small_av2(seed=3):
    return synthetic_av2(seed, **SMALL_ROAD)


def to_jax_scenario(scn):
    """The port's Scenario as mind_tpu's classes, field by field."""
    from mind_tpu.data import av2 as jav2

    return jav2.Scenario(scn.scenario_id, scn.focal_track_id, scn.city_name, [
        jav2.Track(t.track_id,
                   [jav2.ObjectState(s.observed, s.timestep, s.position, s.heading, s.velocity)
                    for s in t.object_states],
                   jav2.ObjectType(t.object_type.value), jav2.TrackCategory(int(t.category)))
        for t in scn.tracks])


def scenario_frame(scn):
    """The scenario as the AV2 parquet's table (needs pandas)."""
    import pandas as pd

    rows = [dict(scenario_id=scn.scenario_id, focal_track_id=scn.focal_track_id,
                 city=scn.city_name, track_id=t.track_id, timestep=s.timestep,
                 observed=s.observed, position_x=s.position[0], position_y=s.position[1],
                 heading=s.heading, velocity_x=s.velocity[0], velocity_y=s.velocity[1],
                 object_type=t.object_type.value, object_category=int(t.category))
            for t in scn.tracks for s in t.object_states]
    return pd.DataFrame(rows)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    s = small_av2()
    root = tmp_path_factory.mktemp("av2")
    return s, write_synthetic_map(s.map_json, root, SEQ_ID)


@pytest.fixture(scope="module")
def maps(world):
    from mind_tpu.data.semantic_map import SemanticMap

    _, map_path = world
    return SemanticMap().load_from_argo2(map_path), tsm.SemanticMap().load_from_argo2(map_path)


def test_synthetic_map_is_a_log_map_archive(world):
    s, map_path = world
    raw = json.loads(map_path.read_text())
    assert set(raw) >= {"lane_segments"}
    full = synthetic_av2(0)
    assert full.n_graph_segments <= 80
    assert len(full.scenario.tracks) == 40
    xs = [p["x"] for ls in full.map_json["lane_segments"].values()
          for p in ls["left_lane_boundary"]]
    assert max(xs) - min(xs) >= 300.0
    for t in full.scenario.tracks:
        assert 0 <= t.object_states[0].timestep <= t.object_states[-1].timestep <= 109


def test_static_map_and_semantic_lanes_equal(maps):
    jsmp, tsmp = maps
    jl, tl = jsmp.map_data.vector_lane_segments, tsmp.map_data.vector_lane_segments
    assert list(jl) == list(tl) and len(tl) == 12
    for k in tl:
        for f in ("left_lane_boundary", "right_lane_boundary"):
            np.testing.assert_array_equal(getattr(jl[k], f), getattr(tl[k], f))
        for f in ("left_neighbor_id", "right_neighbor_id", "predecessors", "successors",
                  "is_intersection"):
            assert getattr(jl[k], f) == getattr(tl[k], f)
        assert jl[k].left_mark_type.value == tl[k].left_mark_type.value
        assert jl[k].lane_type.value == tl[k].lane_type.value
        np.testing.assert_array_equal(jsmp.map_data.get_lane_segment_centerline(k),
                                      tsmp.map_data.get_lane_segment_centerline(k))
    # 3 lanes x 2 chains (the successor links are cut after 3 of 4 segments)
    assert list(jsmp.semantic_lanes) == list(tsmp.semantic_lanes) and len(tsmp.semantic_lanes) == 6
    for k in tsmp.semantic_lanes:
        np.testing.assert_array_equal(jsmp.semantic_lanes[k], tsmp.semantic_lanes[k])
        for a, b in zip(jsmp.semantic_lanes_infos[k], tsmp.semantic_lanes_infos[k]):
            np.testing.assert_array_equal(a, b)
    assert jsmp.get_map_limits() == tsmp.get_map_limits()


def test_lane_graph_equal(world, maps):
    from mind_tpu.data.semantic_map import build_lane_graph, lane_graph_features

    s, _ = world
    jsmp, tsmp = maps
    rng = np.random.default_rng(0)
    th = rng.uniform(-np.pi, np.pi)
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    for orig, r in ((np.zeros(2), np.eye(2)), (np.array([2310.0, 1195.0]), rot)):
        jg = build_lane_graph(jsmp.map_data, orig, r, 15.0, 10)
        tg = tsm.build_lane_graph(tsmp.map_data, orig, r, 15.0, 10)
        assert jg.keys() == tg.keys()
        assert tg["num_lanes"] == s.n_graph_segments == 24
        for k in tg:
            np.testing.assert_array_equal(jg[k], tg[k], err_msg=k)
        np.testing.assert_array_equal(lane_graph_features(jg), tsm.lane_graph_features(tg))


def assert_bundles_equal(jb, tb):
    for f in ("pos", "ang", "vel", "has_flag"):
        a, b = getattr(jb, f), getattr(tb, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert jb.track_ids == tb.track_ids and jb.categories == tb.categories
    assert [[t.value for t in row] for row in jb.types] == \
        [[t.value for t in row] for row in tb.types]


def test_loader_equal_on_the_in_memory_scenario(world, maps, monkeypatch):
    """mind_tpu's loader reads the scenario through its load_scenario, which
    is pointed at the converted synthetic scenario; the port's takes the
    object itself."""
    import mind_tpu.data.loader as jloader

    s, _ = world
    jsmp, tsmp = maps
    monkeypatch.setattr(jloader, "load_scenario", lambda path: to_jax_scenario(s.scenario))
    jb = jloader.ArgoAgentLoader("unused").get_trajs_info(jsmp)
    tb = tloader.ArgoAgentLoader.trajs_info_of(s.scenario, tsmp)
    assert_bundles_equal(jb, tb)
    assert tb.pos.shape == (9, 546, 2) and tb.track_ids[:2] == ["focal", "AV"]
    assert not {"offroad", "late", "lost"} & set(tb.track_ids)   # filtered out
    # gaps, late starts and early ends leave holes in has_flag; the padding
    # fills a gap's positions from the next valid frame (the backward pass
    # runs last) and a vanished track's tail from its last one
    assert 0.5 < tb.has_flag.mean() < 1.0
    gap = tb.track_ids.index("t009")   # style 1: frames 20..26 missing
    assert not tb.has_flag[gap, 5 * 22] and tb.has_flag[gap, 5 * 10]
    np.testing.assert_array_equal(tb.pos[gap, 5 * 22], tb.pos[gap, 5 * 27])
    gone = tb.track_ids.index("t011")   # style 3: last frame 85
    assert not tb.has_flag[gone, 5 * 90]
    np.testing.assert_array_equal(tb.pos[gone, 5 * 90], tb.pos[gone, 5 * 85])


def test_parquet_round_trip(world, maps, tmp_path):
    pytest.importorskip("pandas")
    pytest.importorskip("pyarrow")
    from mind_tpu.data.loader import ArgoAgentLoader as JLoader

    s, _ = world
    jsmp, tsmp = maps
    path = tmp_path / f"scenario_{SEQ_ID}.parquet"
    scenario_frame(s.scenario).to_parquet(path)
    got = tav2.load_scenario(path)
    assert got.scenario_id == s.scenario.scenario_id
    assert got.focal_track_id == s.scenario.focal_track_id
    assert [t.track_id for t in got.tracks] == [t.track_id for t in s.scenario.tracks]
    for a, b in zip(got.tracks, s.scenario.tracks):
        assert a.object_type == b.object_type and a.category == b.category
        assert a.object_states == b.object_states
    tb = tloader.ArgoAgentLoader(path).get_trajs_info(tsmp)
    assert_bundles_equal(JLoader(path).get_trajs_info(jsmp), tb)
    assert_bundles_equal(tloader.ArgoAgentLoader.trajs_info_of(s.scenario, tsmp), tb)


def _geometry_inputs():
    rng = np.random.default_rng(11)
    line = np.cumsum(rng.uniform(0.5, 3.0, (12, 2)), axis=0)
    pts = rng.uniform(-5.0, 30.0, (7, 2))
    a = rng.normal(size=(2, 2))
    cov = a @ a.T + 0.5 * np.eye(2)
    return dict(line=line, pts=pts, cov=cov, mean=rng.normal(size=2),
                angles=rng.uniform(-10.0, 10.0, 9))


GEOMETRY_CASES = {
    "wrap_angle": lambda g, d: g.wrap_angle(d["angles"]),
    "project_point_on_polyline": lambda g, d: np.concatenate(
        [np.r_[p, h, s] for p, h, s in
         (g.project_point_on_polyline(q, d["line"]) for q in d["pts"])]),
    "remove_close_points": lambda g, d: g.remove_close_points(d["line"], 2.5),
    "point_line_distance": lambda g, d: g.point_line_distance(d["pts"], d["line"][0],
                                                               d["line"][3]),
    "resample_polyline": lambda g, d: np.concatenate(
        [g.resample_polyline(d["line"], 1.0)[0].ravel(),
         g.resample_polyline(d["line"], 1.0)[1].astype(float)]),
    "is_inside_ellipse": lambda g, d: np.array(
        [g.is_inside_ellipse(q, d["mean"], d["cov"] * 40.0) for q in d["pts"]], float),
    "ellipse_points": lambda g, d: g.ellipse_points(d["mean"], d["cov"]),
    "mahalanobis_distances": lambda g, d: g.mahalanobis_distances(d["pts"], d["mean"], d["cov"]),
    "point_mean_distances": lambda g, d: g.point_mean_distances(d["pts"], d["mean"]),
    "point_polyline_distance": lambda g, d: np.array(
        [g.point_polyline_distance(q, d["line"]) for q in d["pts"]]),
}


@pytest.mark.parametrize("name", sorted(GEOMETRY_CASES))
def test_host_geometry_equal(name):
    from mind_tpu.common import geometry as jgeo

    d = _geometry_inputs()
    want, got = GEOMETRY_CASES[name](jgeo, d), GEOMETRY_CASES[name](tgeo, d)
    assert np.asarray(got).size > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("obj_type", [t.value for t in tav2.ObjectType])
def test_bbox_for_type_equal(obj_type):
    from mind_tpu.common.bbox import bbox_for_type
    from mind_tpu.data.av2 import ObjectType

    assert t_bbox_for_type(tav2.ObjectType(obj_type)) == bbox_for_type(ObjectType(obj_type))


def test_tree_equal():
    from mind_tpu.common.tree import Node, Tree

    rng = np.random.default_rng(5)
    trees = Tree(), TTree()
    for tree, node in zip(trees, (Node, TNode)):
        tree.add_node(node("r", None, 0))
    for k in range(1, 14):
        parent = "r" if k < 3 else int(rng.integers(1, k))
        for tree, node in zip(trees, (Node, TNode)):
            tree.add_node(node(k, parent, k * k))
    j, t = trees
    assert t.size() == j.size() == 14
    assert t.bfs_keys() == j.bfs_keys() and t.get_leaf_keys() == j.get_leaf_keys()
    assert t.get_root_key() == j.get_root_key() == "r"
    for k in t.bfs_keys():
        assert t.get_children_keys(k) == j.get_children_keys(k)
        assert t.get_node(k).depth == j.get_node(k).depth
        assert t.has_children(k) == j.has_children(k)
        assert [n.key for n in t.retrieve_nodes_to_root(k)] == \
            [n.key for n in j.retrieve_nodes_to_root(k)]
    with pytest.raises(KeyError):
        t.add_node(TNode(99, "nowhere"))
    with pytest.raises(ValueError):
        t.add_node(TNode(5, "r"))


def test_kine_propagate_np_equal():
    from mind_tpu.common.kinematics import VehicleParam, kine_propagate_np

    assert TVehicleParam() == TVehicleParam(**vars(VehicleParam()))
    assert TVehicleParam().max_dec == VehicleParam().max_dec
    rng = np.random.default_rng(2)
    vp = TVehicleParam()
    for _ in range(20):
        state = rng.uniform([-50, -50, 0, -3], [50, 50, 16, 3])
        ctrl = rng.uniform([-9, -1.2], [9, 1.2])   # beyond the clip limits too
        np.testing.assert_array_equal(
            t_kine_propagate_np(state, ctrl, 0.02, vp.wb, vp.max_spd, vp.max_str),
            kine_propagate_np(state, ctrl, 0.02, vp.wb, vp.max_spd, vp.max_str))


def test_centerline_and_padding_helpers_equal():
    from mind_tpu.data.av2 import compute_midpoint_line, interp_arc
    from mind_tpu.data.loader import padding_traj_nn

    rng = np.random.default_rng(9)
    left = np.cumsum(rng.uniform(0.0, 4.0, (6, 3)), axis=0)
    right = left + rng.uniform(2.0, 4.0, (6, 3))
    np.testing.assert_array_equal(tav2.interp_arc(10, left), interp_arc(10, left))
    np.testing.assert_array_equal(tav2.interp_arc(4, left[:1].repeat(3, 0)),
                                  interp_arc(4, left[:1].repeat(3, 0)))
    np.testing.assert_array_equal(tav2.compute_midpoint_line(left, right, 10),
                                  compute_midpoint_line(left, right, 10))
    traj = rng.normal(size=(15, 2))
    valid = np.array([0, 0, 1, 1, 0, 0, 1, 0, 1, 1, 1, 0, 0, 1, 0], bool)
    got = tloader.padding_traj_nn(traj, valid)
    np.testing.assert_array_equal(got, padding_traj_nn(traj, valid))
    np.testing.assert_array_equal(got[0], traj[2])
    np.testing.assert_array_equal(got[4], traj[6])
    np.testing.assert_array_equal(got[14], traj[13])
