"""The planner facade of the PyTorch port against mind_tpu's on the small
synthetic AV2 world, with the same network weights: ObsBuffer, the host
cost-tree construction, MINDPlanner's statics, plan() on the staged path at
float64 (same tree, same iteration count, control within 1e-6) and at the
float32 defaults (control within 1e-3, the BASELINE.json budget), staged
against fused, and the polish / scratch exec re-solves.

Small size: the SMALL widths of test_torch_plan_cycle.py, 8 actor slots,
the 24 lane segments of the small map, 32 scenario-tree slots, 128 cost
nodes per tree and 4 line-search steps (the same in both packages).
"""

import numpy as np
import pytest
import torch

from mind_tpu_torch.config import ClAgentConfig as TClAgentConfig
from mind_tpu_torch.config import NetConfig as TNetConfig, PlannerConfig as TPlannerConfig
from mind_tpu_torch.data import loader as tloader
from mind_tpu_torch.data import semantic_map as tsm
from mind_tpu_torch.models.weights import params_from_flax
from mind_tpu_torch.planner import planner as tplanner
from mind_tpu_torch.planner.trajectory_tree import build_cost_indices as t_build_cost_indices
from mind_tpu_torch.planner.trajectory_tree import flatten_scen_tree as t_flatten_scen_tree
from mind_tpu_torch.sim import agents as tagents
from test_torch_data import SEQ_ID, small_av2, to_jax_scenario
from test_torch_plan_cycle import SMALL

from mind_tpu_torch.synthetic import write_synthetic_map

# The test workers share the machine's cores: with every worker's PyTorch
# spinning a thread per core, a plan takes several times longer than with two.
torch.set_num_threads(2)

A = 8
CPU = torch.device("cpu")
# the AV's closed-loop binding: it logs 5 m/s and is asked for 8, so every
# plan has to accelerate
CL_AGENT = dict(id="AV", target_velocity=8.0)
N_OBS_FRAMES = 30   # 10 Hz frames fed before the plan: the window is part filled


def planner_cfgs(n_lanes, pipeline, solve, **traj_tree):
    """(mind_tpu PlannerConfig, port PlannerConfig) with the same values."""
    from mind_tpu.config import NetConfig, PlannerConfig

    cfgs = []
    for cls, net in ((PlannerConfig, NetConfig(**SMALL, use_pallas_fusion=False)),
                     (TPlannerConfig, TNetConfig(**SMALL))):
        cfg = cls(net=net, max_actors=A, max_lanes=n_lanes, pipeline_dtype=pipeline)
        cfg.scen_tree.max_branch_nodes = 4
        cfg.scen_tree.max_tree_nodes = 32
        cfg.traj_tree.solve_dtype = solve
        cfg.traj_tree.max_cost_nodes = 128
        cfg.traj_tree.n_line_search = 4
        for k, v in traj_tree.items():
            setattr(cfg.traj_tree, k, v)
        cfgs.append(cfg)
    return cfgs


def spread_weights(jcfg):
    """mind_tpu's seeded parameters of the small net, as (flax tree, flat
    dict). A random small net predicts near-identical modes, which the
    merge folds into one tree; a 50x regression head spreads them apart."""
    from flax.traverse_util import flatten_dict, unflatten_dict
    from mind_tpu.models import init_scene_pred

    _, params, _ = init_scene_pred(jcfg.net, jcfg.max_actors, jcfg.max_lanes, seed=jcfg.seed)
    flat = {k: np.asarray(v) * (50.0 if k.startswith("params/SceneDecoder_0/Dense_1/") else 1.0)
            for k, v in flatten_dict(params, sep="/").items()}
    return unflatten_dict(flat, sep="/"), flat


def share_weights(jagent, tagent):
    params, flat = spread_weights(jagent.planner.cfg)
    jagent.planner.params = params
    tagent.planner.net.load_state_dict(params_from_flax(flat))
    tagent.planner.net.apply_compute_dtype()


class World:
    """The small synthetic AV2 world loaded by both packages."""

    def __init__(self, root):
        import mind_tpu.data.loader as jloader
        from mind_tpu.data.semantic_map import SemanticMap

        self.syn = small_av2()
        self.root = root
        map_path = write_synthetic_map(self.syn.map_json, root, SEQ_ID)
        self.jsmp = SemanticMap().load_from_argo2(map_path)
        self.tsmp = tsm.SemanticMap().load_from_argo2(map_path)
        self.jscenario = to_jax_scenario(self.syn.scenario)
        orig = jloader.load_scenario
        jloader.load_scenario = lambda path: self.jscenario
        try:
            self.jbundle = jloader.ArgoAgentLoader("unused").get_trajs_info(self.jsmp)
        finally:
            jloader.load_scenario = orig
        self.tbundle = tloader.ArgoAgentLoader.trajs_info_of(self.syn.scenario, self.tsmp)
        self.n_lanes = self.syn.n_graph_segments

    def agents(self, pipeline, solve, **traj_tree):
        """(mind_tpu MINDAgent, port MINDAgent) for the AV, built by each
        package's load_agents, with the same spread weights."""
        from mind_tpu.config import ClAgentConfig
        from mind_tpu.sim.agents import load_agents

        jcfg, tcfg = planner_cfgs(self.n_lanes, pipeline, solve, **traj_tree)
        jall = load_agents(self.jbundle, self.jsmp, [ClAgentConfig(**CL_AGENT)], lambda p: jcfg)
        tall = tagents.load_agents(self.tbundle, self.tsmp, [TClAgentConfig(**CL_AGENT)],
                                   lambda p: tcfg, CPU)
        j = next(a for a in jall if a.id == "AV")
        t = next(a for a in tall if a.id == "AV")
        share_weights(j, t)
        return j, t

    def observations(self, bundle, frame):
        """(track_id, state, type) of the tracks valid at 10 Hz frame
        `frame`, the AV first."""
        k = 5 * frame
        obs = [(tid, np.array([*bundle.pos[i, k], bundle.vel[i, k], bundle.ang[i, k]],
                              np.float64), bundle.types[i][k])
               for i, tid in enumerate(bundle.track_ids) if bundle.has_flag[i, k]]
        return sorted(obs, key=lambda o: o[0] != "AV")

    def feed(self, jagent, tagent, ctrl=(0.3, 0.01)):
        for f in range(N_OBS_FRAMES):
            jagent.planner.update_observation(self.observations(self.jbundle, f))
            tagent.planner.update_observation(self.observations(self.tbundle, f))
        state = self.observations(self.tbundle, N_OBS_FRAMES - 1)[0][1]
        for a in (jagent, tagent):
            a.planner.update_state_ctrl(state, np.array(ctrl))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return World(tmp_path_factory.mktemp("av2"))


@pytest.fixture(scope="module")
def planned64(world):
    """Both packages' planners after one staged plan with the pipeline and
    the solve in float64: (jagent, tagent, jax result, port result)."""
    j, t = world.agents("float64", "float64")
    world.feed(j, t)
    return j, t, j.planner.plan(), t.planner.plan()


def test_obs_buffer_matches_jax():
    """A stream with a late track, a vanished track and a full buffer:
    slots in order of first appearance, new tracks ignored when no slot is
    free, actor_mask = active & present at the last update."""
    from mind_tpu.data.av2 import ObjectType
    from mind_tpu.planner.planner import ObsBuffer

    from mind_tpu_torch.data.av2 import ObjectType as TObjectType

    rng = np.random.default_rng(4)
    origin = np.array([2300.0, 1200.0])
    jb = ObsBuffer(4, origin=origin, dtype="float64")
    tb = tplanner.ObsBuffer(4, origin=origin, dtype="float64", device=CPU)
    kinds = {"AV": "vehicle", "a": "pedestrian", "b": "bus", "c": "static", "d": "cyclist",
             "e": "vehicle"}
    # frames: who is observed
    stream = [["AV", "a"], ["AV", "a", "b"], ["AV", "b"], ["AV", "b", "c", "d", "e"],
              ["AV", "a", "e", "c"], ["b", "c"]]
    for ids in stream:
        states = {i: rng.normal(size=4) + np.r_[origin, 0, 0] for i in ids}
        jb.update([(i, states[i], ObjectType(kinds[i])) for i in ids])
        tb.update([(i, states[i], TObjectType(kinds[i])) for i in ids])
        assert tb.slots == jb.slots
        np.testing.assert_array_equal(tb.actor_mask(), jb.actor_mask())
        np.testing.assert_array_equal(tb.active, jb.active)
        np.testing.assert_array_equal(tb.types, jb.types)
        for f in ("pos", "ang", "vel", "observed"):
            np.testing.assert_array_equal(getattr(tb.buf, f).numpy(),
                                          np.asarray(getattr(jb.buf, f)), err_msg=f)
    assert tb.slots == {"AV": 0, "a": 1, "b": 2, "c": 3}      # d and e found it full
    np.testing.assert_array_equal(tb.actor_mask(), [False, False, True, True])
    # the device copies are made again only after a change
    m = tb.actor_mask()
    assert tb.mask_device(m) is tb.mask_device(m.copy())
    assert tb.types_device() is tb.types_device()
    np.testing.assert_array_equal(tb.types_device().numpy(), tb.types)


def test_build_cost_indices_equal():
    from mind_tpu.config import TrajTreeConfig
    from mind_tpu.planner.trajectory_tree import build_cost_indices

    from mind_tpu_torch.config import TrajTreeConfig as TTrajTreeConfig

    # two trees: root child 1 with children 3, 4 (4 has child 6); root child 2
    # with child 5; node 7 is not in the end set
    parent = np.array([-1, 0, 0, 1, 1, 2, 4, 2])
    duration = np.array([0, 10, 7, 20, 12, 53, 38, 9])
    end_flag = np.array([0, 1, 1, 1, 1, 1, 1, 0], bool)
    tree_id = np.array([-1, 1, 2, 1, 1, 2, 1, -1])
    want = build_cost_indices(parent, duration, end_flag, tree_id, TrajTreeConfig())
    got = t_build_cost_indices(parent, duration, end_flag, tree_id, TTrajTreeConfig())
    assert len(got) == len(want) == 2
    for (wt, wcs, wst), (gt, gcs, gst) in zip(want, got):
        for f in ("parent", "node_mask", "level_table"):
            np.testing.assert_array_equal(getattr(gt, f), getattr(wt, f), err_msg=f)
        np.testing.assert_array_equal(gcs, wcs)
        np.testing.assert_array_equal(gst, wst)
    assert int(got[0][0].node_mask.sum()) == 5 + 10 + 6 + 19


def test_planner_statics_equal(planned64):
    j, t, _, _ = planned64
    jp, tp = j.planner, t.planner
    np.testing.assert_array_equal(tp.origin, jp.origin)
    assert tp.origin.tolist() == [2300.0, 1200.0]
    for f in ("node_feats", "anchors_g", "anchor_vecs_g", "mask"):
        np.testing.assert_array_equal(getattr(tp.lane_static, f).numpy(),
                                      np.asarray(getattr(jp.lane_static, f)), err_msg=f)
    for f in ("points", "info", "mask"):
        np.testing.assert_array_equal(getattr(tp.tgt_static, f).numpy(),
                                      np.asarray(getattr(jp.tgt_static, f)), err_msg=f)
    assert tp.tgt_static.n_points == int(jp.tgt_static.n_points)
    for a, b in zip(tp._eval_segs, jp._eval_segs):
        assert a.dtype in (torch.float64, torch.bool)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tp.gt_tgt_lane, jp.gt_tgt_lane)
    np.testing.assert_array_equal(t.lcl_smp.target_lane, j.lcl_smp.target_lane)
    assert t.lcl_smp.target_velocity == j.lcl_smp.target_velocity
    for a, b in zip(tp._cost_params(), jp._cost_params()):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy() if isinstance(x, torch.Tensor) else x,
                                          np.asarray(y))
    s = tp.local_state()
    np.testing.assert_array_equal(tp._field_offset(s).numpy(), np.asarray(jp._field_offset(s)))


def assert_same_trees(jres, tres, atol_scen, atol_traj):
    """The exported scenario and trajectory trees: same keys and links, and
    payloads within the tolerances."""
    (jscen,), (jtraj,) = jres
    (tscen,), (ttraj,) = tres
    assert tscen.get_root_key() == jscen.get_root_key(), "selected tree"
    # relative on the scenario side: under the 50x head the predicted
    # covariances reach 1e20 (measured relative gap 2.3e-4)
    for jt, tt, atol, rtol in ((jscen, tscen, atol_scen, 1e-3), (jtraj, ttraj, atol_traj, 0)):
        assert tt.bfs_keys() == jt.bfs_keys()
        for k in tt.bfs_keys():
            assert tt.get_node(k).parent_key == jt.get_node(k).parent_key
            for a, b in zip(tt.get_node(k).data, jt.get_node(k).data):
                assert np.shape(a) == np.shape(b)
                np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def test_plan_staged_float64_matches_jax(planned64):
    j, t, (jok, jctrl, jres), (tok, tctrl, tres) = planned64
    jp, tp = j.planner, t.planner
    assert jok and tok
    for k in ("parent", "duration", "end_flag", "tree_id"):
        np.testing.assert_array_equal(tp.last_meta[k], jp.last_meta[k], err_msg=k)
    # the network runs in float32 in both packages: its mode probabilities
    # agree to float32 rounding (measured gap 1.1e-7)
    np.testing.assert_allclose(tp.last_meta["norm_prob"], jp.last_meta["norm_prob"],
                               rtol=0, atol=2e-6)
    assert tp.last_n_trees == jp.last_n_trees >= 2 and tp.last_n_nodes == jp.last_n_nodes
    assert tp.last_rounds >= 2
    assert tp.metrics.counters["gauge/ilqr_iterations"] == \
        jp.metrics.counters["gauge/ilqr_iterations"], "warm + full iterations"
    np.testing.assert_allclose(tp.last_tree_costs, jp.last_tree_costs, rtol=0, atol=1e-6)
    assert tp.last_best == int(np.argmin(jp.last_tree_costs))
    np.testing.assert_allclose(tctrl, jctrl, rtol=0, atol=1e-6)
    assert tctrl.dtype == np.float64
    # the scenario tree holds the float32 network's predictions (through the
    # 50x head of spread_weights): measured gap 3.8e-5 m
    assert_same_trees(jres, tres, atol_scen=2e-4, atol_traj=1e-5)
    assert set(tp.metrics.timer.totals) == {"aime", "flatten", "solve", "export"}


def test_flatten_exported_scen_tree_equal(planned64):
    """flatten_scen_tree on the port's exported scenario tree: mind_tpu's
    function reads the same tree object (it only walks keys and data)."""
    from mind_tpu.planner.trajectory_tree import flatten_scen_tree

    j, t, _, (_, _, tres) = planned64
    scen = tres[0][0]
    # the exported trajectories hold the masked actors only
    n = int(t.planner.obs_buffer.actor_mask().sum())
    mask = np.ones(n, bool)
    want = flatten_scen_tree(scen, mask, j.planner.cfg.traj_tree, n - 1)
    got = t_flatten_scen_tree(scen, mask, t.planner.cfg.traj_tree, n - 1, device=CPU)
    assert int(got.n_nodes) == int(want.n_nodes) > 0
    for a, b in zip(got.topo + got.nodes, want.topo + want.nodes):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_plan_staged_float32_matches_jax(world):
    j, t = world.agents("float32", "float32")
    world.feed(j, t)
    jok, jctrl, jres = j.planner.plan()
    tok, tctrl, tres = t.planner.plan()
    assert jok and tok
    for k in ("parent", "duration", "end_flag", "tree_id"):
        np.testing.assert_array_equal(t.planner.last_meta[k], j.planner.last_meta[k], err_msg=k)
    assert tres[0][0].get_root_key() == jres[0][0].get_root_key(), "selected tree"
    np.testing.assert_allclose(tctrl, jctrl, rtol=0, atol=1e-3)


def test_staged_and_fused_paths_agree(planned64, monkeypatch):
    """The staged path builds its cost trees on the host in depth-first
    order, the fused path on the device in level order: the same trees with
    their nodes numbered differently, so sums may differ in the last bits.
    Measured gap of the control at float64: 0."""
    _, t, _, (_, ctrl_staged, _) = planned64
    tp = t.planner
    report, core = {}, tplanner.fused_plan_core
    monkeypatch.setattr(tplanner, "fused_plan_core",
                        lambda *a, **kw: core(*a, report=report, **kw))
    monkeypatch.setattr(tp, "export_trees", False)
    ok, ctrl_fused, res = tp.plan()
    assert ok and res is None and "plan_fused" in tp.metrics.timer.totals
    np.testing.assert_allclose(ctrl_fused, ctrl_staged, rtol=0, atol=1e-9)
    assert int(report["best"]) == tp.last_best, "selected tree"
    assert int(report["trees"].n_trees) == tp.last_n_trees
    np.testing.assert_allclose(report["tree_cost"].numpy()[:tp.last_n_trees],
                               tp.last_tree_costs, rtol=0, atol=1e-9)
    assert "exec_resolve" not in report


@pytest.fixture(scope="module")
def resolve_inputs(world, planned64):
    """Planners with the pipeline in float64, the selection solves in
    float32 and a float64 exec re-solve, fed like planned64's."""

    def make(mode):
        j, t = world.agents("float64", "float32", exec_solve_dtype="float64",
                            exec_resolve_mode=mode)
        world.feed(j, t)
        return j, t

    return make


def test_polish_resolve_matches_jax(resolve_inputs, planned64):
    """polish: the winner's float32 controls polished by one float64 full
    solve, against mind_tpu's exec_resolve_ctrl inside its staged plan. The
    two float32 selection solves differ in the last bits, so the polish
    starts from slightly different controls and ends, within rel_tol, on
    the same optimum: 1e-4 (measured gap 1.3e-8)."""
    j, t = resolve_inputs("polish")
    jok, jctrl, jres = j.planner.plan()
    tok, tctrl, tres = t.planner.plan()
    assert jok and tok
    assert tres[0][0].get_root_key() == jres[0][0].get_root_key(), "selected tree"
    np.testing.assert_allclose(tctrl, jctrl, rtol=0, atol=1e-4)
    # the re-solve's time is kept apart, as a part of the solve phase
    timer = t.planner.metrics.timer
    assert 0 < timer.totals["exec_resolve"] < timer.totals["solve"]
    assert timer.counts["exec_resolve"] == 1
    # and near the pure float64 plan's control, which it approaches
    np.testing.assert_allclose(tctrl, planned64[3][1], rtol=0, atol=1e-3)


def test_scratch_resolve_gives_the_float64_control(resolve_inputs, planned64, monkeypatch):
    """scratch, on the fused path: the winner solved again in float64 from
    zero controls, the iteration path of the pure float64 plan. Its control
    equals that plan's (the port's, and mind_tpu's within the 1e-6 of the
    float64 test) when the float32 selection picks the same tree: 1e-9
    (measured gap 0: the re-solve of one tree is the batched solve's
    arithmetic)."""
    _, t = resolve_inputs("scratch")
    _, t64, (_, jctrl64, _), (_, tctrl64, _) = planned64
    report, core = {}, tplanner.fused_plan_core
    monkeypatch.setattr(tplanner, "fused_plan_core",
                        lambda *a, **kw: core(*a, report=report, **kw))
    t.planner.export_trees = False
    ok, ctrl, res = t.planner.plan()
    assert ok and res is None
    assert int(report["best"]) == t64.planner.last_best and report["exec_resolve"] > 0
    np.testing.assert_allclose(ctrl, tctrl64, rtol=0, atol=1e-9)
    np.testing.assert_allclose(ctrl, jctrl64, rtol=0, atol=1e-6)


def test_native_resolve_still_raises(world):
    """The native re-solve is ported: a planner in that mode builds and
    loads the C++ library when it is made. What still raises is a payload
    whose length is not the layout's (the size check of the one helper that
    unpacks it)."""
    from mind_tpu_torch import native

    _, tcfg = planner_cfgs(world.n_lanes, "float32", "float32", exec_resolve_mode="native")
    lcl = tsm.LocalSemanticMap("AV", world.tsmp)
    lcl.update_target_lane(world.tsmp.semantic_lanes[2])
    lcl.update_target_lane_info(world.tsmp.semantic_lanes_infos[2])
    planner = tplanner.MINDPlanner(tcfg, world.tsmp, lcl, device=CPU)
    assert planner._exec_native and native._lib is not None
    n = native.payload_size(tcfg.traj_tree.max_cost_nodes, tcfg.max_actors - 1)
    planner.update_state_ctrl(np.zeros(4), np.zeros(2))
    with pytest.raises(ValueError, match="exec payload"):
        planner._native_exec_ctrl_flat(np.zeros(n - 1), planner.local_state())


def test_planner_needs_a_device_without_gpu(world):
    """With no GPU, MINDPlanner and ObsBuffer called without a device raise
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is the card")
    _, tcfg = planner_cfgs(world.n_lanes, "float32", "float32")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tplanner.ObsBuffer(A)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tplanner.MINDPlanner(tcfg, world.tsmp, tsm.LocalSemanticMap("AV", world.tsmp))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tagents.load_agents(world.tbundle, world.tsmp, [TClAgentConfig(id="AV")],
                            lambda p: tcfg)
