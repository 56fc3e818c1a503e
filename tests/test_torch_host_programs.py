"""The two host paths' compiled programs: the host ScenarioTreeGenerator's
round and window (planner/scenario_tree.py: round_body, window_body; the
JAX package's jitted `_round_fn` and `_window_fn`) and the float64
mirror's network forward (parity/host_planner.py: forward_body; the JAX
mirror's jitted `batched_apply`).

On the CPU a program runs its body eagerly on its buffers (reached by
monkeypatching `programs.compiled` to True, as test_torch_plan_programs.py
does), so what is copied in is held here: an input a capture would bake
(the target lane's length) shows as one generator growing another's tree.

- the generator through its programs against mind_tpu's
  ScenarioTreeGenerator (test_torch_scenario_tree.py's setup and
  tolerances) and equal to the bit to graphed=False, in float32 and
  float64; two generators of one configuration, with their own lanes,
  target lanes and weights, through one program set;
- the mirror through its program at three plans against mind_tpu's
  HostRefPlanner (test_torch_parity.py's setup and tolerances) and equal
  to the bit to graphed=False; a batch past max_branch_nodes a second
  program;
- graphed=True on the CPU raising; on the card (marked cuda) the compiled
  generator and mirror against their eager twins, to the bit.
"""

import copy

import numpy as np
import pytest
import torch

from mind_tpu_torch.parity import HostRefPlanner as THostRefPlanner
from mind_tpu_torch.parity.host_scene import prepare_node_inputs_np
from mind_tpu_torch.planner import programs
from mind_tpu_torch.planner.scenario_tree import ScenarioTreeGenerator
from mind_tpu_torch.planner.scene_prep import LaneGraphStatic as TLane
from mind_tpu_torch.planner.scene_prep import TargetLaneStatic as TTgt
from test_torch_aime import A, L
from test_torch_parity import PLAN_FRAMES, TOL_MIRROR_CTRL, agents, mirrors
from test_torch_planner import World
from test_torch_scenario_tree import (TOL_PROB, TOL_TRAJ, configs, inputs, nets,  # noqa: F401
                                      port_generator, tree_summary)

torch.set_num_threads(2)


def on_the_cpu(device, graphed=None) -> bool:
    """programs.compiled as the tests patch it: the programs on the CPU
    too, unless graphed is False."""
    return graphed is not False


@pytest.fixture
def fresh_sets(monkeypatch):
    """An empty cache of program sets, and programs on the CPU."""
    monkeypatch.setattr(programs, "_SETS", {})
    monkeypatch.setattr(programs, "compiled", on_the_cpu)


def same_trees(got, want) -> bool:
    """Two generators' trees: the same keys, parents and durations, every
    probability and payload array equal to the bit."""
    a, b = tree_summary(got), tree_summary(want)
    if len(a) != len(b):
        return False
    for ta, tb in zip(a, b):
        if [n[:4] for n in ta] != [n[:4] for n in tb]:
            return False
        if not all(np.array_equal(x, y) for na, nb in zip(ta, tb)
                   for x, y in zip(na[4:], nb[4:])):
            return False
    return True


def jax_trees(params, batched_apply, pipeline):
    """mind_tpu's jitted ScenarioTreeGenerator on test_torch_scenario_tree's
    inputs."""
    import jax.numpy as jnp
    from mind_tpu.planner.scenario_tree import ScenarioTreeGenerator as JGenerator
    from mind_tpu.planner.scene_prep import LaneGraphStatic, TargetLaneStatic

    jcfg, _ = configs()
    pos, ang, vel, types, amask, anchors, pts, n, dt = inputs(pipeline)
    jd = jnp.float64 if dt == np.float64 else jnp.float32
    lane = LaneGraphStatic(node_feats=jnp.zeros((L, 10, 16), jnp.float32),
                           anchors_g=jnp.asarray(anchors),
                           anchor_vecs_g=jnp.tile(jnp.asarray([[1.0, 0.0]], jd), (L, 1)),
                           mask=jnp.ones(L, bool))
    tgt = TargetLaneStatic(points=jnp.asarray(pts), info=jnp.zeros((256, 12), jd),
                           mask=jnp.asarray(np.arange(256) < n), n_points=jnp.int32(n))
    jgen = JGenerator(jcfg, batched_apply, params, lane, tgt, A)
    return jgen.branch_aime(
        (jnp.asarray(pos), jnp.asarray(ang), jnp.asarray(vel),
         jnp.full((A, 50), 1e-5, jnp.float32), jnp.ones((A, 50), jnp.float32)),
        jnp.asarray(types), jnp.asarray(amask))


@pytest.mark.parametrize("pipeline", ["float32", "float64"])
def test_generator_programs_match_jax_and_eager(nets, pipeline, fresh_sets, monkeypatch):  # noqa: F811
    params, batched_apply, net = nets
    _, tcfg = configs()
    gen, window, types, amask, _, _ = port_generator(net, tcfg, pipeline)
    got = gen.branch_aime(window, types, amask)
    # graphed=False: the same bodies eagerly on fresh slots
    eager_gen, *_ = port_generator(net, tcfg, pipeline)
    eager_gen.graphed = False
    want = eager_gen.branch_aime(window, types, amask)
    assert same_trees(got, want) and gen.last_rounds == eager_gen.last_rounds >= 2

    # one program set: round 0's (the root window), the later rounds', the gather
    ps = gen.program_set()
    assert sorted(p.kind for p in ps.programs.values()) == \
        ["tree_round", "tree_round", "tree_window"]
    rounds = [p for p in ps.programs.values() if p.kind == "tree_round"]
    assert sum(int(p.rounds) for p in rounds) == gen.last_rounds

    # against mind_tpu's jitted generator, test_torch_scenario_tree's tolerances
    jtrees = jax_trees(params, batched_apply, pipeline)
    assert len(got) == len(jtrees) >= 1
    worst = prob_gap = 0.0
    for g_tree, w_tree in zip(tree_summary(got), tree_summary(jtrees)):
        assert [g[:3] for g in g_tree] == [w[:3] for w in w_tree]
        for g, w in zip(g_tree, w_tree):
            prob_gap = max(prob_gap, abs(g[3] - w[3]))
            for a, b in zip(g[4:], w[4:]):
                b = np.asarray(b, np.float64)
                worst = max(worst, float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max(
                    initial=0.0)))
    assert worst <= TOL_TRAJ and prob_gap <= TOL_PROB


def second_generator(net, tcfg, n_points):
    """A generator of the same configuration with its own weights (the
    regression head 1.2x), lane anchors (moved 2 m) and target lane of
    `n_points` points (0.5 m to the left)."""
    gen, window, types, amask, lane, tgt = port_generator(net, tcfg, "float32")
    net_b = copy.deepcopy(net)
    with torch.no_grad():
        dict(net_b.named_parameters())["SceneDecoder_0.Dense_1.weight"].mul_(1.2)
    pts = tgt.points.clone()
    pts[:, 1] += 0.5
    mask = torch.arange(pts.shape[0]) < n_points
    pts[~mask] = 1e6
    lane_b = lane._replace(anchors_g=lane.anchors_g + 2.0)
    tgt_b = TTgt(points=pts, info=tgt.info, mask=mask, n_points=n_points)
    return ScenarioTreeGenerator(tcfg, net_b, lane_b, tgt_b, A), window, types, amask


def test_generators_share_one_program_set_with_their_own_data(nets, fresh_sets):  # noqa: F811
    """Two generators of one configuration through one program set in turns
    (a, b, a): each tree equal to the bit to the generator's own eager tree,
    the weights copied only where the network changed. The second's target
    lane is short enough that its length moves its tree."""
    _, _, net = nets
    _, tcfg = configs()
    a, window, types, amask, _, _ = port_generator(net, copy.deepcopy(tcfg), "float32")
    n_a = int(a.tgt_static.n_points)
    b, _, _, _ = second_generator(net, copy.deepcopy(tcfg), 70)
    b_long, _, _, _ = second_generator(net, copy.deepcopy(tcfg), n_a)
    assert a.program_set() is b.program_set()
    eager = {}
    for g in (a, b, b_long):
        g.graphed = False
        eager[g] = g.branch_aime(window, types, amask)
        g.graphed = None
    # the data reach the trees, the target lane's length too
    assert not same_trees(eager[a], eager[b]) and not same_trees(eager[b], eager[b_long])
    ps = a.program_set()
    for g in (a, b, a):
        last, copies = ps.net._last, ps.net.copies
        assert same_trees(g.branch_aime(window, types, amask), eager[g])
        assert ps.net.copies == copies + (last is None or last() is not g.net)
    assert len(ps.programs) == 3 and len(ps._lent) == 1


def test_graphed_true_on_the_cpu_raises(nets):  # noqa: F811
    _, _, net = nets
    _, tcfg = configs()
    gen, *_ = port_generator(net, tcfg, "float32")
    with pytest.raises(ValueError, match="CUDA device"):
        ScenarioTreeGenerator(tcfg, net, gen.lane_static, gen.tgt_static, A, graphed=True)
    assert ScenarioTreeGenerator(tcfg, net, gen.lane_static, gen.tgt_static, A,
                                 graphed=False).graphed is False


# ---------------------------------------------------------------------------
# the float64 mirror's forward program
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return World(tmp_path_factory.mktemp("av2"))


@pytest.fixture(scope="module")
def mirror_plans(world):
    """mind_tpu's mirror, the port's through its forward program and the
    port's eager one, fed the same stream and planning at three frames.
    Returns ({name: [(ok, ctrl, debug)]}, the port's compiled mirror, its
    forwards, the eager mirror, the planner)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(programs, "_SETS", {})
    try:
        j, t = agents(world)
        jm, tm = mirrors(j, t)
        tp = t.planner
        eager = THostRefPlanner(tp.cfg, t._smp, t.lcl_smp, shared_net=tp.net, record_debug=True,
                                graphed=False)
        eager.update_target_lane(t.gt_tgt_lane)
        predict, forwards = tm._predict, []
        tm._predict = lambda *a: forwards.append(1) or predict(*a)
        out = {"jax": [], "program": [], "eager": []}
        with mp.context() as m2:
            m2.setattr(programs, "compiled", on_the_cpu)
            for f in range(PLAN_FRAMES[-1] + 1):
                for m, bundle in ((jm, world.jbundle), (tm, world.tbundle),
                                  (eager, world.tbundle)):
                    m.update_observation(world.observations(bundle, f))
                if f in PLAN_FRAMES:
                    state = world.observations(world.tbundle, f)[0][1]
                    for name, m in (("jax", jm), ("program", tm), ("eager", eager)):
                        m.update_state_ctrl(state, np.array([0.3, 0.01]))
                        ok, ctrl, _ = m.plan()
                        out[name].append((ok, ctrl, copy.deepcopy(m.debug)))
        yield out, tm, len(forwards), eager, tp
    finally:
        mp.undo()


def test_mirror_program_matches_jax(mirror_plans):
    """test_torch_parity.py's mirror checks on the program path: the same
    nodes, roots, decisions and tree costs; controls within 1e-5."""
    out, tm, forwards, _, tp = mirror_plans
    worst = 0.0
    for (jok, jctrl, jdbg), (tok, tctrl, tdbg) in zip(out["jax"], out["program"]):
        assert jok and tok
        for k in ("tree_roots", "best_root", "n_nodes"):
            assert tdbg[k] == jdbg[k], k
        keys = ("key", "parent", "cur_t", "t_b", "duration", "end")
        assert [{k: n[k] for k in keys} for n in tdbg["scen_nodes"]] == \
            [{k: n[k] for k in keys} for n in jdbg["scen_nodes"]]
        np.testing.assert_allclose([n["norm_prob"] for n in tdbg["scen_nodes"]],
                                   [n["norm_prob"] for n in jdbg["scen_nodes"]], atol=1e-6)
        for tr, jr in zip(tdbg["rounds"], jdbg["rounds"], strict=True):
            for k in ("branch_key", "cur_t", "keep", "t_b"):
                assert tr[k] == jr[k], k
        np.testing.assert_allclose(tdbg["tree_costs"], jdbg["tree_costs"], rtol=1e-6)
        worst = max(worst, float(np.abs(tctrl - jctrl).max()))
    assert worst <= TOL_MIRROR_CTRL
    # the mirrors' own program set, apart from the planner's; one run a forward,
    # counted by the programs: one per batch size (a branch set past
    # max_branch_nodes pads to its size)
    assert tm.program_set() is not tp.program_set()
    progs = forward_programs(tm)
    assert sum(int(p.rounds) for p in progs) == forwards >= 6
    assert (len(progs) > 1) == (tm.diagnostics["branch_overflows"] > 0)


def forward_programs(mirror):
    return [p for p in mirror.program_set().programs.values() if p.kind == "mirror_forward"]


def test_mirror_program_equals_eager(mirror_plans):
    """The program path against graphed=False: every plan's ok, control and
    decision record equal to the bit."""
    out, _, _, eager, _ = mirror_plans
    for (pok, pctrl, pdbg), (eok, ectrl, edbg) in zip(out["program"], out["eager"],
                                                      strict=True):
        assert pok and eok and np.array_equal(pctrl, ectrl)
        assert pdbg == edbg


def root_prep(mirror):
    """The mirror's root node inputs and actor mask, from its window."""
    pos, ang, vel, obs = mirror.obs_buffer.window()
    prep = prepare_node_inputs_np(pos, ang, vel, obs, mirror.obs_buffer.types,
                                  mirror.lane_feats, mirror.lane_anchors, mirror.lane_vecs,
                                  mirror.tgt_points, mirror.tgt_info, mirror.tgt_n,
                                  mirror.cfg.scen_tree.tar_time_ahead)
    return prep, mirror.obs_buffer.actor_mask()


def test_mirror_programs_apart_from_the_planners(mirror_plans, monkeypatch):
    """The mirror's forward loads the live network into a program network of
    its own: a wrong weight copy in the device planner's program set (its
    network taken as current, its weights then changed) does not reach the
    mirror, whose forward stays equal to the bit to the eager one."""
    _, tm, _, eager, tp = mirror_plans
    assert tm.program_set() is eager.program_set()
    bad = tp.program_set().net
    bad.load(tp.net)
    with torch.no_grad():
        for t in bad.net.parameters():
            t.add_(1.0)
    prep, amask = root_prep(tm)
    n = tm.cfg.scen_tree.max_branch_nodes
    want = eager._predict([prep] * n, amask)
    monkeypatch.setattr(programs, "compiled", on_the_cpu)
    got = tm._predict([prep] * n, amask)
    for g, w in zip(got, want, strict=True):
        assert np.array_equal(g, w)


def test_mirror_overflow_batch_is_a_second_program(mirror_plans, monkeypatch):
    """A branch set past max_branch_nodes pads to its own size: a second
    forward program (as jit retraces), its outputs equal to the bit to the
    eager forward's."""
    _, tm, _, eager, _ = mirror_plans
    B = tm.cfg.scen_tree.max_branch_nodes
    prep, amask = root_prep(tm)
    monkeypatch.setattr(programs, "compiled", on_the_cpu)
    sizes = lambda: sorted(p.inputs.actors.shape[0] for p in forward_programs(tm))  # noqa: E731
    before = sizes()
    assert before[0] == B
    n = before[-1] + 1
    want = eager._predict([prep] * n, amask)
    got = tm._predict([prep] * n, amask)
    assert sizes() == before + [n]
    for g, w in zip(got, want, strict=True):
        assert g.dtype == np.float64 and np.array_equal(g, w)
    assert got[1].shape[:3] == (n, amask.shape[0], tm.cfg.net.num_modes)


def test_mirror_graphed_true_on_the_cpu_raises(mirror_plans):
    _, tm, _, _, _ = mirror_plans
    with pytest.raises(ValueError, match="CUDA device"):
        THostRefPlanner(tm.cfg, tm.smp, tm.lcl_smp, shared_net=tm.net, graphed=True)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_compiled_generator_equals_eager():
    """On the card, at the kernels' width: the compiled generator against
    graphed=False, both pipelines: trees equal to the bit; three programs a
    pipeline."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from mind_tpu_torch.config import NetConfig, PlannerConfig
    from mind_tpu_torch.models.weights import load_scene_pred
    from test_torch_aime import make_window, statics_np

    dev = torch.device("cuda")
    cfg = PlannerConfig(max_actors=A, max_lanes=L)
    cfg.scen_tree.max_branch_nodes, cfg.scen_tree.max_tree_nodes = 4, 32
    net = load_scene_pred(NetConfig(), None, dev)
    with torch.no_grad():
        dict(net.named_parameters())["SceneDecoder_0.Dense_1.weight"].mul_(50.0)
    for dt in (torch.float32, torch.float64):
        pos, ang, vel = (torch.tensor(x, dtype=dt, device=dev) for x in make_window())
        anchors, pts, n = statics_np()
        lane = TLane(node_feats=torch.zeros((L, 10, 16), device=dev),
                     anchors_g=torch.tensor(anchors, dtype=dt, device=dev),
                     anchor_vecs_g=torch.tensor([[1.0, 0.0]], dtype=dt, device=dev).repeat(L, 1),
                     mask=torch.ones(L, dtype=torch.bool, device=dev))
        tgt = TTgt(points=torch.tensor(pts, dtype=dt, device=dev),
                   info=torch.zeros((256, 12), dtype=dt, device=dev),
                   mask=torch.tensor(np.arange(256) < n, device=dev), n_points=n)
        types = torch.zeros((A, 7), device=dev)
        types[:, 0] = 1
        window = (pos, ang, vel, torch.full((A, 50), 1e-5, dtype=torch.float64, device=dev),
                  torch.ones((A, 50), device=dev))
        amask = torch.ones(A, dtype=torch.bool, device=dev)
        trees = {g: ScenarioTreeGenerator(cfg, net, lane, tgt, A, graphed=g).branch_aime(
            window, types, amask) for g in (None, False)}
        assert trees[None] and same_trees(trees[None], trees[False])


@pytest.mark.cuda
@pytest.mark.parametrize("width", ["full", "narrow"])
def test_cuda_compiled_mirror_equals_eager(tmp_path, width):
    """On the card: the mirror's compiled forward against graphed=False,
    sharing the planner's network (full width, or the tests' 4-head 32-wide
    one), three plans: controls and decision records equal to the bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from test_torch_plan_programs import port_world
    from test_torch_planner import CL_AGENT, N_OBS_FRAMES, planner_cfgs

    from mind_tpu_torch.config import ClAgentConfig as TClAgentConfig
    from mind_tpu_torch.config import NetConfig
    from mind_tpu_torch.sim import agents as tagents

    dev = torch.device("cuda")
    smp, bundle, n_lanes = port_world(tmp_path)
    _, tcfg = planner_cfgs(n_lanes, "float64", "float64")
    if width == "full":
        tcfg.net = NetConfig()
    (agent,) = [x for x in tagents.load_agents(bundle, smp, [TClAgentConfig(**CL_AGENT)],
                                                lambda p: tcfg, dev) if x.id == "AV"]
    pl = agent.planner
    mirrors_ = {g: THostRefPlanner(pl.cfg, agent._smp, agent.lcl_smp, shared_net=pl.net,
                                   record_debug=True, graphed=g) for g in (None, False)}
    for f in range(N_OBS_FRAMES + 1):
        k = 5 * f
        obs = sorted([(tid, np.array([*bundle.pos[i, k], bundle.vel[i, k], bundle.ang[i, k]]),
                       bundle.types[i][k])
                      for i, tid in enumerate(bundle.track_ids) if bundle.has_flag[i, k]],
                     key=lambda o: o[0] != "AV")
        res = {}
        for g, m in mirrors_.items():
            m.update_observation(obs)
            if f >= N_OBS_FRAMES - 2:
                m.update_target_lane(agent.gt_tgt_lane)
                m.update_state_ctrl(obs[0][1], np.array([0.3, 0.01]))
                res[g] = (*m.plan()[:2], copy.deepcopy(m.debug))
        if res:
            assert res[None][0] and res[False][0] and np.array_equal(res[None][1], res[False][1])
            assert res[None][2] == res[False][2]
    assert [p.inputs.actors.shape[0] for p in forward_programs(mirrors_[None])] == \
        [tcfg.scen_tree.max_branch_nodes]
