"""MINDPlanner's programs (planner/programs.py and the bodies in
planner/planner.py) against mind_tpu's jitted `_aime_fn`, `_solve_fn` and
`_fused_fn` on the same planner state, at float64: each body run eagerly on
the CPU, the packed AIME meta, tree ids, selected tree and iteration counts
equal, costs and controls within 1e-6. Then two planners of one
configuration with their own target velocity, target lane and weights
through one shared set of programs (on the CPU a program runs its body
eagerly on its buffers): each gets its own eager plan, to the bit, which
guards against a value baked into a program. On the card (marked cuda) the
compiled plan against the eager one, to the bit.

The small world and its weights are test_torch_planner.py's.
"""

import copy

import numpy as np
import pytest
import torch

from mind_tpu_torch.config import ClAgentConfig as TClAgentConfig
from mind_tpu_torch.data import loader as tloader
from mind_tpu_torch.data import semantic_map as tsm
from mind_tpu_torch.planner import planner as tplanner
from mind_tpu_torch.planner import programs
from mind_tpu_torch.sim import agents as tagents
from mind_tpu_torch.synthetic import write_synthetic_map
from test_torch_data import SEQ_ID, small_av2
from test_torch_planner import CL_AGENT, CPU, World, planner_cfgs

torch.set_num_threads(2)

TOL = 1e-6


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return World(tmp_path_factory.mktemp("av2"))


@pytest.fixture(scope="module")
def fed64(world):
    """Both packages' AV planners, float64 pipeline and solve, the same
    spread weights, fed the same 30 frames; mind_tpu's device state."""
    j, t = world.agents("float64", "float64")
    world.feed(j, t)
    jp = j.planner
    amask = jp.obs_buffer.mask_device(jp.obs_buffer.actor_mask())
    return j, t, amask


def port_inputs(tp):
    """(AimeInputs, host vector, warm, full) of the port planner's state."""
    warm, full, tgt = tp._statics()
    ob = tp.obs_buffer
    aime = tplanner.AimeInputs(ob.buf, ob.types_device(), ob.mask_device(ob.actor_mask()),
                               tp.lane_static, tgt)
    return aime, tp._host_vector(tp.local_state()), warm, full


def jax_solve_params(jp):
    """(x0, warm, full, target velocity) as mind_tpu's plan passes them."""
    import jax.numpy as jnp

    s_loc = jp.local_state()
    offset = jp._field_offset(s_loc)
    warm, full = jp._cost_params()
    return (jnp.asarray([*s_loc, *jp.ctrl], jnp.float64), warm._replace(field_offset=offset),
            full._replace(field_offset=offset), jnp.float32(float(jp.lcl_smp.target_velocity)))


@pytest.fixture(scope="module")
def aime_pair(fed64):
    """mind_tpu's `_aime_fn` and the port's aime_body on the same state."""
    j, t, amask = fed64
    jp, tp = j.planner, t.planner
    jout = jp._aime_fn(jp.params, jp.obs_buffer.buf, jp.obs_buffer.types_device(), amask)
    aime, _, _, _ = port_inputs(tp)
    tout, rounds = tp._bodies["aime"](tp.net, aime)
    return jout, tout, rounds


def test_aime_body_matches_jax_aime_fn(fed64, aime_pair):
    j, t, _ = fed64
    MN = t.planner.cfg.scen_tree.max_tree_nodes
    (_, jmeta, jpacked), (_, norm_prob, packed), rounds = aime_pair
    jpacked, packed = np.asarray(jpacked), packed.numpy()
    # parent, duration, end flag, tree id and the node count: equal
    np.testing.assert_array_equal(packed[:4 * MN], jpacked[:4 * MN])
    assert packed[5 * MN] == jpacked[5 * MN] > 1
    # the probabilities of the float32 network in both packages
    np.testing.assert_allclose(packed[4 * MN:5 * MN], jpacked[4 * MN:5 * MN], rtol=0, atol=TOL)
    np.testing.assert_array_equal(norm_prob[0].numpy(), packed[4 * MN:5 * MN])
    # the rounds the device ran, counted on it and packed for the host
    assert packed[5 * MN + 1] == int(rounds) >= 2
    assert packed.dtype == np.float64 and packed.shape == (5 * MN + 2,)


def host_trees(tp, packed):
    MN = tp.cfg.scen_tree.max_tree_nodes
    trees = tplanner.build_cost_indices(
        packed[:MN].astype(np.int64), packed[MN:2 * MN].astype(np.int64),
        packed[2 * MN:3 * MN] > 0.5, packed[3 * MN:4 * MN].astype(np.int64),
        tp.cfg.traj_tree)[:tplanner.MAX_TREES]
    n = len(trees)
    return trees + [trees[0]] * (tplanner.MAX_TREES - n), n


def test_solve_body_matches_jax_solve_fn(fed64, aime_pair):
    """The staged solve of the same host-built trees: selected tree and
    warm + full iterations equal, tree costs, control and the real trees'
    states within 1e-6."""
    import jax.numpy as jnp
    from mind_tpu.planner.ilqr import TreeTopology

    j, t, amask = fed64
    jp, tp = j.planner, t.planner
    (jstate, jmeta, _), (slots, norm_prob, packed), _ = aime_pair
    trees, n_real = host_trees(tp, packed.numpy())
    assert n_real >= 2
    stack = lambda f: jnp.asarray(np.stack([f(t) for t in trees]))
    topo_b = TreeTopology(*(stack(lambda t, k=k: t[0][k]) for k in range(3)))
    jxs, jus, jsmall, jcost = jp._solve_fn(
        jstate.slots, jmeta.norm_prob, amask, topo_b, stack(lambda t: t[1]),
        stack(lambda t: t[2]), jnp.asarray(np.arange(tplanner.MAX_TREES) < n_real),
        *jax_solve_params(jp))
    aime, host, warm, full = port_inputs(tp)
    (xs, us, best, small), _ = tp._bodies["solve"](tp.net, tplanner.SolveInputs(
        slots, norm_prob, aime.amask, torch.from_numpy(tplanner.pack_trees(trees, n_real)), host,
        warm, full, tp._eval_segs, tp._scene))
    jsmall, small = np.asarray(jsmall), small.numpy()
    assert int(best) == int(small[2]) == int(jsmall[2]), "selected tree"
    assert small[3] == jsmall[3], "warm + full iterations"
    np.testing.assert_allclose(small[4:4 + n_real], np.asarray(jcost)[:n_real], rtol=0, atol=TOL)
    np.testing.assert_allclose(small[:2], jsmall[:2], rtol=0, atol=TOL)
    for got, want in ((xs, jxs), (us, jus)):
        np.testing.assert_allclose(got[:n_real].numpy(), np.asarray(want)[:n_real], rtol=0,
                                   atol=TOL)


def test_fused_body_matches_jax_fused_fn(fed64):
    """The whole plan in one body: control within 1e-6, ok and the
    iteration count equal; the selected tree and the rounds appended."""
    j, t, amask = fed64
    jp, tp = j.planner, t.planner
    jout = np.asarray(jp._fused_fn(jp.params, jp.obs_buffer.buf, jp.obs_buffer.types_device(),
                                   amask, *jax_solve_params(jp)))
    aime, host, warm, full = port_inputs(tp)
    out, rounds = tp._bodies["fused"](tp.net, tplanner.FusedInputs(
        aime.buf, aime.types, aime.amask, host, warm, full, tp.lane_static, aime.tgt_static,
        tp._eval_segs))
    out = out.numpy()
    assert out.shape == (6,) and out[2] == jout[2] == 1.0 and out[3] == jout[3] > 0
    np.testing.assert_allclose(out[:2], jout[:2], rtol=0, atol=TOL)
    # then the selected tree (the staged solve's, whose trees are the same
    # in another node order) and the rounds, for the plan's one read
    assert 0 <= out[4] < tplanner.MAX_TREES and out[5] == int(rounds) >= 2


def port_agent(world, tcfg, net, **cl):
    """The port's AV agent of the small world under `tcfg`, its network's
    weights `net`'s, fed as test_torch_planner's."""
    (agent,) = [a for a in tagents.load_agents(
        world.tbundle, world.tsmp, [TClAgentConfig(**{**CL_AGENT, **cl})], lambda p: tcfg, CPU)
        if a.id == "AV"]
    agent.planner.net.load_state_dict(net.state_dict())
    for f in range(30):
        agent.planner.update_observation(world.observations(world.tbundle, f))
    state = world.observations(world.tbundle, 29)[0][1]
    agent.planner.update_state_ctrl(state, np.array([0.3, 0.01]))
    return agent.planner


def same_plan(got, want):
    ok, ctrl, trees = got
    ok_w, ctrl_w, trees_w = want
    assert ok and ok_w and np.array_equal(ctrl, ctrl_w)
    if trees_w is None:
        assert trees is None
        return
    for a, b in zip(trees, trees_w):
        (a,), (b,) = a, b
        assert a.bfs_keys() == b.bfs_keys()
        for k in a.bfs_keys():
            assert a.get_node(k).parent_key == b.get_node(k).parent_key
            for x, y in zip(a.get_node(k).data, b.get_node(k).data):
                assert np.array_equal(np.asarray(x), np.asarray(y))


def test_planners_share_one_program_with_their_own_data(world, fed64, monkeypatch):
    """Two planners of one configuration, with their own target velocity,
    target lane (so their own origin, statics and cost parameters) and
    weights, plan through one set of programs in turns, on the staged and
    the fused path: each plan equal to the bit to the planner's own eager
    plan, the weights copied only where the network changed."""
    _, t, _ = fed64
    _, tcfg = planner_cfgs(world.n_lanes, "float64", "float64")
    net_b = copy.deepcopy(t.planner.net)
    with torch.no_grad():
        dict(net_b.named_parameters())["SceneDecoder_0.Dense_1.weight"].mul_(1.2)
    a = port_agent(world, copy.deepcopy(tcfg), t.planner.net)
    b = port_agent(world, copy.deepcopy(tcfg), net_b, target_velocity=6.0, semantic_lane=4)
    assert a.lcl_smp.target_velocity != b.lcl_smp.target_velocity
    assert not np.array_equal(a.lcl_smp.target_lane, b.lcl_smp.target_lane)
    ps = a.program_set()
    assert b.program_set() is ps
    copies0 = ps.net.copies
    # staged: a, a again (its weights not copied again), b; fused: a after b
    for export, turns in ((True, (a, a, b)), (False, (a,))):
        for p in (a, b):
            p.export_trees = export
        eager = {p: p.plan() for p in set(turns)}
        if export:   # the two plans differ: their data reach them
            assert not np.array_equal(a.last_tree_costs, b.last_tree_costs)
        with monkeypatch.context() as m:
            # on the CPU a program runs its body eagerly on its buffers
            m.setattr(programs, "compiled", lambda *args, **kw: True)
            for p in turns:
                last, copies = ps.net._last, ps.net.copies
                same_plan(p.plan(), eager[p])
                # weights are copied where the network changed, and only there
                assert ps.net.copies == copies + (last is None or last() is not p.net)
    assert ps.net.copies == copies0 + 3
    kinds = sorted(p.kind for p in ps.programs.values())
    assert kinds == ["aime", "fused", "solve"]
    assert all(p.program is None and p.outputs is not None for p in ps.programs.values())
    # the AIME programs' rounds were counted on their (here CPU) counters
    assert all(int(p.rounds) > 0 for p in ps.programs.values() if p.kind != "solve")


def test_graphed_needs_a_cuda_device(world):
    """graphed=True on the CPU raises; the choice rule of the compiled
    path (as the episode's)."""
    _, tcfg = planner_cfgs(world.n_lanes, "float32", "float32")
    lcl = tsm.LocalSemanticMap("AV", world.tsmp)
    lcl.update_target_lane(world.tsmp.semantic_lanes[2])
    lcl.update_target_lane_info(world.tsmp.semantic_lanes_infos[2])
    with pytest.raises(ValueError, match="CUDA device"):
        tplanner.MINDPlanner(tcfg, world.tsmp, lcl, device=CPU, graphed=True)
    planner = tplanner.MINDPlanner(tcfg, world.tsmp, lcl, device=CPU, graphed=False)
    assert planner.graphed is False
    cuda, cpu = torch.device("cuda"), CPU
    assert programs.compiled(cuda, None) and programs.compiled(cuda, True)
    assert not programs.compiled(cuda, False) and not programs.compiled(cpu, None)
    with pytest.raises(ValueError, match="CUDA device"):
        programs.compiled(cpu, True)


def test_eager_plan_keeps_the_timer_phases(fed64):
    """The eager plan (on the CPU, as graphed=False on the card) times the
    staged path's aime / flatten / solve / export phases and the fused
    path's plan_fused, once a plan each, and reads the AIME rounds and the
    selected tree on both paths."""
    _, t, _ = fed64
    tp = t.planner
    for export, keys in ((True, ("aime", "flatten", "solve", "export")), (False, ("plan_fused",))):
        tp.export_trees = export
        counts = {k: tp.metrics.timer.counts[k] for k in keys}
        ok, _, _ = tp.plan()
        assert ok and tp.last_rounds >= 2 and 0 <= tp.last_best < tplanner.MAX_TREES
        assert {k: tp.metrics.timer.counts[k] - counts[k] for k in keys} == dict.fromkeys(keys, 1)
    tp.export_trees = True


def test_tree_upload_round_trip(fed64, aime_pair):
    """pack_trees / split_trees: the host-built trees as one integer array
    and back, field by field."""
    _, t, _ = fed64
    tp = t.planner
    trees, n_real = host_trees(tp, aime_pair[1][2].numpy())
    dct = tplanner.split_trees(torch.from_numpy(tplanner.pack_trees(trees, n_real)),
                               tp.cfg.traj_tree)
    for i, (topo, cs, st) in enumerate(trees):
        for f in ("parent", "node_mask", "level_table"):
            np.testing.assert_array_equal(getattr(dct.topo, f)[i].numpy(), getattr(topo, f))
        np.testing.assert_array_equal(dct.cost_slot[i].numpy(), cs)
        np.testing.assert_array_equal(dct.cost_step[i].numpy(), st)
    assert dct.tree_mask.tolist() == [i < n_real for i in range(tplanner.MAX_TREES)]
    assert int(dct.n_trees) == n_real


def port_world(root):
    """The small world's map and tracks, the port's alone (no JAX: the
    card's machine has none)."""
    syn = small_av2()
    smp = tsm.SemanticMap().load_from_argo2(write_synthetic_map(syn.map_json, root, SEQ_ID))
    return smp, tloader.ArgoAgentLoader.trajs_info_of(syn.scenario, smp), syn.n_graph_segments


@pytest.mark.cuda
@pytest.mark.parametrize("width", ["full", "narrow"])
def test_cuda_compiled_plan_equals_eager(tmp_path, width):
    """On the card: the compiled plan (programs captured at the first
    call, replayed) against graphed=False, staged and fused, three plans
    each: equal to the bit; one AIME program per configuration. At the
    full width (D = E = 128, 8 heads) and with the tests' 4-head, 32-wide
    network (SMALL), both in the fusion kernels' domain."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from test_torch_planner import N_OBS_FRAMES

    from mind_tpu_torch.config import NetConfig

    dev = torch.device("cuda")
    smp, bundle, n_lanes = port_world(tmp_path)
    _, tcfg = planner_cfgs(n_lanes, "float32", "float32")
    if width == "full":
        tcfg.net = NetConfig()

    def agent(graphed):
        (a,) = [x for x in tagents.load_agents(bundle, smp, [TClAgentConfig(**CL_AGENT)],
                                                lambda p: tcfg, dev) if x.id == "AV"]
        a.planner.graphed = graphed
        return a.planner

    planners = {g: agent(g) for g in (None, False)}
    planners[False].net.load_state_dict(planners[None].net.state_dict())
    for export in (True, False):
        for f in range(N_OBS_FRAMES - 2, N_OBS_FRAMES + 1):
            obs = sorted([(tid, np.array([*bundle.pos[i, 5 * f], bundle.vel[i, 5 * f],
                                          bundle.ang[i, 5 * f]]), bundle.types[i][5 * f])
                          for i, tid in enumerate(bundle.track_ids) if bundle.has_flag[i, 5 * f]],
                         key=lambda o: o[0] != "AV")
            res = {}
            for g, p in planners.items():
                p.export_trees = export
                p.update_observation(obs)
                p.update_state_ctrl(obs[0][1], np.array([0.3, 0.01]))
                res[g] = p.plan()
            same_plan(res[None], res[False])
    kinds = sorted(p.kind for p in planners[None].program_set().programs.values())
    assert kinds == ["aime", "fused", "solve"]
