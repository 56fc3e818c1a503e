"""The scale-out runners' programs (parallel/programs.py) against mind_tpu's
jitted programs on the same inputs, at float64 on the small synthetic AV2
world of test_torch_planner.py (the test settings and spread weights of
test_torch_multi_scenario.py, the solver's iterations capped):
MultiScenarioSim's `_obs_update` and `_batched_fn` at S = 2 and
parallel_tree_solve's `fn` on a small make_tree_batch, each body run
through a PlanProgram (on the CPU a program runs its body eagerly on its
buffers: `programs.compiled` is patched to say so). Windows equal to the
bit, ok flags and iteration counts equal, controls, us and J within 1e-6.
MonteCarloSim's programs are held in test_torch_scaleout_programs_mc.py
(each file pays one JAX compile of a batched plan, ~50 s on the CPU). On
the card (marked cuda) each runner compiled against graphed=False, to the
bit.
"""

import functools

import numpy as np
import pytest
import torch

from mind_tpu_torch.config import ClAgentConfig as TClAgentConfig, SimConfig as TSimConfig
from mind_tpu_torch.models.weights import params_from_flax
from mind_tpu_torch.parallel import mesh as tmesh
from mind_tpu_torch.parallel import monte_carlo as tmonte_carlo
from mind_tpu_torch.parallel import multi_scenario as tmulti
from mind_tpu_torch.parallel import scale as tscale
from mind_tpu_torch.planner import ilqr as tilqr
from mind_tpu_torch.planner import programs
from mind_tpu_torch.sim.simulator import Simulator as TSimulator
from test_torch_data import SEQ_ID
from test_torch_planner import CL_AGENT, CPU, World, planner_cfgs, spread_weights

torch.set_num_threads(2)

TOL = 1e-6
F64 = torch.float64
# the solver's iteration caps, cut so that a CPU plan takes seconds (the
# programs' plumbing is under test here, the solver in test_torch_ilqr.py)
SOLVER = dict(max_iterations=10, warm_max_iterations=5)


def configs(world):
    return planner_cfgs(world.n_lanes, "float64", "float64", **SOLVER)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return World(tmp_path_factory.mktemp("av2"))


@pytest.fixture
def as_programs(monkeypatch):
    """Runners built in the test plan through their programs (on the CPU
    each runs its body eagerly on its buffers)."""
    monkeypatch.setattr(programs, "compiled", lambda device, graphed: graphed is not False)


def recording(fn, calls):
    def wrapped(*args):
        out = fn(*args)
        calls.append((args, out))
        return out
    return wrapped


def common(world):
    return dict(sim_name="demo_1", seq_id=SEQ_ID, data_root=str(world.root))


def port_weights(net, flat):
    net.load_state_dict(params_from_flax(flat))
    net.apply_compute_dtype()


def test_multi_scenario_programs_match_jax(world, monkeypatch, as_programs):
    """S = 2 (the AV asked for 8 and 6 m/s, planner on from tick 0), one
    tick: the update program's window equal to `_obs_update`'s, the plan
    program's packed [2, 4] against `_batched_fn`'s on the same x0 and grid
    origins."""
    import mind_tpu.data.loader as jloader
    import mind_tpu.parallel.multi_scenario as jmulti
    from mind_tpu.config import ClAgentConfig, SimConfig
    from mind_tpu.sim.simulator import Simulator

    jcfg, tcfg = configs(world)
    monkeypatch.setattr(jloader, "load_scenario", lambda path: world.jscenario)
    monkeypatch.setattr(jmulti, "Simulator", functools.partial(Simulator, planner_cfg=jcfg))
    monkeypatch.setattr(tmulti, "Simulator", functools.partial(TSimulator, planner_cfg=tcfg))
    agents = [dict(CL_AGENT, target_velocity=v, enable_timestep=0.0) for v in (8.0, 6.0)]
    jms = jmulti.MultiScenarioSim([SimConfig(cl_agents=[ClAgentConfig(**a)], **common(world))
                                   for a in agents], planner_cfg=jcfg, max_steps=1)
    tms = tmulti.MultiScenarioSim([TSimConfig(cl_agents=[TClAgentConfig(**a)], **common(world))
                                   for a in agents], planner_cfg=tcfg, max_steps=1, device=CPU,
                                  scenarios=[world.syn.scenario] * 2)
    params, flat = spread_weights(jcfg)
    jms.params = params
    port_weights(tms.avs[0].planner.net, flat)
    jplans, jupdates = [], []
    jms._batched_fn = recording(jms._batched_fn, jplans)
    jms._obs_update = recording(jms._obs_update, jupdates)
    want, got = jms.run(), tms.run()
    assert got["plan_calls"] == want["plan_calls"] == 1 and len(jupdates) == 1
    progs = tms.programs.programs
    assert sorted(progs) == ["batched_plan", "obs_update"]
    # the window: the update program writes it where the plan program reads it
    assert all(a is b for a, b in zip(progs["batched_plan"].inputs.bufs,
                                      progs["obs_update"].inputs.buf))
    for f, a, b in zip(tms._bufs._fields, tms._bufs, jms._bufs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    (jargs, jout), = jplans
    host = progs["batched_plan"].inputs.host.numpy()
    np.testing.assert_array_equal(host[:, :6], np.asarray(jargs[4]))
    np.testing.assert_array_equal(host[:, 6:], np.asarray(jargs[5].field_offset))
    packed, jpacked = progs["batched_plan"].outputs.numpy(), np.asarray(jout)
    np.testing.assert_array_equal(packed[:, 2:], jpacked[:, 2:])   # ok, iterations
    assert (packed[:, 2] == 1.0).all() and (packed[:, 3] > 0).all()
    np.testing.assert_allclose(packed[:, :2], jpacked[:, :2], rtol=0, atol=TOL)
    assert int(progs["batched_plan"].rounds) >= 2
    np.testing.assert_allclose(tms.ego_states(), jms.ego_states(), rtol=0, atol=TOL)


def tree_batch():
    """make_tree_batch's small branching batch, cast to float64."""
    topo, nodes, params, x0 = tscale.make_tree_batch(8, 12, 16, 12, 3, 3, seed=2,
                                                     device="cpu")
    f64 = lambda tree: type(tree)(*(t.to(F64) if isinstance(t, torch.Tensor)
                                    and t.is_floating_point() else t for t in tree))
    return topo, f64(nodes), f64(params), x0.to(F64)


def test_tree_solve_program_matches_jax(monkeypatch):
    """parallel_tree_solve's fn (jax.jit(jax.vmap(solve))) on 8 branching
    trees at float64 against the port's tree-solve program: iteration
    counts equal, us and J within 1e-6; the program's result equal to the
    direct solve's (graphed=False) to the bit, on a one- and a two-shard
    mesh (one program per shard shape)."""
    import jax
    import jax.numpy as jnp
    from mind_tpu.ops.potential import CostParams, NodeCostData
    from mind_tpu.planner.ilqr import ILQRConfig, TreeTopology, ilqr_solve

    topo, nodes, params, x0 = tree_batch()
    cfg = tilqr.ILQRConfig(max_iterations=20)
    j = lambda t: jnp.asarray(t.numpy())
    jparams = CostParams(*(x if isinstance(x, int) else j(x) for x in params))
    jcfg = ILQRConfig(**cfg._asdict())

    def solve(topo_i, nodes_i, x0_i):
        _, us, info = ilqr_solve(topo_i, x0_i, jnp.zeros((16, 2), x0_i.dtype), nodes_i,
                                 jparams, jcfg)
        return us, info["J"], info["iterations"]

    w_us, w_J, w_its = jax.jit(jax.vmap(solve))(TreeTopology(*map(j, topo)),
                                                NodeCostData(*map(j, nodes)), j(x0))
    monkeypatch.setattr(programs, "compiled", lambda device, graphed: graphed is not False)
    for n in (1, 2):
        mesh = tmesh.make_mesh(n, device="cpu")
        got = tscale.parallel_tree_solve(mesh, topo, nodes, params, x0, cfg,
                                         with_iterations=True)
        direct = tscale.parallel_tree_solve(mesh, topo, nodes, params, x0, cfg, graphed=False,
                                            with_iterations=True)
        assert all(torch.equal(a, b) for a, b in zip(got, direct))
        us, J, its = got
        np.testing.assert_array_equal(its.numpy(), np.asarray(w_its))
        np.testing.assert_allclose(us.numpy(), np.asarray(w_us), rtol=0, atol=TOL)
        np.testing.assert_allclose(J.numpy(), np.asarray(w_J), rtol=TOL, atol=0)
    kinds = [(p.kind, tuple(p.inputs.x0.shape)) for p in programs.programs()
             if p.kind == "tree_solve" and p.device == CPU]
    assert ("tree_solve", (8, 6)) in kinds and ("tree_solve", (4, 6)) in kinds


def test_graphed_needs_a_cuda_device(world):
    """graphed=True on the CPU raises, for all three entry points."""
    _, tcfg = configs(world)
    cfg = TSimConfig(cl_agents=[TClAgentConfig(**CL_AGENT)], **common(world))
    with pytest.raises(ValueError, match="CUDA device"):
        tmulti.MultiScenarioSim([cfg], planner_cfg=tcfg, device=CPU, graphed=True)
    with pytest.raises(ValueError, match="CUDA device"):
        tmonte_carlo.MonteCarloSim(cfg, k=2, planner_cfg=tcfg, device=CPU,
                                   scenario=world.syn.scenario, graphed=True)
    with pytest.raises(ValueError, match="CUDA device"):
        tscale.parallel_tree_solve(tmesh.make_mesh(1, device="cpu"), *tree_batch(),
                                   graphed=True)


def cuda_world(tmp_path):
    """The small world's map written for the port alone (no JAX)."""
    from mind_tpu_torch.synthetic import write_synthetic_map
    from test_torch_data import small_av2

    syn = small_av2()
    write_synthetic_map(syn.map_json, tmp_path, SEQ_ID)
    return syn


def needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def cuda_config(syn, width="full"):
    """The test settings with a float32 network: the full-width one, or the
    tests' own 4-head 32-wide one ("narrow"); the card's fusion kernels take
    both."""
    from mind_tpu_torch.config import NetConfig

    _, tcfg = planner_cfgs(syn.n_graph_segments, "float32", "float32", **SOLVER)
    if width == "full":
        tcfg.net = NetConfig()
    return tcfg


@pytest.mark.cuda
@pytest.mark.parametrize("width", ["full", "narrow"])
def test_cuda_multi_scenario_compiled_equals_eager(tmp_path, monkeypatch, width):
    """On the card: MultiScenarioSim over 2 scenes, 15 ticks, compiled
    against graphed=False: every packed, the plan count and the egos equal
    to the bit; at the full width and with the 4-head 32-wide network."""
    needs_cuda()
    syn = cuda_world(tmp_path)
    tcfg = cuda_config(syn, width)
    monkeypatch.setattr(tmulti, "Simulator", functools.partial(TSimulator, planner_cfg=tcfg))
    cfgs = lambda: [TSimConfig(cl_agents=[TClAgentConfig(**dict(
        CL_AGENT, target_velocity=v, enable_timestep=0.0))], sim_name="demo_1", seq_id=SEQ_ID,
        data_root=str(tmp_path)) for v in (8.0, 6.0)]
    res = {}
    for graphed in (None, False):
        # the same seeded network in both
        ms = tmulti.MultiScenarioSim(cfgs(), planner_cfg=tcfg, max_steps=15,
                                     scenarios=[syn.scenario] * 2, graphed=graphed)
        packed = []
        ms._plan = recording(ms._plan, packed)
        out = ms.run()
        res[graphed] = (out, ms.ego_states(), [p for _, p in packed])
    (a, ego_a, pa), (b, ego_b, pb) = res[None], res[False]
    assert a["plan_calls"] == b["plan_calls"] == 3 and a["terminated"] == b["terminated"]
    assert all(np.array_equal(x, y) for x, y in zip(pa, pb)) and np.array_equal(ego_a, ego_b)


@pytest.mark.cuda
def test_cuda_tree_solve_compiled_equals_eager():
    """On the card: parallel_tree_solve of 64 branching trees, the compiled
    program against graphed=False (a captured iteration per replay): us, J
    and the iteration counts equal to the bit, a second call replaying."""
    needs_cuda()
    mesh = tmesh.make_mesh(1)
    batch = tscale.make_tree_batch(64, 12, 16, 12, 3, 3, seed=2, device=mesh.devices[0])
    cfg = tilqr.ILQRConfig(max_iterations=10)
    got = [tscale.parallel_tree_solve(mesh, *batch, cfg, with_iterations=True)
           for _ in range(2)]
    want = tscale.parallel_tree_solve(mesh, *batch, cfg, graphed=False, with_iterations=True)
    for g in got:
        assert all(torch.equal(a, b) for a, b in zip(g, want))
