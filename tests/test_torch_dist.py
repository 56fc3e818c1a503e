"""The distributed mesh of the PyTorch port (parallel/launch.py starting
one process per shard, parallel/mesh.py::DistMesh) on the CPU: every case
launches a 2-rank gloo world through `launch`, running the rank workloads
of parallel/dryrun.py (the ranks import the port alone; the JAX side runs
here, in the test process).

Against the port's sequential 2-shard CPU mesh, to the bit (the reference
runs at the ranks' thread count, launch.rank_threads): the tree solve, the
Monte-Carlo copies (and a deadline that rank 0 sees expire after the first
chunk while rank 1 has none: both stop there), and the training losses and
parameters after 3 Adam steps, equal on both ranks.

Against mind_tpu's on its make_mesh(2) over two of the virtual CPU devices
of tests/conftest.py, at the tolerances of the files these sizes come from:
parallel_tree_solve at float64 (tests/test_torch_scale.py: us 1e-9, J 1e-9
relative), run_episode_monte_carlo(mesh=) at float64
(tests/test_torch_monte_carlo.py: control 1e-6, ego 1e-4 m) and the
dp_shardings train step (tests/test_torch_train.py: 3 Adam steps' losses
1e-4 relative).

Failures: a rank that raises makes the launch raise with its traceback, a
rank left waiting in a collective ends within the launch's timeout, a
launch without a card and without device="cpu" raises, and nccl where it
cannot run raises.
"""

import contextlib
import time

import numpy as np
import pytest
import torch

from mind_tpu_torch.parallel import launch as tlaunch
from mind_tpu_torch.parallel.mesh import make_mesh
from mind_tpu_torch.sim import episode as tepisode
from mind_tpu_torch.sim.simulator import SimSpec
from test_torch_episode import make_sims
from test_torch_planner import World

torch.set_num_threads(2)

F64 = torch.float64
DRYRUN = "mind_tpu_torch.parallel.dryrun"
# tests/test_torch_scale.py's tree batch: 8 branching trees of 12 nodes in 16
# slots, 12 levels, width 3, 3 exo agents, seed 2; float64, 20 iterations
TREES = dict(n_trees=8, n_nodes=12, max_nodes=16, max_levels=12, max_width=3, n_exo=3, seed=2)
# one planning cycle of the small world from tick 0, copies of seed 11 (a
# float64 cycle of the small world is a 6-8 s solve on one CPU thread)
MC = dict(k=2, chunk=1, seed=11, horizon=5, seg_cycles=10)
RESULT_FIELDS = ("ego_states", "plan_ok", "planned", "iterations", "controls")


def launch2(workload, **kwargs):
    """`workload` of parallel/dryrun.py on a 2-rank CPU world."""
    return tlaunch.launch(f"{DRYRUN}:{workload}", 2, kwargs=kwargs, device="cpu", timeout=300)


@contextlib.contextmanager
def rank_threads():
    """The ranks' thread count, for a reference that must equal them to
    the bit (CPU sums split by thread)."""
    before = torch.get_num_threads()
    torch.set_num_threads(tlaunch.rank_threads(2))
    try:
        yield
    finally:
        torch.set_num_threads(before)


def assert_results_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in RESULT_FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        assert (a.fail_cycle, a.plan_calls) == (b.fail_cycle, b.plan_calls)


# --- tree solve -------------------------------------------------------------

@pytest.fixture(scope="module")
def trees():
    from mind_tpu_torch.parallel import scale as tscale
    from mind_tpu_torch.planner.ilqr import ILQRConfig

    ranks = launch2("tree_solve", **TREES, max_iterations=20, dtype=F64)
    topo, nodes, params, x0 = tscale.make_tree_batch(**TREES, device="cpu")
    f64 = lambda tree: type(tree)(*(t.to(F64) if isinstance(t, torch.Tensor) and
                                    t.is_floating_point() else t for t in tree))
    batch = (topo, f64(nodes), f64(params), x0.to(F64))
    with rank_threads():
        seq = tscale.parallel_tree_solve(make_mesh(2, device="cpu"), *batch,
                                         ILQRConfig(max_iterations=20))
    return ranks, seq, batch


def test_dist_tree_solve_equals_sequential_mesh(trees):
    """Each rank solves its 4 trees; both get all 8 in tree order, equal to
    the sequential 2-shard mesh's to the bit."""
    ranks, (us, J), _ = trees
    assert us.shape == (8, 16, 2) and torch.isfinite(J).all()
    for r in ranks:
        assert torch.equal(r["us"], us) and torch.equal(r["J"], J)


def test_dist_tree_solve_matches_jax(trees):
    import jax.numpy as jnp
    from mind_tpu.ops.potential import CostParams, NodeCostData
    from mind_tpu.parallel.mesh import make_mesh as jmake_mesh
    from mind_tpu.parallel.scale import parallel_tree_solve
    from mind_tpu.planner.ilqr import ILQRConfig, TreeTopology

    ranks, _, (topo, nodes, params, x0) = trees
    j = lambda t: jnp.asarray(t.numpy())
    w_us, w_J = parallel_tree_solve(
        jmake_mesh(2), TreeTopology(*map(j, topo)), NodeCostData(*map(j, nodes)),
        CostParams(*(x if isinstance(x, int) else j(x) for x in params)), j(x0),
        ILQRConfig(max_iterations=20))
    np.testing.assert_allclose(ranks[0]["us"].numpy(), np.asarray(w_us), rtol=0, atol=1e-9)
    np.testing.assert_allclose(ranks[0]["J"].numpy(), np.asarray(w_J), rtol=1e-9, atol=0)


# --- Monte-Carlo episodes ---------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return World(tmp_path_factory.mktemp("av2"))


@pytest.fixture(scope="module")
def sims(world):
    """Both packages' float64 Simulators of the small world with the same
    weights (mind_tpu first), and the port's as a SimSpec for the ranks."""
    jsim, tsim = make_sims(world, ticks=MC["horizon"])
    return jsim, tsim, SimSpec.of(tsim)


@pytest.fixture(scope="module")
def monte_carlo(sims):
    _, tsim, spec = sims
    ranks = launch2("monte_carlo", spec=spec, **MC)
    with rank_threads():
        seq = tepisode.run_episode_monte_carlo(tsim, mesh=make_mesh(2, device="cpu"), **MC)
    return ranks, seq


def test_dist_monte_carlo_equals_sequential_mesh(monte_carlo):
    """One copy per rank; both ranks get both copies, in copy order, equal
    to the sequential 2-shard mesh's to the bit; each rank ran its own
    chunk (one wall each)."""
    ranks, seq = monte_carlo
    assert len(seq) == 2 and seq[0].planned.all()
    for r in ranks:
        assert_results_equal(r["results"], seq)
        assert [w[:2] for w in r["chunk_walls"]] == [(0, 2)]
    assert np.abs(seq[0].ego_states - seq[1].ego_states).max() > 0


def test_dist_monte_carlo_matches_jax(sims, monte_carlo):
    """Against mind_tpu's run_episode_monte_carlo on its 2-device mesh
    (chunks of one copy per device): the same plans, controls within 1e-6,
    ego within 1e-4 m (float64, sums in another order; as
    test_torch_monte_carlo.py, an iteration count may differ by a rejected
    step where the control agrees within 1e-9). One cycle (MC): at the
    second cycle mind_tpu's 2-device run accepts two iterations its own
    one-device run rejects and moves copy 1's control by 5.2e-5 from both
    its one-device run and the port (ROADMAP.md queue C)."""
    from mind_tpu.parallel.mesh import make_mesh as jmake_mesh
    from mind_tpu.sim.episode import run_episode_monte_carlo

    jsim = sims[0]
    want = run_episode_monte_carlo(jsim, mesh=jmake_mesh(2), **MC)
    got = monte_carlo[0][0]["results"]
    assert len(got) == len(want) == 2
    for w, g in zip(want, got):
        assert g.fail_cycle == w.fail_cycle and g.plan_calls == w.plan_calls
        np.testing.assert_array_equal(g.planned, np.asarray(w.planned))
        np.testing.assert_array_equal(g.plan_ok, np.asarray(w.plan_ok))
        gap = np.abs(g.controls - np.asarray(w.controls)).max(-1)
        differ = g.iterations != np.asarray(w.iterations)
        assert (gap[differ] <= 1e-9).all() and differ.sum() <= 1, (g.iterations, w.iterations)
        assert gap.max() <= 1e-6
        np.testing.assert_allclose(g.ego_states, w.ego_states, rtol=0, atol=1e-4)


def test_dist_monte_carlo_deadline_is_rank_0s(sims):
    """k = 4 in two chunks of one copy per rank; rank 0's deadline has
    passed, rank 1 has none. Rank 0 decides for both: after the first chunk
    (one always runs) both stop, with the first chunk's two copies, equal
    to the bit to the sequential mesh under the same deadline. Without the
    decision rank 1 would wait in the second chunk's gather until the
    launch's timeout."""
    _, tsim, spec = sims
    kw = dict(MC, k=4)
    ranks = tlaunch.launch(f"{DRYRUN}:monte_carlo", 2, kwargs=dict(spec=spec, **kw),
                           device="cpu", timeout=300,
                           rank_kwargs=[{"deadline": 0.0}, {"deadline": None}])
    with rank_threads():
        seq = tepisode.run_episode_monte_carlo(tsim, mesh=make_mesh(2, device="cpu"),
                                               deadline=0.0, **kw)
    assert len(seq) == 2
    for r in ranks:
        assert_results_equal(r["results"], seq)
        assert [w[:2] for w in r["chunk_walls"]] == [(0, 2)]


# --- data-parallel training -------------------------------------------------

@pytest.fixture(scope="module")
def training():
    """3 Adam steps (lr 1e-3) of test_torch_train.py's narrow network with
    mind_tpu's seeded parameters on its 4-scene batch: 2 ranks, the
    sequential 2-shard mesh, and mind_tpu's dp_shardings step."""
    from mind_tpu.config import NetConfig
    from mind_tpu.models import init_scene_pred
    from mind_tpu.models.train import make_dummy_batch
    from mind_tpu_torch.config import NetConfig as TNetConfig
    from mind_tpu_torch.models import train as ttrain
    from mind_tpu_torch.models.weights import params_from_flax
    from test_torch_train import TINY, A, B, L, flat, port_batch, port_net

    _, params, _ = init_scene_pred(NetConfig(**TINY, use_pallas_fusion=False), A, L, seed=0)
    jbatch = make_dummy_batch(NetConfig(**TINY), B, A, L, seed=1)
    batch = port_batch(jbatch)
    ranks = launch2("train", net_cfg=TNetConfig(**TINY), batch=batch, steps=3, lr=1e-3,
                    optimizer="adam", net_state=params_from_flax(flat(params)))
    net = port_net(params)
    step = ttrain.make_train_step(net, ttrain.adam(net.parameters(), 1e-3),
                                  mesh=make_mesh(2, device="cpu"))
    with rank_threads():
        losses = [step(batch).item() for _ in range(3)]
    seq = {"losses": losses, "params": {k: p.detach() for k, p in net.named_parameters()}}
    return ranks, seq, params, jbatch


def test_dist_train_equals_sequential_mesh(training):
    """Both ranks return the global loss of each step and hold the same
    parameters after 3 steps: equal to the bit to each other and to the
    sequential 2-shard mesh's; the loss falls."""
    ranks, seq, _, _ = training
    assert seq["losses"][-1] < seq["losses"][0]
    for r in ranks:
        assert r["losses"] == seq["losses"]
        assert set(r["params"]) == set(seq["params"])
        for k, v in seq["params"].items():
            assert torch.equal(r["params"][k], v), k
        assert set(r["times"]) == {"forward", "backward", "all_reduce", "optimizer"}


def test_dist_train_matches_jax_dp_shardings(training):
    """mind_tpu's train step jitted with dp_shardings over its 2-device mesh
    (XLA sums the gradients over the devices): the same 3 losses within
    1e-4 relative."""
    import jax
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from mind_tpu.config import NetConfig
    from mind_tpu.models.train import dp_shardings, make_train_step
    from mind_tpu.parallel.mesh import make_mesh as jmake_mesh
    from test_torch_train import TINY

    ranks, _, params, jbatch = training
    opt = optax.adam(1e-3)
    state = opt.init(params)
    _, train_step = make_train_step(NetConfig(**TINY, use_pallas_fusion=False), opt)
    mesh = jmake_mesh(2)
    param_sh, opt_sh, batch_sh = dp_shardings(mesh, params, state, jbatch)
    step = jax.jit(train_step, in_shardings=(param_sh, opt_sh, batch_sh),
                   out_shardings=(param_sh, opt_sh, NamedSharding(mesh, P())))
    params, state, jbatch = (jax.device_put(params, param_sh), jax.device_put(state, opt_sh),
                             jax.device_put(jbatch, batch_sh))
    want = []
    for _ in range(3):
        params, state, loss = step(params, state, jbatch)
        want.append(float(loss))
    for g, w in zip(ranks[0]["losses"], want):
        assert abs(g - w) / abs(w) < 1e-4, (ranks[0]["losses"], want)


# --- failures and rules -----------------------------------------------------

def test_launch_raises_with_the_failing_ranks_traceback():
    """Rank 1 cuts 7 trees over 2 shards and raises while rank 0 has solved
    its shard and waits in the gather: the launch raises with rank 1's
    traceback, well within its timeout, and no rank is left running."""
    t = time.perf_counter()
    with pytest.raises(RuntimeError, match=r"rank 1 failed(.|\n)*does not divide"):
        tlaunch.launch(f"{DRYRUN}:tree_solve", 2, kwargs=dict(TREES, max_iterations=2),
                       device="cpu", timeout=120, rank_kwargs=[{}, {"n_trees": 7}])
    assert time.perf_counter() - t < 60


def test_launch_ends_a_rank_left_waiting_in_a_collective():
    """Rank 0 solves its shard and waits in the gather; rank 1 runs no
    workload and returns. The world does not hang: the launch raises
    (gloo's error on rank 0, or the timeout) within the timeout and a
    margin, and returns no partial result."""
    t = time.perf_counter()
    with pytest.raises((RuntimeError, TimeoutError)):
        tlaunch.launch(f"{DRYRUN}:workloads", 2, device="cpu", timeout=15,
                       rank_kwargs=[{"jobs": [("tree_solve", dict(TREES, max_iterations=2))]},
                                    {"jobs": []}])
    assert time.perf_counter() - t < 60


def test_launch_without_a_card_raises(monkeypatch):
    """device=None means the cards; without one the launch raises before
    starting a rank, as common/device.py does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.launch(f"{DRYRUN}:tree_solve", 2, kwargs=TREES)


@pytest.mark.parametrize("device,per_card,want", [("cpu", 1, "gloo"), ("cuda", 1, "nccl"),
                                                  ("cuda", 2, "gloo")])
def test_backend_rule(device, per_card, want):
    """nccl when every rank has a card of its own, gloo on the CPU and when
    ranks share a card; gloo asked for is taken."""
    assert tlaunch.choose_backend(device, per_card) == want
    assert tlaunch.choose_backend(device, per_card, "gloo") == "gloo"


def test_asking_for_nccl_where_it_cannot_run_raises():
    """nccl on the CPU, or with two ranks on a card, raises; the launch
    never switches to gloo on its own."""
    with pytest.raises(ValueError, match="CUDA cards only"):
        tlaunch.launch(f"{DRYRUN}:tree_solve", 2, kwargs=TREES, device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="one rank per card"):
        tlaunch.choose_backend("cuda", 2, "nccl")
