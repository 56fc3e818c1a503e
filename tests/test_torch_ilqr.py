"""Cost expansion, cost topology and tree iLQR of the PyTorch port vs
mind_tpu on the same inputs (float64)."""

import numpy as np
import pytest
import torch

from mind_tpu_torch.config import TrajTreeConfig
from mind_tpu_torch.ops import potential as tpot
from mind_tpu_torch.planner import ilqr as tilqr
from mind_tpu_torch.planner.cost_topology import device_cost_topology as t_cost_topology
from mind_tpu_torch.planner.trajectory_tree import make_cost_params as t_make_cost_params
from mind_tpu_torch.planner.trajectory_tree import two_phase_solve as t_two_phase_solve

F64 = torch.float64
# the JAX test modules' sizes (tests/test_ilqr.py); their helpers import jax,
# so they are imported inside the tests that compare with mind_tpu, and this
# file also collects on the card's machine, which has no jax
MN = 16
X_EXO = 4


def to_torch(nt, cls):
    """A JAX NamedTuple of arrays -> the port's NamedTuple (floats in f64)."""
    out = []
    for x in nt:
        if isinstance(x, int):
            out.append(x)
            continue
        a = np.asarray(x)
        t = torch.tensor(a)
        out.append(t.to(F64) if t.is_floating_point() else t)
    return cls(*out)


def random_nodes(rng, n, x_exo):
    from mind_tpu.ops.potential import NodeCostData
    import jax.numpy as jnp

    return NodeCostData(
        prob=jnp.asarray(rng.uniform(0.1, 1.0, n)),
        ego_mean=jnp.asarray(rng.normal(0, 3, (n, 2))),
        ego_cov=jnp.asarray(rng.uniform(0.1, 2.0, n)),
        exo_mean=jnp.asarray(rng.normal(0, 4, (n, x_exo, 2))),
        exo_cov=jnp.asarray(rng.uniform(0.1, 2.0, (n, x_exo))),
        exo_mask=jnp.asarray(rng.random((n, x_exo)) > 0.3),
    )


def test_cost_node_eval_matches_jax():
    """Values, gradients and Hessians at random states, in and out of the
    grid (the pull-back) and at out-of-bound speeds/steer (the state
    constraint), float64, within 1e-10."""
    import jax
    import jax.numpy as jnp
    from mind_tpu.ops.potential import cost_node_eval
    from test_ilqr import make_params

    rng = np.random.default_rng(0)
    n = 64
    params = make_params(target_vel=4.0, w_tgt=1.0, w_ego=1.0, w_exo=10.0)
    params = params._replace(**{k: jnp.asarray(v, jnp.float64) for k, v in
                                params._asdict().items()
                                if k not in ("grid_n", "tgt_seg_mask")})
    nodes = random_nodes(rng, n, X_EXO)
    xs = rng.normal(0, 5, (n, 6))
    xs[::4, :2] *= 30.0          # some far outside the 102 m grid
    xs[1::3, 2] = rng.uniform(-2, 12, len(xs[1::3]))
    xs[2::5, 5] = rng.uniform(-0.5, 0.5, len(xs[2::5]))
    us = rng.normal(0, 1, (n, 2))

    want = jax.vmap(cost_node_eval, in_axes=(0, 0, 0, None))(
        jnp.asarray(xs), jnp.asarray(us), nodes, params)
    got = tpot.cost_node_eval(torch.tensor(xs), torch.tensor(us),
                              to_torch(nodes, tpot.NodeCostData),
                              to_torch(params, tpot.CostParams))
    for g, w, name in zip(got, want, ("l", "l_x", "l_u", "l_xx", "l_uu")):
        assert g.dtype == F64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-10,
                                   err_msg=name)


def test_cost_topology_matches_jax():
    import jax.numpy as jnp
    from mind_tpu.planner.cost_topology import device_cost_topology
    from test_cost_topology import make_meta

    meta = make_meta()
    kw = dict(max_trees=6, max_cost_nodes=64, max_levels=32, max_width=8)
    want = device_cost_topology(*map(jnp.asarray, meta), **kw)
    # the port lays out S scenes' trees: one scene here
    got = t_cost_topology(*(torch.tensor(m)[None] for m in meta), **kw)
    assert got.n_trees.tolist() == [int(want.n_trees)] == [2]
    for name in ("cost_slot", "cost_step", "tree_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    for name in ("parent", "node_mask", "level_table"):
        np.testing.assert_array_equal(getattr(got.topo, name).numpy(),
                                      np.asarray(getattr(want.topo, name)), err_msg=name)


def problems():
    """(topology parents, warm params, full params, nodes, x0) of the
    tests/test_ilqr.py problems: a chain, the branching contingency tree,
    and a branching tree with exo agents near the path."""
    import jax.numpy as jnp
    from test_ilqr import make_nodes, make_params

    chain = list(range(-1, 13))
    branch = [-1, 0, 1, 1, 2, 3, 4, 5]
    exo_nodes = make_nodes(len(branch))._replace(
        exo_mean=jnp.tile(jnp.asarray([[6.0, 1.5], [9.0, -2.0], [1e4, 1e4], [3.0, 4.0]],
                                      jnp.float32), (MN, 1, 1)),
        exo_cov=jnp.full((MN, X_EXO), 0.5, jnp.float32),
        exo_mask=jnp.tile(jnp.asarray([True, True, False, True]), (MN, 1)))
    branch_nodes = make_nodes(len(branch))._replace(
        prob=jnp.asarray([1.0, 1.0, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5] + [0.0] * (MN - 8),
                         jnp.float32))
    return [
        (chain, make_params(target_vel=3.0, w_tgt=1.0, w_des_vel=1.0),
         make_params(target_vel=3.0, w_tgt=1.0, w_des_vel=1.0, w_ego=1.0),
         make_nodes(len(chain)), [0.0, 0.0, 0.5, 0.0, 0.0, 0.0]),
        (branch, make_params(target_vel=6.0, w_tgt=1.0, w_des_vel=5.0, w_ctrl=1.0),
         make_params(target_vel=6.0, w_des_vel=5.0, w_ctrl=1.0, w_tgt=1.0),
         branch_nodes, [0.0, 2.0, 2.0, 0.3, 0.0, 0.0]),
        (branch, make_params(target_vel=4.0, w_tgt=1.0),
         make_params(target_vel=4.0, w_tgt=1.0, w_ego=1.0, w_exo=10.0),
         exo_nodes, [0.0, 0.5, 3.0, 0.0, 0.2, 0.0]),
    ]


def test_two_phase_solve_matches_jax_f64():
    """Each problem alone through the JAX two_phase_solve, all three as one
    batch through the port: identical iteration counts (both phases), states
    and controls within 1e-8."""
    import jax
    import jax.numpy as jnp
    from mind_tpu.planner.ilqr import ILQRConfig, build_topology
    from mind_tpu.planner.trajectory_tree import two_phase_solve

    cfg = ILQRConfig(max_iterations=100, rel_tol=1e-6, dtype="float64")
    wcfg = cfg._replace(max_iterations=40)
    solve = jax.jit(lambda t, x, n, w, f: two_phase_solve(t, x, n, w, f, cfg, wcfg))
    probs = problems()
    want = []
    for parents, warm, full, nodes, x0 in probs:
        topo = build_topology(parents, MN, MN, max_width=4)
        xs, us, info = solve(topo, jnp.asarray(x0), nodes, warm, full)
        want.append((np.asarray(xs), np.asarray(us), int(info["iterations"]),
                     int(info["warm_iterations"])))

    # one batch of three trees; the params are shared, so solve per params set
    for i, (parents, warm, full, nodes, x0) in enumerate(probs):
        topos = [tilqr.build_topology(p, MN, MN, max_width=4) for p, *_ in probs]
        topo = tilqr.TreeTopology(*(torch.stack(f) for f in zip(*topos)))
        tnodes = to_torch(nodes, tpot.NodeCostData)
        tnodes = tpot.NodeCostData(*(t[None].expand((3,) + t.shape) for t in tnodes))
        active = torch.tensor([j == i for j in range(3)])
        xs, us, info = t_two_phase_solve(
            topo, torch.tensor(x0, dtype=F64), tnodes,
            to_torch(warm, tpot.CostParams), to_torch(full, tpot.CostParams),
            tilqr.ILQRConfig(**cfg._asdict()), tilqr.ILQRConfig(**wcfg._asdict()),
            active=active)
        w_xs, w_us, w_it, w_wit = want[i]
        assert int(info["iterations"][i]) == w_it, f"problem {i} full iterations"
        assert int(info["warm_iterations"][i]) == w_wit, f"problem {i} warm iterations"
        assert w_it > 1
        np.testing.assert_allclose(xs[i].numpy(), w_xs, rtol=0, atol=1e-8)
        np.testing.assert_allclose(us[i].numpy(), w_us, rtol=0, atol=1e-8)
        # trees left out keep their start
        assert int(info["iterations"][(i + 1) % 3]) == 0


def random_batch(seed, G, n_max, n_exo, dtype, device):
    """G random trees of up to n_max cost nodes (parents before children,
    the deepest node first), their cost data around a 10 m/s ego, warm and
    full CostParams of the default phase settings, and x0: the inputs of
    one plan's two-phase solve, made with numpy."""
    rng = np.random.default_rng(seed)
    tt = TrajTreeConfig()
    topos, mn = [], n_max
    for g in range(G):
        n = int(rng.integers(n_max // 2, n_max + 1))
        parents = [-1] + [int(rng.integers(max(0, i - 12), i)) for i in range(1, n)]
        topos.append(tilqr.build_topology(parents, mn, 32, max_width=16))
    topo = tilqr.TreeTopology(*(torch.stack(f).to(device) for f in zip(*topos)))
    step = rng.uniform(1.5, 2.5, (G, mn, 1)) * (1 + np.arange(mn))[None, :, None] ** 0.5
    nodes = tpot.NodeCostData(
        prob=torch.tensor(rng.uniform(0.2, 1.0, (G, mn)) * topo.node_mask.cpu().numpy()),
        ego_mean=torch.tensor(np.concatenate([step * 4, rng.normal(0, 0.5, (G, mn, 1))], -1)),
        ego_cov=torch.tensor(rng.uniform(0.2, 1.5, (G, mn))),
        exo_mean=torch.tensor(rng.normal(0, 15, (G, mn, n_exo, 2)) + [20.0, 0.0]),
        exo_cov=torch.tensor(rng.uniform(0.3, 1.5, (G, mn, n_exo))),
        exo_mask=torch.tensor(rng.random((G, mn, n_exo)) > 0.3) & topo.node_mask.cpu()[..., None])
    nodes = tpot.NodeCostData(*(t.to(device) if t.dtype == torch.bool else t.to(device, dtype)
                                for t in nodes))
    x0 = np.array([0.0, 0.2, 10.0, 0.02, 0.0, 0.0])
    lane = np.stack([np.linspace(-20, 200, 40), np.zeros(40)], -1)
    wp, fp = (t_make_cost_params(ph, x0, lane, 12.0, 64, w, device)
              for ph, w in ((tt.warm, True), (tt.full, False)))
    return topo, nodes, wp, fp, torch.tensor(x0, device=device)


def test_graphed_solve_needs_a_card():
    topo, nodes, wp, fp, x0 = random_batch(0, 2, 12, 3, F64, "cpu")
    cfg = tilqr.ILQRConfig(dtype="float64", max_iterations=3)
    with pytest.raises(ValueError, match="CUDA"):
        t_two_phase_solve(topo, x0, nodes, wp, fp, cfg, graphed=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_graphed_solve_matches_eager(dtype):
    """On the card, the two-phase solve with each iteration a replayed CUDA
    graph (one and four replays per host read) against the eager loop: the
    same iteration counts and xs/us equal to the bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    topo, nodes, wp, fp, x0 = random_batch(1, 6, 96, 12, getattr(torch, dtype), dev)
    cfg = tilqr.ILQRConfig(dtype=dtype, rel_tol=1e-5)
    wcfg = cfg._replace(max_iterations=40)
    active = torch.tensor([True, True, True, True, False, True], device=dev)
    eager = t_two_phase_solve(topo, x0, nodes, wp, fp, cfg, wcfg, active, graphed=False)
    keep = tilqr.REPLAYS_PER_READ
    try:
        for k in (1, 4):
            tilqr.REPLAYS_PER_READ = k
            xs, us, info = t_two_phase_solve(topo, x0, nodes, wp, fp, cfg, wcfg, active,
                                             graphed=True)
            for key in ("iterations", "warm_iterations"):
                assert torch.equal(info[key], eager[2][key]), (k, key)
            assert torch.equal(xs, eager[0]) and torch.equal(us, eager[1]), k
    finally:
        tilqr.REPLAYS_PER_READ = keep
    assert int(eager[2]["iterations"][4]) == 0 and int(eager[2]["iterations"].max()) > 2
