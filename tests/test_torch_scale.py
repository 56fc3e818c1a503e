"""Scale-out of the PyTorch port against mind_tpu on the CPU: the batched
plan cycle (batched_plan_core, with the AIME of two scenes in one network
batch per round) against `jax.vmap` of mind_tpu's fused_plan_core as its
MultiScenarioSim builds it, the tree iLQR with per-tree cost parameters
against `jax.vmap(ilqr_solve)`, make_tree_batch and parallel_tree_solve
against mind_tpu's on two-shard CPU meshes, and the mesh helpers.
Tolerances are named at each check.
"""

import functools

import numpy as np
import pytest
import torch

from mind_tpu_torch.ops import potential as tpot
from mind_tpu_torch.parallel import mesh as tmesh
from mind_tpu_torch.parallel import scale as tscale
from mind_tpu_torch.planner import aime_device as taime
from mind_tpu_torch.planner import ilqr as tilqr
from mind_tpu_torch.planner import planner as tplanner
from mind_tpu_torch.planner.trajectory_tree import make_cost_params as t_make_cost_params
from mind_tpu_torch.sim.episode import _stack
from mind_tpu_torch.synthetic import scene_statics, synthetic_scene
from test_torch_ilqr import random_batch
from test_torch_plan_cycle import A, CPU, L, nets, planner_cfgs  # noqa: F401 (fixture)

torch.set_num_threads(2)
F64 = torch.float64
# two scenes that differ in their agents, target-lane length and target speed
SCENES = ((8, 200, 0.0), (5, 170, -2.0))   # (seed, target-lane points, speed offset)


def scenes():
    out = []
    for seed, n_tgt, dv in SCENES:
        sc = synthetic_scene(seed=seed, max_actors=A, max_lanes=L, n_agents=8, n_tgt=n_tgt)
        out.append(sc._replace(target_vel=sc.target_vel + dv))
    return out


def torch_inputs(cfg, scene):
    """One scene's fused_plan_core arguments on the CPU (the window filled
    with its 50 frames, x0 at the ego's last frame, zero control)."""
    pdt = getattr(torch, cfg.pipeline_dtype)
    buf = taime.DeviceObsBuffer.create(A, pdt, CPU)
    for f in range(50):
        buf = taime.obs_buffer_update(buf, torch.tensor(scene.history[:, f]),
                                      torch.tensor(scene.present))
    st = scene_statics(scene, pdt, CPU)
    x0 = np.concatenate([scene.history[0, -1], [0.0, 0.0]])
    tt = cfg.traj_tree
    wp = t_make_cost_params(tt.warm, x0, st.cost_lane, scene.target_vel, 64, True, CPU)
    fp = t_make_cost_params(tt.full, x0, st.cost_lane, scene.target_vel, 64, False, CPU)
    return (buf, torch.tensor(scene.types), torch.tensor(scene.present), torch.tensor(x0),
            wp, fp, scene.target_vel, st.lane, st.tgt, st.eval_segs)


def stack(items):
    """Per-scene NamedTuples -> one with a leading scene axis (the episode
    runner's stacking)."""
    return _stack(list(items), CPU)


def jax_batched_payload(params, batched_apply, cfg, ins):
    """mind_tpu's fused_plan_core vmapped over the scenes as MultiScenarioSim
    builds it (every CostParams leaf but grid_n batched), with
    return_exec_payload=True: [S, payload]."""
    import jax
    import jax.numpy as jnp
    from mind_tpu.ops.potential import CostParams
    from mind_tpu.planner.aime_device import DeviceObsBuffer
    from mind_tpu.planner.ilqr import ILQRConfig
    from mind_tpu.planner.planner import fused_plan_core
    from mind_tpu.planner.scene_prep import LaneGraphStatic, TargetLaneStatic

    tt = cfg.traj_tree
    ilqr = ILQRConfig(dt=tt.dt, wheelbase=tt.wheelbase, max_iterations=tt.max_iterations,
                      rel_tol=tt.rel_tol, n_line_search=tt.n_line_search,
                      mu_max=tt.max_reg, dtype=tt.solve_dtype)
    weights = (cfg.comfort_acc_weight, cfg.comfort_str_weight,
               cfg.efficiency_weight, cfg.target_weight)
    j = lambda t: jnp.asarray(t.numpy())
    per_scene = []
    for buf, types, amask, x0, wp, fp, tv, lane, tgt, segs in ins:
        cp = lambda p: CostParams(*(x if isinstance(x, int) else j(x) for x in p))
        per_scene.append((DeviceObsBuffer(*map(j, buf)), j(types), j(amask), j(x0), cp(wp),
                          cp(fp), jnp.float64(tv), LaneGraphStatic(*map(j, lane)),
                          TargetLaneStatic(*map(j, tgt[:3]), jnp.int32(tgt.n_points)),
                          tuple(map(j, segs))))
    stacked = [jax.tree.map(lambda *xs: jnp.stack(xs), *items) if k not in (4, 5) else
               CostParams(**{f: (getattr(items[0], f) if f == "grid_n" else
                                 jnp.stack([getattr(i, f) for i in items]))
                             for f in CostParams._fields})
               for k, items in enumerate(zip(*per_scene))]
    cp_axes = CostParams(**{f: (None if f == "grid_n" else 0) for f in CostParams._fields})
    core = functools.partial(fused_plan_core, batched_apply=batched_apply, cfg=cfg,
                             ilqr_cfg=ilqr, warm_ilqr_cfg=ilqr._replace(
                                 max_iterations=tt.warm_max_iterations),
                             weights=weights, return_exec_payload=True)
    fn = jax.jit(jax.vmap(core, in_axes=(None, 0, 0, 0, 0, cp_axes, cp_axes, 0, 0, 0, 0)))
    return np.asarray(fn(params, *stacked))


@pytest.fixture(scope="module")
def batched64(nets):
    """Both packages' batched plan of the two scenes at float64, and the
    port's S = 1 plan of each."""
    params, batched_apply, net = nets
    jcfg, tcfg = planner_cfgs("float64", "float64")
    ins = [torch_inputs(tcfg, sc) for sc in scenes()]
    want = jax_batched_payload(params, batched_apply, jcfg, ins)
    ilqr, warm = tplanner.ilqr_configs(tcfg)
    kw = dict(cfg=tcfg, ilqr_cfg=ilqr, warm_ilqr_cfg=warm,
              weights=tplanner.selection_weights(tcfg))
    (buf, types, amask, x0, wp, fp, tv, lane, tgt, segs) = zip(*ins)
    report = {}
    got = tplanner.batched_plan_core(
        net, stack(buf), torch.stack(types), torch.stack(amask), torch.stack(x0), stack(wp),
        stack(fp), torch.tensor(tv, dtype=F64), stack(lane), stack(tgt), stack(segs),
        report=report, **kw)
    singles = []
    for args in ins:
        rep = {}
        singles.append((tplanner.fused_plan_core(net, *args, report=rep, **kw).numpy(), rep))
    return want, got.numpy(), report, singles, tcfg


def test_batched_plan_core_matches_jax_vmap(batched64):
    """Per scene: the same ok, iteration count and selected tree (its parent
    row and node mask) as mind_tpu's vmapped cycle, and the control within
    1e-6 (float64: sums in another order)."""
    want, got, report, _, tcfg = batched64
    MN = tcfg.traj_tree.max_cost_nodes
    T = tplanner.MAX_TREES
    assert got.shape == (2, 4)
    trees = report["trees"]
    assert trees.topo.parent.shape[0] == 2 * T and trees.n_trees.shape == (2,)
    for s in range(2):
        assert got[s, 2] == want[s, 2] == 1.0, f"scene {s} ok"
        assert got[s, 3] == want[s, 3], f"scene {s} iterations"
        np.testing.assert_allclose(got[s, :2], want[s, :2], rtol=0, atol=1e-6)
        g = s * T + report["best"][s]
        np.testing.assert_array_equal(trees.topo.parent[g].numpy(),
                                      want[s, 4:4 + MN].astype(np.int64), err_msg=f"scene {s}")
        np.testing.assert_array_equal(trees.topo.node_mask[g].numpy(),
                                      want[s, 4 + MN:4 + 2 * MN] > 0.5, err_msg=f"scene {s}")
    # the scenes differ, and so do their plans
    assert np.abs(got[0, :2] - got[1, :2]).max() > 1e-3


def test_batched_plan_core_equals_single_scene_runs(batched64):
    """Each scene of the batch against the port's own S = 1 cycle: the same
    rounds-independent result (a scene with nothing left to expand goes
    through the other's extra rounds unchanged), tree, iteration count and
    control, to the bit (common/batch_invariant.py)."""
    _, got, report, singles, _ = batched64
    assert report["rounds"] == max(rep["rounds"] for _, rep in singles)
    for s, (out, rep) in enumerate(singles):
        assert report["best"][s] == int(rep["best"]), f"scene {s} tree"
        assert int(report["trees"].n_trees[s]) == int(rep["trees"].n_trees)
        assert got[s].tolist() == out[:4].tolist(), f"scene {s}"


def test_aime_round_leaves_a_finished_scene_unchanged(nets):
    """A scene with no branch flag left goes through a batched round to the
    bit: scene 1's tree is grown alone, then put in a batch with a fresh
    scene 0 for one more round (float64)."""
    params, batched_apply, net = nets
    _, tcfg = planner_cfgs("float64", "float64")
    ins = [torch_inputs(tcfg, sc) for sc in scenes()]
    done, _, rounds = taime.aime_grow_tree(
        net, tcfg, *taime.scene_axis(*(ins[1][i] for i in (0, 1, 2, 7, 8))))
    assert rounds >= 2 and not bool(done.branch_flag.any())
    fresh = taime._init_tree_state(tcfg, 1, A, F64, CPU)
    cat = lambda a, b: (type(a)(*(cat(x, y) for x, y in zip(a, b))) if isinstance(a, tuple)
                        else torch.cat([a, b]))
    calls = []

    def counting(*a):
        calls.append(a[0].shape[0])
        return net(*a)

    # one round of the pair, from (fresh scene 0, finished scene 1)
    args = []
    for i in (0, 1, 2, 7, 8):
        a, b = ins[0][i], ins[1][i]
        args.append(torch.stack([a, b]) if isinstance(a, torch.Tensor) else stack([a, b]))
    tcfg.scen_tree.max_depth, depth = 1, tcfg.scen_tree.max_depth
    try:
        state, _, r = taime.aime_grow_tree(counting, tcfg, *args, init_state=cat(fresh, done))
    finally:
        tcfg.scen_tree.max_depth = depth
    assert r == 1 and calls == [2 * tcfg.scen_tree.max_branch_nodes]
    for f in ("parent", "depth", "prob", "start_t", "duration", "branch_flag", "active",
              "n_nodes"):
        assert torch.equal(getattr(state, f)[1], getattr(done, f)[0]), f
    for a, b in zip(state.slots, done.slots):
        assert torch.equal(a[1], b[0])
    # end flags: the pair's round leaves them; propagation ran once more on both
    assert torch.equal(state.end_flag[1], done.end_flag[0])
    assert int(state.n_nodes[0]) > 1


def per_tree_params(G, device=CPU):
    """Full-phase CostParams of G trees that differ in every kind of leaf:
    grid origin, target speed (des_state), lane (segments and mask) and
    the speed weight; stacked [G, ...], and the list of the G."""
    from mind_tpu_torch.config import TrajTreeConfig

    tt = TrajTreeConfig()
    items = []
    for g in range(G):
        lane = np.stack([np.linspace(-20, 200, 30 + 5 * g), np.full(30 + 5 * g, 0.3 * g)], -1)
        p = t_make_cost_params(tt.full, np.array([0.5 * g, -0.2 * g, 10.0, 0, 0, 0]), lane,
                               10.0 + g, 64, False, device)
        items.append(p._replace(w_des_state=p.w_des_state * (1.0 + 0.25 * g)))
    return stack(items), items


def test_ilqr_per_tree_params_match_jax_vmap():
    """ilqr_solve over G = 4 trees, each with its own CostParams, against
    jax.vmap(ilqr_solve) with every leaf batched (float64): equal iteration
    counts and controls within 1e-9; and against the port solving each tree
    alone with its params shared: within 1e-12."""
    import jax
    import jax.numpy as jnp
    from mind_tpu.ops.potential import CostParams, NodeCostData
    from mind_tpu.planner.ilqr import ILQRConfig, TreeTopology, ilqr_solve

    G = 4
    topo, nodes, _, _, x0 = random_batch(3, G, 24, 3, F64, CPU)
    params, items = per_tree_params(G)
    x0s = x0[None].repeat(G, 1) + torch.tensor([[0.0, 0.1 * g, 0.5 * g, 0, 0, 0]
                                                 for g in range(G)], dtype=F64)
    us0 = torch.zeros((G, topo.parent.shape[1], 2), dtype=F64)
    cfg = tilqr.ILQRConfig(max_iterations=40, dtype="float64")
    _, us, info = tilqr.ilqr_solve(topo, x0s, us0, nodes, params, cfg)
    its = info["iterations"].numpy()
    assert (its > 2).all() and len(set(its.tolist())) > 1

    j = lambda t: jnp.asarray(t.numpy())
    jp = CostParams(*(x if isinstance(x, int) else j(x) for x in params))
    cp_axes = CostParams(**{f: (None if f == "grid_n" else 0) for f in CostParams._fields})
    jcfg = ILQRConfig(**cfg._asdict())
    solve = jax.jit(jax.vmap(lambda t, x, u, n, p: ilqr_solve(t, x, u, n, p, jcfg),
                             in_axes=(0, 0, 0, 0, cp_axes)))
    _, w_us, w_info = solve(TreeTopology(*map(j, topo)), j(x0s), j(us0),
                            NodeCostData(*map(j, nodes)), jp)
    np.testing.assert_array_equal(its, np.asarray(w_info["iterations"]))
    np.testing.assert_allclose(us.numpy(), np.asarray(w_us), rtol=0, atol=1e-9)

    for g in range(G):
        one = lambda t: t[g:g + 1]
        _, us_g, info_g = tilqr.ilqr_solve(tilqr.TreeTopology(*map(one, topo)), x0s[g], one(us0),
                                           tpot.NodeCostData(*map(one, nodes)), items[g], cfg)
        assert int(info_g["iterations"][0]) == its[g]
        np.testing.assert_allclose(us_g[0].numpy(), us[g].numpy(), rtol=0, atol=1e-12)


def test_select_and_align_params():
    """select_trees takes the per-tree leaves at the indices and keeps the
    shared ones; node_aligned views [G, ...] as [G, 1, ...]."""
    params, _ = per_tree_params(3)
    shared = params._replace(**{f: getattr(params, f)[0] for f in tpot.tree_axis_fields(params)})
    assert tpot.tree_axis_fields(shared) == []
    mixed = shared._replace(field_offset=params.field_offset)
    assert tpot.tree_axis_fields(mixed) == ["field_offset"]
    sel = tpot.select_trees(mixed, torch.tensor([2, 2, 0]))
    assert torch.equal(sel.field_offset, params.field_offset[[2, 2, 0]])
    assert sel.w_tgt is shared.w_tgt and sel.grid_n == shared.grid_n
    al = tpot.node_aligned(params, 2)
    assert al.tgt_seg_start.shape == (3, 1) + params.tgt_seg_start.shape[1:]
    assert al.res.shape == (3, 1) and al.grid_n == params.grid_n


@pytest.mark.parametrize("branching", [True, False])
def test_make_tree_batch_matches_jax(branching):
    """The same topologies and cost data as mind_tpu's for a seed (the same
    numpy draws): equal to the bit, float32."""
    from mind_tpu.parallel.scale import make_tree_batch

    kw = dict(n_trees=6, n_nodes=12, max_nodes=16, max_levels=12, max_width=3, n_exo=3, seed=4,
              branching=branching)
    want = make_tree_batch(**kw)
    got = tscale.make_tree_batch(**kw, device="cpu")
    for w, g in zip(want, got):
        for wf, gf in zip(w, g) if isinstance(w, tuple) else [(w, g)]:
            if isinstance(wf, int):
                assert gf == wf
                continue
            assert gf.device == CPU and gf.shape == tuple(np.shape(wf))
            np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))
    assert got[3].dtype == torch.float32 and got[1].ego_mean.dtype == torch.float32


def as_f64(tree):
    return type(tree)(*(t.to(F64) if isinstance(t, torch.Tensor) and t.is_floating_point()
                        else t for t in tree))


@pytest.mark.parametrize("branching", [True, False])
def test_parallel_tree_solve_matches_jax(branching):
    """parallel_tree_solve on a two-shard CPU mesh against mind_tpu's on two
    of its CPU devices, the batch cast to float64 in both: us within 1e-9,
    J within 1e-9 relative; and within 1e-12 of the port's solve on a
    one-shard mesh (one batch of 8 against two of 4)."""
    import jax.numpy as jnp
    from mind_tpu.ops.potential import CostParams, NodeCostData
    from mind_tpu.parallel.mesh import make_mesh
    from mind_tpu.parallel.scale import parallel_tree_solve
    from mind_tpu.planner.ilqr import ILQRConfig, TreeTopology

    topo, nodes, params, x0 = tscale.make_tree_batch(8, 12, 16, 12, 3, 3, seed=2,
                                                     branching=branching, device="cpu")
    nodes, params, x0 = as_f64(nodes), as_f64(params), x0.to(F64)
    cfg = tilqr.ILQRConfig(max_iterations=20)
    us, J = tscale.parallel_tree_solve(tmesh.make_mesh(2, device="cpu"), topo, nodes, params,
                                       x0, cfg)
    assert us.shape == (8, 16, 2) and torch.isfinite(J).all()
    j = lambda t: jnp.asarray(t.numpy())
    w_us, w_J = parallel_tree_solve(
        make_mesh(2), TreeTopology(*map(j, topo)), NodeCostData(*map(j, nodes)),
        CostParams(*(x if isinstance(x, int) else j(x) for x in params)), j(x0),
        ILQRConfig(**cfg._asdict()))
    np.testing.assert_allclose(us.numpy(), np.asarray(w_us), rtol=0, atol=1e-9)
    np.testing.assert_allclose(J.numpy(), np.asarray(w_J), rtol=1e-9, atol=0)
    us1, J1 = tscale.parallel_tree_solve(tmesh.make_mesh(1, device="cpu"), topo, nodes, params,
                                         x0, cfg)
    np.testing.assert_allclose(us1.numpy(), us.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(J1.numpy(), J.numpy(), rtol=1e-12, atol=0)


def test_mesh_helpers():
    """make_mesh on the CPU names the device n times; shard_rollouts cuts
    the leading axis into contiguous equal shards (and raises on a ragged
    cut); replicate copies; without a card, a CUDA mesh raises."""
    mesh = tmesh.make_mesh(2, device="cpu")
    assert mesh.devices == (CPU, CPU) and mesh.axis_names == ("data",)
    x = torch.arange(12).reshape(6, 2)
    tree = tilqr.TreeTopology(x, x > 3, x * 2)
    shards = tmesh.shard_rollouts(mesh, tree)
    assert len(shards) == 2 and torch.equal(shards[1].parent, x[3:])
    assert torch.equal(torch.cat([s.level_table for s in shards]), x * 2)
    with pytest.raises(ValueError, match="divide"):
        tmesh.shard_rollouts(tmesh.make_mesh(4, device="cpu"), tree)
    reps = tmesh.replicate(mesh, tree)
    assert len(reps) == 2 and all(torch.equal(r.parent, x) for r in reps)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.make_mesh()
