"""The native float64 exec re-solve of the PyTorch port (mind_tpu_torch/native)
against mind_tpu.native and mind_tpu's planner: the C++ solves on the random
tree problems of tests/test_native.py (the same source, so equal to 1e-12),
the packed phase parameters, the exec payload's layout and size check,
fused_plan_core's payload at float64, and MINDPlanner with
exec_resolve_mode="native" on the small synthetic AV2 world, on the staged
and the fused path.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mind_tpu_torch import native as tnative
from mind_tpu_torch.config import TrajTreeConfig as TTrajTreeConfig
from mind_tpu_torch.planner.trajectory_tree import make_cost_params as t_make_cost_params
from test_torch_plan_cycle import jax_payload, nets, planner_cfgs, torch_plan  # noqa: F401
from test_torch_planner import world  # noqa: F401
from mind_tpu_torch.synthetic import synthetic_scene

torch.set_num_threads(2)

SOLVE = dict(dt=0.2, wb=2.5, rel_tol=1e-6, n_line_search=10, mu_max=1e10)


def tree_args(arr, lane):
    return (arr["parents"], arr["prob"], arr["ego_mean"], arr["ego_cov"], arr["exo_mean"],
            arr["exo_cov"], arr["exo_mask"], lane)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_native_solves_match_jax(seed):
    """The single-phase and the two-phase solve of both packages' libraries
    (built from the same C++ source) on one random tree problem: the same
    iteration counts, xs/us within 1e-12."""
    from mind_tpu import native as jnative
    from test_native import _flat_params, _synthetic_problem

    _, params, arr, lane = _synthetic_problem(seed)
    warm = dataclasses.replace(params, w_ego=0.0, w_exo=0.0)
    x0 = np.array([0.0, 0.0, 7.0, 0.05, 0.0, 0.0])
    us0 = np.zeros((len(arr["parents"]), 2))
    one = [mod.ilqr_solve(*tree_args(arr, lane), x0, us0, _flat_params(mod, params),
                          max_iterations=100, **SOLVE) for mod in (tnative, jnative)]
    two = [mod.two_phase_solve(*tree_args(arr, lane), x0, _flat_params(mod, warm),
                               _flat_params(mod, params), warm_max_iterations=40,
                               max_iterations=100, **SOLVE) for mod in (tnative, jnative)]
    for (txs, tus, tinfo), (jxs, jus, jinfo) in (one, two):
        assert tinfo["iterations"] == jinfo["iterations"] > 1
        assert tinfo.get("warm_iterations") == jinfo.get("warm_iterations")
        np.testing.assert_allclose(txs, jxs, rtol=0, atol=1e-12)
        np.testing.assert_allclose(tus, jus, rtol=0, atol=1e-12)
    assert tnative.load() is tnative.load()
    assert tnative._library_path().parent.name == "_build"


def test_pack_cost_params_matches_jax():
    """The port's CostParams (float64 tensors) and mind_tpu's pack into the
    same 42-double blocks and target-lane points, for both phases and with
    a grid origin given apart."""
    from mind_tpu import native as jnative
    from mind_tpu.config import TrajTreeConfig
    from mind_tpu.planner.trajectory_tree import make_cost_params

    rng = np.random.default_rng(3)
    lane = np.cumsum(rng.normal(0, 2.0, (30, 2)), 0)
    x0 = np.array([3.0, -2.0, 6.0, 0.1, 0.0, 0.0])
    jtt, ttt = TrajTreeConfig(), TTrajTreeConfig()
    jtt.full.w_des_velocity = ttt.full.w_des_velocity = 0.5
    for jph, tph, warm in ((jtt.warm, ttt.warm, True), (jtt.full, ttt.full, False)):
        jp = make_cost_params(jph, x0, lane, 7.5, 64, warm=warm)
        tp = t_make_cost_params(tph, x0, lane, 7.5, 64, warm, "cpu")
        for off in (None, np.array([-48.5, 12.25])):
            (tf, tpts), (jf, jpts) = tnative.pack_cost_params(tp, off), \
                jnative.pack_cost_params(jp, off)
            np.testing.assert_array_equal(tf, jf)
            np.testing.assert_array_equal(tpts, jpts)
            assert tf.shape == (tnative.N_PHASE_PARAMS,) and len(tpts) == 30


def test_exec_payload_round_trip_and_size_check():
    rng = np.random.default_rng(0)
    MN, E = 7, 3
    parts = dict(out=rng.normal(size=4), parent=np.arange(-1, MN - 1),
                 node_mask=np.arange(MN) < 5, prob=rng.random(MN),
                 ego_mean=rng.normal(size=(MN, 2)), ego_cov=rng.random(MN),
                 exo_mean=rng.normal(size=(MN, E, 2)), exo_cov=rng.random((MN, E)),
                 exo_mask=rng.random((MN, E)) > 0.5)
    flat = tnative.pack_exec_payload(*(torch.tensor(v) for v in parts.values())).numpy()
    assert flat.dtype == np.float64 and flat.size == tnative.payload_size(MN, E) \
        == 4 + MN * 6 + MN * E * 4
    got = tnative.unpack_exec_payload(flat, MN, E)
    for k, v in parts.items():
        np.testing.assert_array_equal(getattr(got, k), v, err_msg=k)
    assert got.parent.dtype == np.int32 and got.exo_mask.dtype == bool
    for bad in (flat[:-1], np.concatenate([flat, [0.0]]), flat.reshape(1, -1)):
        with pytest.raises(ValueError, match="exec payload"):
            tnative.unpack_exec_payload(bad, MN, E)


def test_fused_plan_core_payload_matches_jax(nets):
    """fused_plan_core(return_exec_payload=True) of both packages on the
    plan-cycle test's scene with the pipeline and the solve in float64: the
    same layout, winner tree (parent row, node mask) and exo mask, and the 4
    numbers as the float64 plan-cycle test holds them (control within 1e-6,
    iterations equal). The cost-node data are the network's predictions,
    which both packages compute in float32 with sums in another order, so
    they agree to float32 rounding as the float64 planner test holds the
    scenario tree: probabilities within 1e-6 (measured 9.9e-8), positions
    within 5e-4 m (measured 1.2e-4 m of 111 m), the covariances of the 50x
    head (up to 1e27) within 1e-3 relative (measured 4.3e-5)."""
    params, batched_apply, net = nets
    jcfg, tcfg = planner_cfgs("float64", "float64")
    scene = synthetic_scene(seed=8, max_actors=8, max_lanes=12, n_agents=8)
    want = jax_payload(params, batched_apply, jcfg, scene)
    got, report = torch_plan(net, tcfg, scene, return_exec_payload=True)
    MN, E = tcfg.traj_tree.max_cost_nodes, tcfg.max_actors - 1
    assert got.dtype == np.float64 and got.shape == want.shape == (tnative.payload_size(MN, E),)
    g, w = tnative.unpack_exec_payload(got, MN, E), tnative.unpack_exec_payload(want, MN, E)
    assert g.out[2] == w.out[2] == 1.0 and g.out[3] == w.out[3]
    np.testing.assert_allclose(g.out[:2], w.out[:2], rtol=0, atol=1e-6)
    assert int(report["trees"].n_trees) >= 3
    for f in ("parent", "node_mask", "exo_mask"):
        np.testing.assert_array_equal(getattr(g, f), getattr(w, f), err_msg=f)
    assert g.node_mask.sum() > 10
    np.testing.assert_allclose(g.prob, w.prob, rtol=0, atol=1e-6)
    for f in ("ego_mean", "exo_mean"):
        np.testing.assert_allclose(getattr(g, f), getattr(w, f), rtol=0, atol=5e-4, err_msg=f)
    for f in ("ego_cov", "exo_cov"):
        np.testing.assert_allclose(getattr(g, f), getattr(w, f), rtol=1e-3, atol=0, err_msg=f)


def native_agents(world, pipeline="float64"):
    j, t = world.agents(pipeline, "float32", exec_resolve_mode="native")
    world.feed(j, t)
    return j, t


@pytest.mark.parametrize("path", ["staged", "fused"])
def test_planner_native_matches_jax(world, path):
    """MINDPlanner with exec_resolve_mode="native" in both packages, the
    pipeline in float64 and the selection solves in float32: the same tree,
    controls within 1e-7 (the same C++ solver on cost data that agrees to
    float64 rounding), timed under "exec_native"."""
    j, t = native_agents(world)
    export = path == "staged"
    j.planner.export_trees = t.planner.export_trees = export
    jok, jctrl, jres = j.planner.plan()
    tok, tctrl, tres = t.planner.plan()
    assert jok and tok
    if export:
        assert tres[0][0].get_root_key() == jres[0][0].get_root_key(), "selected tree"
    np.testing.assert_allclose(tctrl, jctrl, rtol=0, atol=1e-7)
    assert t.planner.metrics.timer.counts["exec_native"] == 1
    assert "exec_resolve" not in t.planner.metrics.timer.totals


def test_native_matches_scratch_resolve(world):
    """The port's native re-solve against its own device 'scratch' float64
    re-solve of the same plan (the check chip_smoke.py makes on the card):
    within 1e-7, as tests/test_native.py holds mind_tpu's."""
    _, t = native_agents(world, "float32")
    ok, ctrl_native, _ = t.planner.plan()
    _, s = native_agents(world, "float32")
    s.planner.cfg.traj_tree.exec_resolve_mode = "scratch"
    s.planner.cfg.traj_tree.exec_solve_dtype = "float64"
    s.planner._init_programs()
    ok_s, ctrl_scratch, _ = s.planner.plan()
    assert ok and ok_s
    assert s.planner.metrics.timer.counts["exec_resolve"] == 1
    np.testing.assert_allclose(ctrl_native, ctrl_scratch, rtol=0, atol=1e-7)
