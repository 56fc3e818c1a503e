"""The whole plan cycle (fused_plan_core) of the PyTorch port vs mind_tpu's
on a small seeded synthetic scene with the same network weights: the same
`ok`, the same selected tree and a control within 1e-3 (the BASELINE.json
budget) at the float32 defaults; the same selection and iteration count
with the pipeline and the solve in float64."""

import functools

import numpy as np
import pytest
import torch

from mind_tpu_torch.config import NetConfig as TNetConfig, PlannerConfig as TPlannerConfig
from mind_tpu_torch.models.weights import load_scene_pred, params_from_flax
from mind_tpu_torch.planner import aime_device as taime
from mind_tpu_torch.planner import planner as tplanner
from mind_tpu_torch.planner.trajectory_tree import make_cost_params as t_make_cost_params
from mind_tpu_torch.synthetic import scene_statics, synthetic_scene

A, L = 8, 12
SMALL = dict(n_scene_layer=1, n_fpn_scale=2, d_actor=32, d_lane=32,
             d_embed=32, d_rpe=32, n_scene_head=4)
CPU = torch.device("cpu")


def planner_cfgs(pipeline, solve):
    from mind_tpu.config import NetConfig, PlannerConfig

    cfgs = []
    for cls, net in ((PlannerConfig, NetConfig(**SMALL, use_pallas_fusion=False)),
                     (TPlannerConfig, TNetConfig(**SMALL))):
        cfg = cls(net=net, max_actors=A, max_lanes=L, pipeline_dtype=pipeline)
        cfg.scen_tree.max_branch_nodes = 4
        cfg.scen_tree.max_tree_nodes = 32
        cfg.traj_tree.solve_dtype = solve
        cfgs.append(cfg)
    return cfgs


@pytest.fixture(scope="module")
def nets():
    from flax.traverse_util import flatten_dict, unflatten_dict
    from mind_tpu.models import init_scene_pred

    jcfg, tcfg = planner_cfgs("float32", "float32")

    _, params, batched_apply = init_scene_pred(jcfg.net, A, L, seed=1)
    # a random small net predicts near-identical modes, which the merge
    # folds into one tree; a 50x regression head spreads them apart
    flat = {k: np.asarray(v) * (50.0 if k.startswith("params/SceneDecoder_0/Dense_1/") else 1.0)
            for k, v in flatten_dict(params, sep="/").items()}
    params = unflatten_dict(flat, sep="/")
    net = load_scene_pred(tcfg.net, None, CPU)
    net.load_state_dict(params_from_flax(flat))
    return params, batched_apply, net


def jax_plan(params, batched_apply, cfg, scene):
    """mind_tpu's fused_plan_core on the scene. It runs with
    return_exec_payload=True, whose payload carries the selected tree's
    parent row and node mask after the [ctrl, ok, iterations] output."""
    import jax
    import jax.numpy as jnp
    from mind_tpu.planner.aime_device import DeviceObsBuffer, obs_buffer_update
    from mind_tpu.planner.ilqr import ILQRConfig
    from mind_tpu.planner.planner import fused_plan_core
    from mind_tpu.planner.scene_prep import LaneGraphStatic, TargetLaneStatic
    from mind_tpu.planner.trajectory_tree import make_cost_params

    tt = cfg.traj_tree
    pdt = jnp.dtype(cfg.pipeline_dtype)
    ilqr = ILQRConfig(dt=tt.dt, wheelbase=tt.wheelbase, max_iterations=tt.max_iterations,
                      rel_tol=tt.rel_tol, n_line_search=tt.n_line_search,
                      mu_max=tt.max_reg, dtype=tt.solve_dtype)
    warm = ilqr._replace(max_iterations=tt.warm_max_iterations)
    weights = (cfg.comfort_acc_weight, cfg.comfort_str_weight,
               cfg.efficiency_weight, cfg.target_weight)

    buf = DeviceObsBuffer.create(A, pdt)
    for f in range(50):
        buf = obs_buffer_update(buf, jnp.asarray(scene.history[:, f]),
                                jnp.asarray(scene.present))
    st = scene_statics(scene, torch.float64, CPU)
    lane = LaneGraphStatic(jnp.asarray(scene.lane_feats), jnp.asarray(scene.lane_anchors, pdt),
                           jnp.asarray(scene.lane_vecs, pdt), jnp.asarray(scene.lane_mask))
    tgt = TargetLaneStatic(jnp.asarray(st.tgt.points.numpy(), pdt),
                           jnp.asarray(st.tgt.info.numpy(), pdt),
                           jnp.asarray(st.tgt.mask.numpy()), jnp.int32(st.tgt.n_points))
    segs = tuple(jnp.asarray(s.numpy()) for s in st.eval_segs)
    x0_np = np.concatenate([scene.history[0, -1], [0.0, 0.0]])
    tv = scene.target_vel
    wp = make_cost_params(tt.warm, x0_np, st.cost_lane, tv, 64, warm=True)
    fp = make_cost_params(tt.full, x0_np, st.cost_lane, tv, 64, warm=False)

    flat = jax.jit(functools.partial(
        fused_plan_core, batched_apply=batched_apply, cfg=cfg, ilqr_cfg=ilqr,
        warm_ilqr_cfg=warm, weights=weights, return_exec_payload=True))(
            params, buf, jnp.asarray(scene.types), jnp.asarray(scene.present),
            jnp.asarray(x0_np, jnp.float64), wp, fp, tv, lane, tgt, segs)
    flat = np.asarray(flat)
    MN = tt.max_cost_nodes
    return flat[:4], flat[4:4 + MN].astype(np.int64), flat[4 + MN:4 + 2 * MN] > 0.5


def torch_plan(net, cfg, scene):
    pdt = getattr(torch, cfg.pipeline_dtype)
    buf = taime.DeviceObsBuffer.create(A, pdt, CPU)
    for f in range(50):
        buf = taime.obs_buffer_update(buf, torch.tensor(scene.history[:, f]),
                                      torch.tensor(scene.present))
    st = scene_statics(scene, pdt, CPU)
    x0_np = np.concatenate([scene.history[0, -1], [0.0, 0.0]])
    tt = cfg.traj_tree
    wp = t_make_cost_params(tt.warm, x0_np, st.cost_lane, scene.target_vel, 64, True, CPU)
    fp = t_make_cost_params(tt.full, x0_np, st.cost_lane, scene.target_vel, 64, False, CPU)
    ilqr, warm = tplanner.ilqr_configs(cfg)
    report = {}
    out = tplanner.fused_plan_core(
        net, buf, torch.tensor(scene.types), torch.tensor(scene.present),
        torch.tensor(x0_np), wp, fp, scene.target_vel, st.lane, st.tgt, st.eval_segs,
        cfg=cfg, ilqr_cfg=ilqr, warm_ilqr_cfg=warm,
        weights=tplanner.selection_weights(cfg), report=report)
    return out.numpy(), report


@pytest.mark.parametrize("precision", ["float32", "float64"])
def test_plan_cycle_matches_jax(nets, precision):
    params, batched_apply, net = nets
    jcfg, tcfg = planner_cfgs(precision, precision)
    scene = synthetic_scene(seed=8, max_actors=A, max_lanes=L, n_agents=8)
    want, want_parent, want_mask = jax_plan(params, batched_apply, jcfg, scene)
    got, report = torch_plan(net, tcfg, scene)

    assert want[2] == got[2] == 1.0, "ok"
    trees = report["trees"]
    assert int(trees.n_trees) >= 3 and report["rounds"] >= 2
    best = int(report["best"])
    np.testing.assert_array_equal(trees.topo.parent[best].numpy(), want_parent,
                                  err_msg="selected tree")
    np.testing.assert_array_equal(trees.topo.node_mask[best].numpy(), want_mask,
                                  err_msg="selected tree")
    if precision == "float32":
        np.testing.assert_allclose(got[:2], want[:2], rtol=0, atol=1e-3)
    else:
        assert got[3] == want[3], "iterations"
        np.testing.assert_allclose(got[:2], want[:2], rtol=0, atol=1e-6)


def test_entry_points_need_a_device_without_gpu():
    """With no GPU, an entry point called without a device raises instead
    of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is the card")
    tcfg = planner_cfgs("float32", "float32")[1]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_scene_pred(tcfg.net, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        taime.DeviceObsBuffer.create(A)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scene_statics(synthetic_scene(0, A, L, 3), torch.float32)
