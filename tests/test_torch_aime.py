"""AIME tree growth of the PyTorch port vs mind_tpu's aime_grow_tree on the
tests/test_aime.py setup (same window, lane graph, target lane and network
weights), with the pipeline in float32 and in float64; plus the
observation-window fill."""

import numpy as np
import pytest
import torch

from mind_tpu_torch.config import NetConfig as TNetConfig, PlannerConfig as TPlannerConfig
from mind_tpu_torch.models.weights import load_scene_pred, params_from_flax
from mind_tpu_torch.planner import aime_device as taime
from mind_tpu_torch.planner.scene_prep import LaneGraphStatic as TLane, TargetLaneStatic as TTgt

A, L = 6, 12
SMALL = dict(n_scene_layer=1, n_fpn_scale=2, d_actor=32, d_lane=32,
             d_embed=32, d_rpe=32, n_scene_head=4)
CPU = torch.device("cpu")


def make_window(seed=0):
    """Agents drive along +x near the target lane (tests/test_aime.py)."""
    rng = np.random.default_rng(seed)
    t = np.arange(50) * 0.1
    pos = np.zeros((A, 50, 2), np.float32)
    for a in range(A):
        speed = rng.uniform(2, 6)
        y0 = rng.uniform(-3, 3)
        pos[a, :, 0] = -20 + a * 5 + speed * t
        pos[a, :, 1] = y0 + 0.1 * rng.normal(size=50).cumsum() * 0.1
    ang = np.zeros((A, 50), np.float32)
    vel = np.zeros((A, 50, 2), np.float32)
    vel[..., 0] = np.gradient(pos[..., 0], 0.1, axis=1)
    return pos, ang, vel


def statics_np():
    """tests/test_aime.py's lane graph and target lane, except that the
    target lane lies on y = 0: there its y stays at the 1e6 padding value,
    the target-lane prune removes every child and the tree is empty."""
    anchors = np.random.default_rng(0).normal(0, 20, (L, 2)).astype(np.float32)
    P, n = 256, 200
    pts = np.full((P, 2), 1e6, np.float32)
    pts[:n, 0] = np.arange(n) - 50.0
    pts[:n, 1] = 0.0
    return anchors, pts, n


@pytest.fixture(scope="module")
def nets():
    from flax.traverse_util import flatten_dict
    from mind_tpu.config import NetConfig
    from mind_tpu.models import init_scene_pred

    jcfg = NetConfig(**SMALL, use_pallas_fusion=False)
    _, params, batched_apply = init_scene_pred(jcfg, A, L, seed=0)
    net = load_scene_pred(TNetConfig(**SMALL), None, CPU)
    net.load_state_dict(params_from_flax(
        {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}))
    return params, batched_apply, net


@pytest.mark.parametrize("pipeline", ["float32", "float64"])
def test_aime_matches_jax(nets, pipeline):
    import jax
    import jax.numpy as jnp
    from mind_tpu.config import PlannerConfig
    from mind_tpu.planner.aime_device import DeviceObsBuffer, aime_grow_tree
    from mind_tpu.planner.scene_prep import LaneGraphStatic, TargetLaneStatic

    params, batched_apply, net = nets
    jcfg = PlannerConfig(max_actors=A, max_lanes=L)
    jcfg.scen_tree.max_branch_nodes = 4
    jcfg.scen_tree.max_tree_nodes = 32
    tcfg = TPlannerConfig(net=TNetConfig(**SMALL), max_actors=A, max_lanes=L)
    tcfg.scen_tree.max_branch_nodes = 4
    tcfg.scen_tree.max_tree_nodes = 32

    pos, ang, vel = make_window()
    types = np.zeros((A, 7), np.float32)
    types[:, 0] = 1
    amask = np.ones(A, bool)
    anchors, pts, n = statics_np()
    jd = jnp.float64 if pipeline == "float64" else jnp.float32
    td = torch.float64 if pipeline == "float64" else torch.float32

    lane = LaneGraphStatic(node_feats=jnp.zeros((L, 10, 16), jnp.float32),
                           anchors_g=jnp.asarray(anchors, jd),
                           anchor_vecs_g=jnp.tile(jnp.asarray([[1.0, 0.0]], jd), (L, 1)),
                           mask=jnp.ones(L, bool))
    tgt = TargetLaneStatic(points=jnp.asarray(pts, jd), info=jnp.zeros((256, 12), jd),
                           mask=jnp.asarray(np.arange(256) < n), n_points=jnp.int32(n))
    buf = DeviceObsBuffer(pos=jnp.asarray(pos, jd), ang=jnp.asarray(ang, jd),
                          vel=jnp.asarray(vel, jd), observed=jnp.ones((A, 50), bool))
    state, meta = jax.jit(lambda p, b: aime_grow_tree(
        p, batched_apply, jcfg, b, jnp.asarray(types), jnp.asarray(amask), lane, tgt)
    )(params, buf)

    t_lane = TLane(node_feats=torch.zeros((L, 10, 16)),
                   anchors_g=torch.tensor(anchors, dtype=td),
                   anchor_vecs_g=torch.tensor([[1.0, 0.0]], dtype=td).repeat(L, 1),
                   mask=torch.ones(L, dtype=torch.bool))
    t_tgt = TTgt(points=torch.tensor(pts, dtype=td), info=torch.zeros((256, 12), dtype=td),
                 mask=torch.tensor(np.arange(256) < n), n_points=n)
    t_buf = taime.DeviceObsBuffer(pos=torch.tensor(pos, dtype=td),
                                  ang=torch.tensor(ang, dtype=td),
                                  vel=torch.tensor(vel, dtype=td),
                                  observed=torch.ones((A, 50), dtype=torch.bool))
    t_state, t_meta, rounds = taime.aime_grow_tree(
        net, tcfg, t_buf, torch.tensor(types), torch.tensor(amask), t_lane, t_tgt)

    end = np.asarray(meta.end_flag)
    assert rounds >= 1 and end.sum() > 1
    for name in ("parent", "duration", "end_flag", "tree_id"):
        np.testing.assert_array_equal(getattr(t_meta, name).numpy(),
                                      np.asarray(getattr(meta, name)), err_msg=name)
    np.testing.assert_array_equal(t_state.depth.numpy(), np.asarray(state.depth))
    assert int(t_meta.n_nodes) == int(meta.n_nodes)
    np.testing.assert_allclose(t_meta.norm_prob.numpy(), np.asarray(meta.norm_prob),
                               rtol=0, atol=1e-9)
    # end-node slot trajectories (prediction part)
    for i in np.flatnonzero(end):
        d = int(np.asarray(meta.duration)[i])
        np.testing.assert_allclose(t_state.slots.pos[i, :, 50:50 + d].numpy(),
                                   np.asarray(state.slots.pos[i])[:, 50:50 + d],
                                   rtol=0, atol=1e-4)


def test_obs_buffer_fill_matches_jax():
    import jax.numpy as jnp
    from mind_tpu.planner.aime_device import DeviceObsBuffer, nn_fill_window, obs_buffer_update

    rng = np.random.default_rng(4)
    jbuf = DeviceObsBuffer.create(5)
    tbuf = taime.DeviceObsBuffer.create(5, device=CPU)
    for _ in range(60):
        states = rng.normal(0, 10, (5, 4))
        present = rng.random(5) > 0.4
        jbuf = obs_buffer_update(jbuf, jnp.asarray(states), jnp.asarray(present))
        tbuf = taime.obs_buffer_update(tbuf, torch.tensor(states), torch.tensor(present))
    for got, want in zip(taime.nn_fill_window(tbuf), nn_fill_window(jbuf)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_scene_prep_and_decode_match_jax():
    """prepare_node_inputs and _decode_node on three nodes with random
    network outputs, one of them at cur_t = 60 (an unused branch slot, whose
    out-of-range cov index JAX clamps), float64 pipeline."""
    import jax
    import jax.numpy as jnp
    from mind_tpu.config import ScenTreeConfig
    from mind_tpu.planner.scenario_tree import _decode_node as j_decode
    from mind_tpu.planner.scene_prep import (LaneGraphStatic, TargetLaneStatic,
                                             prepare_node_inputs as j_prep)
    from mind_tpu_torch.planner.scenario_tree import _decode_node as t_decode
    from mind_tpu_torch.planner.scene_prep import prepare_node_inputs as t_prep

    rng = np.random.default_rng(7)
    B, M, F = 3, 6, 60
    wins = [make_window(s) for s in range(B)]
    pos, ang, vel = (np.stack(x).astype(np.float64) for x in zip(*wins))
    ang += rng.normal(0, 0.1, ang.shape)
    obs = (rng.random((B, A, 50)) > 0.1).astype(np.float32)
    cov = rng.uniform(1e-5, 0.5, (B, A, 50))
    types = np.eye(7, dtype=np.float32)[rng.integers(0, 7, A)]
    amask = np.array([True, True, False, True, True, True])
    anchors, pts, n = statics_np()
    info = rng.random((256, 12))
    feats = rng.normal(0, 1, (L, 10, 16)).astype(np.float32)
    cls = rng.dirichlet(np.ones(M), B).astype(np.float32)
    reg = rng.normal(0, 3, (B, A, M, F, 5)).astype(np.float32)
    reg[..., 2:4] = np.exp(rng.normal(-1, 1, (B, A, M, F, 2)))
    velp = rng.normal(0, 3, (B, A, M, F, 2)).astype(np.float32)
    parent_prob = np.array([1.0, 0.3, 0.05])
    cur_t = np.array([0, 20, 60])
    cfg = ScenTreeConfig()

    lane = LaneGraphStatic(jnp.asarray(feats), jnp.asarray(anchors, jnp.float64),
                           jnp.tile(jnp.asarray([[0.6, 0.8]]), (L, 1)), jnp.ones(L, bool))
    tgt = TargetLaneStatic(jnp.asarray(pts, jnp.float64), jnp.asarray(info),
                           jnp.asarray(np.arange(256) < n), jnp.int32(n))
    prep = jax.vmap(lambda p, a, v, o: j_prep(p, a, v, o, jnp.asarray(types),
                                               jnp.asarray(amask), lane, tgt, 5.0))(
        jnp.asarray(pos), jnp.asarray(ang), jnp.asarray(vel), jnp.asarray(obs))
    want = jax.vmap(lambda c, r, v, i, wp, wa, wv, wc, pp, ct: j_decode(
        c, r, v, i, wp, wa, wv, wc, pp, ct, jnp.asarray(amask), tgt, cfg))(
        jnp.asarray(cls), jnp.asarray(reg), jnp.asarray(velp), prep, jnp.asarray(pos),
        jnp.asarray(ang), jnp.asarray(vel), jnp.asarray(cov), jnp.asarray(parent_prob),
        jnp.asarray(cur_t))

    t_lane = TLane(torch.tensor(feats), torch.tensor(anchors, dtype=torch.float64),
                   torch.tensor([[0.6, 0.8]], dtype=torch.float64).repeat(L, 1),
                   torch.ones(L, dtype=torch.bool))
    t_tgt = TTgt(torch.tensor(pts, dtype=torch.float64), torch.tensor(info),
                 torch.tensor(np.arange(256) < n), n)
    t_in = t_prep(torch.tensor(pos), torch.tensor(ang), torch.tensor(vel), torch.tensor(obs),
                  torch.tensor(types), torch.tensor(amask), t_lane, t_tgt, 5.0)
    for name in ("actors", "rpe", "tgt_nodes", "tgt_rpe", "actor_ctrs", "tgt_pts"):
        np.testing.assert_allclose(getattr(t_in, name).numpy(), np.asarray(getattr(prep, name)),
                                   rtol=1e-9, atol=1e-9, err_msg=name)
    got = t_decode(torch.tensor(cls), torch.tensor(reg), torch.tensor(velp), t_in,
                   torch.tensor(pos), torch.tensor(ang), torch.tensor(vel), torch.tensor(cov),
                   torch.tensor(parent_prob), torch.tensor(cur_t), torch.tensor(amask),
                   t_tgt, cfg)
    # the case exercises both prune outcomes and branch times before 60
    assert got.keep.any() and not got.keep.all() and (got.t_b < 60).any()
    for name in ("keep", "t_b"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    for name in ("pos", "ang", "vel", "cov", "prob"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-9, atol=1e-6, err_msg=name)
