"""The host tree generator of the PyTorch port
(planner/scenario_tree.py::ScenarioTreeGenerator) against mind_tpu's on the
tests/test_aime.py setup, with the target lane on y = 0 so that the trees
are not empty (ROADMAP queue C), the same network weights and the pipeline
in float32 and in float64; and against the port's own aime_grow_tree with
the checks of tests/test_aime.py:70-119."""

import numpy as np
import pytest
import torch

from mind_tpu_torch.config import NetConfig as TNetConfig, PlannerConfig as TPlannerConfig
from mind_tpu_torch.models.weights import load_scene_pred, params_from_flax
from mind_tpu_torch.planner import aime_device as taime
from mind_tpu_torch.planner.scenario_tree import ScenarioTreeGenerator
from mind_tpu_torch.planner.scene_prep import LaneGraphStatic as TLane, TargetLaneStatic as TTgt
from test_torch_aime import SMALL, A, L, make_window, statics_np

torch.set_num_threads(2)
# node trajectories, covariances and target points, relative to max(1,
# |value|) (the scaled head's covariances grow past 1e30): the network's
# float32 outputs differ between the packages by float32 sums in another
# order, whatever the pipeline dtype, and the 50x head scales that up
# (measured 2.5e-4 at most, 2e-5 at depth 1); so do the mode
# probabilities, whose float32 values carry into the float64 path
# probabilities (gap ~1e-8)
TOL_TRAJ = 1e-3
TOL_PROB = 1e-6


@pytest.fixture(scope="module")
def nets():
    """mind_tpu's seeded small network with the regression head scaled 50x
    (a random small net predicts near-identical modes, which the merge
    folds into one child), and the port's network with the same weights."""
    from flax.traverse_util import flatten_dict, unflatten_dict
    from mind_tpu.config import NetConfig
    from mind_tpu.models import init_scene_pred

    _, params, batched_apply = init_scene_pred(NetConfig(**SMALL, use_pallas_fusion=False), A,
                                               L, seed=0)
    flat = {k: np.asarray(v) * (50.0 if k.startswith("params/SceneDecoder_0/Dense_1/") else 1.0)
            for k, v in flatten_dict(params, sep="/").items()}
    net = load_scene_pred(TNetConfig(**SMALL), None, torch.device("cpu"))
    net.load_state_dict(params_from_flax(flat))
    return unflatten_dict(flat, sep="/"), batched_apply, net


def configs():
    from mind_tpu.config import PlannerConfig

    jcfg = PlannerConfig(max_actors=A, max_lanes=L)
    tcfg = TPlannerConfig(net=TNetConfig(**SMALL), max_actors=A, max_lanes=L)
    for c in (jcfg, tcfg):
        c.scen_tree.max_branch_nodes = 4
        c.scen_tree.max_tree_nodes = 32
    return jcfg, tcfg


def inputs(pipeline):
    """The window, types, mask and statics as numpy arrays of the pipeline
    dtype (the root covariance in float32, as tests/test_aime.py gives it)."""
    pos, ang, vel = make_window()
    types = np.zeros((A, 7), np.float32)
    types[:, 0] = 1
    amask = np.ones(A, bool)
    anchors, pts, n = statics_np()
    dt = np.float64 if pipeline == "float64" else np.float32
    return (pos.astype(dt), ang.astype(dt), vel.astype(dt), types, amask,
            anchors.astype(dt), pts.astype(dt), n, dt)


def port_generator(net, tcfg, pipeline):
    pos, ang, vel, types, amask, anchors, pts, n, dt = inputs(pipeline)
    td = torch.float64 if dt == np.float64 else torch.float32
    lane = TLane(node_feats=torch.zeros((L, 10, 16)), anchors_g=torch.tensor(anchors),
                 anchor_vecs_g=torch.tensor([[1.0, 0.0]], dtype=td).repeat(L, 1),
                 mask=torch.ones(L, dtype=torch.bool))
    tgt = TTgt(points=torch.tensor(pts), info=torch.zeros((256, 12), dtype=td),
               mask=torch.tensor(np.arange(256) < n), n_points=n)
    gen = ScenarioTreeGenerator(tcfg, net, lane, tgt, A)
    window = (torch.tensor(pos), torch.tensor(ang), torch.tensor(vel),
              torch.full((A, 50), 1e-5, dtype=torch.float32), torch.ones((A, 50)))
    return gen, window, torch.tensor(types), torch.tensor(amask), lane, tgt


def tree_summary(trees):
    """Per tree, per node in key order: (key, parent, duration, norm_prob,
    traj, cov, tgt_pts)."""
    return [[(k, nd.parent_key, nd.data[1].shape[1], float(nd.data[0]), nd.data[1],
              nd.data[2], nd.data[3]) for k, nd in sorted(t.nodes.items())] for t in trees]


@pytest.mark.parametrize("pipeline", ["float32", "float64"])
def test_host_generator_matches_jax(nets, pipeline):
    import jax.numpy as jnp
    from mind_tpu.planner.scenario_tree import ScenarioTreeGenerator as JGenerator
    from mind_tpu.planner.scene_prep import LaneGraphStatic, TargetLaneStatic

    params, batched_apply, net = nets
    jcfg, tcfg = configs()
    pos, ang, vel, types, amask, anchors, pts, n, dt = inputs(pipeline)
    jd = jnp.float64 if dt == np.float64 else jnp.float32
    lane = LaneGraphStatic(node_feats=jnp.zeros((L, 10, 16), jnp.float32),
                           anchors_g=jnp.asarray(anchors),
                           anchor_vecs_g=jnp.tile(jnp.asarray([[1.0, 0.0]], jd), (L, 1)),
                           mask=jnp.ones(L, bool))
    tgt = TargetLaneStatic(points=jnp.asarray(pts), info=jnp.zeros((256, 12), jd),
                           mask=jnp.asarray(np.arange(256) < n), n_points=jnp.int32(n))
    jgen = JGenerator(jcfg, batched_apply, params, lane, tgt, A)
    jtrees = jgen.branch_aime(
        (jnp.asarray(pos), jnp.asarray(ang), jnp.asarray(vel),
         jnp.full((A, 50), 1e-5, jnp.float32), jnp.ones((A, 50), jnp.float32)),
        jnp.asarray(types), jnp.asarray(amask))

    gen, window, t_types, t_amask, _, _ = port_generator(net, tcfg, pipeline)
    ttrees = gen.branch_aime(window, t_types, t_amask)

    assert len(jtrees) >= 1 and len(ttrees) == len(jtrees)
    worst = prob_gap = 0.0
    for got, want in zip(tree_summary(ttrees), tree_summary(jtrees)):
        assert [g[:3] for g in got] == [w[:3] for w in want]   # keys, parents, durations
        for g, w in zip(got, want):
            prob_gap = max(prob_gap, abs(g[3] - w[3]))          # norm_prob
            for a, b in zip(g[4:], w[4:]):
                b = np.asarray(b, np.float64)
                rel = np.abs(a - b) / np.maximum(1.0, np.abs(b))
                worst = max(worst, float(rel.max(initial=0.0)))
    n_nodes = sum(len(t) for t in tree_summary(ttrees))
    print(f"host generator {pipeline}: {len(ttrees)} trees, {n_nodes} nodes, max gap "
          f"{worst:.3e} (tolerance {TOL_TRAJ}), norm_prob {prob_gap:.3e} ({TOL_PROB})")
    assert n_nodes > len(ttrees)
    assert worst <= TOL_TRAJ and prob_gap <= TOL_PROB


def test_host_generator_matches_device_aime(nets):
    """tests/test_aime.py:70-119 on the port alone: the same number of trees,
    the same multiset of (duration, norm_prob rounded to 1e-4) and the
    root-child trajectories within 2e-3 m."""
    _, _, net = nets
    _, tcfg = configs()
    gen, window, types, amask, lane, tgt = port_generator(net, tcfg, "float32")
    host_trees = gen.branch_aime(window, types, amask)

    buf = taime.DeviceObsBuffer(pos=window[0], ang=window[1], vel=window[2],
                                observed=torch.ones((A, 50), dtype=torch.bool))
    state, meta, _ = taime.aime_grow_tree(net, tcfg, *taime.scene_axis(buf, types, amask, lane,
                                                                         tgt))
    end, tid = meta.end_flag[0].numpy().copy(), meta.tree_id[0].numpy()
    end[0] = False   # the root, which the host trees do not hold
    dur, nprob = meta.duration[0].numpy(), meta.norm_prob[0].numpy()
    assert len({int(t) for t in tid if t >= 0}) == len(host_trees) >= 1
    dev_nodes = sorted((int(dur[i]), round(float(nprob[i]), 4)) for i in np.flatnonzero(end))
    host_nodes = sorted((nd.data[1].shape[1], round(float(nd.data[0]), 4))
                        for t in host_trees for nd in t.nodes.values())
    assert dev_nodes == host_nodes
    host_rc = {(t.get_root().data[1].shape[1], round(float(t.get_root().data[0]), 4)):
               t.get_root().data[1] for t in host_trees}
    depth = state.depth[0].numpy()
    for i in np.flatnonzero(end & (depth == 1)):
        key = (int(dur[i]), round(float(nprob[i]), 4))
        np.testing.assert_allclose(state.slots.pos[0, i, :, 50:50 + int(dur[i])].numpy(),
                                   host_rc[key], atol=2e-3)
