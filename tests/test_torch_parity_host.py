"""The port's copies of the mirror's numpy modules (mind_tpu_torch/parity/
host_scene.py and host_ilqr.py) against mind_tpu's on seeded inputs: every
function equal to the bit (gap 0.0, tolerance 0), host_ilqr_solve's
iteration count, cost and trajectories included."""

import numpy as np
import pytest

from mind_tpu_torch.config import ScenTreeConfig as TScenTreeConfig
from mind_tpu_torch.parity import host_ilqr as t_ilqr
from mind_tpu_torch.parity import host_scene as t_scene

A, L, P = 6, 12, 256


def window(seed=0):
    """Agents driving along +x near the target lane (tests/test_aime.py's
    window, in float64)."""
    rng = np.random.default_rng(seed)
    t = np.arange(50) * 0.1
    pos = np.zeros((A, 50, 2))
    for a in range(A):
        pos[a, :, 0] = -20 + a * 5 + rng.uniform(2, 6) * t
        pos[a, :, 1] = rng.uniform(-3, 3) + 0.01 * rng.normal(size=50).cumsum()
    vel = np.gradient(pos, 0.1, axis=1)
    ang = np.arctan2(vel[..., 1], vel[..., 0])
    observed = (rng.random((A, 50)) > 0.1).astype(float)
    return pos, ang, vel, observed


def statics(seed=0):
    rng = np.random.default_rng(seed + 1)
    types = np.eye(7)[rng.integers(0, 7, A)]
    lane_feats = rng.normal(size=(L, 10, 16))
    anchors = rng.normal(0, 20, (L, 2))
    vecs = rng.normal(size=(L, 2))
    vecs /= np.linalg.norm(vecs, axis=-1, keepdims=True)
    n = 200
    tgt_points = np.full((P, 2), 1e6)
    tgt_points[:n, 0] = np.arange(n) - 50.0
    tgt_points[:n, 1] = 0.3 * np.sin(np.arange(n) / 20.0)
    tgt_info = rng.normal(size=(P, 12))
    return types, lane_feats, anchors, vecs, tgt_points, tgt_info, n


def assert_same(got, want, name=""):
    """Equal to the bit: every array, scalar and dataclass field."""
    if hasattr(want, "__dataclass_fields__"):
        for f in want.__dataclass_fields__:
            assert_same(getattr(got, f), getattr(want, f), f"{name}.{f}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), name
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{name}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=name)


def test_rpe_and_high_level_command_equal():
    from mind_tpu.parity import host_scene as j_scene

    rng = np.random.default_rng(2)
    ctrs, vecs = rng.normal(0, 30, (20, 2)), rng.normal(size=(20, 2))
    assert_same(t_scene.make_rpe_np(ctrs, vecs), j_scene.make_rpe_np(ctrs, vecs))
    _, _, _, _, pts, info, n = statics()
    for orig, vel in (((-10.0, 0.5), 3.0), ((40.0, -1.0), 0.1), ((140.0, 0.0), 9.0)):
        orig = np.asarray(orig)
        rot = t_scene.rot_of(0.2)
        got = t_scene.high_level_command_np(pts, info, n, orig, rot, vel, 5.0)
        want = j_scene.high_level_command_np(pts, info, n, orig, rot, vel, 5.0)
        assert_same(got, want, f"hlc at {orig}")
    assert_same(t_scene.wrap(np.linspace(-10, 10, 41)), j_scene.wrap(np.linspace(-10, 10, 41)))


@pytest.fixture(scope="module")
def prepared():
    from mind_tpu.parity import host_scene as j_scene

    pos, ang, vel, obs = window()
    types, feats, anchors, vecs, pts, info, n = statics()
    args = (pos, ang, vel, obs, types, feats, anchors, vecs, pts, info, n, 5.0)
    return t_scene.prepare_node_inputs_np(*args), j_scene.prepare_node_inputs_np(*args)


def test_prepare_node_inputs_equal(prepared):
    got, want = prepared
    assert_same(got, want, "prep")
    assert np.isfinite(got.rpe).all() and got.actors.shape == (A, 48, 14)


@pytest.mark.parametrize("cur_t", [0, 12, 40])
def test_decode_node_equal(prepared, cur_t):
    """decode_node_np on random network outputs, at the root and at two
    later branch times (the mirror expands only nodes with cur_t < 60)."""
    from mind_tpu.config import ScenTreeConfig
    from mind_tpu.parity import host_scene as j_scene

    got_in, want_in = prepared
    rng = np.random.default_rng(cur_t)
    M = 6
    cls = rng.dirichlet(np.ones(M))
    reg = rng.normal(0, 2, (A, M, 60, 5))
    reg[..., 0] = np.cumsum(np.abs(reg[..., 0]), axis=2) * 0.3    # ahead, near the lane
    reg[..., 1] *= 0.2
    reg[..., 2:4] = np.abs(reg[..., 2:4]) * np.linspace(0.1, 3, 60)[:, None]
    vel_pred = rng.normal(0, 3, (A, M, 60, 2))
    pos, ang, vel, _ = window(1)
    cov = np.full((A, 50), 1e-5) + np.linspace(0, 0.2, 50)
    amask = np.array([True, True, False, True, True, True])
    _, _, _, _, pts, _, n = statics()
    common = (pos, ang, vel, cov, 0.7, cur_t, amask, pts, n)
    got = t_scene.decode_node_np(cls, reg, vel_pred, got_in, *common, TScenTreeConfig())
    want = j_scene.decode_node_np(cls, reg, vel_pred, want_in, *common, ScenTreeConfig())
    assert_same(got, want, "decode")
    assert got.keep.any()


def test_obs_buffer_equal():
    """A stream with late, vanishing and overflowing tracks."""
    from mind_tpu.parity import host_scene as j_scene
    from mind_tpu.planner.planner import type_onehot as j_onehot

    from mind_tpu_torch.planner.planner import type_onehot as t_onehot

    rng = np.random.default_rng(5)
    tb, jb = t_scene.HostObsBuffer(4), j_scene.HostObsBuffer(4)
    kinds = ["vehicle", "pedestrian", "bus", "static", "cyclist"]
    from mind_tpu.data.av2 import ObjectType as JType

    from mind_tpu_torch.data.av2 import ObjectType as TType

    for step in range(60):
        ids = [i for i in range(6) if rng.random() > 0.3 or (i == 0 and step > 2)]
        states = {i: rng.normal(0, 10, 4) for i in ids}
        tb.update([(f"t{i}", states[i], TType(kinds[i % 5])) for i in ids], t_onehot)
        jb.update([(f"t{i}", states[i], JType(kinds[i % 5])) for i in ids], j_onehot)
        assert tb.slots == jb.slots
        for f in ("types", "active", "last_present", "pos", "ang", "vel", "observed"):
            assert_same(getattr(tb, f), getattr(jb, f), f)
        assert_same(tb.window(), jb.window(), "window")
        assert_same(tb.actor_mask(), jb.actor_mask(), "actor_mask")
    assert len(tb.slots) == 4


def cost_problem(seed=0):
    """A branching tree of 14 cost nodes (a chain of 6, then two chains of
    4), exo discs near the ego's path, and both packages' cost params."""
    from mind_tpu.parity import host_ilqr as j_ilqr

    rng = np.random.default_rng(seed)
    parents = [-1, 0, 1, 2, 3, 4, 5, 6, 7, 8, 5, 10, 11, 12]
    prob = [1.0] * 6 + [0.6] * 4 + [0.4] * 4
    x0 = np.array([2.0, 0.3, 4.0, 0.05, 0.2, 0.01])
    lane = np.stack([np.linspace(-20, 120, 36), 0.2 * np.sin(np.linspace(0, 3, 36))], -1)
    out = []
    for mod in (t_ilqr, j_ilqr):
        nodes = [mod.HostCostNode(
            parent=p, prob=pr, ego_mean=np.array([2.0 + 0.9 * i, 0.1 * (i % 3)]),
            ego_cov=0.2 + 0.05 * i,
            exo_mean=np.array([[8.0 + 0.8 * i, 2.5 - 0.1 * i], [20.0 - 0.3 * i, -3.0]]),
            exo_cov=np.array([0.5, 1.0 + 0.1 * i])) for i, (p, pr) in enumerate(zip(parents,
                                                                                    prob))]
        params = mod.HostCostParams(
            field_offset=x0[:2] - 0.5 * 255 * 0.4, res=0.4, grid_n=256, tgt_lane=lane,
            w_tgt=1.0, w_ego=1.0, w_ego_cov_offset=1.0, w_exo=10.0, w_exo_cov_offset=2.5,
            w_exo_cost_offset=10.0, w_des_state=np.array([0, 0, 0.1, 0, 1.0, 10.0]),
            des_state=np.array([0, 0, 6.0, 0, 0, 0]),
            w_state_con=np.array([0, 0, 50.0, 0, 50.0, 500.0]),
            state_lb=np.array([-1e5, -1e5, 0, -10, -6, -0.2]),
            state_ub=np.array([1e5, 1e5, 8, 10, 4, 0.2]), w_ctrl=np.array([5.0, 5.0]))
        out.append((nodes, params))
    us0 = rng.normal(0, 0.3, (len(parents), 2))
    return out, x0, us0


def test_cost_and_dynamics_equal():
    from mind_tpu.parity import host_ilqr as j_ilqr

    ((tn, tp), (jn, jp)), x0, _ = cost_problem()
    rng = np.random.default_rng(7)
    for i in range(len(tn)):
        # in the grid and outside it (the convex pull-back)
        for pos in (tn[i].ego_mean + rng.normal(0, 1.5, 2), np.array([80.0, 70.0])):
            x = np.concatenate([pos, rng.normal(0, 3, 4)])
            u = rng.normal(0, 1, 2)
            assert_same(t_ilqr.potential_field_eval_np(pos, tn[i], tp),
                        j_ilqr.potential_field_eval_np(pos, jn[i], jp), f"field {i}")
            assert_same(t_ilqr.cost_node_eval_np(x, u, tn[i], tp),
                        j_ilqr.cost_node_eval_np(x, u, jn[i], jp), f"cost {i}")
            assert_same(t_ilqr.ext_bicycle_step_np(x, u, 0.2, 2.5),
                        j_ilqr.ext_bicycle_step_np(x, u, 0.2, 2.5))
            assert_same(t_ilqr.ext_bicycle_jacobians_np(x, 0.2, 2.5),
                        j_ilqr.ext_bicycle_jacobians_np(x, 0.2, 2.5))


@pytest.mark.parametrize("phase", ["warm", "full"])
def test_host_ilqr_solve_equal(phase):
    """The whole solve: the same iterations, cost, convergence flag and
    trajectories to the bit (same alpha grid, first-accept rule and LM
    schedule)."""
    from mind_tpu.parity import host_ilqr as j_ilqr

    ((tn, tp), (jn, jp)), x0, us0 = cost_problem(1)
    if phase == "warm":
        tp.w_ego = tp.w_exo = jp.w_ego = jp.w_exo = 0.0
    kw = dict(dt=0.2, wb=2.5, max_iterations=40, rel_tol=1e-6, n_line_search=10)
    got = t_ilqr.host_ilqr_solve(tn, x0, us0, tp, **kw)
    want = j_ilqr.host_ilqr_solve(jn, x0, us0, jp, **kw)
    assert_same(got, want, "solve")
    assert got.iterations > 2 and np.isfinite(got.xs).all()
