"""The Monte-Carlo runners of the PyTorch port against mind_tpu's on the
small synthetic AV2 world with the test settings of test_torch_sim.py (128
cost nodes, 4 line-search steps, the small network with shared weights):
run_episode_monte_carlo (k = 2 copies as one batch, 15 ticks, segments of 2
against 10 cycles, a two-shard CPU mesh) at float64. MonteCarloSim is held
in test_torch_multi_scenario.py.
"""

import numpy as np
import pytest
import torch

from mind_tpu_torch.sim import episode as tepisode
from test_torch_episode import make_sims
from test_torch_planner import CPU, World

torch.set_num_threads(2)

HORIZON = 15       # 3 cycles, every one planning (the copies enable at tick 0)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return World(tmp_path_factory.mktemp("av2"))


@pytest.fixture(scope="module")
def monte_carlo64(world):
    """Both packages' run_episode_monte_carlo at float64 (k = 2, one chunk
    of 2, seed 11) over HORIZON ticks; the port's in segments of 2 and of 10
    cycles, and its first 10 ticks split over a two-shard CPU mesh."""
    from mind_tpu.sim.episode import run_episode_monte_carlo
    from mind_tpu_torch.parallel.mesh import make_mesh

    jsim, tsim = make_sims(world, ticks=HORIZON)
    kw = dict(k=2, chunk=2, seed=11, horizon=HORIZON)
    want = run_episode_monte_carlo(jsim, seg_cycles=10, **kw)
    walls = []
    got = tepisode.run_episode_monte_carlo(tsim, seg_cycles=2, chunk_walls=walls, **kw)
    whole = tepisode.run_episode_monte_carlo(tsim, seg_cycles=10, **kw)
    # the first two cycles again, one copy per device of a two-shard mesh
    meshed = tepisode.run_episode_monte_carlo(tsim, seg_cycles=10, mesh=make_mesh(2, device="cpu"),
                                              **dict(kw, chunk=1, horizon=10))
    return want, got, whole, meshed, walls


def test_monte_carlo_matches_jax(monte_carlo64):
    """Each copy plans at every cycle from tick 0 with mind_tpu's plans, its
    control within 1e-6 and its ego within 1e-4 m (float64: sums in another
    order). The iteration counts are equal but where a solve has converged
    to the last bit: there one package may find no improving step by one
    rounding and take two more, rejected, iterations (measured: 9 against 7
    at one cycle, the control equal to the bit), so a count may differ only
    at a cycle whose control agrees within 1e-9."""
    want, got, _, _, walls = monte_carlo64
    assert len(got) == len(want) == 2 and walls[0][:2] == (0, 2)
    for w, g in zip(want, got):
        assert g.fail_cycle == w.fail_cycle and g.plan_calls == w.plan_calls
        np.testing.assert_array_equal(g.planned, np.asarray(w.planned))
        np.testing.assert_array_equal(g.plan_ok, np.asarray(w.plan_ok))
        gap = np.abs(g.controls - np.asarray(w.controls)).max(-1)
        differ = g.iterations != np.asarray(w.iterations)
        assert (gap[differ] <= 1e-9).all() and differ.sum() <= 1, (g.iterations, w.iterations)
        assert gap.max() <= 1e-6
        np.testing.assert_allclose(g.ego_states, w.ego_states, rtol=0, atol=1e-4)
    assert got[0].planned.all() and np.abs(got[0].ego_states[0] - got[1].ego_states[0]).max() > 0


def test_monte_carlo_segments_are_bit_equal(monte_carlo64):
    """Segments of 2 and of 10 cycles: the same cycles on the same data,
    equal to the bit; a two-shard mesh (chunks of one copy per device)
    within 1e-6 m over its 10 ticks (batches of another size)."""
    _, got, whole, meshed, _ = monte_carlo64
    for a, b, m in zip(got, whole, meshed):
        for f in ("ego_states", "plan_ok", "planned", "iterations", "controls"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        assert m.plan_calls == 2 and (m.iterations == a.iterations[:2]).all()
        np.testing.assert_allclose(m.ego_states, a.ego_states[:10], rtol=0, atol=1e-6)



def test_planner_replica_for_a_mesh_device(world):
    """The replica a mesh device gets (a card other than the planner's):
    its own network with the same weights, and every device static the
    episode reads, on that device (the CPU here)."""
    tsim = make_sims(world, ticks=HORIZON)[1]
    pl = next(a for a in tsim.agents if a.id == "AV").planner
    rep = tepisode._planner_on(pl, "cpu")
    assert rep.net is not pl.net and rep.device == CPU
    for (k, a), b in zip(pl.net.state_dict().items(), rep.net.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(tepisode.build_episode_statics(pl), tepisode.build_episode_statics(rep)):
        for x, y in zip(*(t if isinstance(t, tuple) else (t,) for t in (a, b))):
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y) and y.device == CPU
    assert rep.origin is pl.origin and rep.cfg is pl.cfg
    assert tepisode._same_device("cpu", torch.device("cpu"))
