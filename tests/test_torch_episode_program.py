"""The episode program of the PyTorch port (sim/episode.py::episode_fn_for)
against mind_tpu's in each of its four modes, on test_torch_episode.py's
small synthetic AV2 world at float64 (6 cycles, the planner on from cycle
3, the same weights). On the CPU the port's cycles run eagerly through the
graph-control primitives (the same cycle code the card captures); the JAX
programs are jitted on the CPU, as tests/test_episode.py runs them.

- 'single' and 'scenarios' with a lane whose plans fail: its target lane
  masked out, every branch is pruned and no tree survives. The lane
  keeps planning in lockstep with its plans discarded (JAX's compiled
  semantics): plan_ok, planned and the iteration counts equal mind_tpu's
  on every cycle, the failing cycle too;
- 'single_seg' in 3-cycle segments against mind_tpu's and equal to the bit
  to the port's 'single';
- 'copies_seg' is held against mind_tpu's, and to be invariant to the
  segment length, by test_torch_monte_carlo.py (both packages'
  run_episode_monte_carlo run their 'copies_seg' programs);
- an unknown mode raises, and configurations that differ only in cost
  weights share one program.
The float64 tolerances are test_torch_episode.py's: ego 1e-4 m, controls
1e-5, the discrete outputs equal, and iteration counts equal but at a
solve converged to the last bit (test_torch_monte_carlo.py's rule). A CUDA-only test
(skipped here) holds the captured program against the eager cycles.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mind_tpu_torch.sim import episode as tepisode
from test_torch_episode import HORIZON, ego, make_sims, world  # noqa: F401

SEG = 3


def planners(jsim, tsim):
    return ego(jsim).planner, ego(tsim).planner


def moved(st):
    """Statics with every point of AIME's target lane masked out: the
    target-lane prune finds no lane within reach, so every branch goes."""
    tgt = st.tgt_static
    return st._replace(tgt_static=tgt._replace(mask=tgt.mask & False))


def check_outputs(got, want, name):
    """Port outputs (numpy) against mind_tpu's: plan_ok and planned equal,
    ego and controls at float64 tolerances, iteration counts equal but
    where a solve converged to the last bit (test_torch_monte_carlo.py: one
    package may there take two more, rejected, iterations, the control
    equal within 1e-9)."""
    rec, ok, planned, iters, ctrls = got
    w_rec, w_ok, w_planned, w_iters, w_ctrls = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(ok, w_ok, err_msg=f"{name} plan_ok")
    np.testing.assert_array_equal(planned, w_planned, err_msg=f"{name} planned")
    differ = iters != w_iters
    gap = np.abs(ctrls - w_ctrls).max(-1)
    assert (gap[differ] <= 1e-9).all(), (name, iters, w_iters)
    np.testing.assert_allclose(rec, w_rec, rtol=0, atol=1e-4, err_msg=f"{name} ego")
    np.testing.assert_allclose(ctrls, w_ctrls, rtol=0, atol=1e-5, err_msg=f"{name} controls")


def result_pair(jpl, tpl, got, want):
    from mind_tpu.sim.episode import _to_result

    return tepisode._to_result(tpl, *got), _to_result(jpl, *want)


@pytest.fixture(scope="module")
def sims(world):  # noqa: F811
    return make_sims(world)


@pytest.fixture(scope="module")
def single(sims):
    """The port's 'single' program on the world (eager on the CPU)."""
    _, tsim = sims
    tpl = ego(tsim).planner
    fn = tepisode.episode_fn_for(tpl, ego(tsim).veh_param, tsim.sim_step)
    inp = tepisode.build_episode_inputs(tsim, HORIZON)
    return fn(tpl.net, inp, tepisode.build_episode_statics(tpl), inp.enable_tick)


def test_single_with_a_failing_lane_matches_jax(sims):
    from mind_tpu.sim import episode as jepisode

    jsim, tsim = sims
    jpl, tpl = planners(jsim, tsim)
    jinp = jepisode.build_episode_inputs(jsim, HORIZON)
    tinp = tepisode.build_episode_inputs(tsim, HORIZON)
    jfn = jepisode.episode_fn_for(jpl, ego(jsim).veh_param, jsim.sim_step)
    tfn = tepisode.episode_fn_for(tpl, ego(tsim).veh_param, tsim.sim_step)
    want = jfn(jpl.params, jinp, moved(jepisode.build_episode_statics(jpl)),
               jinp.enable_tick)
    got = tfn(tpl.net, tinp, moved(tepisode.build_episode_statics(tpl)),
              tinp.enable_tick)
    check_outputs(got, want, "single")
    g, w = result_pair(jpl, tpl, got, want)
    # the first planning cycle fails; the later ones plan on, discarded
    assert g.fail_cycle == w.fail_cycle == 3 and g.plan_calls == w.plan_calls == 1
    assert g.planned.tolist() == [False, False, False, True, False, False]
    assert not g.plan_ok.any() and len(g.ego_states) == 4 * tepisode.TICKS_PER_PLAN


def test_single_seg_matches_jax_and_single(sims, single):
    from mind_tpu.sim import episode as jepisode

    jsim, tsim = sims
    jpl, tpl = planners(jsim, tsim)
    jinp = jepisode.build_episode_inputs(jsim, HORIZON)
    tinp = tepisode.build_episode_inputs(tsim, HORIZON)
    jfn = jepisode.episode_fn_for(jpl, ego(jsim).veh_param, jsim.sim_step, batch="single_seg")
    tfn = tepisode.episode_fn_for(tpl, ego(tsim).veh_param, tsim.sim_step, batch="single_seg")
    jst, tst = jepisode.build_episode_statics(jpl), tepisode.build_episode_statics(tpl)
    A = tinp.types.shape[0]
    jcarry = jepisode._init_episode_carry(A, np.float64)
    tcarry = tepisode._init_episode_carry(A, torch.float64, tpl.device)
    jsegs, tsegs = [], []
    C = HORIZON // tepisode.TICKS_PER_PLAN
    for s0 in range(0, C, SEG):
        jcarry, out = jfn(jpl.params, jepisode._slice_cycles(jinp, s0, s0 + SEG), jst,
                          jinp.enable_tick, np.int32(s0), jcarry)
        jsegs.append([np.asarray(o) for o in out])
        tcarry, out = tfn(tpl.net, tepisode._slice_cycles(tinp, s0, s0 + SEG), tst,
                          tinp.enable_tick, s0, tcarry)
        tsegs.append(out)
        assert tcarry[1].shape == (4,) and tcarry[3].shape == ()
    cat = lambda segs: [np.concatenate([s[k] for s in segs]) for k in range(5)]
    got = cat(tsegs)
    check_outputs(got, cat(jsegs), "single_seg")
    for k, name in enumerate(("rec", "ok", "planned", "iterations", "controls")):
        np.testing.assert_array_equal(got[k], single[k], err_msg=name)
    assert int(got[2].sum()) == 3 and got[1][got[2]].all()
    with pytest.raises(TypeError, match="carry"):
        tfn(tpl.net, tinp, tst, tinp.enable_tick)


def test_scenarios_with_a_failing_lane_match_jax(sims, single):
    """Two lanes of the world, the second with its target lane masked: the
    first plans as alone (within 1e-6 m: the network sums in another order
    in a batch of another size), the second fails at its first plan and
    plans on in lockstep with the first."""
    from mind_tpu.sim import episode as jepisode

    jsim, tsim = sims
    jpl, tpl = planners(jsim, tsim)
    jinp = jepisode.build_episode_inputs(jsim, HORIZON)
    tinp = tepisode.build_episode_inputs(tsim, HORIZON)
    jst, tst = jepisode.build_episode_statics(jpl), tepisode.build_episode_statics(tpl)
    jfn = jepisode.episode_fn_for(jpl, ego(jsim).veh_param, jsim.sim_step, batch="scenarios")
    tfn = tepisode.episode_fn_for(tpl, ego(tsim).veh_param, tsim.sim_step, batch="scenarios")
    want = jfn(jpl.params, jepisode._stack([jinp, jinp]),
               jepisode._stack([jst, moved(jst)]), jinp.enable_tick)
    got = tfn(tpl.net, tepisode._stack([tinp, tinp], tpl.device),
              tepisode._stack([tst, moved(tst)], tpl.device), tinp.enable_tick)
    check_outputs(got, want, "scenarios")
    results = [tepisode._to_result(tpl, *(o[i] for o in got)) for i in range(2)]
    assert results[0].fail_cycle == -1 and results[1].fail_cycle == 3
    # the failed lane's planned flags drop after its failure; both lanes'
    # plans ran on every enabled cycle (iterations of the live lane,
    # ok of neither for the failed one)
    assert got[2][1].tolist() == [False, False, False, True, False, False]
    assert not got[1][1].any() and got[1][0][3:].all()
    np.testing.assert_allclose(got[0][0], single[0], rtol=0, atol=1e-6)


def test_modes_and_program_sharing(sims):
    """An unknown mode raises, as the JAX package's; configurations that
    differ only in cost weights (statics data) share one program."""
    _, tsim = sims
    tpl = ego(tsim).planner
    veh, dt = ego(tsim).veh_param, tsim.sim_step
    with pytest.raises(ValueError, match="copies"):
        tepisode.episode_fn_for(tpl, veh, dt, batch="copies")
    other = dataclasses.replace(tpl.cfg)
    other.traj_tree = dataclasses.replace(tpl.cfg.traj_tree)
    other.traj_tree.full = dataclasses.replace(tpl.cfg.traj_tree.full, w_tgt=123.0)
    twin = type("Pl", (), {"cfg": other})()
    assert tepisode._cfg_signature(twin, veh, dt) == tepisode._cfg_signature(tpl, veh, dt)
    other.traj_tree.max_iterations += 1
    assert tepisode._cfg_signature(twin, veh, dt) != tepisode._cfg_signature(tpl, veh, dt)


@pytest.mark.cuda
def test_cuda_compiled_episode_matches_eager():
    """On the card: the world's episode through the compiled program, whole
    and in 2-cycle segments, equal to the bit to the eager cycles."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import tempfile

    from mind_tpu_torch.synthetic import demo_scenario
    from mind_tpu_torch.config import planner_config_for_demo

    with tempfile.TemporaryDirectory() as root:
        sim = demo_scenario("demo_1", 0, root, ticks=100, planner_cfg=planner_config_for_demo(
            "demo_1"), enable_timestep=1.0, target_velocity=8.0)
        eager = tepisode.run_episode(sim, graphed=False)
        compiled = tepisode.run_episode(sim)
        seg = tepisode.run_episode_segmented(sim, seg_cycles=2)
    for f in ("ego_states", "plan_ok", "planned", "iterations", "controls"):
        assert np.array_equal(getattr(compiled, f), getattr(eager, f)), f
        assert np.array_equal(getattr(seg, f), getattr(eager, f)), f
    assert compiled.plan_calls == 10 and compiled.fail_cycle == -1
