"""The device-side control flow of the PyTorch port
(mind_tpu_torch/ops/graph_control.py) on the CPU, where device_while and
device_if run eagerly: their trip counts, a body never run on a false
predicate, nesting and the tree helpers; the condition kernel refusing a
CPU mask. Then what runs through them: the tree iLQR over every level of
its topology equal to the bit to the solve over the levels in use
(float32 and float64), and AIME's rounds through device_if equal to the
host-read loop that stops at the first empty round, with the device round
counter. A CUDA-only test (skipped here) holds captured programs against
the eager primitives.
"""

from typing import NamedTuple

import numpy as np
import pytest
import torch

from mind_tpu_torch.config import NetConfig as TNetConfig, PlannerConfig as TPlannerConfig
from mind_tpu_torch.ops import graph_control as gc
from mind_tpu_torch.planner import aime_device as taime
from mind_tpu_torch.planner import ilqr as tilqr
from mind_tpu_torch.planner.scene_prep import LaneGraphStatic as TLane, TargetLaneStatic as TTgt
from mind_tpu_torch.planner.trajectory_tree import two_phase_solve
from test_torch_aime import A, CPU, L, SMALL, make_window, nets, statics_np  # noqa: F401
from test_torch_ilqr import random_batch


def counting(limits):
    """x counts up to `limits` under device_while; returns (x, body runs)."""
    x = torch.zeros(len(limits), dtype=torch.long)
    lim = torch.tensor(limits)
    runs = []

    def body():
        runs.append(1)
        x.copy_(torch.where(x < lim, x + 1, x))

    gc.device_while(lambda: x < lim, body)
    return x, len(runs)


@pytest.mark.parametrize("limits,trips", [([0, 0, 0], 0), ([3], 3), ([1, 4, 2], 4)])
def test_device_while_runs_until_no_entry_holds(limits, trips):
    x, runs = counting(limits)
    assert x.tolist() == limits and runs == trips


@pytest.mark.parametrize("mask,runs", [([False, False], 0), ([False, True], 1), ([True], 1)])
def test_device_if_runs_on_any(mask, runs):
    calls = []
    gc.device_if(torch.tensor(mask), lambda: calls.append(1))
    assert len(calls) == runs


def test_nested_primitives_eager():
    """An IF inside a WHILE: the body of the IF runs on the odd rounds only."""
    rnd, odd = torch.zeros((), dtype=torch.long), torch.zeros((), dtype=torch.long)

    def round_():
        gc.device_if(rnd % 2 == 1, lambda: odd.add_(1))
        rnd.add_(1)

    gc.device_while(lambda: rnd < 5, round_)
    assert int(rnd) == 5 and int(odd) == 2
    assert not gc.capturing()


class _Inner(NamedTuple):
    a: torch.Tensor
    n: int


class _Outer(NamedTuple):
    inner: _Inner
    pair: tuple
    b: torch.Tensor


def test_tree_helpers():
    tree = _Outer(_Inner(torch.arange(3.0), 7), (torch.ones(2, 2), torch.zeros(1)),
                  torch.tensor([True, False]))
    assert [t.shape for t in gc.tensors(tree)] == [(3,), (2, 2), (1,), (2,)]
    like = gc.empty_like(tree)
    assert type(like.pair) is tuple and like.inner.n == 7
    assert all(a.shape == b.shape and a.dtype == b.dtype and a is not b
               for a, b in zip(gc.tensors(like), gc.tensors(tree)))
    gc.assign(like, tree)
    assert all(torch.equal(a, b) for a, b in zip(gc.tensors(like), gc.tensors(tree)))
    copy = gc.clone(tree)
    assert all(torch.equal(a, b) and a.data_ptr() != b.data_ptr()
               for a, b in zip(gc.tensors(copy), gc.tensors(tree)))


def test_condition_kernel_needs_a_card():
    with pytest.raises(ValueError, match="on the card"):
        gc.set_conditional_any(0, torch.zeros(4, dtype=torch.bool), None)
    assert bool(gc.set_conditional_any_ref(torch.tensor([False, True])))
    assert not bool(gc.set_conditional_any_ref(torch.zeros(5, dtype=torch.bool)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_static_levels_equal_the_levels_in_use(dtype):
    """The solve over all 32 levels of the topology against the same solve
    on the level table cut to the levels that hold a node: empty levels
    write only the dump slot and add zeros, so the two agree to the bit."""
    topo, nodes, wp, fp, x0 = random_batch(3, 4, 24, 4, dtype, CPU)
    used = tilqr._levels_in_use(topo)
    assert topo.level_table.shape[-2] == 32 and used < 32
    trimmed = topo._replace(level_table=topo.level_table[..., :used, :].contiguous())
    cfg = tilqr.ILQRConfig(dtype=str(dtype).split(".")[-1], rel_tol=1e-5)
    wcfg = cfg._replace(max_iterations=15)
    full = two_phase_solve(topo, x0, nodes, wp, fp, cfg, wcfg)
    cut = two_phase_solve(trimmed, x0, nodes, wp, fp, cfg, wcfg)
    assert torch.equal(full[0], cut[0]) and torch.equal(full[1], cut[1])
    for key in ("iterations", "warm_iterations", "J"):
        assert torch.equal(full[2][key], cut[2][key]), key
    assert int(full[2]["iterations"].max()) > 2


def test_aime_rounds_through_device_if_equal_the_host_loop(nets, monkeypatch):
    """AIME with each round a device_if against the loop it replaced (one
    host read per round, stopping at the first round without a branch
    flag), on test_torch_aime.py's window and weights: the same tree, and
    the device round counter equal to the network forwards of both."""
    cfg = TPlannerConfig(net=TNetConfig(**SMALL), max_actors=A, max_lanes=L)
    cfg.scen_tree.max_branch_nodes = 4
    cfg.scen_tree.max_tree_nodes = 32
    net = nets[2]
    forwards = []
    counted = lambda *a: (forwards.append(1), net(*a))[1]
    pos, ang, vel = make_window()
    anchors, pts, n = statics_np()
    f64 = torch.float64
    types = torch.zeros((A, 7))
    types[:, 0] = 1
    lane = TLane(node_feats=torch.zeros((L, 10, 16)), anchors_g=torch.tensor(anchors, dtype=f64),
                 anchor_vecs_g=torch.tensor([[1.0, 0.0]], dtype=f64).repeat(L, 1),
                 mask=torch.ones(L, dtype=torch.bool))
    tgt = TTgt(points=torch.tensor(pts, dtype=f64), info=torch.zeros((256, 12), dtype=f64),
               mask=torch.tensor(np.arange(256) < n), n_points=n)
    buf = taime.DeviceObsBuffer(pos=torch.tensor(pos, dtype=f64), ang=torch.tensor(ang, dtype=f64),
                                vel=torch.tensor(vel, dtype=f64),
                                observed=torch.ones((A, 50), dtype=torch.bool))
    args = taime.scene_axis(buf, types, torch.ones(A, dtype=torch.bool), lane, tgt)
    state, meta, rounds = taime.aime_grow_tree(counted, cfg, *args)
    n_device = len(forwards)

    stopped = []

    def host_loop_round(pred, body):
        if stopped or not bool(pred.any()):
            stopped.append(True)
            return
        body()

    monkeypatch.setattr(gc, "device_if", host_loop_round)
    forwards.clear()
    state_h, meta_h, rounds_h = taime.aime_grow_tree(counted, cfg, *args)
    # the rounds after the first find no flag: device_if skips them, the
    # host loop stops
    assert 1 <= int(rounds) == n_device == int(rounds_h) == len(forwards) < cfg.scen_tree.max_depth
    assert stopped
    for a, b in zip(gc.tensors((state, meta)), gc.tensors((state_h, meta_h))):
        assert torch.equal(a, b)
    assert bool(meta.end_flag.any())


@pytest.mark.cuda
def test_cuda_captured_program_matches_eager():
    """On the card: a WHILE with an IF inside whose bodies allocate and run
    library calls, captured once and replayed on three inputs, equal to the
    eager primitives on the same inputs; the condition kernel counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    torch.manual_seed(0)
    lin = torch.nn.Linear(32, 32).to(dev)
    h = torch.randn(8, 32, device=dev)
    h0 = h.clone()
    rnd, n = torch.zeros((), dtype=torch.long, device=dev), torch.zeros((), dtype=torch.long,
                                                                        device=dev)

    def fn():
        def round_():
            gc.device_if(rnd % 2 == 0, lambda: h.copy_(torch.tanh(lin(h))))
            rnd.add_(1)
        with torch.no_grad():
            gc.device_while(lambda: rnd < n, round_)

    def load(k):
        h.copy_(h0)
        rnd.zero_()
        n.fill_(k)

    want = []
    for k in (3, 0, 6):
        load(k)
        fn()
        want.append(h.clone())
    prog = gc.GraphProgram(fn, dev)
    for k, w in zip((3, 0, 6), want):
        load(k)
        prog.replay()
        torch.cuda.synchronize()
        assert torch.equal(h, w), k
    assert int(prog.executions) > 0 and len(prog.bodies) == 2
    prog.close()
