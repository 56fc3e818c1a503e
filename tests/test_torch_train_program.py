"""The train step's program path (mind_tpu_torch/models/train_program.py,
models/train.py::make_train_step) on the CPU, where the program runs its
body eagerly on its static buffers: test_torch_train.py's narrow network
with mind_tpu's seeded parameters and its 4-scene batch.

Against jax.jit of mind_tpu's train step: 3 Adam and 3 AdamW steps' losses
within 1e-4 relative (test_torch_train.py's tolerance). Against optax fed
the same 20 gradients: adam_update's parameters within 1e-7 and moments
within 1e-6 in relative norm. Against the eager step (graphed=False) from
the same state, to the bit: losses, parameters and optimizer state, for
the unsharded step, the two-shard sequential mesh on one device, a
restored optimizer and a two-rank gloo DistMesh. Also: k calls make k
steps, each call returns a tensor of its own, a changed setting makes a
new program, and what the compiled step refuses raises. Two cuda-marked
tests hold the compiled step against the eager one on the card: the one
graph of the unsharded step, and the two graphs around the all-reduce of
a one-rank gloo DistMesh.
"""

import copy

import numpy as np
import pytest
import torch

from mind_tpu_torch.models import train as ttrain
from mind_tpu_torch.parallel.mesh import make_mesh
from test_torch_dist import launch2, rank_threads
from test_torch_train import (TINY, jax_tiny, port_batch, port_net, rel,  # noqa: F401 (fixture)
                              rel_norm)

torch.set_num_threads(2)

LR = 1e-3


def run(jax_tiny, opt, graphed, k=3, mesh=None):
    """k steps of a fresh port network from mind_tpu's parameters: (losses
    as returned, the network, the optimizer, the step)."""
    net = port_net(jax_tiny.params)
    optimizer = getattr(ttrain, opt)(net.parameters(), LR)
    step = ttrain.make_train_step(net, optimizer, mesh=mesh, graphed=graphed)
    batch = port_batch(jax_tiny.batch)
    return [step(batch) for _ in range(k)], net, optimizer, step


def assert_same_training(a, b):
    """Two runs of `run`: losses, parameters and optimizer state equal to
    the bit."""
    (la, na, oa, _), (lb, nb, ob, _) = a, b
    assert [float(x) for x in la] == [float(x) for x in lb]
    for (k, p), q in zip(na.named_parameters(), nb.parameters()):
        assert torch.equal(p, q), k
    sa, sb = oa.state_dict()["state"], ob.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        assert list(sa[i]) == ["step", "exp_avg", "exp_avg_sq"]
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)


@pytest.mark.parametrize("opt", ["adam", "adamw"])
def test_program_steps_match_optax(jax_tiny, opt):
    import jax
    import optax
    from mind_tpu.models.train import make_train_step

    joptimizer = getattr(optax, opt)(LR)
    _, step = make_train_step(jax_tiny.cfg, joptimizer)
    step = jax.jit(step)
    params, state, want = jax_tiny.params, joptimizer.init(jax_tiny.params), []
    for _ in range(3):
        params, state, loss = step(params, state, jax_tiny.batch)
        want.append(float(loss))
    losses, _, _, tstep = run(jax_tiny, opt, None)
    assert tstep.program is not None and len(tstep.program.programs) == 1
    got = [float(x) for x in losses]
    assert want[-1] < want[0]
    for g, w in zip(got, want):
        assert rel(g, w) < 1e-4, (got, want)


@pytest.mark.parametrize("opt", ["adam", "adamw"])
def test_adam_update_matches_optax_on_equal_gradients(opt):
    """adam_update against optax fed the same 20 gradients (seeded numpy,
    magnitudes from 1e-8 to 1, one parameter's gradient always zero):
    parameters within 1e-7 and moments within 1e-6 in relative norm. Over
    so many steps a formula that differs from optax's (a bias correction, a
    decay, eps's place) parts far more; torch.optim's own AdamW, whose
    decay is rounded differently, is about 5e-7 apart here. optax runs
    under the JAX package's x64 (set when mind_tpu is imported), as its
    training does: its bias corrections are then float64, cast."""
    import jax.numpy as jnp
    import optax

    import mind_tpu  # noqa: F401 (x64)

    rng = np.random.default_rng(0)
    shapes = [(16, 8), (8,), (4, 3, 5), (6,)]
    init = [rng.normal(0, 0.1, s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * 10.0 ** rng.uniform(-8, 0, s)).astype(np.float32)
              * (i != 3) for i, s in enumerate(shapes)] for _ in range(20)]
    joptimizer = getattr(optax, opt)(LR)
    jp = [jnp.asarray(x) for x in init]
    jstate = joptimizer.init(jp)
    params = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in init]
    optimizer = getattr(ttrain, opt)(params, LR)
    groups = ttrain.adam_groups(optimizer)
    state = ttrain.bind_state(optimizer, params)
    for g in grads:
        upd, jstate = joptimizer.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        ttrain.adam_update(groups, [torch.from_numpy(x) for x in g], state)
    adam_state = jstate[0]
    assert int(adam_state.count) == 20 and all(float(ts[0]) == 20.0 for ts in state)
    for i in range(len(shapes)):
        for got, want, tol in ((params[i], jp[i], 1e-7), (state[i][1], adam_state.mu[i], 1e-6),
                               (state[i][2], adam_state.nu[i], 1e-6)):
            assert rel_norm(got.detach().numpy(), np.asarray(want)) < tol, (i, tol)


@pytest.mark.parametrize("opt", ["adam", "adamw"])
def test_program_equals_eager_to_the_bit(jax_tiny, opt):
    assert_same_training(run(jax_tiny, opt, None), run(jax_tiny, opt, False))


def test_k_calls_make_k_steps_and_return_their_own_losses(jax_tiny):
    """Every call is one optimizer step (no warm-up step of its own), and
    its loss is a tensor of its own: the losses kept from earlier calls
    keep their values."""
    losses, net, optimizer, step = run(jax_tiny, "adamw", None, k=4)
    for st in optimizer.state.values():
        assert float(st["step"]) == 4.0
    assert len({x.data_ptr() for x in losses}) == 4
    prog = step.program.programs[next(iter(step.program.programs))]
    assert all(x.data_ptr() != prog.loss.data_ptr() for x in losses)
    assert len({float(x) for x in losses}) == 4 and float(losses[-1]) < float(losses[0])
    assert all(p.grad is g for p, g in zip(step.body.params, step.body.grads))


def test_restored_optimizer_is_seen_by_the_next_step(jax_tiny):
    """After 2 steps the state is saved, 2 more steps run, then the network
    and the optimizer are restored (optimizer.load_state_dict puts new
    state tensors in place) and the program steps again: the same as an
    eager step from the restored state, to the bit, with the state tensors
    the program addresses back in the optimizer."""
    batch = port_batch(jax_tiny.batch)
    _, net, optimizer, step = run(jax_tiny, "adamw", None, k=2)
    saved_net, saved_opt = copy.deepcopy(net.state_dict()), copy.deepcopy(optimizer.state_dict())
    held = [list(ts) for ts in step.body.state]
    step(batch)
    step(batch)
    net.load_state_dict(saved_net)
    optimizer.load_state_dict(saved_opt)
    assert optimizer.state[step.body.params[0]]["exp_avg"] is not held[0][1]
    got = [step(batch), step(batch)]
    for p, ts in zip(step.body.params, held):
        assert all(optimizer.state[p][k] is t for k, t in zip(ttrain.STATE_KEYS, ts))

    net2 = port_net(jax_tiny.params)
    net2.load_state_dict(saved_net)
    opt2 = ttrain.adamw(net2.parameters(), LR)
    opt2.load_state_dict(copy.deepcopy(saved_opt))
    eager = ttrain.make_train_step(net2, opt2, graphed=False)
    want = [eager(batch), eager(batch)]
    assert_same_training((got, net, optimizer, None), (want, net2, opt2, None))


def test_new_setting_makes_a_new_program(jax_tiny):
    """A changed learning rate (baked into the update) and a changed cuDNN
    setting (baked into a capture's convolutions) key programs of their
    own; the step under the new rate equals the eager one's."""
    batch = port_batch(jax_tiny.batch)
    _, net, optimizer, step = run(jax_tiny, "adam", None, k=1)
    for g in optimizer.param_groups:
        g["lr"] = LR / 2
    step(batch)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = not deterministic
    try:
        step(batch)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert len(step.program.programs) == 3

    _, net2, opt2, eager = run(jax_tiny, "adam", False, k=1)
    for g in opt2.param_groups:
        g["lr"] = LR / 2
    eager(batch)
    eager(batch)
    for p, q in zip(net.parameters(), net2.parameters()):
        assert torch.equal(p, q)


def test_two_shard_mesh_program_matches_unsharded(jax_tiny):
    """The two-shard sequential mesh on one device through its program:
    its losses within 1e-5 of the unsharded step's (test_torch_train.py's
    tolerance), and equal to the bit to the same mesh stepped eagerly."""
    mesh = make_mesh(2, device="cpu")
    sharded = run(jax_tiny, "adam", None, k=2, mesh=mesh)
    whole = run(jax_tiny, "adam", None, k=2)
    assert sharded[3].program is not None
    for a, b in zip(sharded[0], whole[0]):
        assert rel(float(a), float(b)) < 1e-5
    assert_same_training(sharded, run(jax_tiny, "adam", False, k=2, mesh=mesh))


def test_dist_split_programs_equal_one_process(jax_tiny):
    """Two gloo ranks on the CPU through the program path (3 AdamW steps),
    which on the CPU runs the step's body eagerly on its static buffers:
    the batch copied in, the gradients, the all-reduce, the update (the two
    graphs around the all-reduce exist only on the card, where
    test_cuda_dist_mesh_two_graphs_equal_eager holds them). Both ranks'
    losses and parameters equal to the bit to the one-process two-shard
    mesh's program; the phases timed by name."""
    from mind_tpu_torch.config import NetConfig as TNetConfig
    from mind_tpu_torch.models.weights import params_from_flax
    from test_torch_train import flat

    batch = port_batch(jax_tiny.batch)
    ranks = launch2("train", net_cfg=TNetConfig(**TINY), batch=batch, steps=3, lr=LR,
                    optimizer="adamw", net_state=params_from_flax(flat(jax_tiny.params)))
    with rank_threads():
        seq = run(jax_tiny, "adamw", None, mesh=make_mesh(2, device="cpu"))
    for r in ranks:
        assert r["losses"] == [float(x) for x in seq[0]]
        for k, p in seq[1].named_parameters():
            assert torch.equal(r["params"][k], p), k
        assert set(r["times"]) == {"forward", "backward", "all_reduce", "optimizer"}
        assert (r["captures"], r["replays"]) == (0, 0)


def test_train_on_nccl_needs_the_card():
    """The nccl rank's workload (rank 0 alone in an nccl group beside a
    gloo world) raises on CPU ranks, with the launch naming the rank."""
    from mind_tpu_torch.config import NetConfig as TNetConfig

    with pytest.raises(RuntimeError, match="nccl runs on CUDA cards"):
        launch2("train_on_nccl", net_cfg=TNetConfig(**TINY), batch=None, steps=1)


def test_what_the_step_refuses_raises(jax_tiny):
    net = port_net(jax_tiny.params)
    with pytest.raises(ValueError, match="CUDA device"):
        ttrain.make_train_step(net, ttrain.adam(net.parameters(), LR), graphed=True)
    with pytest.raises(TypeError, match="Adam or AdamW"):
        ttrain.make_train_step(net, torch.optim.SGD(net.parameters(), lr=LR))
    with pytest.raises(ValueError, match="amsgrad"):
        ttrain.make_train_step(net, torch.optim.Adam(net.parameters(), lr=LR, amsgrad=True))
    with pytest.raises(ValueError, match="L2 weight decay"):
        ttrain.make_train_step(net, torch.optim.Adam(net.parameters(), lr=LR,
                                                     weight_decay=1e-4))


def cuda_runs(mesh_of=lambda dev: None):
    """5 compiled AdamW steps and 5 eager ones (graphed=False) of
    PlannerConfig's float32 network (the kernels take its width) from the
    same initial state on a 2-scene batch of 8 actors and 16 lanes, under
    deterministic cuDNN: ((losses, net, optimizer, step, kernel A's
    launches) compiled, the same eager)."""
    from mind_tpu_torch.config import PlannerConfig
    from mind_tpu_torch.ops import fusion_attention as fa

    cfg = PlannerConfig().net
    dev = torch.device("cuda")
    batch = ttrain.make_dummy_batch(cfg, 2, 8, 16, seed=3, device=dev)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = []
    try:
        for graphed in (None, False):
            net = ttrain.init_scene_pred(cfg, seed=0, device=dev)
            opt = ttrain.adamw(net.parameters(), 3e-4)
            step = ttrain.make_train_step(net, opt, mesh=mesh_of(dev), graphed=graphed)
            fa.reset_launch_counts()
            losses = [step(batch) for _ in range(5)]
            runs.append((losses, net, opt, step, fa.fused_edge_attention.launches))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return runs


@pytest.mark.cuda
def test_cuda_compiled_step_equals_eager():
    """On the card, cuda_runs: the compiled steps equal to the bit to the
    eager ones; the first call captured, 4 replays counted on the device,
    kernel A launched 6 times by the warm-up step and 6 by the capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the compiled step captures CUDA graphs")
    from mind_tpu_torch.config import PlannerConfig

    runs = cuda_runs()
    (_, _, _, compiled, n_compiled), (_, _, _, _, n_eager) = runs
    assert_same_training(runs[0][:4], runs[1][:4])
    assert len(compiled.program.capture_s()) == 1 and compiled.program.replays() == 4
    n_layer = PlannerConfig().net.n_scene_layer
    assert (n_compiled, n_eager) == (2 * n_layer, 5 * n_layer)


@pytest.mark.cuda
def test_cuda_dist_mesh_two_graphs_equal_eager():
    """On the card, cuda_runs on a one-rank gloo DistMesh: the compiled
    step is two graphs with the all-reduce (a host copy under gloo)
    between them, the warm-up's stream hand-offs around it included; its
    steps equal to the bit to the eager ones on the same mesh, one program
    of two graphs captured, 4 replays counted on the device."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the compiled step captures CUDA graphs")
    import socket

    import torch.distributed as dist

    from mind_tpu_torch.parallel.mesh import DistMesh

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        runs = cuda_runs(lambda dev: DistMesh(0, 1, dev, None, "gloo"))
    finally:
        dist.destroy_process_group()
    compiled = runs[0][3].program
    assert_same_training(runs[0][:4], runs[1][:4])
    (prog,) = compiled.programs.values()
    assert len(prog.graphs) == 2 and len(compiled.capture_s()) == 1
    assert compiled.replays() == 4
