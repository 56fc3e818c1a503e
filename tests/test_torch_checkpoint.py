"""The port's checkpoints (mind_tpu_torch/models/checkpoint.py) and the
ways MINDPlanner takes its weights, on the CPU.

Round trips are to the bit: parameters and optimizer state saved and
restored (the latest step when none is named), one step after a restore
equal to one step without it, the flax-layout .npz writer read back by
load_scene_pred (the same forward) and by the JAX package's flax network
(its forward within 1e-4, as tests/test_torch_scene_pred.py holds the two
networks). One test per branch of the planner's weight loading: a
directory, an .npz archive, a reference torch checkpoint, an absent file."""

import numpy as np
import pytest
import torch

from mind_tpu_torch.config import NetConfig
from mind_tpu_torch.models import checkpoint as ckpt
from mind_tpu_torch.models import train as ttrain
from mind_tpu_torch.models.weights import load_scene_pred, to_reference

TINY = dict(n_scene_layer=2, n_fpn_scale=2, d_actor=32, d_lane=32, d_embed=32, d_rpe=32,
            n_scene_head=4, pred_len=12)
A, L = 4, 8
CPU = torch.device("cpu")


def tiny_cfg(**kw):
    return NetConfig(**{**TINY, **kw})


def batch(seed=1):
    return ttrain.make_dummy_batch(tiny_cfg(), 4, A, L, seed=seed, device="cpu")


def forward(net, b):
    with torch.no_grad():
        return net(*b[:7])


def assert_same_params(a, b):
    a, b = ckpt._state(a), ckpt._state(b)
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_params_roundtrip_latest_step(tmp_path):
    nets = [ttrain.init_scene_pred(tiny_cfg(), seed=s, device="cpu") for s in (1, 2)]
    ckpt.save_params(tmp_path / "run", nets[0], step=3)
    d = ckpt.save_params(tmp_path / "run", nets[1].state_dict(), step=12)
    assert d.endswith("12") and ckpt.steps(tmp_path / "run") == [3, 12]
    like = ttrain.init_scene_pred(tiny_cfg(), seed=9, device="cpu")
    assert_same_params(ckpt.load_params(tmp_path / "run", like), nets[1])
    assert_same_params(ckpt.load_params(tmp_path / "run", like, step=3), nets[0])
    # onto the template's types: a bfloat16 network restores in bfloat16
    half = {k: v.to(torch.bfloat16) for k, v in like.state_dict().items()}
    got = ckpt.load_params(tmp_path / "run", half)
    assert all(v.dtype == torch.bfloat16 and torch.equal(v, nets[1].state_dict()[k].to(v.dtype))
               for k, v in got.items())
    with pytest.raises(KeyError, match="keys differ"):
        ckpt.load_params(tmp_path / "run", ttrain.init_scene_pred(
            tiny_cfg(n_scene_layer=1), device="cpu"))
    with pytest.raises(FileNotFoundError):
        ckpt.load_params(tmp_path / "none", like)


def test_restore_then_step_equals_continuing(tmp_path):
    """Save after two AdamW steps; one more step of the restored network and
    optimizer equals one more step without the round trip, to the bit."""
    b = batch()
    net = ttrain.init_scene_pred(tiny_cfg(), seed=0, device="cpu")
    opt = ttrain.adamw(net.parameters(), 1e-3)
    step = ttrain.make_train_step(net, opt)
    for _ in range(2):
        step(b)
    ckpt.save_params(tmp_path, net, step=2, opt_state=opt)
    loss = step(b)

    net2 = ttrain.init_scene_pred(tiny_cfg(), seed=5, device="cpu")
    net2.load_state_dict(ckpt.load_params(tmp_path, net2))
    opt2 = ckpt.load_opt_state(tmp_path, ttrain.adamw(net2.parameters(), 1e-3))
    loss2 = ttrain.make_train_step(net2, opt2)(b)
    assert torch.equal(loss, loss2)
    assert_same_params(net, net2)
    assert_same_params(opt.state_dict()["state"][0], opt2.state_dict()["state"][0])


def test_flax_npz_writer_feeds_load_scene_pred_and_flax(tmp_path):
    import jax.numpy as jnp
    from flax.traverse_util import unflatten_dict
    from mind_tpu.config import NetConfig as JNetConfig
    from mind_tpu.models.scene_pred import ScenePredNet, make_batched_apply

    net = ttrain.init_scene_pred(tiny_cfg(), seed=4, device="cpu")
    path = ckpt.save_flax_npz(tmp_path / "w.npz", net)
    back = load_scene_pred(tiny_cfg(), path, CPU)
    assert_same_params(back, net)
    b = batch(2)
    for x, y in zip(forward(net, b), forward(back, b)):
        assert torch.equal(x, y)
    # the JAX package's network reads the same arrays as its parameter tree
    jcfg = JNetConfig(**TINY, use_pallas_fusion=False)
    with np.load(path) as z:
        params = unflatten_dict({k: jnp.asarray(z[k]) for k in z.files}, sep="/")
    want = make_batched_apply(ScenePredNet(jcfg), jcfg)(params, *(jnp.asarray(x.numpy())
                                                               for x in b[:7]))
    for g, w in zip(forward(net, b), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def planner_net(ckpt_path, cfg=None):
    """MINDPlanner._init_network with cfg.ckpt_path (the planner's other
    state is not needed to pick its weights)."""
    from mind_tpu_torch.config import PlannerConfig
    from mind_tpu_torch.planner.planner import MINDPlanner

    planner = object.__new__(MINDPlanner)
    planner.cfg = PlannerConfig(net=cfg or tiny_cfg(), ckpt_path=ckpt_path)
    planner.device = CPU
    return planner._init_network()


def test_planner_loads_a_checkpoint_directory(tmp_path):
    nets = [ttrain.init_scene_pred(tiny_cfg(), seed=s, device="cpu") for s in (1, 2)]
    for i, net in enumerate(nets):
        ckpt.save_params(tmp_path, net, step=100 * (i + 1))
    got = planner_net(str(tmp_path))
    assert not got.training
    assert_same_params(got, nets[1])


def test_planner_loads_the_npz_archive(tmp_path):
    net = ttrain.init_scene_pred(tiny_cfg(), seed=3, device="cpu")
    assert_same_params(planner_net(ckpt.save_flax_npz(tmp_path / "w.npz", net)), net)
    bf16 = planner_net(str(tmp_path / "w.npz"), tiny_cfg(compute_dtype="bfloat16"))
    assert {p.dtype for p in bf16.parameters()} == {torch.bfloat16}


def test_planner_loads_a_reference_torch_checkpoint(tmp_path):
    net = ttrain.init_scene_pred(tiny_cfg(), seed=6, device="cpu")
    path = tmp_path / "ref.ckpt"
    torch.save({"state_dict": to_reference(net.state_dict(), tiny_cfg()), "epoch": 3}, path)
    got = planner_net(str(path))
    b = batch(3)
    for x, y in zip(forward(net, b), forward(got, b)):
        assert torch.equal(x, y)


def test_planner_keeps_seeded_weights_without_the_file(tmp_path):
    from mind_tpu_torch.config import PlannerConfig

    seed = PlannerConfig().seed
    got = planner_net(str(tmp_path / "absent.ckpt"))
    assert_same_params(got, load_scene_pred(tiny_cfg(), None, CPU, seed=seed))
    assert_same_params(planner_net(None), got)
    with pytest.raises(FileNotFoundError):
        planner_net(str(tmp_path / "absent.npz"))
