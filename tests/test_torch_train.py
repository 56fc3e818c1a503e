"""Training of the port (mind_tpu_torch/models/train.py, data_pipeline.py,
train_weights.py and the fusion core's autograd Function) against
mind_tpu's on the same seeded numpy inputs, with JAX's parameters carried
across by params_from_flax. The JAX side differentiates the plain
formulation of the fusion core (use_pallas_fusion=False): jax.grad cannot
pass the Pallas call.

Tolerances: scene_loss 1e-6 relative; one train step's loss 1e-5 relative
and every gradient 1e-4 in relative norm; 3 Adam and 3 AdamW steps' losses
1e-4 relative; the 2-shard CPU mesh step against the unsharded one 1e-5;
scenario_to_batch 1e-5 on every field; the fusion core's Function passes
gradcheck in float64 and equals plain autograd to the bit on the CPU."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mind_tpu_torch.config import NetConfig as TNetConfig
from mind_tpu_torch.models import train as ttrain
from mind_tpu_torch.models.weights import load_scene_pred, params_from_flax
from mind_tpu_torch.ops import fusion_attention as tfa

TINY = dict(n_scene_layer=2, n_fpn_scale=2, d_actor=32, d_lane=32, d_embed=32, d_rpe=32,
            n_scene_head=4, pred_len=12)
A, L, B = 4, 8, 4
CPU = torch.device("cpu")


def flat(params):
    from flax.traverse_util import flatten_dict

    return {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}


def rel(a, b):
    return float(np.abs(a - b) / np.abs(b))


def rel_norm(got, want):
    scale = np.linalg.norm(want)
    diff = np.linalg.norm(got - want)
    return diff / scale if scale > 0 else diff


def assert_grads_close(got, want, tol):
    """Per parameter, relative norm within tol; the gradients that are zero
    in exact arithmetic (train.shift_invariant_params) are rounding noise on
    both sides and are held to 1e-6 of the whole gradient's norm instead."""
    noise = set(ttrain.shift_invariant_params(TNetConfig(**TINY)))
    assert len(noise) == 5 and noise <= set(want)
    total = np.sqrt(sum(float((w.double() ** 2).sum()) for w in want.values()))
    for name, w in want.items():
        g, w = got[name].numpy(), w.numpy()
        if name in noise:
            assert max(np.linalg.norm(g), np.linalg.norm(w)) < 1e-6 * total, name
        else:
            assert rel_norm(g, w) < tol, name


@pytest.fixture(scope="module")
def jax_tiny():
    from mind_tpu.config import NetConfig
    from mind_tpu.models import init_scene_pred
    from mind_tpu.models.train import make_dummy_batch

    jcfg = NetConfig(**TINY, use_pallas_fusion=False)
    _, params, _ = init_scene_pred(jcfg, A, L, seed=0)
    return SimpleNamespace(cfg=jcfg, params=params, batch=make_dummy_batch(jcfg, B, A, L, seed=1))


def port_net(params):
    net = load_scene_pred(TNetConfig(**TINY), None, CPU)
    net.load_state_dict(params_from_flax(flat(params)), strict=True)
    return net.train()


def port_batch(jbatch):
    return ttrain.Batch(*(torch.from_numpy(np.array(x)) for x in jbatch))


def test_dummy_batch_equals_jax(jax_tiny):
    got = ttrain.make_dummy_batch(TNetConfig(**TINY), B, A, L, seed=1, device="cpu")
    for name, g, w in zip(ttrain.Batch._fields, got, jax_tiny.batch):
        assert g.dtype == torch.from_numpy(np.array(w)).dtype, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_scene_loss_matches_jax_with_ties():
    import jax
    import jax.numpy as jnp
    from mind_tpu.models.train import scene_loss

    rng = np.random.default_rng(0)
    S, M, F = 5, 6, 12
    cls = rng.dirichlet(np.ones(M), size=S).astype(np.float32)
    reg = rng.normal(0, 2, (S, A, M, F, 5)).astype(np.float32)
    reg[..., 2:4] = rng.uniform(-0.5, 2.0, reg[..., 2:4].shape)   # some sigmas clamp at eps
    gt = rng.normal(0, 2, (S, A, F, 2)).astype(np.float32)
    mask = rng.random((S, A, F)) > 0.3
    mask[1] = False                                               # a scene with no target
    reg[2, :, 4, :, :2] = reg[2, :, 1, :, :2]                     # modes 1 and 4 tie ...
    reg[2, :, 1, :, 2:] = 0.5                                     # ... with other sigmas
    reg[2, :, 4, :, 2:] = 1.5
    reg[2, :, [0, 2, 3, 5], :, :2] += 9.0                         # ... and win
    want = np.asarray(jax.vmap(scene_loss)(*map(jnp.asarray, (cls, reg, gt, mask))))
    got = ttrain.scene_loss(*map(torch.from_numpy, (cls, reg, gt, mask))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # the tie goes to the first mode: mode 4's sigmas would give another loss
    swapped = reg.copy()
    swapped[2, :, [1, 4]] = swapped[2, :, [4, 1]]
    other = ttrain.scene_loss(*map(torch.from_numpy, (cls, swapped, gt, mask))).numpy()
    assert abs(other[2] - got[2]) > 1e-3


def train_step_against_jax(jax_tiny, jbatch):
    """The port's loss and gradients on `jbatch` against jax.value_and_grad
    of JAX's loss_fn: its train step with an optimizer that hands the
    gradients back as its state. Returns the port's {name: gradient}."""
    import jax
    import optax
    from mind_tpu.models.train import make_train_step

    capture = optax.GradientTransformation(
        init=lambda p: p, update=lambda g, s, p=None: (jax.tree.map(jax.numpy.zeros_like, g), g))
    _, step = make_train_step(jax_tiny.cfg, capture)
    _, jgrads, jloss = jax.jit(step)(jax_tiny.params, capture.init(jax_tiny.params), jbatch)
    net = port_net(jax_tiny.params)
    loss = ttrain.loss_fn(net, port_batch(jbatch))
    names, params = zip(*net.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    assert rel(loss.item(), float(jloss)) < 1e-5
    want = params_from_flax(flat(jgrads))
    assert set(want) == set(names)
    unused = [n for n, g in zip(names, grads) if g is None]
    for name in unused:
        np.testing.assert_array_equal(want[name].numpy(), 0.0, err_msg=name)
    got = {n: torch.zeros_like(p) if g is None else g for n, p, g in zip(names, params, grads)}
    assert_grads_close(got, want, 1e-4)
    # only the last fusion layer's edge update is unused (layer 0 updates the edge)
    assert sorted(unused) == sorted(f"FusionNet_0.RelaFusionLayer_1.{n}" for n in (
        "w_edge", "b_edge", "ln_e1_scale", "ln_e1_bias", "ln_e2_scale", "ln_e2_bias"))
    assert all(g is not None for n, g in zip(names, grads) if "RelaFusionLayer_0" in n)
    return got


def test_train_step_gradients_match_jax(jax_tiny):
    train_step_against_jax(jax_tiny, jax_tiny.batch)


TARGET_BRANCH = ("SceneDecoder_0.MLPBlock_0.", "SceneDecoder_0.MLPBlock_1.")


def test_train_step_gradients_match_jax_when_mode_0_wins(jax_tiny):
    """The decoder puts the target lane into mode 0 only, so its target
    branch learns only from scenes whose winning mode is 0. Here the ground
    truth is mode 0's prediction moved by 0.01 m (away from |x|'s kink at 0),
    so mode 0 wins every scene and the branch's gradients are nonzero and
    held against JAX's like every other."""
    rng = np.random.default_rng(2)
    batch = port_batch(jax_tiny.batch)
    with torch.no_grad():
        _, reg, _ = port_net(jax_tiny.params)(*batch[:7])
    gt = reg[..., 0, :, :2].numpy() + 0.01 * rng.choice([-1.0, 1.0], reg[..., 0, :, :2].shape)
    jbatch = jax_tiny.batch._replace(gt_pos=gt.astype(np.float32))
    assert ttrain.winning_modes(reg, torch.from_numpy(jbatch.gt_pos), batch.gt_mask).eq(0).all()
    got = train_step_against_jax(jax_tiny, jbatch)
    branch = [n for n in got if n.startswith(TARGET_BRANCH)]
    assert len(branch) == 12 and all(bool(got[n].any()) for n in branch)


@pytest.mark.parametrize("opt", ["adam", "adamw"])
def test_optimizer_steps_match_optax(jax_tiny, opt):
    import jax
    import optax
    from mind_tpu.models.train import make_train_step

    lr = 1e-3
    joptimizer = getattr(optax, opt)(lr)
    _, step = make_train_step(jax_tiny.cfg, joptimizer)
    step = jax.jit(step)
    params, state, want = jax_tiny.params, joptimizer.init(jax_tiny.params), []
    for _ in range(3):
        params, state, loss = step(params, state, jax_tiny.batch)
        want.append(float(loss))
    net = port_net(jax_tiny.params)
    tstep = ttrain.make_train_step(net, getattr(ttrain, opt)(net.parameters(), lr))
    batch = port_batch(jax_tiny.batch)
    got = [tstep(batch).item() for _ in range(3)]
    assert want[-1] < want[0]
    for g, w in zip(got, want):
        assert rel(g, w) < 1e-4, (got, want)


def test_two_shard_mesh_step_matches_unsharded(jax_tiny):
    from mind_tpu_torch.parallel.mesh import make_mesh

    batch = port_batch(jax_tiny.batch)
    runs = []
    for mesh in (None, make_mesh(2, device="cpu")):
        net = port_net(jax_tiny.params)
        step = ttrain.make_train_step(net, ttrain.adam(net.parameters(), 1e-3), mesh=mesh)
        times = {}
        first = step(batch, times=times).item()
        grads = {n: p.grad.clone() for n, p in net.named_parameters()}
        runs.append((first, grads, step(batch).item(), times))
    (l0, g0, m0, _), (l1, g1, m1, times) = runs
    assert rel(l1, l0) < 1e-5 and rel(m1, m0) < 1e-5
    assert_grads_close(g1, g0, 1e-5)
    assert set(times) == {"forward", "backward", "optimizer"}
    with pytest.raises(ValueError, match="does not divide"):
        step(ttrain.Batch(*(x[:3] for x in batch)))


def fn_inputs(dtype, seed=0, n=6, d=8):
    g = torch.Generator().manual_seed(seed)
    rn = lambda *s, sc=0.3: (torch.randn(*s, generator=g) * sc).to(dtype)
    w = tfa.FusionWeights(*(
        (rn(d, d) if f.startswith("w") else 1 + rn(d, sc=0.1) if f.endswith("_g") else rn(d))
        .requires_grad_() for f in tfa.FusionWeights._fields))
    node = rn(2, n, d, sc=1.0).requires_grad_()
    edge = rn(2, n, n, d, sc=1.0).requires_grad_()
    mask = torch.ones(2, n, dtype=torch.bool)
    mask[0, 2] = mask[1, 4] = False
    return node, edge, mask, w


@pytest.mark.parametrize("update_edge", [True, False])
def test_fusion_function_gradcheck_float64(update_edge):
    node, edge, mask, w = fn_inputs(torch.float64)
    fn = lambda n, e, *ww: tfa.FusedEdgeAttentionFn.apply(n, e, mask, 2, update_edge, "float32",
                                                          *ww)
    assert torch.autograd.gradcheck(fn, (node, edge, *w))


@pytest.mark.parametrize("update_edge", [True, False])
def test_fusion_function_equals_plain_autograd(update_edge):
    """Through fused_edge_attention under grad mode (the Function) and
    through the plain version: the same gradients, to the bit, with an
    output gradient that depends on the outputs and one edge returned as it
    came in (update_edge False)."""
    node, edge, mask, w = fn_inputs(torch.float32, seed=1)
    g = torch.Generator().manual_seed(2)
    r_out, r_edge = torch.randn(2, 6, 8, generator=g), torch.randn(2, 6, 6, 8, generator=g)
    inputs = (node, edge, *w)

    def grads(core):
        out, e = core(node, edge, mask, w, 2, update_edge)
        loss = (out * r_out).sum() + (e * r_edge).sum() + (out ** 2).mean()
        return out, torch.autograd.grad(loss, inputs, allow_unused=True)

    out, got = grads(tfa.fused_edge_attention)
    _, want = grads(tfa.fused_edge_attention_ref)
    assert out.grad_fn is not None and "FusedEdgeAttentionFn" in type(out.grad_fn).__name__
    for name, a, b in zip(("node", "edge", *tfa.FusionWeights._fields), got, want):
        assert (a is None) == (b is None), name
        assert a is None or torch.equal(a, b), name
    unused = [n for n, a in zip(tfa.FusionWeights._fields, got[2:]) if a is None]
    assert unused == ([] if update_edge else ["we", "be", "ln_e1_g", "ln_e1_b", "ln_e2_g",
                                               "ln_e2_b"])
    with torch.no_grad():      # serving: no Function, no graph
        out, e = tfa.fused_edge_attention(node, edge, mask, w, 2, update_edge)
    assert out.grad_fn is None and (update_edge or e is edge)


@pytest.mark.cuda
def test_cuda_fusion_function_gradient_matches_plain():
    """On the card: the whole core's gradients through the Function (the
    float32 kernel forward, plain recompute backward) against autograd
    through the plain version, 1e-3 in relative norm per tensor."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from mind_tpu_torch.synthetic import fusion_inputs

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    w, node, edge = fusion_inputs(4, 129, 128, dev, seed=3)
    w = tfa.FusionWeights(*(t.requires_grad_() for t in w))
    node, edge = node.requires_grad_(), edge.requires_grad_()
    mask = torch.ones(4, 129, dtype=torch.bool, device=dev)
    mask[:, 40:48] = False
    inputs = (node, edge, *w)
    for update_edge in (True, False):
        got_want = []
        for core in (tfa.fused_edge_attention, tfa.fused_edge_attention_ref):
            before = tfa.fused_edge_attention.launches
            out, e = core(node, edge, mask, w, 8, update_edge)
            launched = tfa.fused_edge_attention.launches - before
            loss = (out ** 2).mean() + (e * e.detach().cos()).mean()
            got_want.append((launched, torch.autograd.grad(loss, inputs, allow_unused=True)))
        (n_fn, got), (n_ref, want) = got_want
        assert (n_fn, n_ref) == (1, 0)
        total = sum(float(b.double().pow(2).sum()) for b in want if b is not None) ** 0.5
        for name, a, b in zip(("node", "edge", *tfa.FusionWeights._fields), got, want):
            assert (a is None) == (b is None), name
            if name == "bk":   # exact gradient zero: rounding noise on both sides
                assert max(a.norm().item(), b.norm().item()) < 1e-6 * total
            elif a is not None:
                assert ((a - b).norm() / b.norm()).item() <= 1e-3, name


# -------------------------------------------------------------------------
# data pipeline and the training CLI on the synthetic AV2 scenario
# -------------------------------------------------------------------------

def jax_scene_batch(jsmp, bundle, cfg):
    """mind_tpu's batch of one scenario, its statics built as
    scripts/train_demo_weights.py builds them."""
    import jax.numpy as jnp
    from mind_tpu.data.semantic_map import build_lane_graph, lane_graph_features
    from mind_tpu.models.data_pipeline import scenario_to_batch
    from mind_tpu.planner.planner import type_onehot
    from mind_tpu.planner.scene_prep import LaneGraphStatic, TargetLaneStatic

    graph = build_lane_graph(jsmp.map_data, np.zeros(2), np.eye(2))
    feats = lane_graph_features(graph)
    Lm = cfg.max_lanes
    node_feats = np.zeros((Lm, 10, 16), np.float32)
    node_feats[:len(feats)] = feats
    anchors = np.zeros((Lm, 2), np.float32)
    anchors[:len(feats)] = graph["lane_ctrs"]
    vecs = np.tile(np.array([1.0, 0.0], np.float32), (Lm, 1))
    vecs[:len(feats)] = graph["lane_vecs"]
    lane_static = LaneGraphStatic(jnp.asarray(node_feats), jnp.asarray(anchors),
                                  jnp.asarray(vecs), jnp.asarray(np.arange(Lm) < len(feats)))
    lane = max(jsmp.semantic_lanes.values(), key=len)
    P = 256
    tp = np.full((P, 2), 1e6, np.float32)
    tp[:len(lane)] = lane
    tgt_static = TargetLaneStatic(jnp.asarray(tp), jnp.zeros((P, 12), jnp.float32),
                                  jnp.asarray(np.arange(P) < len(lane)), jnp.int32(len(lane)))
    types = np.stack([type_onehot(t[0]) for t in bundle.types]
                     + [np.zeros(7, np.float32)] * (cfg.max_actors - len(bundle)))
    return scenario_to_batch(bundle, lane_static, tgt_static, cfg, types)


def test_scenario_to_batch_matches_jax(tmp_path, monkeypatch):
    from mind_tpu.config import PlannerConfig as JPlannerConfig
    from mind_tpu.data import loader as jloader
    from mind_tpu.data.semantic_map import SemanticMap as JSemanticMap
    from mind_tpu_torch.config import PlannerConfig
    from mind_tpu_torch.data.loader import ArgoAgentLoader
    from mind_tpu_torch.data.semantic_map import SemanticMap
    from mind_tpu_torch.models.data_pipeline import PRED_LEN, stack_batches
    from mind_tpu_torch.synthetic import synthetic_av2, write_synthetic_map
    from mind_tpu_torch.train_weights import scene_batch
    from test_torch_data import to_jax_scenario

    syn = synthetic_av2(0)
    map_path = write_synthetic_map(syn.map_json, tmp_path, "synthetic")
    smp = SemanticMap().load_from_argo2(map_path)
    got = scene_batch(smp, ArgoAgentLoader.trajs_info_of(syn.scenario, smp), PlannerConfig(), CPU)
    monkeypatch.setattr(jloader, "load_scenario", lambda path: to_jax_scenario(syn.scenario))
    jsmp = JSemanticMap().load_from_argo2(map_path)
    want = jax_scene_batch(jsmp, jloader.ArgoAgentLoader("unused").get_trajs_info(jsmp),
                           JPlannerConfig())
    assert got.gt_pos.shape == (1, 48, PRED_LEN, 2) and got.actors.shape == (1, 48, 48, 14)
    for name, g, w in zip(ttrain.Batch._fields, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        if w.dtype == bool:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5, err_msg=name)
    assert got.gt_mask.sum() > 0 and bool(got.actor_mask[0, 0])
    two = stack_batches([got, got])
    assert all(x.shape[0] == 2 and torch.equal(x[1], y[0]) for x, y in zip(two, got))


def test_train_weights_cli(tmp_path, capsys, monkeypatch):
    """python -m mind_tpu_torch.train_weights for 3 steps on the CPU, on
    parquet files of four synthetic AV2 scenarios written under the demo
    configurations' sequence ids, with PlannerConfig's network narrowed to
    the tiny one."""
    pytest.importorskip("pandas")
    pytest.importorskip("pyarrow")
    import dataclasses
    import json

    from mind_tpu_torch import train_weights
    from mind_tpu_torch.config import PlannerConfig
    from mind_tpu_torch.models.checkpoint import load_params, steps
    from mind_tpu_torch.synthetic import synthetic_av2, write_synthetic_map
    from test_torch_data import SMALL_ROAD, scenario_frame

    def tiny_planner_config():
        cfg = PlannerConfig()
        cfg.net = dataclasses.replace(cfg.net, **{k: v for k, v in TINY.items() if k != "pred_len"})
        return cfg

    monkeypatch.setattr(train_weights, "PlannerConfig", tiny_planner_config)
    for d, path in enumerate(train_weights.DEMOS):
        seq = json.loads(open(path).read())["seq_id"]
        syn = synthetic_av2(d, **SMALL_ROAD)
        write_synthetic_map(syn.map_json, tmp_path, seq)
        scenario_frame(syn.scenario).to_parquet(tmp_path / seq / f"scenario_{seq}.parquet")
    out = tmp_path / "ckpt"
    losses = train_weights.main(["--steps", "3", "--data-root", str(tmp_path), "--out", str(out),
                                 "--device", "cpu"])
    text = capsys.readouterr().out
    assert "demo_4: batch built" in text and "step 0: loss" in text and "step 2: loss" in text
    assert len(losses) == 3 and np.isfinite(losses).all() and losses[-1] < losses[0]
    assert steps(out) == [3]
    like = ttrain.init_scene_pred(tiny_planner_config().net, seed=1, device=CPU)
    restored = load_params(out, like)
    assert set(restored) == set(like.state_dict())
    assert not all(torch.equal(restored[k], v) for k, v in like.state_dict().items())
