"""PyTorch ScenePredNet vs the flax ScenePredNet on the same inputs and the
same weights (carried across by params_from_flax), plus the guards of the
committed weight archive and of the port's imports."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from mind_tpu_torch.config import DEFAULT_WEIGHTS, NetConfig as TNetConfig
from mind_tpu_torch.models.weights import load_flax_npz, load_scene_pred, params_from_flax

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "mind_tpu_torch"

SMALL = dict(n_scene_layer=1, n_fpn_scale=2, d_actor=32, d_lane=32,
             d_embed=32, d_rpe=32, n_scene_head=4)


def make_inputs(rng, B, A, L, cfg):
    To = cfg.obs_len - 2
    N = A + L
    amask = rng.random((B, A)) > 0.2
    amask[:, 0] = True
    lmask = rng.random((B, L)) > 0.3
    return (
        rng.normal(0, 1, (B, A, To, cfg.in_actor)).astype(np.float32),
        amask,
        rng.normal(0, 1, (B, L, 10, cfg.in_lane)).astype(np.float32),
        lmask,
        rng.normal(0, 1, (B, N, N, cfg.d_rpe_in)).astype(np.float32),
        rng.normal(0, 1, (B, 10, cfg.in_lane)).astype(np.float32),
        rng.normal(0, 1, (B, 20)).astype(np.float32),
    )


def flat(params):
    from flax.traverse_util import flatten_dict

    return {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}


def run_port(tcfg, params, inputs):
    net = load_scene_pred(tcfg, None, torch.device("cpu"))
    net.load_state_dict(params_from_flax(flat(params)), strict=True)
    with torch.no_grad():
        return [g.numpy() for g in net(*map(torch.from_numpy, inputs))]


def run_both(jcfg, tcfg, params, inputs, A, L):
    import jax.numpy as jnp
    from mind_tpu.models.scene_pred import ScenePredNet, make_batched_apply

    batched_apply = make_batched_apply(ScenePredNet(jcfg), jcfg)
    want = batched_apply(params, *map(jnp.asarray, inputs))
    return [np.asarray(w) for w in want], run_port(tcfg, params, inputs)


def test_small_config_random_init_matches_flax():
    from mind_tpu.config import NetConfig
    from mind_tpu.models import init_scene_pred

    A, L = 6, 12
    jcfg = NetConfig(**SMALL, use_pallas_fusion=False)
    _, params, _ = init_scene_pred(jcfg, A, L, seed=3)
    inputs = make_inputs(np.random.default_rng(0), 3, A, L, jcfg)
    want, got = run_both(jcfg, TNetConfig(**SMALL), params, inputs, A, L)
    for w, g, name in zip(want, got, ("cls", "reg", "vel")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=name)


def test_small_config_bf16_matches_flax_with_pallas_kernel():
    """compute_dtype="bfloat16": the port's bf16 network (parameters in
    bf16, the fusion core's bf16 plain version) vs make_batched_apply with the
    Pallas kernel interpreted. Both round to bf16 at every encoder layer, at
    places that differ by a last bit, and the interpreted kernel leaves
    float32 activations unrounded where the port rounds them as the matrix
    unit does. Measured gaps: 8.4e-4 on cls_prob, 1.25e-2 m on positions,
    2.3e-2 on velocity, 5.4e-3 (relative + absolute) on covariance; each is
    held to about twice that. The port's float32 network lies 2.3e-3 and
    2.6e-2 m from its bf16 one on these inputs, outside the limits, so a
    network that quietly ran in float32 fails; the last lines check that."""
    from mind_tpu.config import NetConfig
    from mind_tpu.models import init_scene_pred

    A, L = 6, 12
    tol_cls, tol_pos = 1.6e-3, 2.4e-2
    jcfg = NetConfig(**SMALL, use_pallas_fusion=True, compute_dtype="bfloat16")
    _, params, _ = init_scene_pred(jcfg, A, L, seed=3)
    inputs = make_inputs(np.random.default_rng(0), 3, A, L, jcfg)
    tcfg = TNetConfig(**SMALL, compute_dtype="bfloat16")
    want, got = run_both(jcfg, tcfg, params, inputs, A, L)
    for w, g, name in zip(want, got, ("cls", "reg", "vel")):
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32, name
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=tol_cls, err_msg="cls_prob")
    np.testing.assert_allclose(got[1][..., :2], want[1][..., :2], rtol=0, atol=tol_pos,
                               err_msg="positions")
    # exp(covariance) reaches 6: relative to its size
    np.testing.assert_allclose(got[1][..., 2:], want[1][..., 2:], rtol=1.2e-2, atol=1.2e-2,
                               err_msg="covariance")
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=4.5e-2, err_msg="velocity")
    got32 = run_port(TNetConfig(**SMALL), params, inputs)
    assert np.abs(got[0] - got32[0]).max() > tol_cls
    assert np.abs(got[1][..., :2] - got32[1][..., :2]).max() > tol_pos
    assert np.abs(got32[0] - want[0]).max() > tol_cls


def test_bf16_network_holds_bf16_parameters_and_float32_buffers():
    net = load_scene_pred(TNetConfig(**SMALL, compute_dtype="bfloat16"), None,
                          torch.device("cpu"))
    assert {p.dtype for p in net.parameters()} == {torch.bfloat16}
    assert net.SceneDecoder_0.mat_T.dtype == torch.float32
    net32 = load_scene_pred(TNetConfig(**SMALL), None, torch.device("cpu"))
    assert {p.dtype for p in net32.parameters()} == {torch.float32}
    # the same seed gives the float32 weights rounded to bf16
    for (k, p), (_, q) in zip(net.named_parameters(), net32.named_parameters()):
        assert torch.equal(p, q.to(torch.bfloat16)), k


def test_production_config_trained_weights_match_flax():
    """Full width (D = 128, 6 layers, N = 129) with the trained checkpoint
    at B = 1. Tolerance 1e-4 absolute + relative: float32 sums taken in
    another order through 6 fusion layers and the Bezier decoder."""
    from mind_tpu.config import NetConfig

    from flax.traverse_util import unflatten_dict

    A, L = 48, 80
    jcfg = NetConfig(use_pallas_fusion=False)

    params = unflatten_dict(load_flax_npz(DEFAULT_WEIGHTS), sep="/")
    inputs = make_inputs(np.random.default_rng(1), 1, A, L, jcfg)
    want, got = run_both(jcfg, TNetConfig(), params, inputs, A, L)
    for w, g, name in zip(want, got, ("cls", "reg", "vel")):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=name)


def test_weight_archive_equals_orbax_checkpoint():
    """The committed .npz holds exactly the orbax checkpoint's arrays."""
    import jax
    from flax.traverse_util import flatten_dict, unflatten_dict
    from mind_tpu.models.checkpoint import load_params

    arc = load_flax_npz(DEFAULT_WEIGHTS)
    # the archive's own tree is the restore template (shapes and dtypes);
    # orbax refuses a template whose structure differs from the checkpoint
    like = unflatten_dict({k: jax.numpy.zeros(v.shape, v.dtype)
                           for k, v in arc.items()}, sep="/")
    ref = flatten_dict(load_params(ROOT / "weights" / "scene_pred_demo", like, 600),
                       sep="/")
    assert sorted(arc) == sorted(ref)
    for k, v in ref.items():
        assert arc[k].dtype == np.float32, k
        np.testing.assert_array_equal(arc[k], np.asarray(jax.device_get(v)), err_msg=k)


@pytest.mark.parametrize("param_out", ["bezier", "monomial", "none"])
def test_decoder_heads_match_flax(param_out):
    """Each param_out head of the port's SceneDecoder against the JAX
    package's on the same random context, actor, target and RPE inputs,
    with its parameters (the Dense_1 of the 'none' head regresses F * 5
    numbers): 1e-5 absolute + relative."""
    import jax
    import jax.numpy as jnp
    from mind_tpu.config import NetConfig
    from mind_tpu.models.scene_pred import SceneDecoder as JSceneDecoder

    from mind_tpu_torch.models.scene_pred import SceneDecoder

    small = dict(SMALL, pred_len=12)
    jcfg = NetConfig(**small, param_out=param_out)
    rng = np.random.default_rng(4)
    B, A, H = 3, 5, small["d_embed"]
    inputs = [rng.normal(0, 1, s).astype(np.float32)
              for s in ((B, H), (B, A, H), (B, small["d_lane"]), (B, 20))]
    dec = JSceneDecoder(jcfg)
    params = dec.init(jax.random.PRNGKey(2), *(jnp.asarray(x[0]) for x in inputs))
    want = jax.vmap(lambda *a: dec.apply(params, *a))(*map(jnp.asarray, inputs))
    net = SceneDecoder(TNetConfig(**small, param_out=param_out))
    net.load_state_dict(params_from_flax(flat(params)), strict=True)
    k = 12 if param_out == "none" else jcfg.bezier_order + 1
    assert net.Dense_1.weight.shape == (k * 5, H)
    with torch.no_grad():
        got = net(*map(torch.from_numpy, inputs))
    for g, w, name in zip(got, want, ("cls", "reg", "vel")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                   err_msg=f"{param_out} {name}")


def _kernel_launch_calls(tree):
    return [n for n in ast.walk(tree) if isinstance(n, ast.Call)
            and getattr(n.func, "attr", getattr(n.func, "id", "")) in
            ("fused_edge_attention", "fused_edge_attention_f32",
             "fused_edge_attention_bf16")]


def test_port_imports_no_jax_and_has_no_fallback():
    """Every module of the port: no jax/flax/orbax/mind_tpu import, and no
    `try` around a kernel launch."""
    files = sorted(PORT.rglob("*.py"))
    assert len(files) >= 10
    banned = ("jax", "flax", "orbax", "mind_tpu")
    for f in files:
        tree = ast.parse(f.read_text(), str(f))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top not in banned, f"{f}: imports {name}"
            if isinstance(node, ast.Try):
                launches = [c for stmt in node.body for c in _kernel_launch_calls(stmt)]
                assert not launches, f"{f}:{node.lineno}: try around a kernel launch"
