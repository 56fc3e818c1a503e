"""The fused edge-attention core at every width the TPU kernel takes: node
width D, edge width E and head count apart from the main path's 128 / 128 / 8.

On the CPU: both plain versions against the Pallas kernel in interpret mode
(as tests/test_fusion_kernel.py runs it) on a grid of (D, E, heads), with and
without the edge update; the port's network with an edge narrower than its
nodes, loading the JAX parameters strictly and computing the JAX forward; the
kernels' domain query; the operation and byte counts at E != D. On the card
(cuda-marked, skipped here): both kernels against their plain versions on
the grid, a batch against its slices, and a call outside the domain."""

import numpy as np
import pytest
import torch

from mind_tpu_torch.ops import fusion_attention as tfa

# (D, E, heads): the JAX tests' narrow network, a narrower edge, widths and a
# head count that are no powers of two, and a narrower edge at full node width
GRID = [(32, 32, 4), (64, 32, 4), (48, 80, 3), (128, 64, 8)]
# the card's grid adds the narrowest shape and 16 heads at full width
CARD_GRID = GRID + [(16, 16, 2), (128, 128, 16)]
TOL = 2e-4
# as test_torch_fusion_attention.py::test_bf16_plain_matches_pallas_kernel
TOL_BF16_OUT, TOL_BF16_EDGE = 1e-2, 3e-2
# as test_torch_fusion_attention.py's card tests
TOL_BF16_KERNEL, TOL_BF16_KERNEL_MEAN = 2e-2, 1e-4


def weights_np(seed, d, e):
    rng = np.random.default_rng(seed)
    w = {}
    for name in tfa.FusionWeights._fields:
        shape = tfa.weight_shape(name, d, e)
        if name.startswith("w"):
            w[name] = rng.normal(0, 0.08 * (128 / shape[0]) ** 0.5, shape).astype(np.float32)
        elif name.endswith("_g"):
            w[name] = (1 + rng.normal(0, 0.1, shape)).astype(np.float32)
        else:
            w[name] = rng.normal(0, 0.1, shape).astype(np.float32)
    return w


def inputs_np(seed, b, n, d, e, n_masked=3):
    rng = np.random.default_rng(seed)
    node = rng.normal(0, 1, (b, n, d)).astype(np.float32)
    edge = rng.normal(0, 0.5, (b, n, n, e)).astype(np.float32)
    mask = np.tile(np.arange(n) < n - n_masked, (b, 1))
    return node, edge, mask


def pallas(w, node, edge, mask, heads, update_edge, dtype="float32", edge_dtype="float32"):
    """mind_tpu's Pallas kernel, interpreted, vmapped over the batch."""
    import jax
    import jax.numpy as jnp
    from mind_tpu.ops.fusion_attention import FusionWeights, fused_edge_attention

    jw = FusionWeights(**{k: jnp.asarray(v).astype(dtype) for k, v in w.items()})
    out, edge_new = jax.vmap(
        lambda x, e, m: fused_edge_attention(x, e, m, jw, heads, update_edge, tj=8,
                                             interpret=True))(
            jnp.asarray(node).astype(dtype), jnp.asarray(edge).astype(edge_dtype),
            jnp.asarray(mask))
    return np.asarray(out), np.asarray(edge_new)


@pytest.mark.parametrize("update_edge", [True, False])
@pytest.mark.parametrize("d,e,heads", GRID)
def test_plain_matches_pallas_kernel_at_widths(d, e, heads, update_edge):
    w = weights_np(d + e + heads, d, e)
    node, edge, mask = inputs_np(1, 1, 20, d, e)
    want_out, want_edge = pallas(w, node, edge, mask, heads, update_edge)
    got_out, got_edge = tfa.fused_edge_attention(
        torch.tensor(node), torch.tensor(edge), torch.tensor(mask),
        tfa.FusionWeights(**{k: torch.tensor(v) for k, v in w.items()}), heads, update_edge)
    assert got_out.shape == (1, 20, d) and got_edge.shape == (1, 20, 20, e)
    valid = 20 - 3   # masked tokens' outputs are not compared, as upstream
    np.testing.assert_allclose(got_out.numpy()[:, :valid], want_out[:, :valid], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got_edge.numpy(), want_edge, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("update_edge", [True, False])
@pytest.mark.parametrize("d,e,heads", GRID)
def test_bf16_plain_matches_pallas_kernel_at_widths(d, e, heads, update_edge, monkeypatch):
    """The bf16 plain version against the interpreted kernel with bf16
    node and weights: held as test_bf16_plain_matches_pallas_kernel holds it
    at 128, as it is and with the activations' rounding switched off. The
    edge is bf16 with the edge update (the first layer) and float32
    without (the last)."""
    edge_dtype = "bfloat16" if update_edge else "float32"
    w = weights_np(d + e + heads, d, e)
    node, edge, mask = inputs_np(2, 1, 20, d, e)
    want_out, want_edge = pallas(w, node, edge, mask, heads, update_edge, "bfloat16",
                                 edge_dtype)
    assert want_out.dtype == want_edge.dtype == np.float32
    bf = torch.bfloat16
    targs = (torch.tensor(node).to(bf), torch.tensor(edge).to(getattr(torch, edge_dtype)),
             torch.tensor(mask),
             tfa.FusionWeights(**{k: torch.tensor(v).to(bf) for k, v in w.items()}))
    valid = 20 - 3

    def check(tol_out, tol_edge):
        got_out, got_edge = tfa.fused_edge_attention(*targs, heads, update_edge)
        assert got_out.dtype == got_edge.dtype == torch.float32
        np.testing.assert_allclose(got_out.numpy()[:, :valid], want_out[:, :valid],
                                   rtol=0, atol=tol_out)
        np.testing.assert_allclose(got_edge.numpy(), want_edge, rtol=0, atol=tol_edge)

    check(TOL_BF16_OUT, TOL_BF16_EDGE)
    # with the activations left unrounded it is the interpreted kernel's arithmetic
    monkeypatch.setattr(tfa, "_round_bf16", lambda x: x.to(torch.float32))
    check(TOL, TOL)


# the fault's guard: a network whose edge (d_rpe) is narrower than its nodes
NARROW_EDGE = dict(n_scene_layer=2, n_fpn_scale=2, d_actor=32, d_lane=32,
                   d_embed=64, d_rpe=32, n_scene_head=4)


def test_fusion_layer_parameters_have_the_jax_shapes():
    """be and the two edge LayerNorms are E wide, as the JAX layer declares
    them (mind_tpu/models/scene_pred.py::RelaFusionLayer)."""
    from mind_tpu_torch.config import NetConfig
    from mind_tpu_torch.models.weights import load_scene_pred

    net = load_scene_pred(NetConfig(**NARROW_EDGE), None, torch.device("cpu"))
    layer = net.FusionNet_0.RelaFusionLayer_0
    shapes = {f: tuple(t.shape) for f, t in layer.fusion_weights()._asdict().items()}
    assert shapes == {f: tfa.weight_shape(f, 64, 32) for f in tfa.FusionWeights._fields}
    assert shapes["be"] == shapes["ln_e1_g"] == shapes["ln_e2_b"] == (32,)
    assert shapes["bm"] == shapes["bo"] == (64,)


@pytest.mark.parametrize("use_pallas_fusion", [True, False])
def test_narrow_edge_network_loads_jax_params_and_matches_flax(use_pallas_fusion):
    """d_embed = 64, d_rpe = 32, 4 heads: the port's network takes the JAX
    parameters strictly (params_from_flax) and computes make_batched_apply's
    forward, with the Pallas kernel interpreted and through its jnp twin, at
    test_torch_scene_pred.py's tolerance (1e-4)."""
    from mind_tpu.config import NetConfig
    from mind_tpu.models import init_scene_pred
    from test_torch_scene_pred import make_inputs, run_both

    from mind_tpu_torch.config import NetConfig as TNetConfig

    A, L = 6, 12
    jcfg = NetConfig(**NARROW_EDGE, use_pallas_fusion=use_pallas_fusion)
    _, params, _ = init_scene_pred(jcfg, A, L, seed=5)
    assert params["params"]["FusionNet_0"]["RelaFusionLayer_0"]["b_edge"].shape == (32,)
    inputs = make_inputs(np.random.default_rng(1), 2, A, L, jcfg)
    want, got = run_both(jcfg, TNetConfig(**NARROW_EDGE), params, inputs, A, L)
    for w, g, name in zip(want, got, ("cls", "reg", "vel")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("d,e,heads", [(128, 128, 8), (32, 32, 4), (64, 32, 4), (48, 80, 3),
                                       (16, 16, 2), (128, 64, 8), (128, 128, 16),
                                       (16, 128, 1), (112, 112, 14), (96, 96, 12),
                                       (80, 80, 10), (48, 48, 2),
                                       # outside the resident layout
                                       (24, 32, 3), (32, 40, 4), (144, 128, 8), (128, 256, 8),
                                       (32, 32, 8), (128, 128, 32), (1, 1, 1), (512, 512, 64),
                                       (7, 512, 7),
                                       # past 512 wide and 64 heads
                                       (520, 128, 8), (128, 513, 8), (640, 640, 8),
                                       (256, 256, 128), (512, 512, 512)])
def test_domain_query_inside(d, e, heads):
    assert tfa.kernel_domain(d, e, heads) is None
    tfa.check_domain(d, e, heads)


# what the JAX function refuses too
REFUSED = "at least 1|does not divide D"


@pytest.mark.parametrize("d,e,heads,what", [
    (0, 16, 1, "D = 0"),            # no width
    (48, 48, 5, "5 heads"),         # does not divide D
])
def test_domain_query_outside(d, e, heads, what, monkeypatch):
    """Outside the domain: the query says why, and a launcher raises
    ValueError before any build (kernel_library) or launch."""
    why = tfa.kernel_domain(d, e, heads)
    assert why is not None and what in why
    with pytest.raises(ValueError, match=REFUSED):
        tfa.check_domain(d, e, heads)
    with pytest.raises(ValueError):
        tfa.compile_kernels([(d, e, heads)])

    def no_build(*_):
        raise AssertionError("a launcher built a library outside the domain")

    monkeypatch.setattr(tfa, "kernel_library", no_build)
    w = tfa.FusionWeights(**{k: torch.zeros(tfa.weight_shape(k, d, e))
                             for k in tfa.FusionWeights._fields})
    node, edge = torch.zeros(1, 3, d), torch.zeros(1, 3, 3, e)
    mask = torch.ones(1, 3, dtype=torch.bool)
    before = tfa.fused_edge_attention.launches
    for launch, ww in ((tfa._launch_f32, w),
                       (tfa._launch_bf16, tfa.FusionWeights(*(t.bfloat16() for t in w)))):
        with pytest.raises(ValueError, match=REFUSED):
            launch(node, edge, mask, ww, heads, True)
    assert tfa.fused_edge_attention.launches == before


def test_launchers_check_edge_wide_weights():
    """Inside the domain, a launcher holds every tensor to its width: be at
    D where it must be E is refused before any build."""
    d, e = 64, 32
    w = tfa.FusionWeights(**{k: torch.zeros(tfa.weight_shape(k, d, e))
                             for k in tfa.FusionWeights._fields})
    node, edge = torch.zeros(1, 3, d), torch.zeros(1, 3, 3, e)
    mask = torch.ones(1, 3, dtype=torch.bool)
    with pytest.raises(ValueError, match="be has shape"):
        tfa._launch_f32(node, edge, mask, w._replace(be=torch.zeros(d)), 4, True)


def test_qk_scale_and_build_defines():
    """The scale a library is built with is float32(1 / sqrt(dh)), as the JAX
    kernel computes it, written so that nvcc reads back the same float."""
    assert tfa._qk_scale(128, 8) == 0.25
    for d, heads in ((32, 4), (48, 3), (80, 10), (128, 16), (96, 2)):
        want = np.float32(1.0 / (d // heads) ** 0.5)
        got = tfa._qk_scale(d, heads)
        assert np.float32(got) == want and float(np.float32(got)) == got
        defines = tfa._nvcc_defines((d, 16, heads))
        assert defines[:3] == [f"-DFUSION_D={d}", "-DFUSION_E=16", f"-DFUSION_NH={heads}"]
        assert np.float32(float(defines[3].split("=")[1])) == want
    # one library per variant and shape, the full width's among them
    paths = {tfa._library_path(v, s) for v in tfa.VARIANTS
             for s in (tfa.FULL_WIDTH, (32, 32, 4))}
    assert len(paths) == 4 and all("x" in p.name for p in paths)


def test_counts_at_a_narrower_edge():
    """fused_edge_attention_flops and _bytes at B = 2, N = 5, D = 32,
    E = 16, 4 heads, against the counts written out by hand."""
    B, N, D, E, H = 2, 5, 32, 16, 4
    pairs, tokens = B * N * N, B * N        # 50, 10
    # folded float32: per pair the [E x D] memory product and the [D x E]
    # edge update, the per-head logits and weighted memory (2 H D); six
    # [D x D] products per token; 4 D a pair besides
    folded = 2 * ((16 * 32 + 32 * 16 + 2 * 4 * 32) * 50 + 6 * 32 * 32 * 10) + 4 * 50 * 32
    assert folded == 257280
    assert tfa.fused_edge_attention_flops(B, N, D, True, "float32", H, e=E) == folded
    assert tfa.fused_edge_attention_flops(B, N, D, False, "float32", H, e=E) == \
        2 * ((16 * 32 + 2 * 4 * 32) * 50 + 6 * 32 * 32 * 10) + 4 * 50 * 32
    # unfolded (kernel B, the TPU kernel): memory, edge update, keys and
    # values per pair, q.k and attention.v (4 D a pair), four per token
    unfolded = 2 * ((16 * 32 + 32 * 16 + 2 * 32 * 32) * 50 + 4 * 32 * 32 * 10) + 4 * 50 * 32
    assert unfolded == 395520
    for variant in ("bfloat16", "unfolded"):
        assert tfa.fused_edge_attention_flops(B, N, D, True, variant, H, e=E) == unfolded
    # float32 bytes: edge in and out, node in and out, the mask, Wm_e, six
    # [D x D], seven D-wide and five E-wide vectors
    nbytes = (2 * 25 * 16 * 4) * 2 + 2 * 5 * 32 * (4 + 4) + 10 \
        + (16 * 32 + 6 * 32 * 32) * 4 + (7 * 32 + 5 * 16) * 4
    assert nbytes == 36810
    assert tfa.fused_edge_attention_bytes(B, N, D, True, e=E) == nbytes
    # bf16 edge and node in, 2-byte weights, float32 edge out
    assert tfa.fused_edge_attention_bytes(B, N, D, True, 2, 2, 2, e=E) == \
        2 * 25 * 16 * 2 + 2 * 25 * 16 * 4 + 2 * 5 * 32 * (2 + 4) + 10 \
        + (16 * 32 + 6 * 32 * 32) * 2 + (7 * 32 + 5 * 16) * 4
    # at E = D the counts are those of the full-width call
    assert tfa.fused_edge_attention_flops(1, 129, 128, True, e=128) == \
        tfa.fused_edge_attention_flops(1, 129, 128, True)


@pytest.mark.parametrize("update_edge", [True, False])
def test_unfolded_count_equals_the_counter_at_a_narrower_edge(update_edge):
    """As test_torch_bench.py::test_flop_count_of_the_fusion_core, at E != D:
    FlopCounterMode's count of one plain call equals the unfolded count."""
    from torch.utils.flop_counter import FlopCounterMode

    B, N, D, E, H = 3, 10, 48, 32, 3
    g = torch.Generator().manual_seed(0)
    w = tfa.FusionWeights(*(torch.randn(tfa.weight_shape(f, D, E), generator=g)
                            for f in tfa.FusionWeights._fields))
    node, edge = torch.randn(B, N, D, generator=g), torch.randn(B, N, N, E, generator=g)
    with FlopCounterMode(display=False) as counter:
        tfa.fused_edge_attention_ref(node, edge, torch.ones(B, N, dtype=torch.bool), w, H,
                                     update_edge)
    assert counter.get_total_flops() == tfa.fused_edge_attention_flops(
        B, N, D, update_edge, "unfolded", H, e=E)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_inputs(d, e, b, n, dev, seed=0):
    w = weights_np(seed, d, e)
    node, edge, mask = inputs_np(seed + 1, b, n, d, e)
    return (tfa.FusionWeights(**{k: torch.tensor(v, device=dev) for k, v in w.items()}),
            torch.tensor(node, device=dev), torch.tensor(edge, device=dev),
            torch.tensor(mask, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("d,e,heads", CARD_GRID)
def test_cuda_kernels_match_plain_at_widths(d, e, heads):
    """Both kernels against their plain versions at B = 8, N = 129 and a
    ragged B = 3, N = 40, with and without the edge update; kernel B with a
    bf16 and a float32 edge."""
    dev = _card()
    bf = torch.bfloat16
    for b, n in ((8, 129), (3, 40)):
        w, node, edge, mask = _card_inputs(d, e, b, n, dev)
        w16 = tfa.FusionWeights(*(t.to(bf) for t in w))
        for update_edge in (True, False):
            cases = [("float32", (node, edge, mask, w), tfa.fused_edge_attention_ref)]
            cases += [("bfloat16", (node.to(dt), edge.to(dt), mask, w16),
                       tfa.fused_edge_attention_bf16_ref) for dt in (bf, torch.float32)]
            for variant, args, ref in cases:
                before = tfa.fused_edge_attention.launches_by_variant[variant]
                out, edge_out = tfa.fused_edge_attention(*args, heads, update_edge)
                torch.cuda.synchronize()
                assert tfa.fused_edge_attention.launches_by_variant[variant] == before + 1
                assert out.shape == (b, n, d) and edge_out.shape == (b, n, n, e)
                ref_out, ref_edge = ref(*args, heads, update_edge)
                for got, want in ((out, ref_out), (edge_out, ref_edge)):
                    diff = (got - want).abs()
                    if variant == "float32":
                        assert diff.max().item() < TOL, (variant, b, n, update_edge)
                    else:
                        assert diff.max().item() < TOL_BF16_KERNEL, (variant, b, update_edge)
                        assert diff.mean().item() < TOL_BF16_KERNEL_MEAN


@pytest.mark.cuda
def test_cuda_batch_gap_at_the_narrow_network():
    """32 nodes of the 4-head 32-wide network compute what each 8 of them
    compute alone, to the bit, in both kernels."""
    dev = _card()
    d, e, heads, B, S = 32, 32, 4, 8, 4
    w, node, edge, mask = _card_inputs(d, e, S * B, 129, dev, seed=7)
    w16 = tfa.FusionWeights(*(t.to(torch.bfloat16) for t in w))
    for ww, dt in ((w, torch.float32), (w16, torch.bfloat16), (w16, torch.float32)):
        for update_edge in (True, False):
            x, ed = node.to(dt), edge.to(dt)
            whole = tfa.fused_edge_attention(x, ed, mask, ww, heads, update_edge)
            for k in range(0, S * B, B):
                cut = lambda t: t[k:k + B].clone()
                alone = tfa.fused_edge_attention(cut(x), cut(ed), cut(mask), ww, heads,
                                                 update_edge)
                for a, b in zip(whole, alone):
                    assert torch.equal(a[k:k + B], b)


@pytest.mark.cuda
def test_cuda_call_outside_the_domain_raises_before_a_launch():
    dev = _card()
    w, node, edge, mask = _card_inputs(32, 32, 1, 9, dev)
    before = tfa.fused_edge_attention.launches
    with pytest.raises(ValueError, match=REFUSED):
        tfa.fused_edge_attention(node, edge, mask, w, 5)     # 5 heads do not divide D
    assert tfa.fused_edge_attention.launches == before
