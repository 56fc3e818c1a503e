"""The fused edge-attention core past the resident layout's domain: widths
above 128, widths that are not multiples of 16, and any head layout, which
the card's kernels take in their tiled layout (csrc/fusion_tiled.cuh).

On the CPU: both plain versions against the Pallas kernel in interpret mode
(as tests/test_torch_fusion_widths.py::pallas runs it) on a grid of (D, E,
heads), with and without the edge update; the wide and the ragged network
loading the JAX parameters strictly and computing the JAX forward; the
operation counts at the true widths against FlopCounterMode. On the card
(cuda-marked, skipped here): both kernels against their plain versions on
the card's grid, a batch against its slices at a ragged and a wide shape,
and a call the domain refuses (heads that do not divide D)."""

import functools

import numpy as np
import pytest
import torch
from test_torch_fusion_widths import (TOL, TOL_BF16_EDGE, TOL_BF16_KERNEL,
                                      TOL_BF16_KERNEL_MEAN, TOL_BF16_OUT, _card,
                                      _card_inputs, inputs_np, pallas, weights_np)

from mind_tpu_torch.ops import fusion_attention as tfa

# (D, E, heads): the wide network, ragged and past 128 (head width 13), the
# ragged network (head width 12, an edge narrower than the nodes), head width
# 6, 32 heads of width 2, and an odd edge row of 28 bytes
GRID = [(256, 256, 8), (130, 130, 10), (72, 40, 6), (36, 20, 6), (64, 64, 32), (12, 7, 3)]
# the card's grid adds the top of the domain, 64 heads, and more than 16
# heads just past 128
CARD_GRID = GRID + [(512, 512, 16), (512, 256, 64), (160, 512, 20)]
N_TOKENS, N_MASKED = 12, 3
# the two networks of this slice (mind_tpu's NetConfig takes both)
WIDE_NET = dict(d_actor=256, d_lane=256, d_embed=256, d_rpe=256, n_scene_head=8)
RAGGED_NET = dict(d_actor=72, d_lane=72, d_embed=72, d_rpe=40, n_scene_head=6)


@functools.lru_cache(maxsize=None)
def case(d, e, heads, update_edge, dtype):
    """(weights, node, edge, mask, the interpreted Pallas kernel's outputs)
    of one grid shape: made once, shared by the tests that need them."""
    w = weights_np(d + e + heads, d, e)
    node, edge, mask = inputs_np(d + heads, 1, N_TOKENS, d, e, N_MASKED)
    edge_dtype = "bfloat16" if dtype == "bfloat16" and update_edge else "float32"
    want = pallas(w, node, edge, mask, heads, update_edge, dtype, edge_dtype)
    return w, node, edge, mask, edge_dtype, want


@pytest.mark.parametrize("update_edge", [True, False])
@pytest.mark.parametrize("d,e,heads", GRID)
def test_plain_matches_pallas_kernel_past_the_resident_domain(d, e, heads, update_edge):
    w, node, edge, mask, _, (want_out, want_edge) = case(d, e, heads, update_edge, "float32")
    got_out, got_edge = tfa.fused_edge_attention(
        torch.tensor(node), torch.tensor(edge), torch.tensor(mask),
        tfa.FusionWeights(**{k: torch.tensor(v) for k, v in w.items()}), heads, update_edge)
    assert got_out.shape == (1, N_TOKENS, d) and got_edge.shape == (1, N_TOKENS, N_TOKENS, e)
    valid = N_TOKENS - N_MASKED   # masked tokens' outputs are not compared, as upstream
    np.testing.assert_allclose(got_out.numpy()[:, :valid], want_out[:, :valid], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got_edge.numpy(), want_edge, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("update_edge", [True, False])
@pytest.mark.parametrize("d,e,heads", GRID)
def test_bf16_plain_matches_pallas_kernel_past_the_resident_domain(d, e, heads, update_edge,
                                                                   monkeypatch):
    """As test_torch_fusion_widths.py::test_bf16_plain_matches_pallas_kernel_at_widths:
    bf16 node and weights, a bf16 edge with the edge update and a float32
    one without; as it is, and with the activations' rounding switched off."""
    w, node, edge, mask, edge_dtype, (want_out, want_edge) = case(d, e, heads, update_edge,
                                                                  "bfloat16")
    assert want_out.dtype == want_edge.dtype == np.float32
    bf = torch.bfloat16
    targs = (torch.tensor(node).to(bf), torch.tensor(edge).to(getattr(torch, edge_dtype)),
             torch.tensor(mask),
             tfa.FusionWeights(**{k: torch.tensor(v).to(bf) for k, v in w.items()}))
    valid = N_TOKENS - N_MASKED

    def check(tol_out, tol_edge):
        got_out, got_edge = tfa.fused_edge_attention(*targs, heads, update_edge)
        assert got_out.dtype == got_edge.dtype == torch.float32
        np.testing.assert_allclose(got_out.numpy()[:, :valid], want_out[:, :valid],
                                   rtol=0, atol=tol_out)
        np.testing.assert_allclose(got_edge.numpy(), want_edge, rtol=0, atol=tol_edge)

    check(TOL_BF16_OUT, TOL_BF16_EDGE)
    monkeypatch.setattr(tfa, "_round_bf16", lambda x: x.to(torch.float32))
    check(TOL, TOL)


@pytest.mark.parametrize("net", ["wide", "ragged"])
def test_network_loads_jax_params_and_matches_flax(net):
    """WIDE_NET and RAGGED_NET at 2 layers: the port's network takes the JAX
    parameters strictly (params_from_flax) and computes make_batched_apply's
    forward, its fusion core through the Pallas kernel interpreted, at
    test_torch_scene_pred.py's tolerance (1e-4), as
    test_torch_fusion_widths.py::test_narrow_edge_network_loads_jax_params_and_matches_flax
    holds the narrow-edge network."""
    from mind_tpu.config import NetConfig
    from mind_tpu.models import init_scene_pred
    from test_torch_scene_pred import make_inputs, run_both

    from mind_tpu_torch.config import NetConfig as TNetConfig

    widths = dict(WIDE_NET if net == "wide" else RAGGED_NET, n_scene_layer=2, n_fpn_scale=2)
    A, L = 6, 12
    jcfg = NetConfig(**widths, use_pallas_fusion=True)
    _, params, _ = init_scene_pred(jcfg, A, L, seed=5)
    layer = params["params"]["FusionNet_0"]["RelaFusionLayer_0"]
    assert layer["b_edge"].shape == (widths["d_rpe"],)
    inputs = make_inputs(np.random.default_rng(1), 2, A, L, jcfg)
    want, got = run_both(jcfg, TNetConfig(**widths), params, inputs, A, L)
    for w, g, name in zip(want, got, ("cls", "reg", "vel")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=name)


def test_counts_at_the_true_widths():
    """fused_edge_attention_flops at 72 / 40 / 6 and 64 / 64 / 32 (B = 2,
    N = 5) against the counts written out by hand at the true D, E and
    heads: no padded tile or head of the kernels' layouts enters them."""
    pairs, tokens = 2 * 5 * 5, 2 * 5
    for (d, e, h), folded, unfolded in (
            ((72, 40, 6), 2 * ((40 * 72 + 72 * 40 + 2 * 6 * 72) * pairs + 6 * 72 * 72 * tokens)
             + 4 * pairs * 72,
             2 * ((40 * 72 + 72 * 40 + 2 * 72 * 72) * pairs + 4 * 72 * 72 * tokens)
             + 4 * pairs * 72),
            ((64, 64, 32), 2 * ((64 * 64 * 2 + 2 * 32 * 64) * pairs + 6 * 64 * 64 * tokens)
             + 4 * pairs * 64,
             2 * ((64 * 64 * 2 + 2 * 64 * 64) * pairs + 4 * 64 * 64 * tokens)
             + 4 * pairs * 64)):
        assert tfa.fused_edge_attention_flops(2, 5, d, True, "float32", h, e=e) == folded
        for variant in ("bfloat16", "unfolded"):
            assert tfa.fused_edge_attention_flops(2, 5, d, True, variant, h, e=e) == unfolded
    assert tfa.fused_edge_attention_flops(2, 5, 72, True, "float32", 6, e=40) == 1298880
    assert tfa.fused_edge_attention_flops(2, 5, 64, True, "unfolded", 32, e=64) == 1978880
    # bytes: edge in and out, node in and out, the mask, Wm_e, six [D x D],
    # seven D-wide and five E-wide vectors, at the true widths
    assert tfa.fused_edge_attention_bytes(2, 5, 72, True, e=40) == \
        2 * (pairs * 40 * 4) + tokens * 72 * 8 + tokens + (40 * 72 + 6 * 72 * 72) * 4 \
        + (7 * 72 + 5 * 40) * 4


@pytest.mark.parametrize("d,e,heads", [(72, 40, 6), (64, 64, 32)])
@pytest.mark.parametrize("update_edge", [True, False])
def test_unfolded_count_equals_the_counter_at_ragged_heads(d, e, heads, update_edge):
    """FlopCounterMode's count of one plain call equals the unfolded count
    at the true widths and heads (head widths 12 and 2)."""
    from torch.utils.flop_counter import FlopCounterMode

    B, N = 2, 5
    g = torch.Generator().manual_seed(0)
    w = tfa.FusionWeights(*(torch.randn(tfa.weight_shape(f, d, e), generator=g)
                            for f in tfa.FusionWeights._fields))
    node, edge = torch.randn(B, N, d, generator=g), torch.randn(B, N, N, e, generator=g)
    with FlopCounterMode(display=False) as counter:
        tfa.fused_edge_attention_ref(node, edge, torch.ones(B, N, dtype=torch.bool), w, heads,
                                     update_edge)
    assert counter.get_total_flops() == tfa.fused_edge_attention_flops(
        B, N, d, update_edge, "unfolded", heads, e=e)


@pytest.mark.parametrize("d,e,heads,layout", [
    (128, 128, 8, "resident"), (32, 32, 4, "resident"), (16, 128, 1, "resident"),
    (128, 128, 16, "resident"), (256, 256, 8, "tiled"), (72, 40, 6, "tiled"),
    (64, 64, 32, "tiled"), (12, 7, 3, "tiled"), (128, 144, 8, "tiled"), (32, 32, 8, "tiled"),
    (128, 128, 32, "tiled"), (1, 1, 1, "tiled"), (512, 512, 64, "tiled")])
def test_kernel_layout(d, e, heads, layout):
    """The layout a library is built in: the resident one for the shapes the
    kernels took before the tiled one existed (kernel B's persistent main
    kernel there: 64-row chunks of 8-column tiles through a ring of 2-4
    stages), the tiled route elsewhere, in the pair-tile design: 128-pair
    tiles, kernel A folded from a head width of 8 and B never, each
    LayerNorm in an epilogue up to 128 wide."""
    assert tfa.kernel_domain(d, e, heads) is None
    assert tfa.kernel_layout(d, e, heads) == layout
    for variant in tfa.VARIANTS:
        m = tfa.kernel_smem(variant, d, e, heads)
        assert m.layout == layout
        if layout == "resident":
            assert m.regime == "resident" and m.scratch == 0
            if variant == "float32":
                assert m.tile == ()
            else:
                assert m.tile[:2] == (64, 8) and 2 <= m.tile[2] <= 4
            continue
        assert m.tile[0] == 128 and m.tj == 0
        assert m.fold == (variant == "float32" and d // heads >= 8)
        assert (m.regime, m.edge_ln) == tuple("epilogue" if x <= 128 else "row pass"
                                              for x in (d, e))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("d,e,heads", CARD_GRID)
def test_cuda_kernels_match_plain_past_the_resident_domain(d, e, heads):
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
@pytest.mark.parametrize("d,e,heads", [(72, 40, 6), (256, 256, 8)])
def test_cuda_batch_gap_past_the_resident_domain(d, e, heads):
    """32 nodes compute what each 8 of them compute alone, to the bit, in
    both kernels, at the ragged network's and the wide network's widths."""
    dev = _card()
    B, S = 8, 4
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
def test_cuda_call_past_the_top_of_the_domain_raises_before_a_launch():
    """The kernels' domain has no top: what they refuse is what the JAX
    function refuses, here 8 heads at D = 520 + 4, which do not divide it."""
    dev = _card()
    w, node, edge, mask = _card_inputs(524, 32, 1, 9, dev)
    before = tfa.fused_edge_attention.launches
    with pytest.raises(ValueError, match="does not divide D"):
        tfa.fused_edge_attention(node, edge, mask, w, 8)     # 8 heads at D = 524
    assert tfa.fused_edge_attention.launches == before
