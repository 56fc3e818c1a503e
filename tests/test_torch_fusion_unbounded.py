"""The fused edge-attention core with no width ceiling: D and E past 512 and
more than 64 heads, which the card's kernels take in the tiled route
(csrc/fusion_tiled.cuh) at any width: pair tiles whose shared memory does
not grow with the width, their intermediates in a pair scratch the wrapper
allocates per call.

On the CPU: both plain versions against the Pallas kernel in interpret mode
(as tests/test_torch_fusion_wide.py runs it) at four shapes past 512 or past
64 heads, with and without the edge update; the kernels' domain (exactly the
JAX function's); the layout mirror `kernel_smem` over a grid of widths to
16,384 and every head layout, and at the shapes the card ran before; the
768-wide network loading the JAX parameters strictly and computing the JAX
forward. On the card (cuda-marked, skipped here): both kernels against their
plain versions at chip_smoke.py's shapes past 512, and a batch against its
slices at 1376 wide."""

import functools

import numpy as np
import pytest
import torch
from test_torch_fusion_widths import (TOL, TOL_BF16_EDGE, TOL_BF16_KERNEL,
                                      TOL_BF16_KERNEL_MEAN, TOL_BF16_OUT, _card,
                                      _card_inputs, inputs_np, pallas, weights_np)

from mind_tpu_torch.ops import fusion_attention as tfa

# (D, E, heads): past 512 with a narrower edge, 256 heads of width 4 with a
# narrow edge, 520 heads of width 1, and a ragged 2,060-byte edge row with
# heads of width 103
GRID = [(640, 520, 10), (1024, 96, 256), (520, 130, 520), (1030, 515, 10)]
N_TOKENS, N_MASKED = 12, 3
# chip_smoke.py's WIDTHS_UNBOUNDED, each with its call's (B, N)
CARD_GRID = [(640, 640, 10, 8, 129), (768, 768, 12, 8, 129), (1024, 512, 128, 8, 129),
             (512, 512, 512, 8, 129), (1376, 1376, 8, 2, 129), (1056, 1056, 1056, 2, 129),
             (2048, 2048, 16, 2, 129), (1030, 515, 10, 2, 129), (8192, 256, 64, 1, 33)]
# the network of this slice, 12 heads of width 64 (mind_tpu's NetConfig takes it)
WIDER_NET = dict(d_actor=768, d_lane=768, d_embed=768, d_rpe=768, n_scene_head=12)


@functools.lru_cache(maxsize=None)
def case(d, e, heads, update_edge, dtype):
    """(weights, node, edge, mask, edge type, the interpreted Pallas kernel's
    outputs) of one grid shape, made once for the tests that need them."""
    w = weights_np(d + e + heads, d, e)
    node, edge, mask = inputs_np(d + heads, 1, N_TOKENS, d, e, N_MASKED)
    edge_dtype = "bfloat16" if dtype == "bfloat16" and update_edge else "float32"
    want = pallas(w, node, edge, mask, heads, update_edge, dtype, edge_dtype)
    return w, node, edge, mask, edge_dtype, want


@pytest.mark.parametrize("update_edge", [True, False])
@pytest.mark.parametrize("d,e,heads", GRID)
def test_plain_matches_pallas_kernel_past_512(d, e, heads, update_edge):
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
def test_bf16_plain_matches_pallas_kernel_past_512(d, e, heads, update_edge, monkeypatch):
    """As test_torch_fusion_wide.py holds the bf16 plain version: bf16 node
    and weights, a bf16 edge with the edge update and a float32 one without;
    as it is, and with the activations' rounding switched off."""
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


@pytest.mark.parametrize("d,e,heads", [
    (513, 1, 1), (1, 100000, 1), (640, 640, 10), (768, 768, 12), (1024, 512, 128),
    (512, 512, 512), (1056, 1056, 1056), (8192, 256, 64), (16384, 16384, 16384),
    (12345, 7, 823), (65536, 65536, 1)])
def test_domain_has_no_ceiling(d, e, heads):
    """Every width from 1 up and every head count that divides D."""
    assert tfa.kernel_domain(d, e, heads) is None
    tfa.check_domain(d, e, heads)


@pytest.mark.parametrize("d,e,heads,what", [
    (16, 0, 1, "E = 0"), (-1, 16, 1, "D = -1"), (16, 16, 0, "0 heads"),
    (1030, 515, 20, "20 heads"), (512, 512, 1024, "1024 heads")])
def test_domain_refuses_what_jax_refuses(d, e, heads, what):
    why = tfa.kernel_domain(d, e, heads)
    assert why is not None and what in why
    with pytest.raises(ValueError, match="at least 1|does not divide D"):
        tfa.check_domain(d, e, heads)
    assert not hasattr(tfa, "MAX_WIDTH") and not hasattr(tfa, "MAX_HEADS")


def _divisors(d):
    small = [h for h in range(1, int(d ** 0.5) + 1) if d % h == 0]
    return sorted(set(small + [d // h for h in small]))


# widths to 16,384: the narrowest, the resident top, each side of the
# epilogue LayerNorms' 128, the former column-block regimes' edges, odd and
# ragged ones
MIRROR_WIDTHS = (1, 7, 16, 100, 128, 129, 512, 513, 640, 1000, 1024, 1376, 2048, 2750,
                 3000, 3750, 4096, 6000, 8192, 12000, 12345, 16384)


def test_layout_mirror_fits_every_width_to_16384():
    """Every (D, E, heads) of the grid, in both variants, gets a layout whose
    dynamic shared memory stays within the card's 231,424 B and each
    kernel's static shared memory within 48 KB, one static entry a kernel
    the library reports; a tiled library takes 128-pair tiles in 4 stages
    whatever the width (128 columns, 64 for a library no wider than 64),
    folds where kernel A's head width is at least 8, runs a LayerNorm
    in an epilogue up to 128 wide, and keeps a pair scratch a pair of its
    float32 products (absent where it folds with both LayerNorms in
    epilogues), its memory rows and its logits."""
    seen = set()
    for d in MIRROR_WIDTHS:
        divs = _divisors(d)
        heads = {divs[0], divs[len(divs) // 2], divs[-1], *(h for h in divs if h <= 8)}
        for e in MIRROR_WIDTHS:
            for h in heads:
                for variant in tfa.VARIANTS:
                    m = tfa.kernel_smem(variant, d, e, h)
                    bf = variant == "bfloat16"
                    assert m.dynamic <= tfa.SMEM_BUDGET == 231424, (variant, d, e, h, m)
                    assert all(0 <= x <= tfa.STATIC_LIMIT == 49152 for x in m.static)
                    assert len(m.static) == (len(tfa.kernel_names(variant, d, e, h))
                                             if m.layout == "tiled" else 3)
                    if m.layout == "resident":
                        assert m.regime == "resident" and m.scratch == 0 and m.tj in (4, 8)
                        seen.add((variant, "resident", m.fold))
                        continue
                    wide = max(d, e) > 64
                    assert m.tile == (128, 128 if wide else 64, 4) and m.tj == 0
                    assert m.dynamic == ((132096 if wide else 99328) if bf else
                                         (73728 if wide else 57344))
                    assert m.fold == (not bf and d // h >= 8)
                    assert m.regime == ("epilogue" if d <= 128 else "row pass")
                    assert m.edge_ln == ("epilogue" if e <= 128 else "row pass")
                    s_bytes, m_bytes, l_bytes = m.pair_bytes
                    assert m.scratch == s_bytes + m_bytes + l_bytes and l_bytes == 4 * h
                    assert (s_bytes == 0) == (m.fold and d <= 128 and e <= 128)
                    assert m_bytes == (2 * -(-max(d, e) // 8) * 8 if bf else 4 * -(-d // 4) * 4)
                    seen.add((variant, m.fold, m.regime, m.edge_ln))
    # the grid reaches every route of both variants
    for variant in tfa.VARIANTS:
        folds = (True, False) if variant == "float32" else (False,)
        want = {(f, r, g) for f in folds for r in ("epilogue", "row pass")
                for g in ("epilogue", "row pass")}
        assert {k[1:] for k in seen if k[0] == variant and len(k) == 4} >= want
        assert (variant, "resident", variant == "float32") in seen


# (variant, D, E, heads) -> (layout, columns a block, dynamic bytes): every
# shape the card ran before this slice; kernel A's resident libraries as they
# were built then, kernel B's in its persistent main kernel (8-column tiles,
# the four weights and the chunks in TMA boxes, a ring of 2-4 stages), the tiled ones in the
# pair-tile design (no columns a block: 128-pair tiles, the largest
# product's shared memory)
CARD_BEFORE = {
    ("float32", 128, 128, 8): ("resident", 8, 231424),
    ("float32", 32, 32, 4): ("resident", 8, 29696),
    ("float32", 64, 32, 4): ("resident", 8, 58368),
    ("float32", 48, 80, 3): ("resident", 8, 77056),
    ("float32", 16, 16, 2): ("resident", 8, 11776),
    ("float32", 128, 64, 8): ("resident", 8, 165888),
    ("float32", 128, 128, 16): ("resident", 4, 198656),
    ("float32", 256, 256, 8): ("tiled", 0, 73728),
    ("float32", 512, 512, 16): ("tiled", 0, 73728),
    ("float32", 512, 256, 64): ("tiled", 0, 73728),
    ("float32", 160, 512, 20): ("tiled", 0, 73728),
    ("float32", 130, 130, 10): ("tiled", 0, 73728),
    ("float32", 72, 40, 6): ("tiled", 0, 73728),
    ("float32", 36, 20, 6): ("tiled", 0, 57344),
    ("float32", 64, 64, 32): ("tiled", 0, 57344),
    ("float32", 12, 7, 3): ("tiled", 0, 57344),
    ("bfloat16", 128, 128, 8): ("resident", 8, 226336),
    ("bfloat16", 32, 32, 4): ("resident", 8, 78896),
    ("bfloat16", 64, 32, 4): ("resident", 8, 89136),
    ("bfloat16", 48, 80, 3): ("resident", 8, 166960),
    ("bfloat16", 16, 16, 2): ("resident", 8, 72752),
    ("bfloat16", 128, 64, 8): ("resident", 8, 208944),
    ("bfloat16", 128, 128, 16): ("resident", 8, 226336),
    ("bfloat16", 256, 256, 8): ("tiled", 0, 132096),
    ("bfloat16", 512, 512, 16): ("tiled", 0, 132096),
    ("bfloat16", 512, 256, 64): ("tiled", 0, 132096),
    ("bfloat16", 160, 512, 20): ("tiled", 0, 132096),
    ("bfloat16", 130, 130, 10): ("tiled", 0, 132096),
    ("bfloat16", 72, 40, 6): ("tiled", 0, 132096),
    ("bfloat16", 36, 20, 6): ("tiled", 0, 99328),
    ("bfloat16", 64, 64, 32): ("tiled", 0, 99328),
    ("bfloat16", 12, 7, 3): ("tiled", 0, 99328),
}


@pytest.mark.parametrize("variant,d,e,heads", sorted(CARD_BEFORE))
def test_shapes_on_the_card_keep_their_layout(variant, d, e, heads):
    """The resident shapes the card ran before keep their layout and columns
    a block, with the bytes of their main kernel (kernel B's persistent one:
    no static shared memory), and their per-token kernels a block of 8
    tokens over the whole row (one column block, one chunk of k); the tiled
    ones take the pair-tile design's, their per-token products in tiles of
    64 tokens."""
    m = tfa.kernel_smem(variant, d, e, heads)
    assert (m.layout, m.tj, m.dynamic) == CARD_BEFORE[(variant, d, e, heads)]
    assert tfa.kernel_layout(d, e, heads) == m.layout
    dp = -(-d // 16) * 16
    fold = m.layout == "resident" and variant == "float32"
    if m.layout == "resident":
        assert m.static[0] == 8 * dp * 4 * (2 if fold else 1)
        assert m.regime == "resident" and m.scratch == 0
        assert m.static[1] == (12 * m.tj if variant == "float32" else 0)
    elif variant == "float32":
        # the per-token products' tiles: 64 tokens by 64 columns (fewer
        # columns below 64 wide), 32 k a step
        tn = next(t for t in (8, 16, 32, 64) if d <= t or t == 64)
        assert m.static[0] == m.static[-1] == 32 * 68 * 4 + 32 * (tn + 4) * 4
    else:
        # kernel B's per-token kernels: 8 tokens a block, as resident
        assert m.static[0] == m.static[1] == m.static[-1] == 8 * dp * 4
    if m.layout == "tiled":
        assert m.regime in ("epilogue", "row pass") and m.scratch == sum(m.pair_bytes) > 0


@pytest.mark.parametrize("variant,d,e,heads,fold,regime,edge_ln", [
    ("float32", 768, 768, 12, True, "row pass", "row pass"),
    ("bfloat16", 768, 768, 12, False, "row pass", "row pass"),
    ("float32", 1056, 1056, 1056, False, "row pass", "row pass"),
    ("bfloat16", 1056, 1056, 1056, False, "row pass", "row pass"),
    ("float32", 72, 40, 6, True, "epilogue", "epilogue"),
    ("bfloat16", 72, 40, 6, False, "epilogue", "epilogue"),
    ("float32", 64, 64, 32, False, "epilogue", "epilogue"),
    ("bfloat16", 64, 64, 32, False, "epilogue", "epilogue"),
    ("float32", 128, 144, 8, True, "epilogue", "row pass"),
    ("bfloat16", 128, 144, 8, False, "epilogue", "row pass"),
    ("float32", 8192, 256, 64, True, "row pass", "row pass"),
    ("bfloat16", 8192, 256, 64, False, "row pass", "row pass")])
def test_new_card_shapes_reach_their_regimes(variant, d, e, heads, fold, regime, edge_ln):
    """Shapes of chip_smoke.py reach the routes they are there for: the
    768-wide network folded in A and not in B, head width 1 unfolded in
    both, the ragged network and head width 2 with every LayerNorm in an
    epilogue, an edge wider than a tile beside a node row that fits one,
    and 8192 wide in row passes."""
    m = tfa.kernel_smem(variant, d, e, heads)
    assert (m.layout, m.fold, m.regime, m.edge_ln) == ("tiled", fold, regime, edge_ln)
    assert m.tile[0] == tfa.TILE_PAIRS == 128 and m.tile[2] == 4


def test_staged_scratch_a_call():
    """The pair scratch of a call: three 256-byte aligned buffers of B N^2
    pairs each (the float32 product rows, the memory rows, the logits) and
    the softmax statistics of B N tokens, as the wrapper allocates it from
    the library's bytes a pair; none in the resident layout."""
    for variant, shape in (("float32", (8192, 256, 64)), ("bfloat16", (768, 768, 12)),
                           ("float32", (72, 40, 6))):
        m = tfa.kernel_smem(variant, *shape)

        class Lib:
            pair_bytes, scratch_bytes = m.pair_bytes, m.scratch

        for b, n in ((1, 33), (8, 129), (3, 40)):
            pairs = b * n * n
            want = sum(-(-pairs * x // 256) * 256 for x in m.pair_bytes) \
                + -(-b * n * shape[2] * 8 // 256) * 256
            assert tfa.pair_scratch_bytes(variant, *shape, b, n) == want
            assert tfa._scratch(Lib, b, n, "cpu").numel() == want
    Lib.scratch_bytes = 0
    assert tfa._scratch(Lib, 8, 129, "cpu") is None
    assert tfa.pair_scratch_bytes("float32", 128, 128, 8, 8, 129) == 0


def test_wider_network_loads_jax_params_and_matches_flax():
    """WIDER_NET at 2 layers: the port's network takes the JAX parameters
    strictly (params_from_flax) and computes make_batched_apply's forward,
    its fusion core through the Pallas kernel interpreted, at
    test_torch_scene_pred.py's tolerance (1e-4), as
    test_torch_fusion_wide.py holds the 256-wide network."""
    from mind_tpu.config import NetConfig
    from mind_tpu.models import init_scene_pred
    from test_torch_scene_pred import make_inputs, run_both

    from mind_tpu_torch.config import NetConfig as TNetConfig

    widths = dict(WIDER_NET, n_scene_layer=2, n_fpn_scale=2)
    A, L = 6, 12
    jcfg = NetConfig(**widths, use_pallas_fusion=True)
    _, params, _ = init_scene_pred(jcfg, A, L, seed=5)
    layer = params["params"]["FusionNet_0"]["RelaFusionLayer_0"]
    assert layer["b_edge"].shape == (768,)
    inputs = make_inputs(np.random.default_rng(1), 2, A, L, jcfg)
    want, got = run_both(jcfg, TNetConfig(**widths), params, inputs, A, L)
    for w, g, name in zip(want, got, ("cls", "reg", "vel")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=name)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("d,e,heads,b,n", CARD_GRID)
def test_cuda_kernels_match_plain_past_512(d, e, heads, b, n):
    """Both kernels against their plain versions at the shape's B and N, with
    and without the edge update; kernel B with a bf16 and a float32 edge;
    each library's layout equal to its mirror."""
    dev = _card()
    bf = torch.bfloat16
    for variant in tfa.VARIANTS:
        lib = tfa.kernel_library(variant, (d, e, heads))
        m = tfa.kernel_smem(variant, d, e, heads)
        assert (lib.smem_bytes, lib.tj, lib.scratch_bytes) == (m.dynamic, m.tj, m.scratch)
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
                    assert diff.max().item() < TOL, (variant, update_edge)
                else:
                    assert diff.max().item() < TOL_BF16_KERNEL, (variant, update_edge)
                    assert diff.mean().item() < TOL_BF16_KERNEL_MEAN


@pytest.mark.cuda
def test_cuda_batch_gap_past_two_columns():
    """32 nodes compute what each 8 of them compute alone, to the bit, in
    both kernels, at 1376 / 1376 / 8 (every LayerNorm in a row pass)."""
    dev = _card()
    d, e, heads, B, S = 1376, 1376, 8, 8, 4
    w, node, edge, mask = _card_inputs(d, e, S * B, 33, dev, seed=7)
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
