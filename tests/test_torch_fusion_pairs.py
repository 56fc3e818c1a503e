"""The tiled route's pair tiles (csrc/fusion_tiled.cuh): the folded form of
kernel A at tiled widths, the head-width rule that decides the fold, and on
the card both redesigned kernels against their plain versions.

On the CPU: a helper in this file computes the float32 core in the folded
order kernel A takes from a head width of 8 (logits mem . qt_h with
qt_h = Wk[:, h] q_h / sqrt(dh), the output (sum_i p mem) Wv[:, h] + bv); it
is held against mind_tpu's Pallas kernel in interpret mode (as
tests/test_torch_fusion_widths.py runs it) at three tiled shapes, with and
without the edge update. The fold rule is checked through the layout
mirror (`kernel_smem`, `tiled_fold`). On the card (cuda-marked, skipped
here): both kernels against their plain versions at every tiled shape of
chip_smoke.py's widths grid, and a batch of scenes against each scene
alone."""

import numpy as np
import pytest
import torch
from test_torch_fusion_widths import (TOL, TOL_BF16_KERNEL, TOL_BF16_KERNEL_MEAN, _card,
                                      _card_inputs, inputs_np, pallas, weights_np)

from mind_tpu_torch.ops import fusion_attention as tfa

# tiled shapes the fold takes (head widths 32, 8 and 12), N = 12
FOLD_GRID = [(256, 256, 8), (160, 96, 20), (72, 40, 6)]
N_TOKENS, N_MASKED = 12, 3
# the tiled shapes of chip_smoke.py's WIDTHS_GRID below 1,024 wide, each at
# a small call (B, N), for the card tests (the wider ones run in chip_smoke)
CARD_GRID = [(256, 256, 8), (512, 512, 16), (512, 256, 64), (160, 512, 20), (130, 130, 10),
             (72, 40, 6), (36, 20, 6), (64, 64, 32), (12, 7, 3), (640, 640, 10),
             (768, 768, 12), (512, 512, 512)]


def _ln(x, g, b):
    m = x.mean(-1, keepdims=True)
    v = ((x - m) ** 2).mean(-1, keepdims=True)
    return (x - m) / torch.sqrt(v + 1e-5) * g + b


def folded_core(node, edge, mask, w, n_head, update_edge):
    """The float32 core in kernel A's folded order at a tiled width: per
    pair the memory product (and the edge update), then per head the logits
    mem . qt_h and the context sum_i p mem; keys and values are never formed
    per pair. node [B, N, D], edge [B, N, N, E], mask [B, N] bool."""
    B, N, D = node.shape
    dh = D // n_head
    mem = torch.relu(_ln(torch.einsum("bije,ed->bijd", edge, w.wm_e)
                         + (node @ w.wm_s)[:, :, None] + (node @ w.wm_t + w.bm)[:, None],
                         w.ln_m_g, w.ln_m_b))
    if update_edge:
        eu = torch.relu(_ln(torch.einsum("bijd,de->bije", mem, w.we) + w.be,
                            w.ln_e1_g, w.ln_e1_b))
        edge_new = _ln(edge + eu, w.ln_e2_g, w.ln_e2_b)
    else:
        edge_new = edge
    q = (node @ w.wq + w.bq).reshape(B, N, n_head, dh)
    # qt[b, j, h, c] = sum_d Wk[c, h dh + d] q[b, j, h, d] / sqrt(dh)
    qt = torch.einsum("chd,bjhd->bjhc", w.wk.reshape(D, n_head, dh), q) \
        * np.float32(1 / dh ** 0.5)
    logits = torch.einsum("bijc,bjhc->bjhi", mem, qt)
    logits = torch.where(mask[:, None, None, :], logits, torch.tensor(-1e9))
    p = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bjhi,bijc->bjhc", p, mem)
    # attn[b, j, c] = ctx[b, j, head of c] . Wv[:, c]
    attn = torch.einsum("bjhk,khd->bjhd", ctx, w.wv.reshape(D, n_head, dh)).reshape(B, N, D)
    return (attn + w.bv) @ w.wo + w.bo, edge_new


@pytest.mark.parametrize("update_edge", [True, False])
@pytest.mark.parametrize("d,e,heads", FOLD_GRID)
def test_folded_order_matches_pallas_kernel(d, e, heads, update_edge):
    assert tfa.kernel_layout(d, e, heads) == "tiled" and tfa.tiled_fold("float32", d, heads)
    w = weights_np(d + e + heads, d, e)
    node, edge, mask = inputs_np(d + heads, 1, N_TOKENS, d, e, N_MASKED)
    want_out, want_edge = pallas(w, node, edge, mask, heads, update_edge)
    got_out, got_edge = folded_core(
        torch.tensor(node), torch.tensor(edge), torch.tensor(mask),
        tfa.FusionWeights(**{k: torch.tensor(v) for k, v in w.items()}), heads, update_edge)
    valid = N_TOKENS - N_MASKED   # masked tokens' outputs are not compared, as upstream
    np.testing.assert_allclose(got_out.numpy()[:, :valid], want_out[:, :valid], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got_edge.numpy(), want_edge, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("d,e,heads,fold", [
    (256, 256, 8, True), (160, 96, 20, True), (72, 40, 6, True), (512, 256, 64, True),
    (1024, 512, 128, True), (2048, 2048, 16, True), (8192, 256, 64, True),
    (130, 130, 10, True), (1030, 515, 10, True), (36, 20, 6, False), (64, 64, 32, False),
    (12, 7, 3, False), (512, 512, 512, False), (1056, 1056, 1056, False),
    (128, 128, 32, False), (520, 130, 130, False)])
def test_fold_rule_by_head_width(d, e, heads, fold):
    """Kernel A's tiled route folds from a head width of 8, whatever D, E
    and the head count; kernel B never folds; the resident layout keeps its
    own (A folds, B does not). The mirror's scratch follows: the folded A
    keeps no float32 product rows where both LayerNorms run in epilogues."""
    assert tfa.kernel_layout(d, e, heads) == "tiled"
    a, b = tfa.kernel_smem("float32", d, e, heads), tfa.kernel_smem("bfloat16", d, e, heads)
    assert a.fold == tfa.tiled_fold("float32", d, heads) == fold == (d // heads >= 8)
    assert not b.fold and not tfa.tiled_fold("bfloat16", d, heads)
    names = tfa.kernel_names("float32", d, e, heads)
    assert ("fold_keys" in names) == ("fold_values" in names) == fold
    assert any(k in names for k in ("product keys", "product keys, values")) == (not fold)
    assert ("logits" in names) == (not fold and not tfa.logits_epilogue("float32", d, heads))
    assert (a.pair_bytes[0] == 0) == (fold and d <= tfa.EPI_MAX and e <= tfa.EPI_MAX)
    assert tfa.kernel_smem("float32", 128, 128, 8).fold
    assert not tfa.kernel_smem("bfloat16", 128, 128, 8).fold


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("d,e,heads", CARD_GRID)
def test_cuda_pair_tiles_match_plain(d, e, heads):
    """Both redesigned kernels against their plain versions at B = 3, N =
    40, with and without the edge update, kernel B with a bf16 and a float32
    edge; each library in the tiled route its mirror gives."""
    dev = _card()
    bf = torch.bfloat16
    for variant in tfa.VARIANTS:
        lib = tfa.kernel_library(variant, (d, e, heads))
        m = tfa.kernel_smem(variant, d, e, heads)
        assert m.layout == "tiled" and (lib.smem_bytes, lib.pair_bytes) == (m.dynamic,
                                                                             m.pair_bytes)
    w, node, edge, mask = _card_inputs(d, e, 3, 40, dev)
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
            ref_out, ref_edge = ref(*args, heads, update_edge)
            for got, want in ((out, ref_out), (edge_out, ref_edge)):
                diff = (got - want).abs()
                if variant == "float32":
                    assert diff.max().item() < TOL, (variant, update_edge)
                else:
                    assert diff.max().item() < TOL_BF16_KERNEL, (variant, update_edge)
                    assert diff.mean().item() < TOL_BF16_KERNEL_MEAN


@pytest.mark.cuda
@pytest.mark.parametrize("d,e,heads", [(256, 256, 8), (12, 7, 3), (512, 512, 512)])
def test_cuda_pair_tiles_batch_gap(d, e, heads):
    """12 scenes compute what each 4 of them compute alone, to the bit, in
    both kernels: the tiles cut the pairs at other rows in a batch."""
    dev = _card()
    B, S = 4, 3
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
