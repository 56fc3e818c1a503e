"""Fused edge-attention core: the port's plain PyTorch version vs the JAX
Pallas kernel (interpret mode) and its jnp twin on the CPU; the CUDA kernel
vs the plain version on the card (skipped without one). Tolerance 2e-4, as
tests/test_fusion_kernel.py holds the Pallas kernel."""

import numpy as np
import pytest
import torch

from mind_tpu_torch.ops import fusion_attention as tfa

D = E = 128
H = 8
TOL = 2e-4


def weights_np(seed, d=D, e=E):
    rng = np.random.default_rng(seed)
    w = {}
    for name in tfa.FusionWeights._fields:
        if name.startswith("w"):
            w[name] = rng.normal(0, 0.08, (d, d)).astype(np.float32)
        elif name.endswith("_g"):
            w[name] = (1 + rng.normal(0, 0.1, d)).astype(np.float32)
        else:
            w[name] = rng.normal(0, 0.1, d).astype(np.float32)
    return w


def inputs_np(seed, b, n, n_masked=5):
    rng = np.random.default_rng(seed)
    node = rng.normal(0, 1, (b, n, D)).astype(np.float32)
    edge = (rng.normal(0, 0.5, (b, n, n, E))).astype(np.float32)
    mask = np.tile(np.arange(n) < n - n_masked, (b, 1))
    return node, edge, mask


def torch_weights(w, device="cpu"):
    return tfa.FusionWeights(**{k: torch.tensor(v, device=device) for k, v in w.items()})


@pytest.mark.parametrize("b,n,update_edge", [(1, 32, True), (1, 40, True), (1, 32, False),
                                             (2, 129, True)])
def test_plain_matches_pallas_kernel_and_jnp_twin(b, n, update_edge):
    import jax
    import jax.numpy as jnp
    from mind_tpu.ops.fusion_attention import (
        FusionWeights,
        fused_edge_attention,
        fused_edge_attention_ref,
    )

    w = weights_np(0)
    node, edge, mask = inputs_np(1, b, n)
    jw = FusionWeights(**{k: jnp.asarray(v) for k, v in w.items()})
    got_out, got_edge = tfa.fused_edge_attention(
        torch.tensor(node), torch.tensor(edge), torch.tensor(mask), torch_weights(w), H,
        update_edge)
    for fn, kw in ((fused_edge_attention, dict(tj=8, interpret=True)),
                   (fused_edge_attention_ref, {})):
        want_out, want_edge = jax.vmap(
            lambda x, e, m: fn(x, e, m, jw, H, update_edge, **kw))(
                jnp.asarray(node), jnp.asarray(edge), jnp.asarray(mask))
        valid = n - 5  # masked tokens' outputs are not compared, as upstream
        np.testing.assert_allclose(got_out.numpy()[:, :valid],
                                   np.asarray(want_out)[:, :valid], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got_edge.numpy(), np.asarray(want_edge),
                                   rtol=TOL, atol=TOL)


def test_passthrough_returns_input_edge():
    w = torch_weights(weights_np(2))
    node, edge, mask = map(torch.tensor, inputs_np(3, 1, 16))
    _, edge_out = tfa.fused_edge_attention(node, edge, mask, w, H, update_edge=False)
    assert edge_out is edge


def test_flop_and_byte_counts():
    """The numbers the bound rests on, at the main path's shapes: the
    per-pair products alone are 2.18 GFLOP per scene with the edge update
    and 1.64 without; the per-token projections and the attention add
    0.027."""
    assert 2.18 < tfa.fused_edge_attention_flops(1, 129, 128, True) / 1e9 < 2.21
    assert 1.64 < tfa.fused_edge_attention_flops(1, 129, 128, False) / 1e9 < 1.67
    # 17.0 MB of edge in and out, plus nodes and weights
    assert 17.0 < tfa.fused_edge_attention_bytes(1, 129, 128, True) / 1e6 < 17.7


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """The sm_90a kernel vs the plain version on the card, at the main
    path's B = 8, N = 129 and at a ragged N = 40; both update modes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    w = torch_weights(weights_np(4), dev)
    for b, n in ((8, 129), (3, 40)):
        node, edge, mask = (torch.tensor(a, device=dev) for a in inputs_np(5, b, n))
        for update_edge in (True, False):
            before = tfa.fused_edge_attention.launches
            out, edge_out = tfa.fused_edge_attention(node, edge, mask, w, H, update_edge)
            torch.cuda.synchronize()
            assert tfa.fused_edge_attention.launches == before + 1
            ref_out, ref_edge = tfa.fused_edge_attention_ref(node, edge, mask, w, H,
                                                             update_edge)
            assert (out - ref_out).abs().max().item() < TOL
            assert (edge_out - ref_edge).abs().max().item() < TOL
            if not update_edge:
                assert edge_out is edge
    with pytest.raises(TypeError):
        tfa.fused_edge_attention(node.double(), edge, mask, w, H)
