"""Fused edge-attention core: the port's plain PyTorch version vs the JAX
Pallas kernel (interpret mode) and its jnp twin on the CPU; the CUDA kernel
vs the plain version on the card (skipped without one). Tolerance 2e-4, as
tests/test_fusion_kernel.py holds the Pallas kernel.

The bf16 operand mode: the port's second plain version vs the Pallas kernel in
interpret mode with bf16 node, weights and (first-layer) edge. On the CPU the
interpreted kernel multiplies a float32 activation (mem, a later layer's edge)
with bf16 weights in float32, where the plain version rounds the activation
to bf16 as the matrix unit and the CUDA kernel do. So each case is held twice:
with that rounding switched off to 2e-4 (the same arithmetic), and as it is to
1e-2 on the output and 3e-2 on the edge (the rounding's 2^-9 relative error
on 128 summands, after two LayerNorms; measured 3.4e-3 and 1.6e-2)."""

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
    """The numbers the bounds rest on, at the main path's shapes. float32
    counts the folded form (keys and values never formed per pair): 1.16
    GFLOP per scene with the edge update and 0.61 without, against 2.18 and
    1.64 unfolded, which is what the bf16 variant and the TPU kernel run."""
    assert 1.15 < tfa.fused_edge_attention_flops(1, 129, 128, True) / 1e9 < 1.20
    assert 0.61 < tfa.fused_edge_attention_flops(1, 129, 128, False) / 1e9 < 0.66
    for variant in ("unfolded", "bfloat16"):
        assert 2.18 < tfa.fused_edge_attention_flops(1, 129, 128, True, variant) / 1e9 < 2.21
        assert 1.64 < tfa.fused_edge_attention_flops(1, 129, 128, False, variant) / 1e9 < 1.67
    # 17.0 MB of edge in and out, plus nodes and weights
    assert 17.0 < tfa.fused_edge_attention_bytes(1, 129, 128, True) / 1e6 < 17.7
    # bf16 variant at B = 8: 68.2 MB of float32 edge in and 68.2 MB out
    assert 136.3 < tfa.fused_edge_attention_bytes(8, 129, 128, True, 4, 4, 2) / 1e6 < 137.7
    # first layer: bf16 edge in (34.1 MB), float32 edge out
    assert 102.2 < tfa.fused_edge_attention_bytes(8, 129, 128, True, 2, 2, 2) / 1e6 < 103.4
    # last layer: float32 edge read, none written
    assert 68.1 < tfa.fused_edge_attention_bytes(8, 129, 128, False, 4, 4, 2) / 1e6 < 69.6


TOL_BF16_OUT, TOL_BF16_EDGE = 1e-2, 3e-2
BF16_CASES = [(32, True, "bfloat16"), (40, True, "float32"), (32, False, "bfloat16"),
              (129, True, "float32")]


def bf16_inputs(seed_w, seed_x, b, n, edge_dtype, device="cpu", node_dtype="bfloat16"):
    """Weights (bf16), node and edge (bf16 or float32) as torch tensors, and
    the numpy arrays they were rounded from."""
    w = weights_np(seed_w)
    node, edge, mask = inputs_np(seed_x, b, n)
    tw = tfa.FusionWeights(**{k: torch.tensor(v, device=device).to(torch.bfloat16)
                              for k, v in w.items()})
    te = torch.tensor(edge, device=device).to(getattr(torch, edge_dtype))
    tn = torch.tensor(node, device=device).to(getattr(torch, node_dtype))
    return (w, node, edge, mask), (tn, te, torch.tensor(mask, device=device), tw)


@pytest.mark.parametrize("n,update_edge,edge_dtype", BF16_CASES)
def test_bf16_plain_matches_pallas_kernel(n, update_edge, edge_dtype, monkeypatch):
    import jax
    import jax.numpy as jnp
    from mind_tpu.ops.fusion_attention import FusionWeights, fused_edge_attention

    (w, node, edge, mask), targs = bf16_inputs(0, 1, 1, n, edge_dtype)
    bf = jnp.bfloat16
    jw = FusionWeights(**{k: jnp.asarray(v).astype(bf) for k, v in w.items()})
    want_out, want_edge = jax.vmap(
        lambda x, e, m: fused_edge_attention(x, e, m, jw, H, update_edge, tj=8,
                                             interpret=True))(
            jnp.asarray(node).astype(bf), jnp.asarray(edge).astype(edge_dtype),
            jnp.asarray(mask))
    want_out, want_edge = np.asarray(want_out), np.asarray(want_edge)
    assert want_out.dtype == want_edge.dtype == np.float32
    valid = n - 5

    def check(tol_out, tol_edge):
        got_out, got_edge = tfa.fused_edge_attention(*targs, H, update_edge)
        assert got_out.dtype == got_edge.dtype == torch.float32
        np.testing.assert_allclose(got_out.numpy()[:, :valid], want_out[:, :valid],
                                   rtol=0, atol=tol_out)
        np.testing.assert_allclose(got_edge.numpy(), want_edge, rtol=0, atol=tol_edge)

    check(TOL_BF16_OUT, TOL_BF16_EDGE)
    # with the activations left unrounded it is the interpreted kernel's arithmetic
    monkeypatch.setattr(tfa, "_round_bf16", lambda x: x.to(torch.float32))
    check(TOL, TOL)


@pytest.mark.parametrize("edge_dtype", ["bfloat16", "float32"])
def test_bf16_passthrough_returns_float32(edge_dtype):
    """update_edge=False in the bf16 mode: the edge comes back as float32,
    whatever came in, with the input's values."""
    _, (node, edge, mask, w) = bf16_inputs(2, 3, 1, 16, edge_dtype)
    out, edge_out = tfa.fused_edge_attention(node, edge, mask, w, H, update_edge=False)
    assert out.dtype == edge_out.dtype == torch.float32
    assert torch.equal(edge_out, edge.to(torch.float32))


def test_wrapper_refuses_other_weight_types():
    w = torch_weights(weights_np(2))
    node, edge, mask = map(torch.tensor, inputs_np(3, 1, 8))
    w64 = tfa.FusionWeights(*(t.double() for t in w))
    with pytest.raises(TypeError):
        tfa.fused_edge_attention(node.double(), edge.double(), mask, w64, H)


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


# kernel B vs its plain version on the card: sums in another order, and a
# float32 activation that lies on a bf16 rounding boundary may round the other
# way in the kernel. One such flip of a mem value between 2 and 4 is a step of
# 2^-6 on one of a row's 128 summands; through a weight of 0.3 and two
# LayerNorms it moves an edge output by up to ~1e-2 (measured max 7.1e-3).
# Flips are rare, so the mean error is held far tighter (measured 2.6e-6).
TOL_BF16_KERNEL = 2e-2
TOL_BF16_KERNEL_MEAN = 1e-4


@pytest.mark.cuda
def test_cuda_bf16_kernel_matches_plain():
    """The tensor-core kernel vs the bf16 plain version on the card, at
    B = 8, N = 129 and a ragged N = 40, and at the B and N whose tiles of 8
    (scene, target) columns lie inside a scene, straddle two, span up to
    eight (N < 8) or end ragged: B in {1, 3, 8, 32, 128}, N in {1, 7, 9, 33,
    129} (tests/test_torch_fusion_resident.py walks the schedule there); both
    update modes, and every pair of node and edge types it takes (the network
    gives it both bf16 in the first layer and both float32 in the later
    ones), the two the network gives at B = 32 and 128."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    calls = [(8, 129), (3, 40), (1, 1), (1, 7), (3, 7), (1, 9), (3, 9), (8, 9), (3, 33),
             (8, 33), (1, 129), (3, 129), (32, 129), (128, 129)]
    for b, n in calls:
        types = (("bfloat16", "bfloat16"), ("float32", "float32"), ("bfloat16", "float32"),
                 ("float32", "bfloat16"))
        for node_dtype, edge_dtype in types[:2] if b >= 32 else types:
            _, (node, edge, mask, w) = bf16_inputs(4, 5, b, n, edge_dtype, dev, node_dtype)
            for update_edge in (True, False):
                before = dict(tfa.fused_edge_attention.launches_by_variant)
                out, edge_out = tfa.fused_edge_attention(node, edge, mask, w, H, update_edge)
                torch.cuda.synchronize()
                after = tfa.fused_edge_attention.launches_by_variant
                assert after["bfloat16"] == before["bfloat16"] + 1
                assert after["float32"] == before["float32"]
                ref_out, ref_edge = tfa.fused_edge_attention_bf16_ref(node, edge, mask, w, H,
                                                                      update_edge)
                assert out.dtype == edge_out.dtype == torch.float32
                for got, ref in ((out, ref_out), (edge_out, ref_edge)):
                    diff = (got - ref).abs()
                    assert diff.max().item() < TOL_BF16_KERNEL
                    assert diff.mean().item() < TOL_BF16_KERNEL_MEAN
    with pytest.raises(TypeError):
        tfa.fused_edge_attention(node.double(), edge, mask, w, H)
    with pytest.raises(TypeError):   # bias / LayerNorm vectors must be bf16 too
        tfa.fused_edge_attention(node, edge, mask, w._replace(bm=w.bm.float()), H)


class _StubLibrary:
    """Stands in for a built kernel library on the CPU: records, at each
    launch, the device the caller made current and the stream it passed.
    Its layout is one whose rows lie in shared memory (no scratch), as the
    loader records it on a library (columns a block, scratch a pair)."""

    tj, scratch_bytes = 8, 0

    def __init__(self, current):
        self.current, self.calls = current, []

    def _launch(self, *args):
        self.calls.append((self.current[-1] if self.current else None, args[-1]))
        return 0

    fused_edge_attention_f32 = fused_edge_attention_bf16 = _launch


@pytest.mark.parametrize("variant", ["float32", "bfloat16"])
def test_launch_runs_under_the_tensors_device(variant, monkeypatch):
    """Each launch wrapper makes the tensors' device current around the
    library call (a launch, and its cudaFuncSetAttribute, apply to the
    current device: on a second card, a launch from the first one's context
    into the second one's stream fails) and passes that device's stream.
    The library, torch.cuda.device and torch.cuda.current_stream are stubs,
    so the wrappers run on CPU tensors."""
    import contextlib

    current = []

    @contextlib.contextmanager
    def device(d):
        current.append(torch.device(d))
        try:
            yield
        finally:
            current.pop()

    streams = {}
    lib = _StubLibrary(current)
    monkeypatch.setattr(tfa, "kernel_library", lambda variant, shape: lib)
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: streams.setdefault(
        torch.device(d), type("Stream", (), {"cuda_stream": 1000 + len(streams)})()))
    w = torch_weights(weights_np(1))
    node, edge, mask = map(torch.tensor, inputs_np(2, 1, 8))
    launch = tfa._launch_f32
    if variant == "bfloat16":
        w = tfa.FusionWeights(*(t.to(torch.bfloat16) for t in w))
        launch = tfa._launch_bf16
    before = tfa.fused_edge_attention.launches_by_variant[variant]
    for update_edge in (True, False):
        launch(node, edge, mask, w, H, update_edge)
    tfa.fused_edge_attention.launches_by_variant[variant] = before
    tfa.fused_edge_attention.launches -= 2
    cpu = torch.device("cpu")
    assert lib.calls == [(cpu, streams[cpu].cuda_stream)] * 2 and current == []
