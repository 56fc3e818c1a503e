"""A scene computes in a batch what it computes alone
(mind_tpu_torch/common/batch_invariant.py).

`mm` and `mv` against PyTorch's matrix product (they sum in another order:
1e-12 at float64); `per_scene` against the same call on the whole batch
(1e-6 at float32: the same function, summed per scene); and, bit for bit,
each scene's rows of a per-scene call, and each scene's outputs of a
ScenePredNet forward under `scenes(S)`, against the scene alone. On the
card (skipped without one) the same for the full-width network and both
fusion kernels.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mind_tpu_torch.common import batch_invariant as bi
from mind_tpu_torch.config import NetConfig
from mind_tpu_torch.models.weights import load_scene_pred

SMALL = dict(n_scene_layer=1, n_fpn_scale=2, d_actor=32, d_lane=32,
             d_embed=32, d_rpe=32, n_scene_head=4)


def rand(*shape, seed=0, dtype=torch.float32):
    return torch.tensor(np.random.default_rng(seed).normal(size=shape), dtype=dtype)


def test_mm_mv_match_matmul():
    a = rand(2, 3, 4, 5, dtype=torch.float64)
    b = rand(3, 5, 6, seed=1, dtype=torch.float64)      # broadcast over the leading 2
    v = rand(2, 3, 5, seed=2, dtype=torch.float64)
    np.testing.assert_allclose(bi.mm(a, b).numpy(), (a @ b).numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(bi.mv(a, v).numpy(), (a @ v[..., None])[..., 0].numpy(),
                               rtol=0, atol=1e-12)


CALLS = {
    "linear": (lambda x: F.linear(x, rand(5, 7, seed=1), rand(5, seed=2)), (12, 4, 7)),
    "conv1d": (lambda x: F.conv1d(x, rand(6, 7, 3, seed=1), stride=2, padding=1), (12, 7, 9)),
    "mean": (lambda x: torch.mean(x, dim=(-2, -1), keepdim=True), (12, 40, 33)),
    "einsum": (lambda x: torch.einsum("fk,bkd->bfd", rand(9, 4, seed=1), x), (12, 4, 2)),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_per_scene_equals_each_scene_alone(name):
    """Within scenes(3) a call on 3 scenes' rows: close to the one call on
    all of them, and each scene's rows equal to the call on them alone."""
    fn, shape = CALLS[name]
    x = rand(*shape)
    assert torch.equal(bi.per_scene(fn, x), fn(x))          # outside: one call
    with bi.scenes(3):
        got = bi.per_scene(fn, x)
    np.testing.assert_allclose(got.numpy(), fn(x).numpy(), rtol=0, atol=1e-6)
    for s, part in enumerate(x.chunk(3)):
        assert torch.equal(got[4 * s:4 * (s + 1)], fn(part.clone())), s


def test_per_scene_needs_whole_scenes():
    with bi.scenes(5), pytest.raises(ValueError):
        bi.per_scene(torch.mean, rand(12, 3))


def network_inputs(B, A, L, cfg, seed=0):
    rng = np.random.default_rng(seed)
    N = A + L
    amask = rng.random((B, A)) > 0.2
    amask[:, 0] = True
    lmask = rng.random((B, L)) > 0.3
    arrays = (rng.normal(0, 1, (B, A, cfg.obs_len - 2, cfg.in_actor)), amask,
              rng.normal(0, 1, (B, L, 10, cfg.in_lane)), lmask,
              rng.normal(0, 1, (B, N, N, cfg.d_rpe_in)), rng.normal(0, 1, (B, 10, cfg.in_lane)),
              rng.normal(0, 1, (B, 20)))
    return [torch.tensor(a) if a.dtype == bool else torch.tensor(a, dtype=torch.float32)
            for a in arrays]


def scene_gaps(net, inputs, S):
    """Each scene's outputs of one forward of S scenes' nodes under
    scenes(S) against the forward of that scene's nodes alone: the largest
    abs gap per output."""
    B = inputs[0].shape[0] // S
    with torch.no_grad():
        with bi.scenes(S):
            whole = net(*inputs)
        alone = [net(*(x[s * B:(s + 1) * B] for x in inputs)) for s in range(S)]
    return [max(float((w[s * B:(s + 1) * B] - alone[s][k]).abs().max()) for s in range(S))
            for k, w in enumerate(whole)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_network_scene_equals_alone(dtype):
    """A small ScenePredNet, 3 scenes of 2 nodes: every output of every
    scene equal to the bit to the scene's forward alone."""
    cfg = NetConfig(**SMALL, compute_dtype=dtype)
    net = load_scene_pred(cfg, None, torch.device("cpu"))
    assert scene_gaps(net, network_inputs(6, 6, 12, cfg), 3) == [0.0, 0.0, 0.0]


@pytest.mark.cuda
def test_cuda_scene_equals_alone():
    """On the card: the full-width bf16 network (the demo configuration's),
    4 scenes of 8 nodes, and both fusion kernels, 32 nodes against each 8
    alone: equal to the bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fusion kernels run on the card only")
    from mind_tpu_torch.ops import fusion_attention as fa
    from mind_tpu_torch.synthetic import fusion_inputs

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = NetConfig(compute_dtype="bfloat16")
    net = load_scene_pred(cfg, None, dev)
    inputs = [x.to(dev) for x in network_inputs(32, 48, 80, cfg)]
    assert scene_gaps(net, inputs, 4) == [0.0, 0.0, 0.0]
    ww, node, edge = fusion_inputs(32, 129, 128, dev)
    mask = (torch.arange(129, device=dev) < 120)[None].expand(32, -1).contiguous()
    for weights in (ww, fa.FusionWeights(*(t.to(torch.bfloat16) for t in ww))):
        out, e_out = fa.fused_edge_attention(node, edge, mask, weights, 8, True)
        for k in (0, 8, 24):
            o, e = fa.fused_edge_attention(*(t[k:k + 8].clone() for t in (node, edge, mask)),
                                           weights, 8, True)
            assert torch.equal(out[k:k + 8], o) and torch.equal(e_out[k:k + 8], e)
