"""Building blocks of the scene-prediction network (port of
mind_tpu/models/layers.py).

Submodules carry the names flax gives them (`Dense_0`, `LayerNorm_1`,
`Conv_0`, ...), so a flax parameter path maps onto a state_dict key by
joining with "." (see models/weights.py). Sequence layers keep the JAX
layout [..., T, C] at their interface and transpose to torch's [N, C, T]
only around the convolution.

A scene planned in a batch of scenes must compute what it computes alone
(common/batch_invariant.py, tools/batch_invariance.py): dense layers,
convolutions and a normalization's statistics run through
`batch_invariant.per_scene`, the mode attention's small products are
`batch_invariant.mm`.

Normalizations follow flax: variance as E[x^2] - E[x]^2 clipped at 0, then
(x - mean) * (rsqrt(var + eps) * scale) + bias.

Mixed types follow flax too, written out because PyTorch does not promote
the operands of a matrix product: a `Dense` brings input, weight and bias to
their common type (bfloat16 with bfloat16 -> bfloat16, float32 input with
bfloat16 weights -> float32), and a normalization takes its statistics and
its affine in float32 and returns the common type of input and parameters.
With float32 parameters and inputs every cast is a no-op.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from mind_tpu_torch.common.batch_invariant import mm, per_scene


def _flax_norm(x, dims, weight, bias, eps):
    out_dtype = torch.promote_types(x.dtype, weight.dtype)
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = per_scene(torch.mean, x, dim=dims, keepdim=True)
    mean2 = per_scene(torch.mean, x * x, dim=dims, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    y = (x - mean) * (torch.rsqrt(var + eps) * weight.to(x.dtype)) + bias.to(x.dtype)
    return y.to(out_dtype)


class Dense(nn.Linear):
    """flax nn.Dense: operands promoted to their common type. In bfloat16 the
    bias is added to the rounded product, as flax adds it."""

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        if dt == torch.bfloat16:
            return per_scene(F.linear, x.to(dt), self.weight.to(dt)) + self.bias.to(dt)
        return per_scene(F.linear, x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.Module):
    """flax nn.LayerNorm over the last axis."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return _flax_norm(x, (-1,), self.weight, self.bias, self.eps)


class GroupNorm1(nn.Module):
    """flax nn.GroupNorm(num_groups=1) on [..., T, C]: statistics over
    (T, C) per leading index, scale and bias per channel."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return _flax_norm(x, (-2, -1), self.weight, self.bias, self.eps)


class Conv1d(nn.Module):
    """Bias-free 1D convolution on [..., T, C] (flax nn.Conv layout)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int, stride: int = 1,
                 padding: int = 0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(c_out, c_in, kernel_size))
        nn.init.kaiming_uniform_(self.weight)

    def forward(self, x):
        lead = x.shape[:-2]
        h = x.reshape((-1,) + x.shape[-2:]).transpose(1, 2)   # [N, C, T]
        h = per_scene(F.conv1d, h, self.weight, stride=self.stride, padding=self.padding)
        h = h.transpose(1, 2)
        return h.reshape(lead + h.shape[-2:])


class GNConv1d(nn.Module):
    """Conv1d + GroupNorm(1 group) + optional ReLU (reference layers.py
    Conv1d with norm='GN', ng=1)."""

    def __init__(self, c_in: int, features: int, kernel_size: int = 3,
                 stride: int = 1, act: bool = True):
        super().__init__()
        pad = (kernel_size - 1) // 2
        self.Conv_0 = Conv1d(c_in, features, kernel_size, stride, pad)
        self.GroupNorm_0 = GroupNorm1(features)
        self.act = act

    def forward(self, x):  # [..., T, C]
        x = self.GroupNorm_0(self.Conv_0(x))
        return torch.relu(x) if self.act else x


class Res1d(nn.Module):
    """Residual temporal conv block (reference layers.py Res1d, GN ng=1)."""

    def __init__(self, c_in: int, features: int, stride: int = 1):
        super().__init__()
        self.GNConv1d_0 = GNConv1d(c_in, features, stride=stride, act=True)
        self.Conv_0 = Conv1d(features, features, 3, 1, 1)
        self.GroupNorm_0 = GroupNorm1(features)
        self.project = stride != 1 or c_in != features
        if self.project:
            self.Conv_1 = Conv1d(c_in, features, 1, stride, 0)
            self.GroupNorm_1 = GroupNorm1(features)

    def forward(self, x):  # [..., T, C_in]
        h = self.GroupNorm_0(self.Conv_0(self.GNConv1d_0(x)))
        identity = self.GroupNorm_1(self.Conv_1(x)) if self.project else x
        return torch.relu(h + identity)


def linear_upsample2(x):
    """Length-doubling linear interpolation matching
    F.interpolate(scale_factor=2, mode='linear', align_corners=False),
    written out as in the JAX package. x: [..., T, C] -> [..., 2T, C].

    Output k interpolates between rows lo = max(k - 1, 0) // 2 and
    hi = min(lo + 1, T - 1). Both are taken as slices of x with each row
    doubled, not by index_select: that one's gradient on the card is an
    atomic scatter, whose sums come out in another order at every run."""
    T = x.shape[-2]
    src = ((torch.arange(2 * T, device=x.device, dtype=torch.float32) + 0.5) / 2.0
           - 0.5).to(x.dtype)
    lo = torch.clamp(torch.floor(src).long(), 0, T - 1)
    w = torch.clamp(src - lo.to(x.dtype), 0.0, 1.0)
    x2 = x.unsqueeze(-2).expand(x.shape[:-1] + (2, x.shape[-1])).reshape(
        x.shape[:-2] + (2 * T, x.shape[-1]))                  # row r at 2r and 2r + 1
    h1 = min(1, T - 1)
    xl = torch.cat([x[..., :1, :], x2[..., :-1, :]], dim=-2)
    xh = torch.cat([x[..., h1:h1 + 1, :], x2[..., 2:, :], x[..., -1:, :]], dim=-2)
    return xl + (xh - xl) * w[:, None]


class MLPBlock(nn.Module):
    """Linear -> LayerNorm -> ReLU stack."""

    def __init__(self, c_in: int, features: tuple):
        super().__init__()
        self.n = len(features)
        for i, f in enumerate(features):
            setattr(self, f"Dense_{i}", Dense(c_in, f))
            setattr(self, f"LayerNorm_{i}", LayerNorm(f))
            c_in = f

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"Dense_{i}")(x)
            x = torch.relu(getattr(self, f"LayerNorm_{i}")(x))
        return x


class PointAggregateBlock(nn.Module):
    """PointNet-style aggregation over a lane's points
    (reference network.py:64-99). x: [..., P, H]."""

    def __init__(self, hidden_size: int, aggre_out: bool):
        super().__init__()
        H = hidden_size
        self.MLPBlock_0 = MLPBlock(H, (H, H))
        self.MLPBlock_1 = MLPBlock(2 * H, (H, H))
        self.LayerNorm_0 = LayerNorm(H)
        self.aggre_out = aggre_out

    def forward(self, x_inp):
        x = self.MLPBlock_0(x_inp)
        x_agg = x.amax(dim=-2, keepdim=True)
        x_cat = torch.cat([x, x_agg.expand_as(x)], dim=-1)
        out = self.LayerNorm_0(x_inp + self.MLPBlock_1(x_cat))
        if self.aggre_out:
            return out.amax(dim=-2)
        return out


class SelfAttentionEncoderLayer(nn.Module):
    """Post-LN transformer encoder layer (relu, norm-after) used for mode
    self-attention. x: [..., M, D]."""

    def __init__(self, d_model: int, n_head: int, d_ffn: int):
        super().__init__()
        D = d_model
        self.n_head = n_head
        self.Dense_0 = Dense(D, D)   # q
        self.Dense_1 = Dense(D, D)   # k
        self.Dense_2 = Dense(D, D)   # v
        self.Dense_3 = Dense(D, D)   # out
        self.LayerNorm_0 = LayerNorm(D)
        self.Dense_4 = Dense(D, d_ffn)
        self.Dense_5 = Dense(d_ffn, D)
        self.LayerNorm_1 = LayerNorm(D)

    def forward(self, x):
        D, H = x.shape[-1], self.n_head
        dh = D // H
        shp = x.shape[:-1] + (H, dh)
        q = self.Dense_0(x).reshape(shp)
        k = self.Dense_1(x).reshape(shp)
        v = self.Dense_2(x).reshape(shp)
        q, k, v = (t.transpose(-3, -2) for t in (q, k, v))            # [..., H, M, dh]
        logits = mm(q, k.transpose(-1, -2)) / (dh ** 0.5)                # [..., H, M, M]
        attn = torch.softmax(logits, dim=-1)
        sa = mm(attn, v).transpose(-3, -2).reshape(x.shape)
        x = self.LayerNorm_0(x + self.Dense_3(sa))
        ff = self.Dense_5(torch.relu(self.Dense_4(x)))
        return self.LayerNorm_1(x + ff)
