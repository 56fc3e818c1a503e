"""Building blocks of the scene-prediction network (port of
mind_tpu/models/layers.py).

Submodules carry the names flax gives them (`Dense_0`, `LayerNorm_1`,
`Conv_0`, ...), so a flax parameter path maps onto a state_dict key by
joining with "." (see models/weights.py). Sequence layers keep the JAX
layout [..., T, C] at their interface and transpose to torch's [N, C, T]
only around the convolution.

Normalizations follow flax: variance as E[x^2] - E[x]^2 clipped at 0, then
(x - mean) * (rsqrt(var + eps) * scale) + bias.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F


def _flax_norm(x, dims, weight, bias, eps):
    mean = x.mean(dim=dims, keepdim=True)
    mean2 = (x * x).mean(dim=dims, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    return (x - mean) * (torch.rsqrt(var + eps) * weight) + bias


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
        h = F.conv1d(h, self.weight, stride=self.stride, padding=self.padding)
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
    written out as in the JAX package. x: [..., T, C] -> [..., 2T, C]."""
    T = x.shape[-2]
    src = ((torch.arange(2 * T, device=x.device, dtype=torch.float32) + 0.5) / 2.0
           - 0.5).to(x.dtype)
    lo = torch.clamp(torch.floor(src).long(), 0, T - 1)
    hi = torch.clamp(lo + 1, 0, T - 1)
    w = torch.clamp(src - lo.to(x.dtype), 0.0, 1.0)
    xl = x.index_select(-2, lo)
    xh = x.index_select(-2, hi)
    return xl + (xh - xl) * w[:, None]


class MLPBlock(nn.Module):
    """Linear -> LayerNorm -> ReLU stack."""

    def __init__(self, c_in: int, features: tuple):
        super().__init__()
        self.n = len(features)
        for i, f in enumerate(features):
            setattr(self, f"Dense_{i}", nn.Linear(c_in, f))
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
        self.Dense_0 = nn.Linear(D, D)   # q
        self.Dense_1 = nn.Linear(D, D)   # k
        self.Dense_2 = nn.Linear(D, D)   # v
        self.Dense_3 = nn.Linear(D, D)   # out
        self.LayerNorm_0 = LayerNorm(D)
        self.Dense_4 = nn.Linear(D, d_ffn)
        self.Dense_5 = nn.Linear(d_ffn, D)
        self.LayerNorm_1 = LayerNorm(D)

    def forward(self, x):
        D, H = x.shape[-1], self.n_head
        dh = D // H
        shp = x.shape[:-1] + (H, dh)
        q = self.Dense_0(x).reshape(shp)
        k = self.Dense_1(x).reshape(shp)
        v = self.Dense_2(x).reshape(shp)
        logits = torch.einsum("...qhd,...khd->...hqk", q, k) / (dh ** 0.5)
        attn = torch.softmax(logits, dim=-1)
        sa = torch.einsum("...hqk,...khd->...qhd", attn, v).reshape(x.shape)
        x = self.LayerNorm_0(x + self.Dense_3(sa))
        ff = self.Dense_5(torch.relu(self.Dense_4(x)))
        return self.LayerNorm_1(x + ff)
