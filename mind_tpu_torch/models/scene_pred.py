"""ScenePredNet in PyTorch (port of mind_tpu/models/scene_pred.py).

Joint multi-agent multi-modal scene prediction: conv-FPN actor encoder,
PointNet lane encoder, edge-conditioned fusion transformer and a Bezier
regression decoder. The forward is batched over a leading axis of AIME
branch nodes (the JAX package vmaps the unbatched module).

Inputs (B = batch of tree nodes):
  actors     [B, A, To, 14]   history features, time-major (To = obs_len - 2)
  actor_mask [B, A]
  lanes      [B, L, 10, 16]
  lane_mask  [B, L]
  rpe        [B, N, N, 5]     N = A + L (no cls)
  tgt_nodes  [B, 10, 16]
  tgt_rpe    [B, 20]

Outputs:
  cls [B, M]            mode probabilities (softmax)
  reg [B, A, M, F, 5]   positions (2) + exp(cov) (2) + unused 5th channel
  vel [B, A, M, F, 2]   velocities from the Bezier derivative matrix

The fusion-layer core goes through ops.fusion_attention.fused_edge_attention:
the CUDA kernel for CUDA tensors, the plain twin for CPU tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from mind_tpu_torch.config import NetConfig
from mind_tpu_torch.models.layers import (
    GNConv1d,
    LayerNorm,
    MLPBlock,
    PointAggregateBlock,
    Res1d,
    SelfAttentionEncoderLayer,
    linear_upsample2,
)
from mind_tpu_torch.ops.fusion_attention import FusionWeights, fused_edge_attention


class ActorNet(nn.Module):
    """1D-conv FPN over agent history (reference network.py:12-61).
    x: [..., T, 14] -> [..., D]."""

    def __init__(self, c_in: int, hidden_size: int = 128, n_fpn_scale: int = 4):
        super().__init__()
        self.n_fpn_scale = n_fpn_scale
        widths = []
        c = c_in
        for s in range(n_fpn_scale):
            f = 2 ** (5 + s)
            setattr(self, f"Res1d_{2 * s}", Res1d(c, f, stride=1 if s == 0 else 2))
            setattr(self, f"Res1d_{2 * s + 1}", Res1d(f, f, stride=1))
            widths.append(f)
            c = f
        # lateral convs in flax creation order: deepest scale first
        for k, f in enumerate(reversed(widths)):
            setattr(self, f"GNConv1d_{k}", GNConv1d(f, hidden_size, act=False))
        setattr(self, f"Res1d_{2 * n_fpn_scale}", Res1d(hidden_size, hidden_size))

    def forward(self, x):
        S = self.n_fpn_scale
        outs = []
        h = x
        for s in range(S):
            h = getattr(self, f"Res1d_{2 * s}")(h)
            h = getattr(self, f"Res1d_{2 * s + 1}")(h)
            outs.append(h)
        out = self.GNConv1d_0(outs[-1])
        for k, i in enumerate(range(S - 2, -1, -1), start=1):
            out = linear_upsample2(out)
            out = out + getattr(self, f"GNConv1d_{k}")(outs[i])
        out = getattr(self, f"Res1d_{2 * S}")(out)
        return out[..., -1, :]  # last timestep


class LaneNet(nn.Module):
    """PointNet-ish per-lane encoder (reference network.py:102-121).
    feats: [..., P, 16] -> [..., D]."""

    def __init__(self, c_in: int, hidden_size: int = 128):
        super().__init__()
        self.MLPBlock_0 = MLPBlock(c_in, (hidden_size,))
        self.PointAggregateBlock_0 = PointAggregateBlock(hidden_size, aggre_out=False)
        self.PointAggregateBlock_1 = PointAggregateBlock(hidden_size, aggre_out=True)

    def forward(self, feats):
        x = self.MLPBlock_0(feats)
        x = self.PointAggregateBlock_0(x)
        return self.PointAggregateBlock_1(x)


_FUSION_PARAMS = {  # FusionWeights field -> flax parameter name
    "wm_e": "w_mem_edge", "wm_s": "w_mem_src", "wm_t": "w_mem_tar",
    "bm": "b_mem", "ln_m_g": "ln_mem_scale", "ln_m_b": "ln_mem_bias",
    "wq": "w_q", "bq": "b_q", "wk": "w_k", "bk": "b_k", "wv": "w_v",
    "bv": "b_v", "wo": "w_o", "bo": "b_o", "we": "w_edge", "be": "b_edge",
    "ln_e1_g": "ln_e1_scale", "ln_e1_b": "ln_e1_bias",
    "ln_e2_g": "ln_e2_scale", "ln_e2_b": "ln_e2_bias",
}


class RelaFusionLayer(nn.Module):
    """One edge-conditioned fusion layer (reference network.py:124-232).
    The core's weights are explicit [in, out] parameters, as the kernel
    takes them."""

    def __init__(self, d_model: int, d_edge: int, n_head: int, update_edge: bool):
        super().__init__()
        D, E = d_model, d_edge
        self.n_head, self.update_edge = n_head, update_edge
        shapes = {"wm_e": (E, D), "we": (D, E)}
        for field, name in _FUSION_PARAMS.items():
            if field.startswith("w"):
                t = torch.empty(shapes.get(field, (D, D)))
                nn.init.normal_(t, std=1.0 / math.sqrt(t.shape[0]))
            elif field.endswith("_g"):
                t = torch.ones(D)
            else:
                t = torch.zeros(D)
            self.register_parameter(name, nn.Parameter(t))
        self.LayerNorm_0 = LayerNorm(D)
        self.Dense_0 = nn.Linear(D, 2 * D)
        self.Dense_1 = nn.Linear(2 * D, D)
        self.LayerNorm_1 = LayerNorm(D)

    def fusion_weights(self) -> FusionWeights:
        return FusionWeights(**{f: getattr(self, n) for f, n in _FUSION_PARAMS.items()})

    def forward(self, node, edge, key_mask):
        x_prime, edge = fused_edge_attention(
            node, edge, key_mask, self.fusion_weights(), self.n_head,
            self.update_edge)
        x = self.LayerNorm_0(node + x_prime)
        ff = self.Dense_1(torch.relu(self.Dense_0(x)))
        return self.LayerNorm_1(x + ff), edge


class FusionNet(nn.Module):
    """Symmetric scene encoder over [actors; lanes; cls] tokens
    (reference network.py:271-340)."""

    def __init__(self, cfg: NetConfig):
        super().__init__()
        self.cfg = cfg
        self.MLPBlock_0 = MLPBlock(cfg.d_actor, (cfg.d_embed,))
        self.MLPBlock_1 = MLPBlock(cfg.d_lane, (cfg.d_embed,))
        self.MLPBlock_2 = MLPBlock(cfg.d_rpe_in, (cfg.d_rpe,))
        for i in range(cfg.n_scene_layer):
            update_edge = cfg.update_edge and i != cfg.n_scene_layer - 1
            setattr(self, f"RelaFusionLayer_{i}", RelaFusionLayer(
                cfg.d_embed, cfg.d_rpe, cfg.n_scene_head, update_edge))

    def forward(self, actors, lanes, rpe, token_mask):
        # actors [B, A, D], lanes [B, L, D], rpe [B, N, N, 5], token_mask [B, N+1]
        cfg = self.cfg
        actors = self.MLPBlock_0(actors)
        lanes = self.MLPBlock_1(lanes)
        B = actors.shape[0]
        cls = actors.new_zeros((B, 1, cfg.d_embed))
        x = torch.cat([actors, lanes, cls], dim=1)
        # project rpe first, then zero-pad the cls row/col (network.py:326-330)
        edge = F.pad(self.MLPBlock_2(rpe), (0, 0, 0, 1, 0, 1))   # [B, N+1, N+1, E]
        for i in range(cfg.n_scene_layer):
            x, edge = getattr(self, f"RelaFusionLayer_{i}")(x, edge, token_mask)
        A = actors.shape[1]
        return x[:, :A], x[:, A:-1], x[:, -1]  # actors, lanes, cls


def bezier_T(n_order: int, n_step: int) -> np.ndarray:
    ts = np.linspace(0.0, 1.0, n_step, endpoint=True)
    return np.stack([
        math.comb(n_order, i) * (1.0 - ts) ** (n_order - i) * ts**i
        for i in range(n_order + 1)
    ], axis=1)


def bezier_Tp(n_order: int, n_step: int) -> np.ndarray:
    ts = np.linspace(0.0, 1.0, n_step, endpoint=True)
    return np.stack([
        n_order * math.comb(n_order - 1, i) * (1.0 - ts) ** (n_order - 1 - i) * ts**i
        for i in range(n_order)
    ], axis=1)


class SceneDecoder(nn.Module):
    """cls token -> M modes; per-actor Bezier control-point regression
    (reference network.py:343-556, param_out='bezier')."""

    def __init__(self, cfg: NetConfig):
        super().__init__()
        if cfg.param_out != "bezier":
            raise NotImplementedError(f"param_out={cfg.param_out!r} is not ported")
        self.cfg = cfg
        H, M = cfg.d_embed, cfg.num_modes
        self.MLPBlock_0 = MLPBlock(20, (H,))
        self.MLPBlock_1 = MLPBlock(cfg.d_lane + H, (H, H))
        self.MLPBlock_2 = MLPBlock(H, (H * M // 2, H * M))
        self.SelfAttentionEncoderLayer_0 = SelfAttentionEncoderLayer(H, 4, H * 12)
        self.SelfAttentionEncoderLayer_1 = SelfAttentionEncoderLayer(H, 4, H * 12)
        self.MLPBlock_3 = MLPBlock(H, (H * M // 2, H * M))
        self.MLPBlock_4 = MLPBlock(H, (H, H))
        self.Dense_0 = nn.Linear(H, 1)
        self.MLPBlock_5 = MLPBlock(H, (H, H))
        self.Dense_1 = nn.Linear(H, (cfg.bezier_order + 1) * 5)
        F_ = cfg.pred_len
        self.register_buffer("mat_T", torch.tensor(
            bezier_T(cfg.bezier_order, F_), dtype=torch.float32), persistent=False)
        self.register_buffer("mat_Tp", torch.tensor(
            bezier_Tp(cfg.bezier_order, F_), dtype=torch.float32), persistent=False)

    def forward(self, ctx, actors, tgt_feat, tgt_rpe):
        # ctx [B, D], actors [B, A, D], tgt_feat [B, D], tgt_rpe [B, 20]
        cfg = self.cfg
        H, M, F_ = cfg.d_embed, cfg.num_modes, cfg.pred_len
        K = cfg.bezier_order + 1
        B, A = actors.shape[:2]

        tgt_rpe_e = self.MLPBlock_0(tgt_rpe)
        tgt = self.MLPBlock_1(torch.cat([tgt_feat, tgt_rpe_e], dim=-1))   # [B, H]

        cls_embed = self.MLPBlock_2(ctx).reshape(B, M, H)
        cls_embed = self.SelfAttentionEncoderLayer_0(cls_embed)
        cls_embed = self.SelfAttentionEncoderLayer_1(cls_embed)

        actor_embed = self.MLPBlock_3(actors).reshape(B, A, M, H).transpose(1, 2)  # [B, M, A, H]

        # the target-lane embedding goes into MODE 0 of every actor
        # (reference network.py:506-508)
        tgt_embed = torch.zeros_like(actor_embed)
        tgt_embed[:, 0] = tgt[:, None, :]
        embed = cls_embed[:, :, None, :] + actor_embed + tgt_embed   # [B, M, A, H]

        cls_logit = self.Dense_0(self.MLPBlock_4(cls_embed))[..., 0]  # [B, M]
        cls_prob = torch.softmax(cls_logit, dim=-1)

        param = self.Dense_1(self.MLPBlock_5(embed)).reshape(B, M, A, K, 5)
        reg_param = param[..., :2].permute(0, 2, 1, 3, 4)    # [B, A, M, K, 2]
        cov_param = param[..., 2:].permute(0, 2, 1, 3, 4)    # [B, A, M, K, 3]

        reg = torch.einsum("fk,bamkd->bamfd", self.mat_T, reg_param)
        vel = torch.einsum("fk,bamkd->bamfd", self.mat_Tp,
                           torch.diff(reg_param, dim=3)) / (F_ * 0.1)
        cov = torch.einsum("fk,bamkd->bamfd", self.mat_T, cov_param)
        reg_out = torch.cat([reg, torch.exp(cov)], dim=-1)   # [B, A, M, F, 5]
        return cls_prob, reg_out, vel


class ScenePredNet(nn.Module):
    """Full scene predictor over a batch of padded scenes."""

    def __init__(self, cfg: NetConfig):
        super().__init__()
        if cfg.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={cfg.compute_dtype!r}: only float32 is ported")
        self.cfg = cfg
        self.ActorNet_0 = ActorNet(cfg.in_actor, cfg.d_actor, cfg.n_fpn_scale)
        # one LaneNet instance encodes the lanes and the target nodes
        self.LaneNet_0 = LaneNet(cfg.in_lane, cfg.d_lane)
        self.FusionNet_0 = FusionNet(cfg)
        self.SceneDecoder_0 = SceneDecoder(cfg)

    def forward(self, actors, actor_mask, lanes, lane_mask, rpe, tgt_nodes,
                tgt_rpe):
        actor_feat = self.ActorNet_0(actors)                 # [B, A, D]
        lane_feat = self.LaneNet_0(lanes)                    # [B, L, D]
        tgt_feat = self.LaneNet_0(tgt_nodes[:, None])[:, 0]  # [B, D]
        B = actors.shape[0]
        token_mask = torch.cat(
            [actor_mask, lane_mask,
             torch.ones((B, 1), dtype=torch.bool, device=actor_mask.device)], dim=1)
        a_out, _, cls_tok = self.FusionNet_0(actor_feat, lane_feat, rpe, token_mask)
        return self.SceneDecoder_0(cls_tok, a_out, tgt_feat, tgt_rpe)
