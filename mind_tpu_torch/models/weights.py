"""Weights of the PyTorch ScenePredNet, from every layout the JAX package
takes.

- The flax parameter tree. The flax checkpoint (orbax, weights/scene_pred_demo)
  cannot be read without JAX, so it is committed once more as a flat numpy
  archive (mind_tpu_torch/weights/scene_pred_demo_600.npz, written by
  tools/export_flax_weights.py, or by models/checkpoint.py::save_flax_npz
  for weights the port trained): one float32 array per "/"-joined flax
  path. `params_from_flax` turns such a flat dict into the port's
  state_dict.
- The reference torch ScenePredNet's state_dict (reference
  planners/mind/planner.py:46-47 loads `torch.load(ckpt)['state_dict']`).
  `reference_mapping` is the port's own copy of
  mind_tpu/models/weights.py::build_torch_mapping, written against the
  port's keys: a reference Linear weight [out, in] and Conv1d weight
  [out, in, k] are the port's as they are; the fusion core's explicit
  matrices are [in, out], the transposes; RelaFusionLayer's memory
  projection packs [edge, src, tar] into one Linear over the concatenated
  input (reference network.py:199) and MultiheadAttention packs q/k/v
  into in_proj_weight [3D, D], both cut into column or row blocks here.
  `params_from_reference` applies it, `to_reference` inverts it.
- The port's own checkpoints (models/checkpoint.py), a directory of steps.

`load_scene_pred` picks the layout from the path, as the JAX planner does.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mind_tpu_torch.common.device import resolve_device
from mind_tpu_torch.config import NetConfig
from mind_tpu_torch.models.checkpoint import load_params
from mind_tpu_torch.models.scene_pred import ScenePredNet


def params_from_flax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """{"params/ActorNet_0/.../kernel": array} -> ScenePredNet state_dict.

    Submodules carry the flax names, so the key is the path joined by ".".
    Dense kernels [in, out] become Linear weights [out, in]; Conv kernels
    [k, in, out] become [out, in, k]; norm scales become weights. The fusion
    core's explicit parameters (w_mem_edge, w_q, ...) stay [in, out], the
    layout the kernel takes."""
    out = {}
    for path, arr in flat.items():
        parts = path.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        t = torch.from_numpy(np.asarray(arr, np.float32).copy())
        leaf = parts[-1]
        if leaf == "kernel":
            t = t.t() if t.dim() == 2 else t.permute(2, 1, 0)
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        out[".".join(parts[:-1] + [leaf])] = t.contiguous()
    return out


def load_flax_npz(path: str | Path) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


class RefEntry(NamedTuple):
    """port[key] = (ref[ref_key] cut to `part`), transposed if `t`."""

    key: str
    ref_key: str
    t: bool = False
    part: Optional[Tuple[int, int, int]] = None   # (dim, lo, hi) of the reference tensor


def reference_mapping(cfg: NetConfig) -> List[RefEntry]:
    """Every parameter of the reference ScenePredNet (reference
    network.py:559-580 module tree) against the port's state_dict key."""
    entries: List[RefEntry] = []

    def take(key, ref_key, t=False, part=None):
        entries.append(RefEntry(key, ref_key, t, part))

    def lin(prefix, ref_prefix):          # Linear, LayerNorm, GroupNorm: weight + bias
        take(prefix + ".weight", ref_prefix + ".weight")
        take(prefix + ".bias", ref_prefix + ".bias")

    def mlp(prefix, ref_prefix, n_layers):
        # torch nn.Sequential(Linear, LN, ReLU, [Linear, LN, ReLU]) indices
        for i in range(n_layers):
            lin(f"{prefix}.Dense_{i}", f"{ref_prefix}.{3 * i}")
            lin(f"{prefix}.LayerNorm_{i}", f"{ref_prefix}.{3 * i + 1}")

    def res1d(prefix, ref_prefix, downsample):
        take(prefix + ".GNConv1d_0.Conv_0.weight", ref_prefix + ".conv1.weight")
        lin(prefix + ".GNConv1d_0.GroupNorm_0", ref_prefix + ".bn1")
        take(prefix + ".Conv_0.weight", ref_prefix + ".conv2.weight")
        lin(prefix + ".GroupNorm_0", ref_prefix + ".bn2")
        if downsample:
            take(prefix + ".Conv_1.weight", ref_prefix + ".downsample.0.weight")
            lin(prefix + ".GroupNorm_1", ref_prefix + ".downsample.1")

    # ActorNet (reference network.py:12-61); the first block of each group
    # changes channels (s = 0) or strides (s > 0)
    nf = cfg.n_fpn_scale
    for s in range(nf):
        for j in range(2):
            res1d(f"ActorNet_0.Res1d_{2 * s + j}", f"actor_net.groups.{s}.{j}", j == 0)
    for i in range(nf):   # laterals, deepest scale first
        take(f"ActorNet_0.GNConv1d_{i}.Conv_0.weight", f"actor_net.lateral.{nf - 1 - i}.conv.weight")
        lin(f"ActorNet_0.GNConv1d_{i}.GroupNorm_0", f"actor_net.lateral.{nf - 1 - i}.norm")
    res1d(f"ActorNet_0.Res1d_{2 * nf}", "actor_net.output", False)

    # LaneNet (network.py:102-121)
    mlp("LaneNet_0.MLPBlock_0", "lane_net.proj", 1)
    for a, agg in ((0, "aggre1"), (1, "aggre2")):
        pab = f"LaneNet_0.PointAggregateBlock_{a}"
        mlp(pab + ".MLPBlock_0", f"lane_net.{agg}.fc1", 2)
        mlp(pab + ".MLPBlock_1", f"lane_net.{agg}.fc2", 2)
        lin(pab + ".LayerNorm_0", f"lane_net.{agg}.norm")

    # FusionNet (network.py:271-340)
    mlp("FusionNet_0.MLPBlock_0", "fusion_net.proj_actor", 1)
    mlp("FusionNet_0.MLPBlock_1", "fusion_net.proj_lane", 1)
    mlp("FusionNet_0.MLPBlock_2", "fusion_net.proj_rpe_scene", 1)
    D, E = cfg.d_embed, cfg.d_rpe
    for i in range(cfg.n_scene_layer):
        fl, tp = f"FusionNet_0.RelaFusionLayer_{i}", f"fusion_net.fuse_scene.fusion.{i}"
        # memory projection over cat([edge, src, tar]): column blocks of W.
        # The reference repeats src_x[i, j] = node[j], tar_x[i, j] = node[i]
        # (network.py:197-199), while w_mem_src multiplies node[i] and
        # w_mem_tar node[j]: the 'tar' block feeds w_mem_src
        mem = f"{tp}.proj_memory.0.weight"
        take(f"{fl}.w_mem_edge", mem, True, (1, 0, E))
        take(f"{fl}.w_mem_tar", mem, True, (1, E, E + D))
        take(f"{fl}.w_mem_src", mem, True, (1, E + D, E + 2 * D))
        take(f"{fl}.b_mem", f"{tp}.proj_memory.0.bias")
        take(f"{fl}.ln_mem_scale", f"{tp}.proj_memory.1.weight")
        take(f"{fl}.ln_mem_bias", f"{tp}.proj_memory.1.bias")
        if cfg.update_edge and i != cfg.n_scene_layer - 1:
            # the last layer's edge parameters exist in the port but are unused
            take(f"{fl}.w_edge", f"{tp}.proj_edge.0.weight", True)
            take(f"{fl}.b_edge", f"{tp}.proj_edge.0.bias")
            take(f"{fl}.ln_e1_scale", f"{tp}.proj_edge.1.weight")
            take(f"{fl}.ln_e1_bias", f"{tp}.proj_edge.1.bias")
            take(f"{fl}.ln_e2_scale", f"{tp}.norm_edge.weight")
            take(f"{fl}.ln_e2_bias", f"{tp}.norm_edge.bias")
        for j, name in enumerate("qkv"):
            part = (0, j * D, (j + 1) * D)
            take(f"{fl}.w_{name}", f"{tp}.multihead_attn.in_proj_weight", True, part)
            take(f"{fl}.b_{name}", f"{tp}.multihead_attn.in_proj_bias", False, part)
        take(f"{fl}.w_o", f"{tp}.multihead_attn.out_proj.weight", True)
        take(f"{fl}.b_o", f"{tp}.multihead_attn.out_proj.bias")
        lin(f"{fl}.Dense_0", f"{tp}.linear1")
        lin(f"{fl}.Dense_1", f"{tp}.linear2")
        lin(f"{fl}.LayerNorm_0", f"{tp}.norm2")
        lin(f"{fl}.LayerNorm_1", f"{tp}.norm3")

    # SceneDecoder (network.py:343-556)
    de = "SceneDecoder_0"
    mlp(de + ".MLPBlock_0", "pred_scene.proj_rpe", 1)
    mlp(de + ".MLPBlock_1", "pred_scene.proj_tgt", 2)
    mlp(de + ".MLPBlock_2", "pred_scene.ctx_proj", 2)
    H = cfg.d_embed
    for i in range(2):   # ctx_sat TransformerEncoder layers
        sa, tp = f"{de}.SelfAttentionEncoderLayer_{i}", f"pred_scene.ctx_sat.layers.{i}"
        for j in range(3):   # q, k, v
            part = (0, j * H, (j + 1) * H)
            take(f"{sa}.Dense_{j}.weight", f"{tp}.self_attn.in_proj_weight", False, part)
            take(f"{sa}.Dense_{j}.bias", f"{tp}.self_attn.in_proj_bias", False, part)
        lin(sa + ".Dense_3", f"{tp}.self_attn.out_proj")
        lin(sa + ".Dense_4", f"{tp}.linear1")
        lin(sa + ".Dense_5", f"{tp}.linear2")
        lin(sa + ".LayerNorm_0", f"{tp}.norm1")
        lin(sa + ".LayerNorm_1", f"{tp}.norm2")
    mlp(de + ".MLPBlock_3", "pred_scene.actor_proj", 2)
    mlp(de + ".MLPBlock_4", "pred_scene.cls", 2)
    lin(de + ".Dense_0", "pred_scene.cls.6")
    mlp(de + ".MLPBlock_5", "pred_scene.reg", 2)
    lin(de + ".Dense_1", "pred_scene.reg.6")
    return entries


_EDGE_UPDATE = ("w_edge", "b_edge", "ln_e1_scale", "ln_e1_bias", "ln_e2_scale", "ln_e2_bias")


def unused_edge_params(cfg: NetConfig) -> List[str]:
    """The last fusion layer's edge-update parameters: the port holds them,
    its forward does not use them and the reference does not create them."""
    last = f"FusionNet_0.RelaFusionLayer_{cfg.n_scene_layer - 1}."
    return [last + name for name in _EDGE_UPDATE]


def _template(cfg: NetConfig) -> Dict[str, torch.Tensor]:
    """The port's state_dict as meta tensors (shapes and types, no data)."""
    with torch.device("meta"):
        return ScenePredNet(cfg).state_dict()


def to_reference(state_dict, cfg: NetConfig) -> Dict[str, torch.Tensor]:
    """The port's state_dict in the reference torch layout (the inverse of
    params_from_reference; the unused edge parameters are dropped)."""
    groups: Dict[str, list] = {}
    for e in reference_mapping(cfg):
        v = state_dict[e.key]
        groups.setdefault(e.ref_key, []).append((e.part, v.t() if e.t else v))
    out = {}
    for ref_key, pieces in groups.items():
        if pieces[0][0] is None:
            out[ref_key] = pieces[0][1].contiguous()
            continue
        dim = pieces[0][0][0]
        pieces.sort(key=lambda p: p[0][1])
        out[ref_key] = torch.cat([v for _, v in pieces], dim=dim)
    return out


def _as_tensor(v) -> torch.Tensor:
    return v.detach().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))


def params_from_reference(state_dict, cfg: NetConfig, strict: bool = True
                          ) -> Dict[str, torch.Tensor]:
    """A reference-layout state_dict (tensors or arrays) -> the port's
    float32 state_dict. A missing reference key raises KeyError, a tensor
    of another shape ValueError. Under `strict`, so does a reference tensor
    that feeds no parameter, or a port parameter that none feeds (except
    the last layer's unused edge-update parameters, which are filled with
    zeros and ones so that the state_dict is whole; their values do not
    reach the outputs)."""
    sd = {k: _as_tensor(v) for k, v in state_dict.items()}
    template = _template(cfg)
    ref_shapes = {k: tuple(v.shape) for k, v in to_reference(template, cfg).items()}
    out = {}
    for e in reference_mapping(cfg):
        v = sd[e.ref_key]
        if tuple(v.shape) != ref_shapes[e.ref_key]:
            raise ValueError(f"shape mismatch at {e.ref_key}: the checkpoint has "
                             f"{tuple(v.shape)}, the configuration needs {ref_shapes[e.ref_key]}")
        if e.part is not None:
            dim, lo, hi = e.part
            v = v.narrow(dim, lo, hi - lo)
        out[e.key] = (v.t() if e.t else v).to(torch.float32).contiguous().clone()
    if strict:
        used = {e.ref_key for e in reference_mapping(cfg)}
        leftover = [k for k in sd if k not in used]
        if leftover:
            raise ValueError(f"reference tensors not consumed: {leftover[:8]} "
                             f"(+{max(0, len(leftover) - 8)} more)")
        missing = set(template) - set(out) - set(unused_edge_params(cfg))
        if missing:
            raise ValueError(f"unmapped parameters: {sorted(missing)[:8]} "
                             f"(+{max(0, len(missing) - 8)} more)")
    for k in unused_edge_params(cfg):
        fill = torch.ones if k.endswith("_scale") else torch.zeros
        out.setdefault(k, fill(template[k].shape))
    return out


def try_load_torch_checkpoint(path, cfg: NetConfig) -> Optional[Dict[str, torch.Tensor]]:
    """A reference torch checkpoint file -> the port's state_dict
    (reference planner.py:46-47: the file's "state_dict", or the file
    itself). None when the file is absent; raises on a checkpoint that
    does not map (params_from_reference, strict). Read with
    weights_only=True: tensors and plain containers, not arbitrary
    pickled objects."""
    if not path or not os.path.exists(path):
        return None
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return params_from_reference(ckpt.get("state_dict", ckpt), cfg)


def load_scene_pred(cfg: NetConfig, path: str | Path | None, device=None,
                    seed: int = 0) -> ScenePredNet:
    """ScenePredNet in eval mode on `device` (the card unless the caller
    passes a CPU device), any of the three heads of cfg.param_out. Its
    weights, by the path, as the JAX planner picks them
    (mind_tpu/planner/planner.py:381-390):

    - None: random weights from `seed`;
    - a directory: the latest step of the port's checkpoints
      (models/checkpoint.py::load_params);
    - a `.npz` file: the flat flax archive (params_from_flax);
    - any other path: a reference torch checkpoint
      (try_load_torch_checkpoint); an absent file leaves the seeded weights.

    Every parameter must be present. The weights are float32; under
    cfg.compute_dtype == "bfloat16" they are rounded to bfloat16 after
    loading."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):  # leaves the caller's RNG alone
        torch.manual_seed(seed)
        net = ScenePredNet(cfg)
    if path is not None:
        path = Path(path)
        if path.is_dir():
            sd = load_params(path, net)
        elif path.suffix == ".npz":
            sd = params_from_flax(load_flax_npz(path))
        else:
            sd = try_load_torch_checkpoint(path, cfg)
        if sd is not None:
            net.load_state_dict(sd, strict=True)
    return net.apply_compute_dtype().to(device).eval()
