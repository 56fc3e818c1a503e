"""Weights of the PyTorch ScenePredNet from the flax parameter tree.

The flax checkpoint (orbax, weights/scene_pred_demo) cannot be read
without JAX, so it is committed once more as a flat numpy archive
(mind_tpu_torch/weights/scene_pred_demo_600.npz, written by
tools/export_flax_weights.py): one float32 array per "/"-joined flax path.
`params_from_flax` turns such a flat dict into the port's state_dict.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np
import torch

from mind_tpu_torch.common.device import resolve_device
from mind_tpu_torch.config import NetConfig
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


def load_scene_pred(cfg: NetConfig, path: str | Path | None, device=None,
                    seed: int = 0) -> ScenePredNet:
    """ScenePredNet in eval mode on `device` (the CUDA card unless the
    caller passes a CPU device), with the archive's weights (every
    parameter must be present) or, without a path, random weights from
    `seed`. The archive is float32; under cfg.compute_dtype == "bfloat16"
    the parameters are rounded to bfloat16 after loading."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):  # leaves the caller's RNG alone
        torch.manual_seed(seed)
        net = ScenePredNet(cfg)
    if path is not None:
        net.load_state_dict(params_from_flax(load_flax_npz(path)), strict=True)
    return net.apply_compute_dtype().to(device).eval()
