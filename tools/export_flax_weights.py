"""Write the trained flax ScenePredNet checkpoint as a flat numpy archive
that the PyTorch port reads without JAX.

    python tools/export_flax_weights.py \
        [--ckpt weights/scene_pred_demo] \
        [--out mind_tpu_torch/weights/scene_pred_demo_600.npz]

Keys are the "/"-joined flax parameter paths; values are float32 arrays in
flax layout (mind_tpu_torch.models.weights.params_from_flax converts them).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def flat_flax_params(ckpt: str | Path, step: int | None = None):
    """{"params/.../kernel": np.ndarray} of the production-config checkpoint."""
    import jax
    from flax.traverse_util import flatten_dict

    from mind_tpu.config import PlannerConfig
    from mind_tpu.models import init_scene_pred
    from mind_tpu.models.checkpoint import load_params

    jax.config.update("jax_platforms", "cpu")
    cfg = PlannerConfig()
    _, like, _ = init_scene_pred(cfg.net, cfg.max_actors, cfg.max_lanes, seed=0)
    params = load_params(ckpt, like, step)
    return {k: np.asarray(v, np.float32)
            for k, v in flatten_dict(params, sep="/").items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", default=str(ROOT / "weights" / "scene_pred_demo"))
    ap.add_argument("--step", type=int, default=600)
    ap.add_argument("--out", default=str(
        ROOT / "mind_tpu_torch" / "weights" / "scene_pred_demo_600.npz"))
    args = ap.parse_args()
    flat = flat_flax_params(args.ckpt, args.step)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez(args.out, **flat)
    print(f"wrote {len(flat)} arrays to {args.out}")


if __name__ == "__main__":
    main()
