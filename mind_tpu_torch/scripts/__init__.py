"""The repository's acceptance, certification and decision drivers, run on
the port (the counterparts of the JAX package's scripts/*.py; each one
`python -m mind_tpu_torch.scripts.<name>`, with `main(argv=None) -> int`):

- run_all_demos (scripts/run_all_demos.py): closed-loop acceptance, host loop
  and episode runner;
- bench_north_star (scripts/bench_north_star.py): a policy's host-loop
  steps/s beside its free-run parity;
- bench_strict (scripts/bench_strict.py): float64 solves through
  run_episode_segmented;
- bench_exec_ab (scripts/bench_exec_ab.py): the precision-policy matrix;
- bench_unroll_ab (scripts/bench_unroll_ab.py): episode steps/s under a label;
- diag_playback (scripts/diag_playback.py): the playback parity's
  stage-by-stage dump;
- bench_forward_split (scripts/bench_forward_split.py): the network forward
  by submodule, its FLOPs and MFU;
- bench_fusion (scripts/bench_fusion.py): the forward with the fusion kernel
  against the plain core;
- bench_mc (scripts/bench_mc.py): the Monte-Carlo sweep;
- bench_scale (scripts/bench_scale.py): a batch of tree solves, trees/s;
- render_demo_video (scripts/render_demo_video.py): a full-horizon video;
- run_evidence (scripts/run_evidence.py): the drivers in turn, one
  subprocess each.

`scripts/parity_run.py` and `scripts/train_demo_weights.py` are
`mind_tpu_torch/parity_run.py` and `mind_tpu_torch/train_weights.py`.

Every driver runs on the CUDA card unless `--device cpu` is given. Its
scenes are the demos' AV2 logs under `--data-root`, or with `--synthetic`
`synthetic_av2` seeds 0-3 for demo_1..4 (synthetic.py::demo_scenario); a
missing log raises. Artifacts go under outputs/torch/ by default; inside the
repository a driver writes nowhere else but chiprun_out/, so the JAX
package's committed artifacts (DEMOS_TPU.md, outputs/*.json, ...) are never
overwritten.
"""

from __future__ import annotations

import contextlib
import json
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
OUT = ROOT / "outputs" / "torch"
# the repository's folders a driver may write into
WRITABLE = (OUT, ROOT / "chiprun_out")
DEMOS = ("demo_1", "demo_2", "demo_3", "demo_4")


def demo_names(spec: str) -> list:
    """'1,2' -> ['demo_1', 'demo_2']."""
    return [f"demo_{d.strip()}" for d in spec.split(",") if d.strip()]


def add_scene_args(ap):
    ap.add_argument("--synthetic", action="store_true",
                    help="synthetic_av2 seeds 0-3 in place of demo_1..4's AV2 logs")
    ap.add_argument("--data-root", help="directory holding the demos' AV2 folders")
    ap.add_argument("--device", help="torch device (default: the CUDA card)")


def check_scene_args(ap, opts):
    if not opts.synthetic and not opts.data_root:
        ap.error("pass --data-root DIR (the AV2 demo logs) or --synthetic")


@contextlib.contextmanager
def scene_root(opts):
    """The data root of a run: a temporary directory for the synthetic maps
    with --synthetic, else --data-root."""
    if opts.synthetic:
        with tempfile.TemporaryDirectory() as d:
            yield d
    else:
        yield opts.data_root


def demo_seed(opts, demo: str):
    """The synthetic_av2 seed standing in for `demo`'s log, None for the log."""
    return DEMOS.index(demo) if opts.synthetic else None


def demo_sim(opts, demo: str, data_root, **kw):
    """synthetic.py::demo_scenario of `demo` on the run's scenes and device;
    `kw` goes through (ticks, planner_cfg, enable_timestep, ...)."""
    from mind_tpu_torch.synthetic import demo_scenario

    return demo_scenario(demo, demo_seed(opts, demo), data_root, device=opts.device, **kw)


def demo_log(opts, demo: str, data_root):
    """The in-memory scenario a parity runner takes for `demo`: with
    --synthetic the seed's scenario, its map written under data_root; else
    None (the runner reads the log under data_root)."""
    from mind_tpu_torch.synthetic import demo_spec

    seed = demo_seed(opts, demo)
    return None if seed is None else demo_spec(demo, seed, data_root).scenario


def artifact(path) -> Path:
    """`path` as a driver's output, its folder made. Inside the repository
    only outputs/torch/ and chiprun_out/ take one; anywhere else raises."""
    p = Path(path).resolve()
    if ROOT in p.parents and not any(w == p.parent or w in p.parents for w in WRITABLE):
        raise ValueError(f"{path}: inside the repository a driver writes only under "
                         f"{', '.join(str(w.relative_to(ROOT)) for w in WRITABLE)}")
    p.parent.mkdir(parents=True, exist_ok=True)
    return p


def write_json(path, obj):
    with open(artifact(path), "w") as f:
        json.dump(obj, f, indent=1, default=float)
    print(f"wrote {path}", flush=True)


def write_text(path, text: str):
    artifact(path).write_text(text)
    print(f"wrote {path}", flush=True)


def launches() -> dict:
    """The fusion kernels' launches so far by variant (the counts of
    ops/fusion_attention.py, which a driver reads and never resets)."""
    from mind_tpu_torch.ops import fusion_attention as fa

    return dict(fa.fused_edge_attention.launches_by_variant)


def launched_since(before: dict) -> dict:
    """The launches by variant since `before` (an earlier launches())."""
    return {k: n - before[k] for k, n in launches().items()}


def device_name(device) -> str:
    """The card's name, or the device's type off the card."""
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def synchronize(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)

