"""Run chip_smoke.py's host-path program phases alone: the kernels and the
graph-control library built, the host tree (phase 4a: the compiled
ScenarioTreeGenerator against graphed=False to the bit and against the
device AIME, reads per round, replays under sync debug "error", kernel A
runs, capture seconds, peak memory) and the parity runs (phases 12a-b:
the mirror's compiled forward, each output against the eager network to
the bit, on the playback and the resync); then the same parity runs with
the mirror eager (graphed=False), for its seconds a plan and a forward.

    python3 tools/host_programs_phase.py

Prints the phases' lines and their seconds; exits non-zero if a check
fails. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

if __name__ == "__main__":
    from mind_tpu_torch.config import (CONFIGS, DEFAULT_WEIGHTS, PlannerConfig,
                                       planner_config_for_demo)
    from mind_tpu_torch.models.weights import load_scene_pred
    from mind_tpu_torch.ops import fusion_attention as fa
    from mind_tpu_torch.planner import aime_device as aime
    from mind_tpu_torch.synthetic import (scene_statics, synthetic_av2, synthetic_scene,
                                          write_synthetic_map)
    from mind_tpu_torch.utils import device_specs

    chip_smoke.PEAKS = device_specs.peaks(torch.cuda.get_device_name(0))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    laps, t = {}, time.perf_counter()
    chip_smoke.phase_build(fa)
    laps["build"] = time.perf_counter() - t
    t = time.perf_counter()
    cfg = PlannerConfig()
    scene = synthetic_scene(chip_smoke.SEED, cfg.max_actors, cfg.max_lanes, n_agents=40)
    net = load_scene_pred(cfg.net, DEFAULT_WEIGHTS, dev)
    chip_smoke.phase_host_tree(cfg, net, scene, aime, scene_statics, fa, dev)
    laps["host_tree"] = time.perf_counter() - t
    dcfg = planner_config_for_demo("demo_1")
    syn = synthetic_av2(chip_smoke.SEED)
    with tempfile.TemporaryDirectory() as data_root:
        seq_id = json.loads((CONFIGS / "demo_1.json").read_text())["seq_id"]
        write_synthetic_map(syn.map_json, data_root, seq_id)
        for name, graphed in (("parity", None), ("parity_eager_mirror", False)):
            t = time.perf_counter()
            chip_smoke.phase_parity(dcfg, fa, data_root, syn, mirror_graphed=graphed)
            laps[name] = time.perf_counter() - t
    print(f"seconds {laps} ({card})", flush=True)
