"""Run chip_smoke.py's episode phases alone: the kernels and the
graph-control library built, the closed loop (phase 6, for its trajectory),
the eager episode (phase 10), the condition kernel against its plain
version and the compiled episode program (phase 10a), each held to its
checks.

    python3 tools/compiled_episode_phase.py

Prints the phases' lines and their seconds; exits non-zero if a check
fails. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

if __name__ == "__main__":
    from mind_tpu_torch.config import planner_config_for_demo
    from mind_tpu_torch.ops import fusion_attention as fa
    from mind_tpu_torch.synthetic import AV2_ORIGIN, LANE_W, synthetic_av2
    from mind_tpu_torch.utils import device_specs

    chip_smoke.PEAKS = device_specs.peaks(torch.cuda.get_device_name(0))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    laps, t = {}, time.perf_counter()
    chip_smoke.phase_build(fa)
    laps["build"] = time.perf_counter() - t
    dcfg = planner_config_for_demo("demo_1")
    t = time.perf_counter()
    _, loop, ego = chip_smoke.phase_closed_loop(dcfg, fa, synthetic_av2(chip_smoke.SEED), LANE_W,
                                                AV2_ORIGIN)
    laps["closed_loop"] = time.perf_counter() - t
    with tempfile.TemporaryDirectory() as data_root:
        t = time.perf_counter()
        _, eager_summary, eager = chip_smoke.phase_episode(dcfg, fa, data_root, ego,
                                                           loop["plan_calls"])
        laps["episode"] = time.perf_counter() - t
        t = time.perf_counter()
        chip_smoke.phase_condition_kernel(torch.device("cuda"))
        laps["condition_kernel"] = time.perf_counter() - t
        t = time.perf_counter()
        chip_smoke.phase_compiled(dcfg, fa, data_root, ego, eager, eager_summary)
        laps["compiled"] = time.perf_counter() - t
    print(f"seconds {laps} ({card})", flush=True)
