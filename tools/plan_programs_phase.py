"""Run chip_smoke.py's planner-program phases alone: the kernels and the
graph-control library built, the closed loop (phase 6, which plans through
MINDPlanner's compiled programs) and (plan programs): the compiled host
loop against graphed=False to the bit on the staged and fused paths and in
the float32, native and polish configurations, reads and replays per plan,
kernel runs inside the replays, capture seconds, the weight copy and the
peak memory.

    python3 tools/plan_programs_phase.py

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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    laps, t = {}, time.perf_counter()
    chip_smoke.phase_build(fa)
    laps["build"] = time.perf_counter() - t
    dcfg = planner_config_for_demo("demo_1")
    t = time.perf_counter()
    _, loop, sim, plans = chip_smoke.phase_closed_loop(dcfg, fa, synthetic_av2(chip_smoke.SEED),
                                                       LANE_W, AV2_ORIGIN)
    laps["closed_loop"] = time.perf_counter() - t
    with tempfile.TemporaryDirectory() as data_root:
        t = time.perf_counter()
        chip_smoke.phase_plan_programs(dcfg, fa, loop, sim, plans, data_root, card)
        laps["plan_programs"] = time.perf_counter() - t
    print(f"seconds {laps} ({card})", flush=True)
