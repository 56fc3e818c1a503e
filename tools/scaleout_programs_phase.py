"""Run chip_smoke.py's scale-out program phases alone: the kernels and the
graph-control library built, (scale-out programs) (phase 12c: the compiled
MultiScenarioSim and MonteCarloSim against graphed=False to the bit, reads
per trigger and per update, kernel runs inside the replays, capture
seconds, peak memory at K = 16) and the tree scale (phase 13: the
compiled parallel_tree_solve against graphed=False to the bit); then, last,
one compiled trigger of 64 copies (the bench's Monte-Carlo size) and its
peak memory with its capture (chip_smoke.scaleout_peak_memory).

    python3 tools/scaleout_programs_phase.py

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
    with tempfile.TemporaryDirectory() as data_root:
        t = time.perf_counter()
        chip_smoke.phase_scaleout_programs(dcfg, fa, data_root, card)
        laps["scaleout_programs"] = time.perf_counter() - t
        t = time.perf_counter()
        chip_smoke.phase_tree_scale()
        laps["tree_scale"] = time.perf_counter() - t
        # the bench's Monte-Carlo size, one trigger, last: its capture's pool
        t = time.perf_counter()
        chip_smoke.scaleout_peak_memory(dcfg, fa, data_root, card, k=64)
        laps["scaleout_k64"] = time.perf_counter() - t
    print(f"seconds {laps} ({card})", flush=True)
