"""Run chip_smoke.py's closed loop (phase 6) and demo command (phase 6b)
alone: the kernels built, the committed AV2 log read, 150 ticks under the
demo configuration in this process, then `python -m mind_tpu_torch.run_sim`
with rendering on, as a subprocess and through run_sim.main, each held to
its checks.

    python3 tools/demo_command_phase.py

Prints the phases' [loop] and [demo command] lines and their seconds; exits
non-zero if a check fails. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

if __name__ == "__main__":
    from mind_tpu_torch.config import planner_config_for_demo
    from mind_tpu_torch.ops import fusion_attention as fa
    from mind_tpu_torch.synthetic import AV2_ORIGIN, LANE_W, synthetic_av2

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    t = time.perf_counter()
    chip_smoke.phase_build(fa)
    _, loop, ego = chip_smoke.phase_closed_loop(planner_config_for_demo("demo_1"), fa,
                                                synthetic_av2(chip_smoke.SEED), LANE_W,
                                                AV2_ORIGIN)
    t6 = time.perf_counter()
    chip_smoke.phase_demo_command(fa, loop, ego, card)
    print(f"phase 6: {t6 - t:.1f} s, phase 6b: {time.perf_counter() - t6:.1f} s ({card})",
          flush=True)
