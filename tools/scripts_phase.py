"""Run chip_smoke.py's (scripts) phase alone: the drivers of
mind_tpu_torch/scripts/ on synthetic scenes at 250 ticks, each held to its
checks.

    python3 tools/scripts_phase.py

Prints the phase's [scripts] line and its seconds; exits non-zero if a
check fails. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from mind_tpu_torch.ops import fusion_attention as fa  # noqa: E402

if __name__ == "__main__":
    t = time.perf_counter()
    chip_smoke.phase_scripts(fa)
    print(f"(scripts) phase: {time.perf_counter() - t:.1f} s", flush=True)
