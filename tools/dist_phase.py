"""Run chip_smoke.py's (dist) phase alone: two ranks sharing the card
against the sequential two-shard mesh, rank 0 alone on nccl against the
unsharded step, and with two cards or more part (d), one rank per card
against the sequential mesh across cards.

    python3 tools/dist_phase.py

Prints the phase's [dist] line and its seconds; exits non-zero if a check
fails. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from mind_tpu_torch.config import planner_config_for_demo  # noqa: E402
from mind_tpu_torch.ops import fusion_attention as fa  # noqa: E402
from mind_tpu_torch.synthetic import synthetic_av2  # noqa: E402

if __name__ == "__main__":
    t = time.perf_counter()
    chip_smoke.phase_dist(planner_config_for_demo("demo_1"), fa, synthetic_av2)
    print(f"(dist) phase: {time.perf_counter() - t:.1f} s", flush=True)
