"""Device health probe of the CUDA card (the card's counterpart of
mind_tpu/utils/tpu_health.py).

The probe runs in a fresh, killable subprocess, so a card or CUDA stack that
hangs at initialization cannot hang the caller: a 128x128 bfloat16 matrix
product on `cuda`, then a marker on standard output. Callers decide how
often to probe.
"""

from __future__ import annotations

import subprocess
import sys

PROBE_TIMEOUT_S = 180

_PROBE_CODE = (
    "import torch; "
    "x = torch.ones((128, 128), dtype=torch.bfloat16, device='cuda'); "
    "print('PROBE_OK', float((x @ x).float().sum()))"
)


def probe_once(timeout_s: float = PROBE_TIMEOUT_S) -> bool:
    """One trivial-matmul device probe in a fresh subprocess.

    Returns True iff the probe printed its marker within `timeout_s`. A
    hang is killed by the timeout and reported as unhealthy; no card (the
    product raises) is unhealthy too."""
    try:
        p = subprocess.run([sys.executable, "-c", _PROBE_CODE], stdout=subprocess.PIPE,
                           stderr=subprocess.DEVNULL, timeout=timeout_s)
        return b"PROBE_OK" in p.stdout
    except subprocess.TimeoutExpired:
        return False
