"""Observability: per-phase timers, structured step metrics, profiler traces
(port of mind_tpu/utils/metrics.py).

Planning phases (aime / flatten / solve / export) and the sim loop report
into a structured metrics object; `profile_trace` wraps torch.profiler for
on-demand traces of the host and the card.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, Optional


class PhaseTimer:
    """Accumulating wall-clock timer keyed by phase name."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, dict]:
        return {
            k: {"total_s": round(self.totals[k], 4), "calls": self.counts[k],
                "mean_ms": round(1e3 * self.totals[k] / max(self.counts[k], 1), 2)}
            for k in self.totals
        }

    def reset(self):
        self.totals.clear()
        self.counts.clear()


class Metrics:
    """Structured per-run metrics: counters + the phase timer."""

    def __init__(self):
        self.counters: Dict[str, float] = defaultdict(float)
        self.timer = PhaseTimer()

    def incr(self, name: str, value: float = 1.0):
        self.counters[name] += value

    def observe(self, name: str, value: float):
        # last-value gauges share the counter dict with a distinct prefix
        self.counters[f"gauge/{name}"] = value

    def to_dict(self) -> dict:
        return {"counters": dict(self.counters), "phases": self.timer.summary()}

    def dump(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=float)


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """torch.profiler trace context (host, and the card when there is one);
    writes a Chrome trace `trace.json` into log_dir on exit. No-op when
    log_dir is None."""
    if log_dir is None:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
