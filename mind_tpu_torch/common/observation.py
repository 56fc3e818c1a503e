"""What an agent shows the others and the renderer each tick (the
AgentObservation of mind_tpu/sim/agents.py) and the agents' colours.

Kept out of sim/agents.py, which imports torch, so that a render worker
(viz/render.py's spawn pool), which unpickles the recorded frames, starts
on numpy alone.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from mind_tpu_torch.data.av2 import ObjectType

EXO_COLOR = ("lightcoral", "indianred")
EGO_DISABLE_COLOR = ("lightskyblue", "deepskyblue")
EGO_ENABLE_COLOR = ("lime", "blue")


@dataclass
class AgentObservation:
    id: str = ""
    type: Optional[ObjectType] = None
    clr: Tuple[str, str] = EXO_COLOR
    bbox: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    state: Optional[np.ndarray] = None
    timestep: float = 0.0
