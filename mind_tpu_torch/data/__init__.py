from mind_tpu_torch.data.av2 import (
    ObjectType,
    TrackCategory,
    ObjectState,
    Track,
    Scenario,
    LaneSegment,
    StaticMap,
    load_scenario,
    load_static_map,
    interp_arc,
    compute_midpoint_line,
)
from mind_tpu_torch.data.semantic_map import SemanticMap, LocalSemanticMap
from mind_tpu_torch.data.loader import ArgoAgentLoader

__all__ = [
    "ObjectType",
    "TrackCategory",
    "ObjectState",
    "Track",
    "Scenario",
    "LaneSegment",
    "StaticMap",
    "load_scenario",
    "load_static_map",
    "interp_arc",
    "compute_midpoint_line",
    "SemanticMap",
    "LocalSemanticMap",
    "ArgoAgentLoader",
]
