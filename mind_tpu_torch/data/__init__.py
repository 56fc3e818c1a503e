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


def __getattr__(name):
    # the loader imports torch; a process that only unpickles map or agent
    # types (a render worker) does not need it
    if name == "ArgoAgentLoader":
        from mind_tpu_torch.data.loader import ArgoAgentLoader

        return ArgoAgentLoader
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
