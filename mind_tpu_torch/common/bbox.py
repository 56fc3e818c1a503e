"""Fixed bounding-box footprints per object type (reference common/bbox.py;
port of mind_tpu/common/bbox.py), as a plain table looked up by type."""

from __future__ import annotations

from mind_tpu_torch.data.av2 import ObjectType

# (length, width, height)
BBOX_DIMS = {
    "pedestrian": (0.5, 0.75, 1.8),
    "cyclist": (1.5, 0.75, 1.5),
    "vehicle": (4.5, 2.0, 1.5),
    "bus": (7.0, 2.1, 2.25),
    "unknown": (1.0, 1.0, 1.0),
}


def bbox_for_type(obj_type: ObjectType):
    """Reference mapping (agent.py:92-105): motorcyclist/cyclist share the
    cyclist box; static/background/etc. fall back to unknown."""
    if obj_type == ObjectType.VEHICLE:
        return BBOX_DIMS["vehicle"]
    if obj_type == ObjectType.PEDESTRIAN:
        return BBOX_DIMS["pedestrian"]
    if obj_type in (ObjectType.MOTORCYCLIST, ObjectType.CYCLIST):
        return BBOX_DIMS["cyclist"]
    if obj_type == ObjectType.BUS:
        return BBOX_DIMS["bus"]
    return BBOX_DIMS["unknown"]
