"""Generic keyed tree used for host-side bookkeeping of scenario / cost /
trajectory trees (reference planners/basic/tree.py; port of
mind_tpu/common/tree.py).

Device code never walks this structure: the planner works on index arrays
(parent indices, level tables). This class carries the trees that
MINDPlanner.plan exports for the host and for visualization.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


class Node:
    __slots__ = ("key", "parent_key", "children_keys", "data", "depth")

    def __init__(self, key, parent_key, data: Any = None):
        self.key = key
        self.parent_key = parent_key
        self.children_keys: List = []
        self.data = data
        self.depth = 0

    def __repr__(self):
        return f"Node({self.key!r}, parent={self.parent_key!r}, children={self.children_keys!r})"


class Tree:
    def __init__(self):
        self.nodes: Dict[Any, Node] = {}
        self.root: Optional[Any] = None
        self.leaves: List = []

    def add_node(self, node: Node) -> None:
        if node.parent_key is None and not self.nodes:
            self.nodes[node.key] = node
            self.root = node.key
            self.leaves.append(node.key)
            return
        if node.parent_key not in self.nodes:
            raise KeyError(f"unknown parent key {node.parent_key!r}")
        if node.key in self.nodes:
            raise ValueError(f"duplicate node key {node.key!r}")
        parent = self.nodes[node.parent_key]
        parent.children_keys.append(node.key)
        if node.parent_key in self.leaves:
            self.leaves.remove(node.parent_key)
        node.depth = parent.depth + 1
        self.nodes[node.key] = node
        self.leaves.append(node.key)

    def get_node(self, key) -> Node:
        return self.nodes[key]

    def get_root(self) -> Node:
        if self.root is None:
            raise KeyError("tree has no root yet")
        return self.nodes[self.root]

    def get_root_key(self):
        if self.root is None:
            raise KeyError("tree has no root yet")
        return self.root

    def has_children(self, key) -> bool:
        return len(self.nodes[key].children_keys) > 0

    def get_children_keys(self, key) -> List:
        return self.nodes[key].children_keys

    def get_leaf_nodes(self) -> List[Node]:
        return [self.nodes[k] for k in self.leaves]

    def get_leaf_keys(self) -> List:
        return self.leaves

    def retrieve_nodes_to_root(self, key) -> List[Node]:
        out = [self.get_node(key)]
        while out[-1].parent_key is not None:
            out.append(self.get_node(out[-1].parent_key))
        return out

    def size(self) -> int:
        return len(self.nodes)

    def bfs_keys(self) -> List:
        """Root-first breadth-first key order (a valid topological order)."""
        if self.root is None:
            return []
        order, queue = [], [self.root]
        while queue:
            k = queue.pop(0)
            order.append(k)
            queue.extend(self.nodes[k].children_keys)
        return order
