"""The node graph: nodes, pins, links, validation, JSON serde (the port's
copy of nodey_tpu.core.graph; the same project-file schema, so a file
saved by either package loads in the other).

Re-implements the reference's ``infra::Graph`` semantics
(reference: include/infra/graph.hpp:21-194, src/infra/graph.cpp:1-479):

* integer IDs allocated smallest-free-first (graph.hpp:64-82)
* pins re-derived from the processor on arity change, preserving links whose
  pin identifier and product type still match (graph.cpp:53-114)
* link validation: product-type match + fan-in <= 1 (graph.cpp:116-130)
* ``check_graph``: per-link validation, zero-in-degree root discovery, DFS
  cycle detection, unreachable-residue rejection (graph.cpp:180-282)
* singleton node bookkeeping (graph.cpp:17, 29-38, 411-417)
* JSON project format compatible with graph.cpp:284-479.

One deliberate fix vs the reference: node editor positions are plain float
pairs here, not ImGui vectors — the serialized schema keeps the
``position {x, y}`` fields for file compatibility, but the core graph has no
UI dependency (the reference's layering violation at graph.hpp:30).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Set, Tuple

from nodey_tpu_torch.core import registry
from nodey_tpu_torch.core.errors import (
    InvalidFileError,
    LogicError,
    LoopDetectedError,
    MismatchedPinError,
    MultipleInputError,
)
from nodey_tpu_torch.core.registry import PinAttribute, Processor

_NODE_ID_RE = re.compile(r"^[+-]?\d+$")


def _find_empty(mapping: Dict[int, object]) -> int:
    """Smallest non-negative ID not present in ``mapping``
    (reference: include/infra/graph.hpp:64-82)."""
    idx = 0
    while idx in mapping:
        idx += 1
    return idx


@dataclasses.dataclass
class Node:
    processor: Processor
    pins: Set[int] = dataclasses.field(default_factory=set)
    pin_name_map: Dict[str, int] = dataclasses.field(default_factory=dict)
    position: Tuple[float, float] = (0.0, 0.0)


@dataclasses.dataclass
class Pin:
    parent: int
    attribute: PinAttribute


@dataclasses.dataclass
class Link:
    from_pin: int
    to_pin: int


class Graph:
    """Node/pin/link store with structural validation and JSON serde."""

    def __init__(self) -> None:
        self.nodes: Dict[int, Node] = {}
        self.pins: Dict[int, Pin] = {}
        self.links: Dict[int, Link] = {}
        self.singleton_node_map: Dict[str, int] = {}
        self.modified = False

    # -- mutations ----------------------------------------------------------

    def add_node(self, processor: Processor) -> int:
        """Add a node; returns its ID (reference: src/infra/graph.cpp:9-22)."""
        node_id = _find_empty(self.nodes)
        info = processor.info()
        self.nodes[node_id] = Node(processor=processor)
        self.update_node_pin(node_id)
        if info.singleton:
            if info.identifier in self.singleton_node_map:
                raise LogicError(
                    f"Duplicate singleton node '{info.identifier}' added"
                )
            self.singleton_node_map[info.identifier] = node_id
        self.modified = True
        return node_id

    def remove_node(self, node_id: int) -> None:
        """Remove a node, its pins and incident links
        (reference: src/infra/graph.cpp:24-51)."""
        node = self.nodes[node_id]
        info = node.processor.info()
        if info.singleton:
            if info.identifier not in self.singleton_node_map:
                raise LogicError("Singleton node ID not found")
            if self.singleton_node_map[info.identifier] != node_id:
                raise LogicError(
                    "Singleton node ID mismatch, expected "
                    f"{self.singleton_node_map[info.identifier]}, got {node_id}"
                )
            del self.singleton_node_map[info.identifier]

        pin_set = node.pins
        for pin_id in pin_set:
            self.pins.pop(pin_id, None)
        self.links = {
            lid: link
            for lid, link in self.links.items()
            if link.from_pin not in pin_set and link.to_pin not in pin_set
        }
        self.modified = True
        del self.nodes[node_id]

    def update_node_pin(self, node_id: int) -> None:
        """Re-derive a node's pins after its arity may have changed,
        preserving links whose pin identifier + product type still match
        (reference: src/infra/graph.cpp:53-114)."""
        node = self.nodes[node_id]
        pin_set = node.pins

        prev_input_link: Dict[str, int] = {}       # pin identifier -> from pin
        prev_output_link: Dict[str, Set[int]] = {}  # pin identifier -> to pins

        for lid in list(self.links):
            link = self.links[lid]
            if link.from_pin in pin_set:
                ident = self.pins[link.from_pin].attribute.identifier
                prev_output_link.setdefault(ident, set()).add(link.to_pin)
                del self.links[lid]
            elif link.to_pin in pin_set:
                ident = self.pins[link.to_pin].attribute.identifier
                prev_input_link[ident] = link.from_pin
                del self.links[lid]

        for pin_id in pin_set:
            self.pins.pop(pin_id, None)
        pin_set.clear()
        node.pin_name_map.clear()

        for attribute in node.processor.pin_attributes():
            pin_id = _find_empty(self.pins)
            pin_set.add(pin_id)
            self.pins[pin_id] = Pin(parent=node_id, attribute=attribute)

            # Endpoint pins may themselves have been deleted above when a
            # link connected the node to itself; drop such links instead of
            # dereferencing a dead pin (the reference crashes here,
            # graph.cpp:92-105 — a hardening, not a behavior change for
            # valid graphs).
            prev_from = prev_input_link.get(attribute.identifier)
            if (
                prev_from is not None
                and prev_from in self.pins
                and attribute.type is self.pins[prev_from].attribute.type
            ):
                self.links[_find_empty(self.links)] = Link(
                    from_pin=prev_from, to_pin=pin_id
                )

            for prev_to in prev_output_link.get(attribute.identifier, ()):
                if (
                    prev_to in self.pins
                    and attribute.type is self.pins[prev_to].attribute.type
                ):
                    self.links[_find_empty(self.links)] = Link(
                        from_pin=pin_id, to_pin=prev_to
                    )

            if attribute.identifier in node.pin_name_map:
                raise LogicError(
                    f"Pin name {attribute.identifier} already exists for node "
                    f"ID {node_id}"
                )
            node.pin_name_map[attribute.identifier] = pin_id

        self.modified = True

    def add_link(self, from_pin: int, to_pin: int) -> int:
        """Add a link with product-type and coarse fan-in checks; returns
        its ID (reference: src/infra/graph.cpp:116-130). Full validation
        (incl. the second-link-into-a-pin case and cycles) happens in
        check_graph — callers follow the reference app's
        add -> check_graph -> rollback flow."""
        if not self.check_node_type_match(from_pin, to_pin):
            raise MismatchedPinError(from_pin, to_pin)
        if not self.check_multiple_input(to_pin):
            raise MultipleInputError(to_pin)
        link_id = _find_empty(self.links)
        self.links[link_id] = Link(from_pin=from_pin, to_pin=to_pin)
        self.modified = True
        return link_id

    def remove_link(self, link_id: int) -> None:
        """Remove a link by ID (reference: src/infra/graph.cpp:132-137)."""
        self.links.pop(link_id, None)
        self.modified = True

    def remove_link_between(self, from_pin: int, to_pin: int) -> None:
        """Remove links by endpoint pair (reference: src/infra/graph.cpp:139-148)."""
        self.links = {
            lid: link
            for lid, link in self.links.items()
            if not (link.from_pin == from_pin and link.to_pin == to_pin)
        }
        self.modified = True

    # -- derived maps -------------------------------------------------------

    def get_pin_to_node_map(self) -> Dict[int, int]:
        """pin ID -> owning node ID (reference: src/infra/graph.cpp:150-160)."""
        return {
            pin: node_id
            for node_id, node in self.nodes.items()
            for pin in node.pins
        }

    def get_node_input_map(self) -> Dict[int, Set[int]]:
        """node ID -> set of upstream *pin* IDs feeding it
        (reference: src/infra/graph.cpp:162-178)."""
        result: Dict[int, Set[int]] = {}
        for node_id in self.nodes:
            result[node_id] = {
                link.from_pin
                for link in self.links.values()
                if self.pins[link.to_pin].parent == node_id
            }
        return result

    # -- checks -------------------------------------------------------------

    def check_node_type_match(self, from_pin: int, to_pin: int) -> bool:
        """Product-type identity check (reference: include/infra/graph.hpp:167-170)."""
        return (
            self.pins[from_pin].attribute.type
            is self.pins[to_pin].attribute.type
        )

    def check_multiple_input(self, pin_id: int) -> bool:
        """True while ``pin_id`` has at most ONE existing incoming link
        (reference: include/infra/graph.hpp:173-183).

        NOTE deliberate reference parity: because this counts EXISTING
        links, add_link still accepts the second link into an occupied
        input pin; the violation is caught by check_graph, which the app
        layer uses for its add -> validate -> rollback flow
        (app.cpp:1826-1839)."""
        count = sum(1 for link in self.links.values() if link.to_pin == pin_id)
        return count <= 1

    def check_graph(self) -> None:
        """Validate the whole graph (reference: src/infra/graph.cpp:180-282).

        Raises MismatchedPinError / MultipleInputError for bad links,
        LoopDetectedError when a cycle exists — including the
        unreachable-residue case where a cycle hangs off no zero-in-degree
        root (graph.cpp:279-281).
        """
        node_to_output: Dict[int, Set[int]] = {}
        in_degree = {
            node_id: len(srcs)
            for node_id, srcs in self.get_node_input_map().items()
        }

        seen_to: Dict[int, int] = {}
        for link in self.links.values():
            if not self.check_node_type_match(link.from_pin, link.to_pin):
                raise MismatchedPinError(link.from_pin, link.to_pin)
            seen_to[link.to_pin] = seen_to.get(link.to_pin, 0) + 1
            if seen_to[link.to_pin] > 1:
                raise MultipleInputError(link.to_pin)
            node_to_output.setdefault(
                self.pins[link.from_pin].parent, set()
            ).add(self.pins[link.to_pin].parent)

        roots = {nid for nid, deg in in_degree.items() if deg == 0}
        if self.nodes and not roots:
            raise LoopDetectedError()

        # Iterative DFS with an explicit on-stack set — equivalent to the
        # reference's four-state traversal machine (graph.cpp:214-277).
        visited: Set[int] = set()
        on_stack: Set[int] = set()
        for root in sorted(roots):
            stack: List[Tuple[int, Optional[object]]] = [(root, None)]
            while stack:
                node_id, children = stack[-1]
                if children is None:
                    if node_id in on_stack:
                        raise LoopDetectedError()
                    on_stack.add(node_id)
                    visited.add(node_id)
                    children = iter(sorted(node_to_output.get(node_id, ())))
                    stack[-1] = (node_id, children)
                child = next(children, None)
                if child is None:
                    on_stack.discard(node_id)
                    stack.pop()
                elif child in on_stack:
                    raise LoopDetectedError()
                else:
                    # Revisiting an already-fully-explored node via another
                    # path is fine (diamond fan-in); only on-stack revisits
                    # are cycles.
                    if child not in visited:
                        stack.append((child, None))
                    else:
                        visited.add(child)

        if set(in_degree) - visited:
            raise LoopDetectedError()

    # -- serde --------------------------------------------------------------

    def serialize(self) -> dict:
        """Serialize to the reference project-file schema
        (reference: src/infra/graph.cpp:284-372)::

            {"nodes": {"<id>": {"identifier": ..., "info": {...},
                                "position": {"x": ..., "y": ...}}, ...},
             "links": [{"from": {"node": n, "pin": name},
                        "to":   {"node": n, "pin": name}}, ...]}
        """
        nodes_json = {}
        for node_id, node in self.nodes.items():
            info = node.processor.info()
            nodes_json[str(node_id)] = {
                "identifier": info.identifier,
                "info": node.processor.serialize(),
                "position": {
                    "x": float(node.position[0]),
                    "y": float(node.position[1]),
                },
            }

        links_json = []
        for _, link in sorted(self.links.items()):
            from_pin = self.pins[link.from_pin]
            to_pin = self.pins[link.to_pin]
            links_json.append(
                {
                    "from": {
                        "node": from_pin.parent,
                        "pin": from_pin.attribute.identifier,
                    },
                    "to": {
                        "node": to_pin.parent,
                        "pin": to_pin.attribute.identifier,
                    },
                }
            )

        return {"nodes": nodes_json, "links": links_json}

    @staticmethod
    def deserialize(value: object) -> "Graph":
        """Rebuild a graph from :meth:`serialize` output
        (reference: src/infra/graph.cpp:374-479).

        Raises InvalidFileError on any structural problem, mirroring the
        reference's error sites one-for-one.
        """
        if not isinstance(value, dict):
            raise InvalidFileError("Invalid graph format, expected object")

        nodes_json = value.get("nodes")
        links_json = value.get("links")
        if not isinstance(nodes_json, dict):
            raise InvalidFileError("Invalid nodes format, expected object")
        if not isinstance(links_json, list):
            raise InvalidFileError("Invalid links format, expected array")

        registry.register_all_processors()
        graph = Graph()

        for key, node_json in nodes_json.items():
            # The reference uses std::stoi and rejects trailing junk
            # (graph.cpp:385-388); mirror that with a strict integer pattern.
            if not _NODE_ID_RE.match(key):
                raise InvalidFileError(f"Invalid node ID: {key}")
            node_id = int(key)
            if not isinstance(node_json, dict):
                raise InvalidFileError(
                    f"Invalid node JSON format for ID: {node_id}"
                )

            identifier = node_json.get("identifier")
            metadata = registry.processor_map.get(identifier)
            if metadata is None:
                raise InvalidFileError(
                    f"Unknown processor identifier: {identifier}"
                )

            processor = metadata.generate()
            processor.deserialize(node_json.get("info"))

            if metadata.singleton:
                if identifier in graph.singleton_node_map:
                    raise InvalidFileError(
                        f'Duplicating singleton node "{identifier}"'
                    )
                graph.singleton_node_map[identifier] = node_id

            position = node_json.get("position", {})
            graph.nodes[node_id] = Node(
                processor=processor,
                position=(
                    float(position.get("x", 0.0)),
                    float(position.get("y", 0.0)),
                ),
            )
            graph.update_node_pin(node_id)

        for link in links_json:
            if not isinstance(link, dict):
                raise InvalidFileError(
                    "Invalid link JSON format, expected object"
                )
            from_json = link.get("from")
            to_json = link.get("to")
            if not isinstance(from_json, dict) or not isinstance(to_json, dict):
                raise InvalidFileError(
                    "Invalid link 'from' or 'to' JSON format, expected object"
                )

            from_node = from_json.get("node")
            to_node = to_json.get("node")
            from_pin_name = from_json.get("pin")
            to_pin_name = to_json.get("pin")

            if from_node not in graph.nodes or to_node not in graph.nodes:
                raise InvalidFileError(
                    f"Link references non-existent node: {from_node} -> {to_node}"
                )

            from_pin_map = graph.nodes[from_node].pin_name_map
            to_pin_map = graph.nodes[to_node].pin_name_map
            if from_pin_name not in from_pin_map or to_pin_name not in to_pin_map:
                raise InvalidFileError(
                    "Link references non-existent pin: "
                    f"{from_node}.{from_pin_name} -> {to_node}.{to_pin_name}"
                )

            graph.add_link(
                from_pin_map[from_pin_name], to_pin_map[to_pin_name]
            )

        return graph
