"""The port's graph: ``nodey_tpu.core.graph.Graph`` with a deserializer
that resolves identifiers against this package's registry.

Everything else (IDs, pins, links, ``check_graph``, ``serialize``) is the
JAX package's code, which imports no jax. Its ``deserialize`` calls
``nodey_tpu.core.registry.register_all_processors()``, which imports every
JAX processor and so jax; the override below is the same reader over
:mod:`nodey_tpu_torch.core.registry`. Project files stay interchangeable
between the two packages.
"""

from __future__ import annotations

from nodey_tpu.core import graph as _jgraph
from nodey_tpu.core.errors import InvalidFileError
from nodey_tpu.core.graph import Node

from nodey_tpu_torch.core import registry


class Graph(_jgraph.Graph):
    """Node/pin/link store whose nodes are the port's processors."""

    @staticmethod
    def deserialize(value: object) -> "Graph":
        """Rebuild a graph from the project-file schema; raises
        InvalidFileError at the same sites as the JAX reader
        (reference: src/infra/graph.cpp:374-479)."""
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
            if not _jgraph._NODE_ID_RE.match(key):
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
