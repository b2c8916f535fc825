"""Carry a JAX-package graph, with its live state, into the port.

The system has no model weights. Its state is the filter banks, which
both packages design identically from the rate pair, and each node's live
parameters. ``Graph.serialize`` alone does not carry the latter: by a
reference quirk ``audio_volume_adjust`` persists no volume
(audio-vol.hpp:57-58), so a JSON round trip resets it to 1.0. This module
adds each node's ``snapshot_params()`` on top of the project JSON.
"""

from __future__ import annotations

from nodey_tpu_torch.core.graph import Graph


def graph_from_jax(jax_graph) -> Graph:
    """Rebuild a ``nodey_tpu.core.graph.Graph`` (node IDs, links, positions
    and live parameters) as a graph of the port's processors. Takes the
    JAX graph object; imports nothing of the JAX package."""
    graph = Graph.deserialize(jax_graph.serialize())
    for nid, node in jax_graph.nodes.items():
        graph.nodes[nid].processor.restore_params(
            node.processor.snapshot_params()
        )
    return graph
