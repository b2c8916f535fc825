"""Editing session services: undo/redo, copy/paste, project IO, autosave
(the port's copy of nodey_tpu.app.session, routed through the port's
registry and graph: ``shallow_copy_graph`` :34, ``_Snapshot`` :60,
``apply_params`` :82, ``SessionService`` :115-305).

The engine-level (UI-free) re-implementation of the reference App's editing
behaviors (reference: src/frontend/app.cpp):

* undo/redo — whole-graph snapshot stacks with cap and periodic compression
  (app.cpp:919-1041). Snapshots copy graph STRUCTURE and share processor
  instances like the C++ ``std::list<infra::Graph>`` of shallow Graph
  copies (shared_ptr<Processor> members) — PLUS a per-node parameter
  snapshot (``Processor.snapshot_params``) restored on undo/redo, which
  makes parameter tweaks undoable (in the reference they are not — a
  known gap of its shared-processor copies).
* copy/paste — clipboard is a serialized sub-graph JSON; paste
  re-instantiates via the registry with ID remap, position offset, and
  singleton skip (app.cpp:1047-1383).
* project IO — save/load with modified-flag bookkeeping (app.cpp:688-913).
* autosave — the setting the reference declares but never wires up
  (SURVEY.md §2.3); implemented here: ``maybe_autosave()`` writes
  ``<project>.autosave`` when the interval elapsed and the graph is dirty.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Sequence

from nodey_tpu_torch.app.settings import AppSettings
from nodey_tpu_torch.core import registry
from nodey_tpu_torch.core.errors import InvalidFileError
from nodey_tpu_torch.core.graph import Graph, Link, Node, Pin


def shallow_copy_graph(graph: Graph) -> Graph:
    """Structure-copy sharing processor instances (the C++ Graph copy
    constructor's semantics: value-copied maps, shared processors)."""
    out = Graph()
    out.nodes = {
        nid: Node(
            processor=node.processor,
            pins=set(node.pins),
            pin_name_map=dict(node.pin_name_map),
            position=node.position,
        )
        for nid, node in graph.nodes.items()
    }
    out.pins = {
        pid: Pin(parent=pin.parent, attribute=pin.attribute)
        for pid, pin in graph.pins.items()
    }
    out.links = {
        lid: Link(from_pin=link.from_pin, to_pin=link.to_pin)
        for lid, link in graph.links.items()
    }
    out.singleton_node_map = dict(graph.singleton_node_map)
    out.modified = graph.modified
    return out


class _Snapshot:
    """One undo/redo state: a structure-copied graph plus each node's
    parameter snapshot at capture time (processors are shared between the
    live graph and snapshots, so params must be captured separately)."""

    __slots__ = ("graph", "params")

    def __init__(self, graph: Graph):
        self.graph = shallow_copy_graph(graph)
        self.params = {
            nid: node.processor.snapshot_params()
            for nid, node in graph.nodes.items()
        }

    def restore(self) -> Graph:
        for nid, blob in self.params.items():
            node = self.graph.nodes.get(nid)
            if node is not None:
                node.processor.restore_params(blob)
        return self.graph


def apply_params(proc, params: Dict) -> Dict:
    """Apply a {key: value} dict to a processor.

    A dedicated ``set_<key>`` setter wins (it applies live-state semantics
    like clamping — e.g. the gain node's volume, which is deliberately NOT
    in the serde, reference quirk); other keys merge through
    serialize()/deserialize(). Returns what was applied; raises
    InvalidFileError for keys neither settable nor serializable."""
    applied = {}
    serde_updates = {}
    for key, value in params.items():
        setter = getattr(proc, f"set_{key}", None)
        if callable(setter):
            setter(value)
            applied[key] = value
        else:
            serde_updates[key] = value
    if serde_updates:
        blob = proc.serialize()
        if not isinstance(blob, dict):
            blob = {}
        unknown = [k for k in serde_updates if k not in blob]
        if unknown:
            raise InvalidFileError(
                f"{type(proc).__name__} has no settable parameter(s) "
                f"{unknown} (serde fields: {sorted(blob)})"
            )
        blob.update(serde_updates)
        proc.deserialize(blob)
        applied.update(serde_updates)
    return applied


class SessionService:
    """Holds the live graph plus editing state for one project."""

    MAX_REDO = 30  # reference: app.cpp:940, 961

    def __init__(self, settings: Optional[AppSettings] = None):
        registry.register_all_processors()
        self.settings = settings or AppSettings()
        self.graph = Graph()
        self.undo_stack: List[_Snapshot] = []
        self.redo_stack: List[_Snapshot] = []
        self.clipboard_json: str = ""
        self.project_path: Optional[str] = None
        self._last_paste_position = (100.0, 100.0)
        self._last_autosave = time.monotonic()

    # -- undo/redo (reference: app.cpp:919-1041) -----------------------------

    def save_undo_state(self) -> None:
        self.graph.modified = True
        self.undo_stack.append(_Snapshot(self.graph))
        if len(self.undo_stack) > self.settings.editor.max_undo_levels:
            self.undo_stack.pop(0)
        self.redo_stack.clear()
        if len(self.undo_stack) % 10 == 0:
            self._compress_undo_stack()

    def undo(self) -> bool:
        if not self.undo_stack:
            return False
        self.redo_stack.append(_Snapshot(self.graph))
        if len(self.redo_stack) > self.MAX_REDO:
            self.redo_stack.pop(0)
        self.graph = self.undo_stack.pop().restore()
        return True

    def redo(self) -> bool:
        if not self.redo_stack:
            return False
        self.undo_stack.append(_Snapshot(self.graph))
        if len(self.undo_stack) > self.MAX_REDO:
            self.undo_stack.pop(0)
        self.graph = self.redo_stack.pop().restore()
        return True

    def _compress_undo_stack(self) -> None:
        """Keep the newest 10 states, one checkpoint per 5 older ones
        (reference: app.cpp:1001-1029)."""
        if len(self.undo_stack) < 20:
            return
        recent_start = max(0, len(self.undo_stack) - 10)
        compressed = self.undo_stack[:recent_start:5]
        compressed.extend(self.undo_stack[recent_start:])
        self.undo_stack = compressed

    # -- copy/paste (reference: app.cpp:1047-1383) ---------------------------

    def copy_nodes(self, node_ids: Sequence[int]) -> int:
        """Serialize the induced sub-graph of ``node_ids`` to the clipboard.
        Links are kept when both endpoints are selected. Returns the number
        of copied nodes."""
        temp = Graph()
        mapping: Dict[int, int] = {}
        for nid in node_ids:
            node = self.graph.nodes.get(nid)
            if node is None:
                continue
            info = node.processor.info()
            fresh = registry.processor_map[info.identifier].generate()
            fresh.deserialize(node.processor.serialize())
            new_id = temp.add_node(fresh)
            temp.nodes[new_id].position = node.position
            mapping[nid] = new_id

        for link in self.graph.links.values():
            from_pin = self.graph.pins[link.from_pin]
            to_pin = self.graph.pins[link.to_pin]
            if from_pin.parent in mapping and to_pin.parent in mapping:
                from_map = temp.nodes[mapping[from_pin.parent]].pin_name_map
                to_map = temp.nodes[mapping[to_pin.parent]].pin_name_map
                src = from_map.get(from_pin.attribute.identifier)
                dst = to_map.get(to_pin.attribute.identifier)
                if src is not None and dst is not None:
                    temp.add_link(src, dst)

        self.clipboard_json = json.dumps(temp.serialize())
        return len(mapping)

    def paste_nodes(self, at=None) -> List[int]:
        """Paste the clipboard into the live graph. Returns new node IDs.
        Singletons already present are skipped (app.cpp:1259-1264); repeated
        pastes cascade the offset like the reference's last_paste_position
        (app.cpp:1231-1240)."""
        if not self.clipboard_json:
            return []
        try:
            temp = Graph.deserialize(json.loads(self.clipboard_json))
        except (json.JSONDecodeError, InvalidFileError):
            return []
        if not temp.nodes:
            return []

        self.save_undo_state()

        if at is None:
            x, y = self._last_paste_position
            x, y = x + 20.0, y + 20.0
            if x > 500.0 or y > 500.0:
                x, y = 100.0, 100.0
            self._last_paste_position = (x, y)
        else:
            x, y = at
        first = next(iter(temp.nodes.values()))
        offset = (x - first.position[0], y - first.position[1])

        mapping: Dict[int, int] = {}
        pasted: List[int] = []
        for temp_id, temp_node in temp.nodes.items():
            info = temp_node.processor.info()
            if (
                info.singleton
                and info.identifier in self.graph.singleton_node_map
            ):
                continue
            fresh = registry.processor_map[info.identifier].generate()
            fresh.deserialize(temp_node.processor.serialize())
            new_id = self.graph.add_node(fresh)
            self.graph.nodes[new_id].position = (
                temp_node.position[0] + offset[0],
                temp_node.position[1] + offset[1],
            )
            mapping[temp_id] = new_id
            pasted.append(new_id)

        for link in temp.links.values():
            from_pin = temp.pins[link.from_pin]
            to_pin = temp.pins[link.to_pin]
            if from_pin.parent not in mapping or to_pin.parent not in mapping:
                continue
            from_map = self.graph.nodes[mapping[from_pin.parent]].pin_name_map
            to_map = self.graph.nodes[mapping[to_pin.parent]].pin_name_map
            src = from_map.get(from_pin.attribute.identifier)
            dst = to_map.get(to_pin.attribute.identifier)
            if src is not None and dst is not None:
                try:
                    self.graph.add_link(src, dst)
                except Exception:
                    pass  # mirror the reference's tolerant paste
        return pasted

    # -- project IO (reference: app.cpp:688-913) -----------------------------

    def new_project(self) -> None:
        self.graph = Graph()
        self.undo_stack.clear()
        self.redo_stack.clear()
        self.project_path = None

    def save_project(self, path: Optional[str] = None) -> str:
        path = path or self.project_path
        if not path:
            raise ValueError("no project path")
        with open(path, "w") as f:
            json.dump(self.graph.serialize(), f, indent=1)
        self.graph.modified = False
        self.project_path = path
        return path

    def open_project(self, path: str) -> None:
        with open(path) as f:
            blob = json.load(f)
        self.save_undo_state()
        self.graph = Graph.deserialize(blob)
        self.graph.modified = False
        self.project_path = path

    # -- autosave (declared-but-unwired in the reference; fixed here) --------

    def maybe_autosave(self) -> Optional[str]:
        if not self.settings.editor.auto_save or not self.graph.modified:
            return None
        if not self.project_path:
            return None
        now = time.monotonic()
        if now - self._last_autosave < self.settings.editor.auto_save_interval:
            return None
        self._last_autosave = now
        path = self.project_path + ".autosave"
        with open(path, "w") as f:
            json.dump(self.graph.serialize(), f, indent=1)
        return path
