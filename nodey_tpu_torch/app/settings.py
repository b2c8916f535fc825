"""Application settings with the reference's settings.json schema (the
port's copy of nodey_tpu.app.settings: the same fields, the same JSON).

reference: include/frontend/app/settings.hpp:9-57,
src/frontend/app/settings.cpp:13-117. Field names and the top-level
{"ui", "editor", "render"} nesting match byte-semantics so a reference
settings.json loads here and vice versa, and a file saved by either package
is byte-equal to the other's. NOTE the reference declares
auto_save/auto_save_interval but never implements autosave (SURVEY.md §2.3);
here SessionService honors them (an intentional fix, as in the JAX
package).

``_restore`` is nodey_tpu/app/settings.py:19, the three sections :47-74 and
``AppSettings`` :75-121.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any


def _restore(obj, blob: Any) -> None:
    if not isinstance(blob, dict):
        return
    try:
        import typing

        hints = typing.get_type_hints(type(obj))
    except Exception:
        hints = {}
    for field in dataclasses.fields(obj):
        if field.name in blob:
            # Resolve the real annotation (field.type is a string under
            # `from __future__ import annotations`); fall back to the
            # default value's type so a future non-primitive field loads
            # instead of being silently skipped.
            caster = hints.get(field.name)
            if not callable(caster):
                current = getattr(obj, field.name, None)
                caster = type(current) if current is not None else None
            if caster is None:
                continue
            try:
                setattr(obj, field.name, caster(blob[field.name]))
            except (TypeError, ValueError):
                pass


@dataclasses.dataclass
class UISettings:
    """reference: settings.hpp:11-22."""

    show_toolbar: bool = True
    show_minimap: bool = True
    show_grid: bool = True
    grid_size: float = 20.0
    snap_to_grid: bool = False
    side_panel_width: int = 300


@dataclasses.dataclass
class EditorSettings:
    """reference: settings.hpp:25-33."""

    auto_save: bool = True
    auto_save_interval: int = 300
    max_undo_levels: int = 30


@dataclasses.dataclass
class ExportSettings:
    """reference: settings.hpp:36-41."""

    default_output_directory: str = "./output/"


@dataclasses.dataclass
class AppSettings:
    """reference: settings.hpp:44-57."""

    ui: UISettings = dataclasses.field(default_factory=UISettings)
    editor: EditorSettings = dataclasses.field(default_factory=EditorSettings)
    export_settings: ExportSettings = dataclasses.field(
        default_factory=ExportSettings
    )

    def serialize(self) -> dict:
        # Top-level keys per settings.cpp:71-77 ("render" for export).
        return {
            "ui": dataclasses.asdict(self.ui),
            "editor": dataclasses.asdict(self.editor),
            "render": dataclasses.asdict(self.export_settings),
        }

    def deserialize(self, blob: Any) -> None:
        if not isinstance(blob, dict):
            return
        _restore(self.ui, blob.get("ui"))
        _restore(self.editor, blob.get("editor"))
        _restore(self.export_settings, blob.get("render"))

    def load_from_file(self, path: str) -> None:
        """Missing/invalid file silently keeps defaults
        (settings.cpp:87-99)."""
        if not os.path.isfile(path):
            return
        try:
            with open(path) as f:
                self.deserialize(json.load(f))
        except (OSError, json.JSONDecodeError):
            pass

    def save_to_file(self, path: str) -> bool:
        try:
            with open(path, "w") as f:
                json.dump(self.serialize(), f, indent=1)
            return True
        except OSError:
            return False

    def reset_to_defaults(self) -> None:
        self.ui = UISettings()
        self.editor = EditorSettings()
        self.export_settings = ExportSettings()
