"""The port's processor registry.

The ``Processor`` base and the pin/info records come from
``nodey_tpu.core.registry`` (they import no jax); the map of identifiers
is this package's own, so the JAX processors and the port's can be loaded
in one process without colliding on the same identifiers.
"""

from __future__ import annotations

from typing import Dict, Type

from nodey_tpu.core.errors import LogicError
from nodey_tpu.core.registry import PinAttribute, Processor, ProcessorInfo

__all__ = [
    "PinAttribute",
    "Processor",
    "ProcessorInfo",
    "processor_map",
    "register_all_processors",
    "register_processor",
]

processor_map: Dict[str, ProcessorInfo] = {}


def register_processor(cls: Type[Processor]) -> Type[Processor]:
    """Register a processor class; duplicate identifiers raise LogicError."""
    info = cls().info()
    if info.identifier in processor_map:
        raise LogicError(
            f"Processor with identifier '{info.identifier}' already registered"
        )
    processor_map[info.identifier] = info
    return cls


_registered = False


def register_all_processors() -> None:
    """Populate the registry with every ported node. Idempotent."""
    global _registered
    if _registered:
        return
    _registered = True
    from nodey_tpu_torch.processors import register_builtin_processors

    register_builtin_processors()
