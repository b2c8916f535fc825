"""Processor base class and the port's static registry (the port's copy
of nodey_tpu.core.registry).

Mirrors the reference's ``infra::Processor`` ABC + string-keyed metadata
registry (reference: include/infra/processor.hpp:26-130,
src/register.cpp:14-24). ``lower()`` runs PyTorch ops on the tensors of
a node's inputs (see nodey_tpu_torch.core.compiler). The map of
identifiers is this package's own, so the JAX processors and the port's
can be loaded in one process without colliding on the same identifiers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Type

from nodey_tpu_torch.core.errors import LogicError, ProcessorRuntimeError

__all__ = [
    "PinAttribute",
    "Processor",
    "ProcessorInfo",
    "processor_map",
    "register_all_processors",
    "register_processor",
]


@dataclasses.dataclass
class PinAttribute:
    """Pin metadata (reference: include/infra/processor.hpp:42-49).

    ``type`` is a product-type marker class (e.g.
    :class:`nodey_tpu_torch.core.stream.AudioStreamType`); link validation
    compares markers by identity, exactly as the reference compares
    ``std::type_info`` addresses (include/infra/graph.hpp:167-170).
    """

    identifier: str
    display_name: str
    type: type
    is_input: bool


@dataclasses.dataclass
class ProcessorInfo:
    """Processor metadata (reference: include/infra/processor.hpp:51-59)."""

    identifier: str
    display_name: str
    singleton: bool
    generate: Callable[[], "Processor"]
    description: str = ""


class Processor:
    """Base class for all node processors.

    Subclasses implement ``info()``, ``pin_attributes()``,
    ``serialize()/deserialize()`` (the per-node JSON info blob with the
    reference's field names) and ``lower(ctx, inputs) -> outputs``.
    """

    # True where ``lower`` also takes batched streams (``[B, C, N]`` data
    # with per-clip lengths) and gives each clip its single render:
    # ``CompiledGraph.run_batch`` refuses a graph with any other node.
    batched = False

    def info(self) -> ProcessorInfo:  # pragma: no cover - abstract
        raise NotImplementedError

    def pin_attributes(self) -> List[PinAttribute]:  # pragma: no cover
        raise NotImplementedError

    def serialize(self) -> Any:
        """Export node settings as a JSON-compatible value. Default: empty
        object, like reference nodes whose serialize returns ``{}``."""
        return {}

    def deserialize(self, value: Any) -> None:
        """Restore node settings from :meth:`serialize` output. Default: no-op."""

    def snapshot_params(self) -> Any:
        """Full editable-parameter snapshot. Default: the serde blob; nodes
        whose live params are left out of the project serde override it
        (Audio_vol's volume, audio-vol.hpp:57-58 quirk).
        ``convert.graph_from_jax`` carries graphs with it."""
        return self.serialize()

    def restore_params(self, blob: Any) -> None:
        """Inverse of :meth:`snapshot_params`."""
        self.deserialize(blob)

    def param_spec(self) -> Optional[List[Dict[str, Any]]]:
        """Declarative widget schema for an editor's parameter panel, as in
        the JAX package: ``{key, label, kind, value}`` plus kind-specific
        constraints. Default ``None``: no editable parameters."""
        return None

    def lower(self, ctx, inputs: Dict[str, Any]) -> Dict[str, Any]:
        """Run this node's DSP: input-pin identifier -> Stream (absent if
        unconnected) to output-pin identifier -> Stream."""
        raise NotImplementedError

    def plan_stream(self, ctx, in_specs: Dict[str, Any]):
        """The base class's refusal for a node without a streamed
        lowering (the streaming executor then exports offline)."""
        raise ProcessorRuntimeError(
            "Node does not support streaming execution",
            f"{type(self).__name__} implements only whole-clip lowering.",
            "plan_stream",
        )

    def lower_stream(self, ctx, inputs: Dict[str, Any], state):
        """The base class's refusal for a node without a streamed
        lowering."""
        raise ProcessorRuntimeError(
            "Node does not support streaming execution",
            f"{type(self).__name__} implements only whole-clip lowering.",
            "lower_stream",
        )


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
