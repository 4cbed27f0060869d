"""Checkpointer backend registry: name -> factory.

Backends self-register at import via the `@register_backend` decorator;
`create_checkpointer` is the single construction path every trainer uses
(directly or through `CheckpointSpec.build` / `CheckpointSession`).
"""
from __future__ import annotations

from typing import Any, Callable, Dict

from repro_torch.api.types import Checkpointer, CheckpointSpec

_REGISTRY: Dict[str, Callable[[CheckpointSpec, Any], Checkpointer]] = {}


def register_backend(name: str):
    def deco(factory):
        if name in _REGISTRY:
            raise ValueError(f"backend {name!r} already registered")
        _REGISTRY[name] = factory
        return factory
    return deco


def available_backends() -> list:
    _load_builtin()
    return sorted(_REGISTRY)


def create_checkpointer(spec: CheckpointSpec,
                        state_template: Any) -> Checkpointer:
    _load_builtin()
    try:
        factory = _REGISTRY[spec.backend]
    except KeyError:
        raise KeyError(f"unknown checkpointer backend {spec.backend!r}; "
                       f"available: {available_backends()}") from None
    return factory(spec, state_template)


def _load_builtin():
    # import for registration side effects (idempotent)
    from repro_torch.api import backends as _b          # noqa: F401
    from repro_torch.api import disk as _d              # noqa: F401
    from repro_torch.api import objstore as _o          # noqa: F401
