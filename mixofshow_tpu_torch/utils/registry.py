"""Name → class registry for config-driven construction.

Port of mixofshow_tpu/utils/registry.py. Used by the transform pipeline
(reference: mixofshow/utils/registry.py:4-79, TRANSFORM_REGISTRY at :79 —
the reference's only registry use)."""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._obj_map: Dict[str, Any] = {}

    def register(self, obj: Optional[Any] = None) -> Callable:
        """Decorator (`@REG.register()`) or direct call
        (`REG.register(cls)`)."""
        if obj is None:
            def deco(cls):
                self._do_register(cls.__name__, cls)
                return cls
            return deco
        self._do_register(obj.__name__, obj)
        return obj

    def _do_register(self, name: str, obj: Any):
        if name in self._obj_map:
            raise KeyError(f'{name} already registered in {self._name}')
        self._obj_map[name] = obj

    def get(self, name: str) -> Any:
        if name not in self._obj_map:
            raise KeyError(f"No object named '{name}' in '{self._name}' "
                           f'registry. Known: {sorted(self._obj_map)}')
        return self._obj_map[name]

    def __contains__(self, name: str) -> bool:
        return name in self._obj_map


TRANSFORM_REGISTRY = Registry('transform')
