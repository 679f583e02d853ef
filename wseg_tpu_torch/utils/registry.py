"""Name -> factory registries (reference: segmentation/lib/utils/registry.py).

The port keeps its own tables, so its "contrast" never collides with the JAX
package's registration of the same name.
"""

from __future__ import annotations


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._table: dict[str, object] = {}

    def register(self, name: str | None = None):
        def deco(obj):
            key = name or getattr(obj, "__name__", str(obj))
            if key in self._table:
                raise KeyError(f"{key!r} already registered in {self.name}")
            self._table[key] = obj
            return obj

        return deco

    def get(self, name: str):
        if name not in self._table:
            raise KeyError(
                f"{name!r} not found in registry {self.name}; "
                f"available: {sorted(self._table)}"
            )
        return self._table[name]

    def __contains__(self, name: str) -> bool:
        return name in self._table

    def keys(self):
        return self._table.keys()


MODELS = Registry("models")
BACKBONES = Registry("backbones")
DATASETS = Registry("datasets")
