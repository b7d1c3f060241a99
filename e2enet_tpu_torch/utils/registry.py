"""Explicit string-keyed component registries.

The reference resolves trainers/planners/preprocessors by *recursively
scanning modules* for a class of a given name
(e2enet/training/model_restore.py:23-41). We replace that implicit plugin
mechanism with explicit registries: components self-register at import time
and are looked up by name. Unknown names raise with the list of known keys.

The port's own copy of e2enet_tpu/utils/registry.py, unchanged but for this note:
the port imports nothing of the JAX package.
"""


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._items = {}

    def register(self, name=None):
        def deco(obj):
            key = name or obj.__name__
            self._items[key] = obj
            return obj
        return deco

    def add(self, name, obj):
        self._items[name] = obj
        return obj

    def get(self, name):
        if name not in self._items:
            raise KeyError(
                f"Unknown {self.kind} '{name}'. Registered: "
                f"{sorted(self._items)}")
        return self._items[name]

    def __contains__(self, name):
        return name in self._items

    def keys(self):
        return sorted(self._items)


NETWORKS = Registry("network")
TRAINERS = Registry("trainer")
PLANNERS = Registry("planner")
PREPROCESSORS = Registry("preprocessor")
