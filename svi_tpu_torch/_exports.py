"""Lazy exports of the subpackages: a name is imported from its module at
first access, so that importing a subpackage loads none of its modules (the
SD, Step and OmniGen paths stay free of Pillow, cv2 and imageio)."""

from __future__ import annotations

import importlib


def lazy_exports(package: str, exports: dict[str, str]):
    """A module-level `__getattr__` for `package`: exports maps each public
    name to the submodule that defines it, or to itself for a submodule."""

    def __getattr__(name):
        if name not in exports:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        module = importlib.import_module(f".{exports[name]}", package)
        return module if exports[name] == name else getattr(module, name)

    return __getattr__
