"""Deferred module imports for interpreter-startup-sensitive paths.

The reference is a C extension with negligible import cost; this package
pays a Python interpreter start on every CLI invocation, and the
sub-5-second gallery scripts are dominated by it (BENCH.md section 5:
~3.5 s process floor).  scipy.sparse alone is ~0.4 s of the package's
import — but it is only needed once a solve actually assembles
constraints, so the solver modules bind it through this proxy and the
import happens on first attribute access instead of at package import.
"""

from __future__ import annotations

import importlib


class _LazyModule:
    """Attribute-forwarding proxy that imports the module on first use."""

    def __init__(self, name: str) -> None:
        object.__setattr__(self, "_lazy_name", name)
        object.__setattr__(self, "_lazy_mod", None)

    def _load(self):
        mod = object.__getattribute__(self, "_lazy_mod")
        if mod is None:
            mod = importlib.import_module(
                object.__getattribute__(self, "_lazy_name")
            )
            object.__setattr__(self, "_lazy_mod", mod)
        return mod

    def __getattr__(self, item):
        return getattr(self._load(), item)

    def __dir__(self):
        return dir(self._load())


def lazy_module(name: str) -> _LazyModule:
    """A module proxy whose real import is deferred to first attribute use."""
    return _LazyModule(name)
