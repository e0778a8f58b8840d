"""Lazy imports for the port's test modules (``tests/test_torch_*.py``).

The port's test modules reach ``torch`` and ``repro_torch`` through
:class:`LazyModule`, never by a top-level import.  Every test worker
imports every test module while it collects, and a worker that has
imported torch runs the JAX package's serving tests into a race of the
JAX engine far more often (ROADMAP queue C): with lazy imports, only the
workers that run a port test load torch, after their JAX tests ran.
This module imports neither torch nor JAX.
"""
from __future__ import annotations

import importlib

__all__ = ["LazyModule", "torch"]


class LazyModule:
    """Stands for module ``name`` and imports it at the first attribute
    read."""

    def __init__(self, name: str):
        self._name = name

    def __getattr__(self, attr):
        return getattr(importlib.import_module(self._name), attr)


torch = LazyModule("torch")
