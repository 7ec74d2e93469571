"""Serving layer: the continuous-batching slot engine (engine.py) and the
HTTP server over it (http.py, router.py)."""

from .engine import ServerEngine, Task

__all__ = ["ServerEngine", "Task"]
