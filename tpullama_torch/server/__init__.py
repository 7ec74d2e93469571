"""Serving layer: the continuous-batching slot engine."""

from .engine import ServerEngine, Task

__all__ = ["ServerEngine", "Task"]
