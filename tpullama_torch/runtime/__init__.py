"""Runtime layer: KV cache + decode engine, host sampler chain, state I/O
(runtime/state.py)."""

from .context import Context, ContextParams, make_context

__all__ = ["Context", "ContextParams", "make_context"]
