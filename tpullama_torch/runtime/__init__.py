"""Runtime layer: KV cache + decode engine, host sampler chain."""

from .context import Context, ContextParams

__all__ = ["Context", "ContextParams"]
