"""Memory-buffer and split-future model ingestion (a copy of
tpullama/gguf/stream.py).

The analog of the fork's distinctive loading machinery:

- `llama_file_buffer` (src/llama-mmap.h:55-80): own a byte buffer and read
  a model from it → here any bytes-like object is accepted directly by
  GGUFReader; `BufferSource` adds named ownership.
- `llama_future_file_buffer` promise registry (src/llama-mmap.h:82-113):
  model loading starts before the bytes arrive; another thread "fulfills"
  each split as it lands (e.g. streamed over the network), and the loader
  blocks on extraction. Mirrored by `SplitFutureRegistry` below, with the
  same (promise_key, context) keying and cross-thread fulfillment
  semantics exercised by the fork's tests/test-model-load-memory-split.cpp.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional, Union

BytesLike = Union[bytes, bytearray, memoryview]


@dataclass
class BufferSource:
    """A named in-memory model source (fork: uint8-buff-stream.h:26-44)."""

    name: str
    data: BytesLike


class SplitFuture:
    """A promise for one split's bytes, fulfilled from another thread."""

    def __init__(self, key: str, context: str):
        self.key = key
        self.context = context
        self._event = threading.Event()
        self._data: Optional[BytesLike] = None
        self._cancelled = False

    def fulfill(self, data: BytesLike):
        self._data = data
        self._event.set()

    def cancel(self):
        self._cancelled = True
        self._event.set()

    def extract(self, timeout: Optional[float] = None) -> BytesLike:
        """Block until fulfilled (llama_future_file_buffer::extract)."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"split future {self.key!r} (context {self.context!r}) "
                f"not fulfilled within {timeout}s"
            )
        if self._cancelled:
            raise RuntimeError(f"split future {self.key!r} was cancelled")
        assert self._data is not None
        return self._data


class SplitFutureRegistry:
    """Global promise registry keyed by (promise_key, context).

    Mirrors the fork's static registry semantics (src/llama-mmap.h:82-113):
    the loader registers futures for each expected split path; the
    application thread calls `fulfill(path, context, data)` as split bytes
    arrive (llama_model_load_fulfill_split_future, src/llama.cpp:377).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._futures: dict[tuple[str, str], SplitFuture] = {}

    def register(self, key: str, context: str) -> SplitFuture:
        with self._lock:
            k = (key, context)
            if k not in self._futures:
                self._futures[k] = SplitFuture(key, context)
            return self._futures[k]

    def fulfill(self, key: str, context: str, data: BytesLike) -> bool:
        """Fulfill a pending future; creates it if the loader hasn't
        registered yet (either side may arrive first)."""
        fut = self.register(key, context)
        fut.fulfill(data)
        return True

    def cancel_context(self, context: str):
        with self._lock:
            for (k, ctx), fut in self._futures.items():
                if ctx == context:
                    fut.cancel()

    def release_context(self, context: str):
        """Drop all futures of a context (frees fulfilled buffers — the
        analog of the fork's release_split host-memory bounding)."""
        with self._lock:
            for k in [k for k in self._futures if k[1] == context]:
                del self._futures[k]


# module-level registry, like the fork's static promise registry
GLOBAL_REGISTRY = SplitFutureRegistry()


def fulfill_split_future(path: str, context: str, data: BytesLike) -> bool:
    """Public API analog of llama_model_load_fulfill_split_future
    (include/llama-cpp.h / src/llama.cpp:377)."""
    return GLOBAL_REGISTRY.fulfill(path, context, data)
