"""Profiling hookup (port of tpullama/runtime/profiling.py).

Wraps torch.profiler behind one env var / context manager:
  TPULLAMA_PROFILE=/tmp/trace  ->  tools (cli, server) write a Chrome
  trace of the host and, on the card, of every kernel launch, viewable
  in chrome://tracing or Perfetto.

Per-op timing comes from the profiler's device records: PyTorch runs
eagerly, so each kernel of a step shows up under its own name.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time


@contextlib.contextmanager
def maybe_profile(trace_dir: str | None = None):
    """Profile the enclosed block when a trace dir is given (argument or
    TPULLAMA_PROFILE env). No-op otherwise."""
    trace_dir = trace_dir or os.environ.get("TPULLAMA_PROFILE")
    if not trace_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield trace_dir
    path = os.path.join(trace_dir, f"trace_{os.getpid()}_{int(time.time())}.json")
    prof.export_chrome_trace(path)
    print(f"[profile] wrote a torch.profiler trace to {path} "
          "(chrome://tracing or Perfetto)", file=sys.stderr)


def annotate(name: str):
    """Named-range annotation for a region (torch.profiler.record_function;
    shows up in the profiler timeline)."""
    import torch

    return torch.profiler.record_function(name)
