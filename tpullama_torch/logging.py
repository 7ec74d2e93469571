"""Async ring-buffer logger — the common/log.cpp analog.

The reference's logger (common/log.cpp:494) queues messages into a ring
and drains them on a dedicated writer thread so hot paths never block on
stderr; it supports levels, timestamps, colors, and a redirect callback
(llama_log_set, llama.h:1362). This module provides the same surface:

    from tpullama_torch.logging import log
    log.info("loaded %s", path)
    log.set_callback(fn)        # llama_log_set analog
    log.tail(50)                # recent entries (the ring)
"""

from __future__ import annotations

import os
import queue
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass

LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40, "none": 99}
_COLORS = {"debug": "\x1b[90m", "info": "", "warn": "\x1b[33m",
           "error": "\x1b[31m"}
_RESET = "\x1b[0m"


@dataclass
class Entry:
    t: float
    level: str
    msg: str


class RingLogger:
    def __init__(self, capacity: int = 1024, level: str | None = None,
                 colors: bool | None = None, stream=None):
        self._ring: deque[Entry] = deque(maxlen=capacity)
        self._q: "queue.Queue[Entry | None]" = queue.Queue()
        self._cb = None
        self._stream = stream or sys.stderr
        env_level = os.environ.get("TPULLAMA_LOG_LEVEL", "info")
        self.level = LEVELS.get(level or env_level, 20)
        self.colors = (
            colors
            if colors is not None
            else os.environ.get("TPULLAMA_LOG_COLORS", "0") == "1"
        )
        self._t0 = time.time()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()

    # -------------------------------------------------- producer side

    def _log(self, level: str, fmt: str, *args):
        if LEVELS[level] < self.level:
            return
        msg = (fmt % args) if args else fmt
        e = Entry(time.time(), level, msg)
        self._ring.append(e)
        self._ensure_thread()
        self._q.put(e)  # never blocks the caller; the writer drains

    def debug(self, fmt, *a):
        self._log("debug", fmt, *a)

    def info(self, fmt, *a):
        self._log("info", fmt, *a)

    def warn(self, fmt, *a):
        self._log("warn", fmt, *a)

    def error(self, fmt, *a):
        self._log("error", fmt, *a)

    # -------------------------------------------------- control surface

    def set_callback(self, cb):
        """llama_log_set analog: cb(level: str, text: str) replaces the
        stderr writer (pass None to restore)."""
        self._cb = cb

    def set_level(self, level: str):
        self.level = LEVELS[level]

    def tail(self, n: int = 100) -> list[Entry]:
        return list(self._ring)[-n:]

    def flush(self, timeout: float = 2.0):
        t0 = time.time()
        while not self._q.empty() and time.time() - t0 < timeout:
            time.sleep(0.005)

    # -------------------------------------------------- writer thread

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            with self._lock:
                if self._thread is None or not self._thread.is_alive():
                    self._thread = threading.Thread(
                        target=self._drain, daemon=True
                    )
                    self._thread.start()

    def _drain(self):
        while True:
            e = self._q.get()
            if e is None:
                return
            cb = self._cb
            if cb is not None:
                try:
                    cb(e.level, e.msg)
                except Exception:
                    pass
                continue
            ts = e.t - self._t0
            line = f"[{ts:10.3f}] [{e.level:5s}] {e.msg}\n"
            if self.colors and _COLORS.get(e.level):
                line = _COLORS[e.level] + line.rstrip("\n") + _RESET + "\n"
            try:
                self._stream.write(line)
                self._stream.flush()
            except Exception:
                pass


log = RingLogger()
