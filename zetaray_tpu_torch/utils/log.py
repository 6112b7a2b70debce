"""Ring-buffer logger (LOG_UI analog, App/Log.h).

The reference appends into a lock-guarded arena-backed list rendered in the
GUI log window (App.h:86-100). Here: a bounded deque with levels, plus a
plain-stderr mirror; viewers read ``ring()``.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import deque

_LEVELS = ("DEBUG", "INFO", "WARNING", "ERROR")
_ring: deque = deque(maxlen=512)
_lock = threading.Lock()
_mirror = True


def log(level: str, msg: str) -> None:
    assert level in _LEVELS
    entry = (time.time(), level, msg)
    with _lock:
        _ring.append(entry)
    if _mirror:
        print(f"[zetaray:{level}] {msg}", file=sys.stderr)


def info(msg: str) -> None:
    log("INFO", msg)


def warning(msg: str) -> None:
    log("WARNING", msg)


def error(msg: str) -> None:
    log("ERROR", msg)


def ring() -> list:
    with _lock:
        return list(_ring)


def set_mirror(on: bool) -> None:
    global _mirror
    _mirror = on
