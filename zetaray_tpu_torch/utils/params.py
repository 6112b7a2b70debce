"""Runtime-tweakable parameter system (ParamVariant analog).

The reference exposes every tunable (sun direction, ReSTIR M-max,
tonemapper, FOV, ...) as a self-registering typed variant with a callback
delegate, grouped by group/subgroup, applied once per frame as a task
(Support/Param.h:163-267, App::AddParam App.h:152-155). This is the same
contract in Python: declare a ``Param``, it lands in the global registry,
UIs/CLIs enumerate the registry, and ``apply`` fires the callback.

Callbacks typically rebuild the frozen RenderConfig that the next frame
reads (the app's ``_register_params``), so a change takes effect at the
frame boundary where ``apply_pending`` runs.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable


@dataclass
class Param:
    group: str
    subgroup: str
    name: str
    kind: str  # "float" | "int" | "bool" | "enum" | "color3" | "float3" | "unitdir"
    value: Any
    min: Any = None
    max: Any = None
    step: Any = None
    choices: tuple = ()
    on_change: Callable[[Any], None] | None = None

    @property
    def path(self) -> str:
        return f"{self.group}/{self.subgroup}/{self.name}"


class ParamRegistry:
    """Global, thread-safe param table (the reference's AppData param list
    guarded by an SRWLOCK, Win32App.cpp:1624-1630)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._params: dict[str, Param] = {}
        self._pending: list[tuple[str, Any]] = []

    def add(self, p: Param) -> Param:
        with self._lock:
            self._params[p.path] = p
        return p

    def remove(self, path: str) -> None:
        with self._lock:
            self._params.pop(path, None)

    def get(self, path: str) -> Param:
        with self._lock:
            return self._params[path]

    def all(self, group: str | None = None) -> list[Param]:
        with self._lock:
            ps = list(self._params.values())
        if group is not None:
            ps = [p for p in ps if p.group == group]
        return sorted(ps, key=lambda p: p.path)

    def queue_set(self, path: str, value: Any) -> None:
        """Thread-safe deferred set; applied at the frame boundary (the
        reference applies param messages once per frame as a task)."""
        with self._lock:
            self._pending.append((path, value))

    def apply_pending(self) -> int:
        """Apply queued sets; a bad value is logged and dropped so a remote
        caller can never kill the frame loop (the reference clamps/ignores
        malformed param messages the same way)."""
        with self._lock:
            pending, self._pending = self._pending, []
        applied = 0
        for path, value in pending:
            try:
                self.set(path, value)
                applied += 1
            except (KeyError, ValueError, TypeError) as e:
                from . import log

                log.warning(f"param set {path}={value!r} rejected: {e}")
        return applied

    def set(self, path: str, value: Any) -> None:
        p = self.get(path)
        value = _validate(p, value)
        p.value = value
        if p.on_change is not None:
            p.on_change(value)

    def snapshot(self) -> dict[str, Any]:
        """All current values (persistable; the closest thing the reference
        has is the PSO cache -- we also cover tweakables)."""
        with self._lock:
            return {k: p.value for k, p in self._params.items()}

    def restore(self, snap: dict[str, Any]) -> None:
        for k, v in snap.items():
            if k in self._params:
                self.set(k, v)


def _validate(p: Param, value):
    if p.kind == "float":
        value = float(value)
    elif p.kind == "int":
        value = int(value)
    elif p.kind == "bool":
        value = bool(value)
    elif p.kind == "enum":
        if value not in p.choices:
            raise ValueError(f"{p.path}: {value!r} not in {p.choices}")
        return value
    elif p.kind in ("color3", "float3", "unitdir"):
        value = tuple(float(v) for v in value)
        if len(value) != 3:
            raise ValueError(f"{p.path}: need 3 components")
        if p.kind == "unitdir":
            import math

            n = math.sqrt(sum(v * v for v in value)) or 1.0
            value = tuple(v / n for v in value)
        return value
    if p.min is not None:
        value = max(p.min, value)
    if p.max is not None:
        value = min(p.max, value)
    return value


registry = ParamRegistry()


def add_param(group, subgroup, name, kind, value, **kw) -> Param:
    """Self-registration helper (App::AddParam)."""
    return registry.add(Param(group, subgroup, name, kind, value, **kw))
