"""Self-instrumentation spans: JSONL telemetry for the tool's own hot paths.

The simulator is itself a performance artifact — trace import, cluster
build/retune, sweep points, calibration rounds, and serving graphgen all
have bench-gated budgets, but regressions in the field are invisible
without timing in situ.  ``span()`` wraps those sections:

    from repro_torch.obs import span
    with span("cluster.retune", records=len(prov)) as s:
        ...
        s.note(touched=n)

Emission is **off by default** and costs one module-global ``None`` check
(bench-gated <= 1.05x in ``benchmarks/bench_obs.py``).  Set
``REPRO_TELEMETRY=<path>`` in the environment (read once at import) or
call :func:`configure` (the ``--telemetry PATH`` CLI flag) to append one
JSON object per completed span::

    {"span": "scenario.sweep.scenario.sweep_point", "name": "...",
     "ts": <wall-clock start>, "dur_s": <perf_counter duration>,
     "attrs": {...}, "error": "ValueError"?}

``span`` is the dotted path of the contextvar-stacked enclosing spans, so
nested sections reconstruct a call tree without ids; ``contextvars`` keeps
the stack correct across threads and async tasks.  Stdlib-only: importable
from anywhere in the package without cycles.
"""

from __future__ import annotations

import contextvars
import json
import os
import threading
import time
from typing import Any, Dict, Optional, Tuple

__all__ = ["span", "configure", "enabled", "telemetry_path"]

_ENV = "REPRO_TELEMETRY"
_path: Optional[str] = os.environ.get(_ENV) or None
_file = None
_lock = threading.Lock()
_stack: "contextvars.ContextVar[Tuple[str, ...]]" = contextvars.ContextVar(
    "repro_obs_span_stack", default=())


def enabled() -> bool:
    """True when spans are being written somewhere."""
    return _path is not None


def telemetry_path() -> Optional[str]:
    """The active JSONL sink path, or None when disabled."""
    return _path


def configure(path: Optional[str]) -> None:
    """Point span emission at ``path`` (JSONL, appended); ``None``/empty
    disables.  Overrides ``REPRO_TELEMETRY``; safe to call repeatedly."""
    global _path, _file
    with _lock:
        if _file is not None:
            try:
                _file.close()
            finally:
                _file = None
        _path = path or None


def _emit(record: Dict[str, Any]) -> None:
    global _file
    line = json.dumps(record, default=str)
    with _lock:
        if _path is None:        # disabled between span start and end
            return
        if _file is None:
            _file = open(_path, "a", encoding="utf-8")
        _file.write(line + "\n")
        _file.flush()


class _NullSpan:
    """Shared no-op span: the entire disabled-path cost."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def note(self, **attrs: Any) -> None:
        pass


_NULL = _NullSpan()


class Span:
    """Context manager recording one timed section (see module doc)."""

    __slots__ = ("name", "attrs", "_t0", "_wall", "_token")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "Span":
        self._token = _stack.set(_stack.get() + (self.name,))
        self._wall = time.time()
        self._t0 = time.perf_counter()
        return self

    def note(self, **attrs: Any) -> None:
        """Attach attributes discovered mid-section to the record."""
        self.attrs.update(attrs)

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        dur = time.perf_counter() - self._t0
        path = _stack.get()
        _stack.reset(self._token)
        rec: Dict[str, Any] = {"span": ".".join(path), "name": self.name,
                               "ts": self._wall, "dur_s": dur}
        if exc_type is not None:
            rec["error"] = exc_type.__name__
        if self.attrs:
            rec["attrs"] = self.attrs
        _emit(rec)
        return False


def span(name: str, **attrs: Any) -> Any:
    """A timed section named ``name``; no-op unless telemetry is enabled."""
    if _path is None:
        return _NULL
    return Span(name, attrs)
