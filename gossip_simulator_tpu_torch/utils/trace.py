"""Host-side span tracer: Chrome trace-event "X" spans behind ``-trace``.

The port's copy of the JAX package's ``utils/trace.py``: named spans
(``init``, the phase-1 and phase-2 windows, quiescence and run-to-target
loops, each bounded call) with counters as span args, written as one
Chrome/Perfetto trace-event JSON document.

``-xprof DIR`` additionally runs ``torch.profiler.profile`` around the
run (CPU activity, and CUDA activity on the card) and enters
``torch.profiler.record_function(name)`` per span, so the device
timeline in the profiler's Chrome trace (written into DIR) lines up with
the host spans recorded here.

Instrumentation sites use the module-level ``span()`` / ``instant()``
helpers, which are no-ops while no tracer is active: a run without
``-trace`` pays one None check per span site, each on a host-side
per-call or per-window boundary.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Optional


class Tracer:
    """Collects Chrome trace-event "X" (complete) events host-side,
    timestamped in microseconds from the tracer's construction."""

    def __init__(self, path: str = "", xprof_dir: str = ""):
        self.path = path
        self.xprof_dir = xprof_dir
        self.events: list[dict] = []
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._pid = os.getpid()
        self._prof = None

    def now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "host", **args):
        """One timed region; yields its args dict, so counters known only
        at the span's exit can be added before the event is sealed."""
        ann = self._annotation(name)
        t0 = self.now_us()
        try:
            if ann is not None:
                with ann:
                    yield args
            else:
                yield args
        finally:
            ev = {"name": name, "cat": cat, "ph": "X", "ts": t0,
                  "dur": self.now_us() - t0, "pid": self._pid,
                  "tid": threading.get_ident()}
            if args:
                ev["args"] = dict(args)
            with self._lock:
                self.events.append(ev)

    def instant(self, name: str, cat: str = "host", **args) -> None:
        """Zero-duration marker (trace-event "i")."""
        ev = {"name": name, "cat": cat, "ph": "i", "s": "p",
              "ts": self.now_us(), "pid": self._pid,
              "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        with self._lock:
            self.events.append(ev)

    # --- -xprof: the torch profiler's device timeline -------------------
    def _annotation(self, name: str):
        if self._prof is None:
            return None
        import torch

        return torch.profiler.record_function(name)

    def start(self) -> None:
        """Begin the optional device profile (``-xprof DIR``)."""
        if self.xprof_dir and self._prof is None:
            self._prof = start_profile()
            self._prof.__enter__()

    def stop(self) -> None:
        if self._prof is not None:
            prof, self._prof = self._prof, None
            prof.__exit__(None, None, None)
            write_profile(prof, self.xprof_dir)

    # --- output ---------------------------------------------------------
    def to_json(self, metadata: Optional[dict] = None) -> dict:
        with self._lock:
            events = list(self.events)
        doc: dict = {"traceEvents": events, "displayTimeUnit": "ms"}
        if metadata:
            doc["metadata"] = metadata
        return doc

    def write(self, path: str = "", metadata: Optional[dict] = None) -> str:
        """Write the trace file; returns the path written."""
        out = path or self.path
        if not out:
            raise ValueError("Tracer.write: no path configured")
        parent = os.path.dirname(os.path.abspath(out))
        os.makedirs(parent, exist_ok=True)
        tmp = out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_json(metadata), f)
        os.replace(tmp, out)
        return out


def start_profile():
    """A ``torch.profiler.profile`` with CPU activity, plus CUDA activity
    when a card is present (not yet entered)."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def write_profile(prof, out_dir: str) -> str:
    """Export a finished profile as a Chrome trace into `out_dir`."""
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"torch_trace.{os.getpid()}.json")
    prof.export_chrome_trace(out)
    return out


# --- module-level active tracer ---------------------------------------------

_ACTIVE: Optional[Tracer] = None


def activate(tracer: Tracer) -> Tracer:
    global _ACTIVE
    _ACTIVE = tracer
    return tracer


def deactivate() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[Tracer]:
    return _ACTIVE


class _NullContext:
    """Inactive-tracer span: yields None (callers guard counter updates
    with ``if sp is not None``)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullContext()


def span(name: str, cat: str = "host", **args):
    """A timed span on the active tracer, or a no-op yielding None."""
    t = _ACTIVE
    if t is None:
        return _NULL
    return t.span(name, cat=cat, **args)


def instant(name: str, cat: str = "host", **args) -> None:
    t = _ACTIVE
    if t is not None:
        t.instant(name, cat=cat, **args)


@contextlib.contextmanager
def activated(tracer: Optional[Tracer]):
    """Scoped activation: activates on entry, starts the optional device
    profile, and always deactivates, so a raised run leaves no stale
    tracer behind."""
    if tracer is None:
        yield None
        return
    prev = _ACTIVE
    activate(tracer)
    tracer.start()
    try:
        yield tracer
    finally:
        tracer.stop()
        globals()["_ACTIVE"] = prev
