"""Graceful shutdown: the port's copy of the JAX package's
``utils/lifecycle.py``.

``install_signal_handlers()`` turns the first SIGTERM or SIGINT into a
flag that the driver polls at window boundaries (and the run-to-target
loop between its bounded calls): the run then writes a final snapshot
(with ``-checkpoint-dir``), its records with reason "interrupted", and
exits 2.  A second signal restores the default disposition and re-raises
it, so a run that does not reach a boundary can still be killed.

The flag is process-wide, as signals are.  It is read on the host only,
so a run that is never signalled follows the same trajectory whether the
handlers are installed or not.
"""

from __future__ import annotations

import signal

_shutdown_signum: int | None = None
_installed = False
# Callbacks fired once, at the first request, before the flag is polled.
_on_shutdown: list = []


def shutdown_requested() -> bool:
    return _shutdown_signum is not None


def register_on_shutdown(cb) -> None:
    """Run `cb()` when shutdown is first requested (by a signal or
    ``request_shutdown``).  What a callback raises is swallowed: it must
    not break the signal's delivery.  ``reset()`` clears them."""
    _on_shutdown.append(cb)


def _fire_callbacks() -> None:
    for cb in list(_on_shutdown):
        try:
            cb()
        except Exception:  # noqa: BLE001 - see register_on_shutdown
            pass


def request_shutdown(signum: int = signal.SIGTERM) -> None:
    """Raise the flag from code (tests, a host that embeds the run)."""
    global _shutdown_signum
    first = _shutdown_signum is None
    _shutdown_signum = signum
    if first:
        _fire_callbacks()


def reset() -> None:
    """Clear the flag and the callbacks (tests; a new run in the same
    process)."""
    global _shutdown_signum
    _shutdown_signum = None
    _on_shutdown.clear()


def _handler(signum, frame):
    global _shutdown_signum
    if _shutdown_signum is not None:
        # The second signal: die the default way.
        signal.signal(signum, signal.SIG_DFL)
        signal.raise_signal(signum)
        return
    _shutdown_signum = signum
    _fire_callbacks()


def install_signal_handlers() -> bool:
    """Install the SIGTERM and SIGINT handlers.  Only the main thread can:
    elsewhere ``signal.signal`` raises ValueError, shutdown stays
    signal-less and this returns False.  Idempotent."""
    global _installed
    if _installed:
        return True
    try:
        signal.signal(signal.SIGTERM, _handler)
        signal.signal(signal.SIGINT, _handler)
    except ValueError:
        return False
    _installed = True
    return True
