"""Thread-local runtime hooks between a solve scheduler and the solver
pipeline (port of cruise_control_tpu/sched/runtime.py).

* the *gateway* flag — set while a scheduled job runs;
* the *segment checkpoint* — a scheduler installs a preemption check
  around a preemptible job; the optimizer calls `segment_checkpoint()`
  between goal segments, and when the check fires the solve unwinds with
  `SolvePreempted` at that boundary;
* the *mesh token* of the running job;
* the *submission listener* — a per-thread callback told of every
  scheduler submission.

`DeviceTimeScheduler` (sched/scheduler.py) sets them around every job it
runs: the gateway always, the preemption check around a preemptible job
on its dispatch thread.  Outside a job the checkpoint is a no-op; the
port has no mesh, so the token is always None.  The module has no
dependency inside the package.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

_TLS = threading.local()


class SolvePreempted(Exception):
    """Control flow, not an error: a higher-priority request asked the
    running solve to yield at the next segment boundary.  Never ladder
    material."""


def under_gateway() -> bool:
    """True while the current thread runs a scheduled solve job."""
    return getattr(_TLS, "gateway_depth", 0) > 0


@contextlib.contextmanager
def gateway(preempt_check: Optional[Callable[[], bool]] = None,
            async_dispatch: bool = False):
    """Mark the current thread as inside the solve gateway; with
    `preempt_check`, `segment_checkpoint()` consults it between goal
    segments.  `async_dispatch` marks a job run on a scheduler's own
    dispatch thread."""
    depth = getattr(_TLS, "gateway_depth", 0)
    prev_check = getattr(_TLS, "preempt_check", None)
    prev_async = getattr(_TLS, "async_dispatch", False)
    _TLS.gateway_depth = depth + 1
    _TLS.preempt_check = preempt_check
    _TLS.async_dispatch = async_dispatch
    try:
        yield
    finally:
        _TLS.gateway_depth = depth
        _TLS.preempt_check = prev_check
        _TLS.async_dispatch = prev_async


def dispatch_is_async() -> bool:
    """True while the current thread runs a job of a scheduler's own
    dispatch thread."""
    return getattr(_TLS, "async_dispatch", False)


@contextlib.contextmanager
def shielded():
    """Suppress the preemption checkpoint for the duration."""
    prev = getattr(_TLS, "preempt_check", None)
    _TLS.preempt_check = None
    try:
        yield
    finally:
        _TLS.preempt_check = prev


@contextlib.contextmanager
def mesh_token_scope(token):
    """Put a scheduler's mesh token in scope for the duration of a job
    (opaque here; None means one device)."""
    prev = getattr(_TLS, "mesh_token", None)
    _TLS.mesh_token = token
    try:
        yield
    finally:
        _TLS.mesh_token = prev


def current_mesh_token():
    """The mesh token of the job on this thread (None outside one)."""
    return getattr(_TLS, "mesh_token", None)


def segment_checkpoint() -> None:
    """Called by the solver between goal segments: a no-op unless a
    scheduler installed a preemption check for the running job."""
    check = getattr(_TLS, "preempt_check", None)
    if check is not None and check():
        raise SolvePreempted(
            "higher-priority solve queued; yielding the device at a "
            "segment boundary")


def set_submission_listener(cb: Callable[[object], None]) -> None:
    """Install a per-thread callback told of every scheduler
    submission."""
    _TLS.submission_listener = cb


def clear_submission_listener() -> None:
    _TLS.submission_listener = None


def notify_submission(ticket: object) -> None:
    """Report a submission to the current thread's listener (no-op
    without one)."""
    cb = getattr(_TLS, "submission_listener", None)
    if cb is not None:
        cb(ticket)
