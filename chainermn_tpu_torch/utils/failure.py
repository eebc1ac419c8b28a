"""Typed failures of the port (the subset its ported paths raise).

Counterpart of ``chainermn_tpu/utils/failure.py``: the same class names,
bases, ``status_name`` codes and constructor arguments, so a caller
catches the same types on either package.  The JAX package's
constructors also drop a telemetry flight record; telemetry is not
ported yet (ROADMAP.md A9), so these only carry their fields.
"""


class CommFailure(RuntimeError):
    """Base of the failure taxonomy."""

    status_name = 'CMN_ERROR'


class OverloadError(CommFailure):
    """The serving admission layer REFUSED work instead of wedging: the
    bounded request queue is full, or a request's deadline expired
    before (or while) it could be executed.

    ``reason`` classifies the shed: ``'queue_full'`` | ``'deadline'`` |
    ``'shutdown'``.  ``queue_depth`` records the depth observed at the
    decision.
    """

    status_name = 'CMN_OVERLOAD'

    def __init__(self, message, reason='queue_full', queue_depth=None):
        super().__init__(message)
        self.reason = reason
        self.queue_depth = queue_depth
