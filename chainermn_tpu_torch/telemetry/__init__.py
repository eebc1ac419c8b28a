"""Runtime telemetry: spans, events, request traces and a metrics
registry -- the core the serving path reads.

Counterpart of ``chainermn_tpu/telemetry/__init__.py``: :func:`active`,
:func:`enabled`, :func:`enable`, :func:`disable`, :func:`span`,
:func:`event`, :func:`request_stage`, :func:`request_event`,
:func:`registry` and :func:`flush`, over the :class:`Recorder` of
:mod:`~chainermn_tpu_torch.telemetry.recorder`; and
:mod:`~chainermn_tpu_torch.telemetry.report`'s ``request_traces`` /
``request_summary``.

Activation is programmatic (``telemetry.enable()`` for an in-memory
session, ``telemetry.enable(outdir)`` to flush to a directory) or from
the environment, as in the JAX package (:func:`maybe_enable_from_env`,
which ``StandardUpdater`` calls)::

    CHAINERMN_TPU_TELEMETRY=/path/to/outdir python train.py
    # optional: device fences (spans cover the card's work, not the
    # launch; serializes host and card -- a measurement mode)
    CHAINERMN_TPU_TELEMETRY_SYNC=1

Disabled, :func:`span` and :func:`event` cost one function call and
return a preallocated no-op context.

Not ported yet (ROADMAP.md A9): the SLO monitor (``slo``), the
cross-rank ``diagnosis`` and ``goodput``, the ``python -m`` report CLI
and the crash-safe flight recorder (``dump_flight``); none of them
exists here.
"""

import os

from chainermn_tpu_torch.telemetry.recorder import (  # noqa: F401
    Counter, Gauge, Histogram, NULL_SPAN, Recorder, Registry,
    escape_help, escape_label_value, snapshot_to_prometheus)

ENV_VAR = 'CHAINERMN_TPU_TELEMETRY'
ENV_SYNC = 'CHAINERMN_TPU_TELEMETRY_SYNC'

_active = None
_env_checked = False


def active():
    """The installed :class:`Recorder`, or None."""
    return _active


def enabled():
    return _active is not None


def enable(outdir=None, sync_fences=False):
    """Install a recorder (idempotent: enabling again with an ``outdir``
    points an in-memory recorder's flush there, so nothing recorded
    before is lost).  ``sync_fences`` makes ``span.sync`` wait for the
    card."""
    global _active
    if _active is None:
        _active = Recorder(outdir=outdir, sync_fences=sync_fences)
    elif outdir is not None and _active.outdir is None:
        _active.outdir = outdir
    return _active


def disable():
    """Uninstall the recorder (does not flush)."""
    global _active, _env_checked
    _active, _env_checked = None, False


def maybe_enable_from_env(env_var=ENV_VAR):
    """Install a recorder from ``CHAINERMN_TPU_TELEMETRY`` once per
    process (a no-op when it is unset or was checked already).  The
    value is the session's output directory; the literal ``1`` enables
    an in-memory session.  ``CHAINERMN_TPU_TELEMETRY_SYNC`` set to
    anything but ``0`` turns the device fences on."""
    global _env_checked
    if _active is not None or _env_checked:
        return _active
    _env_checked = True
    value = os.environ.get(env_var)
    if not value:
        return None
    return enable(outdir=None if value == '1' else value,
                  sync_fences=os.environ.get(ENV_SYNC, '') not in ('',
                                                                   '0'))


def span(name, kind='generic', **attrs):
    """Context manager timing the enclosed block into the active
    recorder; disabled, a no-op singleton."""
    rec = _active
    if rec is None:
        return NULL_SPAN
    return rec.span(name, kind=kind, **attrs)


def event(name, kind='event', **attrs):
    """Record a point-in-time event (no-op when disabled)."""
    rec = _active
    if rec is not None:
        rec.event(name, kind=kind, **attrs)


def request_stage(request_id, name, t0, t1=None, **attrs):
    """Record one stage of a request's trace (``kind='request'``); no-op
    when disabled.  The serving path threads a request through
    ``queue_wait`` -> ``bucket_pack`` -> ``prefill`` -> per-tick
    ``decode`` (or ``execute`` on the batch path), each stage's ``t0``
    the previous stage's ``t1``."""
    rec = _active
    if rec is not None:
        rec.child_span(request_id, name, t0, t1, **attrs)


def request_event(request_id, name, **attrs):
    """Record a terminal request event (``complete`` / ``shed`` /
    ``error``); no-op when disabled."""
    rec = _active
    if rec is not None:
        rec.event(name, kind='request', request_id=request_id, **attrs)


def registry():
    """The active recorder's metrics registry, or None."""
    rec = _active
    return rec.registry if rec is not None else None


def flush(outdir=None):
    rec = _active
    return rec.flush(outdir) if rec is not None else None
