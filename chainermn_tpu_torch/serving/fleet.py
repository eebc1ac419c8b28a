"""serving.fleet -- train-to-serve continuous deployment: N generation
replicas behind one admission front, rolling new weights from the
training checkpoint chain without dropping requests, and healing
themselves when a replica dies.

Counterpart of ``chainermn_tpu/serving/fleet.py``, with its classes,
ledger events and verdict dicts:

1. **watch** (:class:`CheckpointWatcher`): poll
   :func:`~chainermn_tpu_torch.training.recovery.chain_heads` (the
   manifest/sentinel completeness probe drops a sentinel-less newest), an
   mtime debounce, a full crc verification that rejects a corrupt newest
   with the typed ``CheckpointSkippedWarning`` and falls back to the next
   older valid snapshot; one snapshot never fires two rolls.
2. **roll** (:class:`FleetController`): per replica drain -> swap ->
   rejoin.  The front stops routing to the draining replica (its peers
   absorb the traffic), :meth:`~chainermn_tpu_torch.serving.
   GenerationEngine.swap_params` validates the new tree eagerly and copies
   it into the captured storage of the engine's CUDA graphs (``captures``
   flat: a roll never captures again).
3. **canary** (:class:`FleetFront` + :class:`CanaryJudge`): a crc32
   hash slice of request ids (:func:`canary_slice`) routes to the replica
   serving the new version; fresh per-(replica, version)
   :class:`~chainermn_tpu_torch.telemetry.slo.SLOMonitor` s judge it live
   against the incumbents' matched window.
4. **promote or roll back**, and 5. **record** in the append-only,
   fsynced ``fleet_ledger.jsonl`` (:class:`~chainermn_tpu_torch.utils.
   ledger.Ledger`).

Self-healing: a crash-safe :class:`RequestJournal` records every
admission and streamed token, so a dead replica's in-flight generations
are requeued on a survivor as exact continuations (a teacher-forced
prefill of ``prompt + emitted``, then greedy decode), one seamless
:class:`FrontHandle` stream; a :class:`ReplicaSupervisor` detects deaths,
respawns replacements from the incumbent snapshot under the training
``RestartPolicy`` and drives the :class:`DegradationPolicy` ladder.

Chaos: ``swap_kill`` (:func:`~chainermn_tpu_torch.utils.chaos.on_swap`)
kills the controller at a swap point; a restarted fleet boots every
replica from the newest valid snapshot and records ``converged``.
``serve_slow`` (in the engines, on a hot-swapped version only) is the
latency regression that drives a canary breach.

The demo model is a :class:`~chainermn_tpu_torch.models.TransformerLM` of
:data:`DEMO_MODEL`'s geometry with its own seeded init; every helper that
builds one (:func:`demo_model`, :func:`demo_params`, :func:`demo_train`,
:func:`build_local_fleet`, :func:`local_respawn_fn`) takes the geometry
as ``config`` (default :data:`DEMO_MODEL`), so the same code runs the
full-width :data:`SERVE_MODEL` on the card.  Entry points run on the card
unless ``device`` (``--device``) asks for the CPU.

``python -m chainermn_tpu_torch.serving.fleet`` is the CLI: it trains the
demo LM for a few real steps, snapshots, serves open-loop traffic from N
replica subprocesses (``--replica`` workers speaking newline JSON over a
local socket) and rolls each new snapshot through the fleet; ``--local``
runs the replicas in process, ``--model serve`` at full width (bf16),
``--recover`` arms the journal and the replica supervisor.
"""

import argparse
import contextlib
import itertools
import json
import os
import socket
import subprocess
import sys
import threading
import time
import warnings
import zlib

import numpy as np
import torch

from chainermn_tpu_torch import telemetry as _telemetry
from chainermn_tpu_torch.serving.batcher import (RequestQueue,
                                                 admission_order,
                                                 next_request_id,
                                                 record_shed)
from chainermn_tpu_torch.serving.generate import GenerationQueue
from chainermn_tpu_torch.utils import chaos as _chaos
from chainermn_tpu_torch.utils import failure
from chainermn_tpu_torch.utils.failure import (OverloadError,
                                               ReplicaDeadError,
                                               WeightSwapError)
from chainermn_tpu_torch.utils.ledger import Ledger

LEDGER_NAME = 'fleet_ledger.jsonl'
JOURNAL_NAME = 'request_journal.jsonl'

#: hash-slice resolution: canary fractions are exact to 1/10000
CANARY_MOD = 10000


def canary_slice(request_id, fraction):
    """Deterministic canary admission: True when ``request_id`` falls
    in the first ``fraction`` of the crc32 hash ring.  A request id is
    routed the same way on every evaluation (retries included), two
    fleets given the same ids pick the same slice, and no clock or
    rng is involved -- the property the canary A/B needs to be a
    controlled experiment rather than a coin flip."""
    if fraction <= 0:
        return False
    if fraction >= 1:
        return True
    return (zlib.crc32(str(request_id).encode()) % CANARY_MOD
            < int(fraction * CANARY_MOD))


# ----------------------------------------------------------------------
# the crash-safe request journal (the recovery source)
# ----------------------------------------------------------------------

class RequestJournal:
    """Crash-safe admission journal at the front -- the RECOVERY
    source for exact-replay requeue (the flight-recorder request
    table stays the *forensic* twin).

    One fsynced JSON line per state change, on
    :class:`~chainermn_tpu_torch.utils.ledger.Ledger` underneath, so the
    append-survives-``os._exit`` and torn-tail-tolerant-read
    guarantees are inherited rather than re-implemented:

    - ``admit``: ``request_id``, prompt tokens, ``max_new``, absolute
      deadline (front clock), assigned ``replica``, params
      ``version``;
    - ``token``: the tokens a replica streamed back this scheduler
      tick -- after a death the journal knows each request's
      committed ``prompt + emitted`` prefix, which IS the
      continuation prompt that exact-replay recovery teacher-forces
      into a survivor;
    - ``reassign``: the requeue target after a replica death;
    - ``done``: terminal outcome (``served`` / ``shed`` / ``error``)
      with attribution fields.

    The in-memory mirror answers :meth:`inflight` without re-reading
    the file; :meth:`replay` rebuilds the same mirror from disk --
    what a restarted front would know.
    """

    def __init__(self, path):
        self.path = path
        self._ledger = Ledger(path)
        self._lock = threading.Lock()
        self._live = {}   # request_id -> entry
        self.admitted = 0
        self.completed = 0

    def admit(self, request_id, prompt, max_new_tokens, deadline,
              replica, version):
        toks = [int(t) for t in np.asarray(prompt).reshape(-1)]
        with self._lock:
            self._live[request_id] = {
                'prompt': toks, 'max_new': int(max_new_tokens),
                'deadline': deadline, 'replica': replica,
                'version': version, 'emitted': []}
            self.admitted += 1
        self._ledger.append('admit', request_id=request_id,
                            prompt=toks, max_new=int(max_new_tokens),
                            deadline=deadline, replica=replica,
                            version=version)

    def tokens(self, request_id, tokens):
        """The per-tick ``token`` frame sink (the shape of the
        engines' ``on_token`` callback and of the subprocess stream
        frames, so it plugs into either directly)."""
        toks = [int(t) for t in tokens]
        with self._lock:
            e = self._live.get(request_id)
            if e is None:
                return
            e['emitted'].extend(toks)
        self._ledger.append('token', request_id=request_id,
                            tokens=toks)

    def reassign(self, request_id, replica):
        with self._lock:
            e = self._live.get(request_id)
            if e is not None:
                e['replica'] = replica
        self._ledger.append('reassign', request_id=request_id,
                            replica=replica)

    def done(self, request_id, outcome='served', **fields):
        """Close a request; False when it was already closed -- the
        idempotency guard that makes a requeue racing a late
        completion frame harmless (greedy twins carry identical
        tokens, and only the first closer resolves the handle)."""
        with self._lock:
            if request_id not in self._live:
                return False
            del self._live[request_id]
            self.completed += 1
        self._ledger.append('done', request_id=request_id,
                            outcome=outcome, **fields)
        return True

    def inflight(self, replica=None):
        """Snapshot of the open requests (optionally one replica's)
        -- the requeue worklist at a death."""
        with self._lock:
            return {rid: dict(e, emitted=list(e['emitted']))
                    for rid, e in self._live.items()
                    if replica is None or e['replica'] == replica}

    @staticmethod
    def replay(path):
        """Rebuild the in-flight mirror from disk (torn tails from a
        killed writer skipped, inherited from ``Ledger.read``): what
        a RESTARTED front knows about committed prefixes."""
        live = {}
        for e in Ledger.read(path):
            rid, ev = e.get('request_id'), e.get('event')
            if ev == 'admit':
                live[rid] = {'prompt': list(e.get('prompt') or []),
                             'max_new': e.get('max_new'),
                             'deadline': e.get('deadline'),
                             'replica': e.get('replica'),
                             'version': e.get('version'),
                             'emitted': []}
            elif ev == 'token' and rid in live:
                live[rid]['emitted'].extend(e.get('tokens') or [])
            elif ev == 'reassign' and rid in live:
                live[rid]['replica'] = e.get('replica')
            elif ev == 'done':
                live.pop(rid, None)
        return live


class FrontHandle:
    """The completion handle a journaled front hands out: the same
    ``done()`` / ``result()`` surface as ``GenRequest`` / ``_Cell``,
    but OWNED by the front, so a replica death re-binds it to the
    requeued continuation invisibly -- the caller sees one seamless
    stream (journaled prefix + continuation tokens), never a
    duplicated or dropped token."""

    __slots__ = ('request_id', '_evt', '_tokens', '_error')

    def __init__(self, request_id):
        self.request_id = request_id
        self._evt = threading.Event()
        self._tokens = None
        self._error = None

    def _complete(self, tokens):
        if self._evt.is_set():
            return
        self._tokens = np.asarray([int(t) for t in tokens], np.int32)
        self._evt.set()

    def _fail(self, exc):
        if self._evt.is_set():
            return
        self._error = exc
        self._evt.set()

    def done(self):
        return self._evt.is_set()

    def result(self, timeout=None):
        if not self._evt.wait(timeout):
            raise TimeoutError('request %s not completed within %rs'
                               % (self.request_id, timeout))
        if self._error is not None:
            raise self._error
        return self._tokens


# ----------------------------------------------------------------------
# the load-degradation ladder
# ----------------------------------------------------------------------

#: the ladder's rungs, mildest first.  0 is healthy; 1-3 trade reuse/
#: speculation/admission concurrency for headroom on the ENGINES; 4
#: sheds a deterministic hash-slice of new admissions at the FRONT.
DEGRADATION_RUNGS = ('none', 'evict_prefix', 'no_spec',
                     'shrink_admission', 'shed')


def apply_degradation_rung(engine, rung, saved):
    """Walk one engine's load knobs to degradation rung ``rung``
    (idempotent -- every knob is set to its value AT that rung, so
    skipped intermediate calls cannot leave a stale knob behind).
    ``saved`` is a per-engine dict remembering the healthy values for
    the walk back.  Rungs: 1 evicts the radix prefix index (banked
    pages return to the pool; live sequences keep theirs), 2 disables
    speculative decoding (the target cache stays authoritative, so
    greedy output is unchanged), 3 halves ``spec_tokens`` and caps
    admission at one request per tick.  Rung 4 (shed) is applied at
    the FRONT, not here."""
    if 'speculative' not in saved:
        saved['speculative'] = bool(engine.speculative)
        saved['spec_tokens'] = int(engine.spec_tokens)
        saved['admit_cap'] = engine.admit_cap
    rung = max(0, min(int(rung), len(DEGRADATION_RUNGS) - 1))
    idx = getattr(engine, '_prefix_index', None)
    if rung >= 1 and idx is not None:
        while idx.evict(1):
            pass
    engine.speculative = saved['speculative'] and rung < 2
    if saved['spec_tokens']:
        engine.spec_tokens = (saved['spec_tokens'] if rung < 3
                              else max(2, saved['spec_tokens'] // 2))
    engine.admit_cap = saved['admit_cap'] if rung < 3 else 1
    return rung


class DegradationPolicy:
    """Typed, hysteresis-reversible load-degradation ladder over
    :data:`DEGRADATION_RUNGS`, driven by the live
    :class:`~chainermn_tpu_torch.telemetry.slo.SLOMonitor` burn-rate
    verdict and KV-page pressure.

    Escalation: any observation with an SLO ``breach`` verdict or
    with free KV pages under ``kv_free_floor`` climbs ONE rung.
    Recovery walks back one rung only after ``recover_healthy``
    CONSECUTIVE observations whose verdict is ``ok`` -- the
    multi-window burn-rate verdict is ``ok`` only when both the fast
    and slow windows are healthy, which is the hysteresis that stops
    the ladder from oscillating on the edge of a breach.

    Every transition is a ``degrade`` ledger event and moves the
    ``fleet_degradation_rung`` gauge; per-rung wall-clock occupancy
    is accumulated (:meth:`occupancy`).
    """

    def __init__(self, ledger=None, kv_free_floor=0.125,
                 recover_healthy=2, shed_fraction=0.5,
                 clock=time.monotonic):
        self.ledger = ledger
        self.kv_free_floor = float(kv_free_floor)
        self.recover_healthy = int(recover_healthy)
        self.shed_fraction = float(shed_fraction)
        self._clock = clock
        self.rung = 0
        self.transitions = 0
        self._healthy_streak = 0
        self._t_entered = clock()
        self.occupancy_s = {name: 0.0 for name in DEGRADATION_RUNGS}

    @property
    def rung_name(self):
        return DEGRADATION_RUNGS[self.rung]

    def sheds(self, request_id):
        """At the ``shed`` rung: True for the deterministic
        ``shed_fraction`` hash-slice of request ids (same ring
        discipline as :func:`canary_slice` -- retries of an id are
        shed consistently, and no rng is involved)."""
        if self.rung < len(DEGRADATION_RUNGS) - 1:
            return False
        return (zlib.crc32(('shed:%s' % request_id).encode())
                % CANARY_MOD < int(self.shed_fraction * CANARY_MOD))

    def observe(self, overall, breaches=(), kv_in_use=None,
                kv_total=None):
        """One observation of the live signals.  ``overall`` is the
        worst SLO verdict across serving replicas (``'ok'`` /
        ``'warn'`` / ``'breach'`` / None when monitors are quiet).
        Returns the new rung after a transition, None when the
        ladder did not move."""
        reasons = []
        if overall == 'breach':
            reasons.append('slo_breach:%s'
                           % ','.join(sorted(set(breaches))))
        if kv_total:
            free = (kv_total - (kv_in_use or 0)) / float(kv_total)
            if free < self.kv_free_floor:
                reasons.append('kv_pressure:%.0f%%_free'
                               % (100 * free))
        if reasons:
            self._healthy_streak = 0
            if self.rung < len(DEGRADATION_RUNGS) - 1:
                return self._move(self.rung + 1, 'escalate', reasons)
            return None
        if overall == 'ok':
            self._healthy_streak += 1
            if (self.rung > 0
                    and self._healthy_streak >= self.recover_healthy):
                self._healthy_streak = 0
                return self._move(
                    self.rung - 1, 'recover',
                    ['healthy_windows:%d' % self.recover_healthy])
        return None

    def _move(self, new, direction, reasons):
        now = self._clock()
        old = self.rung
        self.occupancy_s[DEGRADATION_RUNGS[old]] += \
            now - self._t_entered
        self._t_entered = now
        self.rung = new
        self.transitions += 1
        if self.ledger is not None:
            self.ledger.append(
                'degrade', direction=direction, from_rung=old,
                to_rung=new, from_name=DEGRADATION_RUNGS[old],
                to_name=DEGRADATION_RUNGS[new], reasons=reasons)
        reg = _telemetry.registry()
        if reg is not None:
            reg.gauge('fleet_degradation_rung',
                      help='current load-degradation ladder rung '
                           '(0 none .. 4 shed)').set(new)
        return new

    def occupancy(self):
        """Per-rung wall seconds including the currently-open rung --
        what a run reports."""
        now = self._clock()
        out = dict(self.occupancy_s)
        out[DEGRADATION_RUNGS[self.rung]] += now - self._t_entered
        return {k: round(v, 4) for k, v in out.items()}

    def describe(self):
        return {'rung': self.rung, 'rung_name': self.rung_name,
                'transitions': self.transitions,
                'kv_free_floor': self.kv_free_floor,
                'recover_healthy': self.recover_healthy,
                'shed_fraction': self.shed_fraction,
                'occupancy_s': self.occupancy()}


# ----------------------------------------------------------------------
# checkpoint-chain watching
# ----------------------------------------------------------------------

class CheckpointWatcher:
    """Poll the training checkpoint chain for a NEW snapshot that is
    safe to roll.

    Safety ladder, applied newest-first over
    :func:`~chainermn_tpu_torch.training.recovery.chain_heads`:

    - **completeness** (inherited from ``chain_heads``): sentinel-less
      or zero-byte candidates -- a legacy/foreign file, or a writer
      without the atomic tmp+rename discipline -- are dropped before
      the watcher sees them, falling through to the next-older valid
      snapshot;
    - **mtime debounce**: a candidate fires only after its mtime has
      been STABLE for ``debounce_s`` seconds (an mtime change
      restarts the clock).  While the newest candidate is settling
      the watcher returns None rather than rolling an older one --
      rolling stale weights just to roll sooner is the wrong trade;
    - **crc verification** (``verify=True``): the full per-leaf
      probe.  A corrupt newest is rejected ONCE with the typed
      :class:`~chainermn_tpu_torch.utils.failure.CheckpointSkippedWarning`
      (+ a ``checkpoint_skipped`` telemetry event) and the chain
      falls back to the next-older valid candidate;
    - **once**: a returned snapshot advances ``last_iteration``, so
      one snapshot can never double-fire a roll -- and anything at or
      below the returned iteration is permanently out.

    ``start_after`` seeds ``last_iteration`` with the fleet's boot
    snapshot so the boot version is never re-rolled.
    """

    def __init__(self, ckpt_dir, debounce_s=0.3, verify=True,
                 start_after=None, clock=time.monotonic):
        self.ckpt_dir = ckpt_dir
        self.debounce_s = float(debounce_s)
        self.verify = verify
        self.last_iteration = (-1 if start_after is None
                               else int(start_after))
        self._clock = clock
        self._pending = {}    # path -> (mtime, first_seen_t)
        self._rejected = set()

    def poll(self):
        """``(kind, path, iteration)`` of the next snapshot to roll,
        or None (nothing new, still settling, or nothing valid)."""
        from chainermn_tpu_torch import serializers
        from chainermn_tpu_torch.training import recovery
        now = self._clock()
        for kind, path, it, mtime in recovery.chain_heads(
                self.ckpt_dir):
            if it <= self.last_iteration:
                return None   # newest-first: nothing newer exists
            if path in self._rejected:
                continue
            pend = self._pending.get(path)
            if pend is None or pend[0] != mtime:
                # first sight, or the file moved under us: (re)start
                # the debounce clock and WAIT -- never fall back to
                # an older snapshot while a newer one is settling
                self._pending[path] = (mtime, now)
                return None
            if now - pend[1] < self.debounce_s:
                return None
            if self.verify:
                try:
                    serializers.verify_checkpoint(path)
                except failure.CheckpointCorruptError as e:
                    self._rejected.add(path)
                    _telemetry.event('checkpoint_skipped',
                                     kind='checkpoint', path=path,
                                     reason=e.kind)
                    warnings.warn(
                        'fleet watcher: skipping corrupt snapshot %s '
                        '(%s: %s)' % (path, e.kind, e),
                        failure.CheckpointSkippedWarning,
                        stacklevel=2)
                    continue   # fall back to the next-older valid
            self.last_iteration = it
            self._pending.pop(path, None)
            return kind, path, it
        return None


# ----------------------------------------------------------------------
# replicas
# ----------------------------------------------------------------------

def _fresh_monitor(label, version, slos=None):
    """A per-(replica, version) SLO monitor attached to the active
    recorder -- the canary gate's measurement unit.  Filtering on the
    ``replica``/``version`` attrs the engines stamp means a monitor
    created at swap time sees ONLY post-swap traffic of its own
    replica, even on a recorder shared by the whole fleet.  Returns
    None when telemetry is off."""
    from chainermn_tpu_torch.telemetry.slo import SLOMonitor
    rec = _telemetry.active()
    if rec is None:
        return None
    mon = SLOMonitor(
        slos=slos,
        record_filter=lambda r: (r.get('replica') == label
                                 and r.get('version') == version))
    mon.attach(rec)
    return mon


class LocalReplica:
    """One in-process replica: an engine, its own bounded admission
    queue, and a scheduler/worker thread.  The drain/swap surface the
    controller drives is this class's contract (the subprocess twin
    :class:`SubprocessReplica` speaks the same one over a socket):

    - ``state``: ``'serving'`` (front routes to it) or not (the
      controller parked it for a drain/swap);
    - :meth:`drain`: wait until the queue is empty and every admitted
      request has resolved (for a generation engine that includes
      every live cache slot) -- the front stopped routing first, so
      nothing new arrives;
    - :meth:`swap`: the engine's double-buffered
      ``swap_from_checkpoint`` (typed failure leaves the incumbent
      serving);
    - :meth:`reset_slo` / :meth:`slo_eval`: the per-version canary
      monitor.
    """

    def __init__(self, name, engine, max_queue=256, slos=None,
                 clock=time.monotonic):
        self.name = name
        self.engine = engine
        engine.label = name
        self.generation = hasattr(engine, 'decode_edges')
        if self.generation:
            self.queue = GenerationQueue(
                engine.max_prompt_len, max_queue=max_queue,
                label=name,
                # paged engines group admissions by radix prefix
                page_size=(engine.page_size
                           if getattr(engine, 'paged', False)
                           else None))
        else:
            self.queue = RequestQueue(max_batch=engine.max_batch,
                                      max_queue=max_queue, label=name)
        self.state = 'serving'
        self.slos = slos
        self._clock = clock
        self._stop = threading.Event()
        self._abort = threading.Event()
        self._thread = None
        self._outstanding = []
        self._monitor = None
        self._degrade_saved = {}

    @property
    def version(self):
        return self.engine.param_version

    def start(self):
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name='fleet-%s' % self.name)
        self._thread.start()
        return self

    def _run(self):
        # ``engine.run`` with an abort hatch: :meth:`kill` must stop
        # the scheduler MID-GENERATION (an unplanned death leaves
        # slots live), which run()'s drain-first exit cannot express
        device = getattr(self.engine, 'device', None)
        if device is not None and device.type == 'cuda':
            torch.cuda.set_device(device)
        while not self._abort.is_set():
            worked = self.engine.step(self.queue)
            if not worked:
                if (self._stop.is_set() and self.queue.depth() == 0
                        and not self.engine._slots
                        and not getattr(self.engine, '_prefilling',
                                        ())):
                    return
                time.sleep(0.002)

    def kill(self):
        """Hard-kill the replica in process -- the
        :class:`LocalReplica` twin of a ``replica_kill``'d
        subprocess.  The scheduler stops between ticks (tokens the
        final tick committed were already streamed to ``on_token``,
        so a journaling front's prefix stays exact), then every
        outstanding request resolves with the typed
        :class:`~chainermn_tpu_torch.utils.failure.ReplicaDeadError` --
        exactly what the subprocess front sees at read-loop EOF."""
        self.state = 'dead'
        self._abort.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
        open_reqs = [r for r in self._outstanding if not r.done()]
        rids = [r.request_id for r in open_reqs]
        for req in open_reqs:
            req.set_error(ReplicaDeadError(
                'replica %s killed with %s in flight'
                % (self.name, req.request_id),
                replica=self.name, request_ids=rids))
        self._outstanding = []
        return rids

    def degrade(self, rung):
        """Apply one degradation-ladder rung to the engine (rung 4's
        shed lives at the front)."""
        return apply_degradation_rung(self.engine, rung,
                                      self._degrade_saved)

    def submit(self, *args, deadline=None, request_id=None, **kw):
        if self.state == 'dead':
            raise ReplicaDeadError('replica %s is dead' % self.name,
                                   replica=self.name)
        req = self.queue.submit(*args, deadline=deadline,
                                request_id=request_id, **kw)
        self._outstanding.append(req)
        if len(self._outstanding) > 512:
            self._prune()
        return req

    def _prune(self):
        self._outstanding = [r for r in self._outstanding
                             if not r.done()]

    def inflight(self):
        self._prune()
        return len(self._outstanding)

    def drain(self, timeout):
        """True when the replica went idle inside ``timeout``: queue
        empty, every admitted request resolved, no live cache slots.
        The engine thread keeps running (it idles) -- drain parks the
        WORK, not the machinery."""
        deadline = self._clock() + timeout
        while self._clock() < deadline:
            if (self.queue.depth() == 0 and self.inflight() == 0
                    and not getattr(self.engine, '_slots', None)):
                return True
            time.sleep(0.005)
        return False

    def swap(self, path, version):
        """Hot-swap from ``path``; returns wall seconds.  Typed
        failures (``WeightSwapError`` / ``CheckpointCorruptError``)
        propagate with the incumbent still serving."""
        t0 = time.perf_counter()
        self.engine.swap_from_checkpoint(path, version=version)
        return round(time.perf_counter() - t0, 4)

    def reset_slo(self):
        """Fresh monitor over THIS replica at its CURRENT version
        (call after a swap for the candidate, at roll start for the
        incumbents, so both windows start empty together)."""
        if self._monitor is not None:
            self._monitor.detach()
        self._monitor = _fresh_monitor(self.name, self.version,
                                       slos=self.slos)
        return self._monitor

    def slo_eval(self):
        return (self._monitor.evaluate()
                if self._monitor is not None else None)

    def shed_total(self):
        st = self.queue.stats()
        return st['shed_queue_full'] + st['shed_deadline']

    def stats(self):
        return {'name': self.name, 'state': self.state,
                'version': self.version, 'queue': self.queue.stats(),
                'inflight': self.inflight()}

    def close(self):
        self._stop.set()
        self.queue.close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if self._monitor is not None:
            self._monitor.detach()
            self._monitor = None

# ----------------------------------------------------------------------
# subprocess replicas: newline-JSON over a local socket
# ----------------------------------------------------------------------

class _Cell:
    """Completion cell for one subprocess-served request (the
    socket-side twin of ``GenRequest``'s result surface).
    ``on_token`` (set at submit when the front journals) receives the
    incremental ``token`` frames the worker streams per scheduler
    tick; the final reply still carries the full token list."""

    __slots__ = ('request_id', '_evt', '_msg', 'on_token')

    def __init__(self, request_id, on_token=None):
        self.request_id = request_id
        self.on_token = on_token
        self._evt = threading.Event()
        self._msg = None

    def _resolve(self, msg):
        self._msg = msg
        self._evt.set()

    def done(self):
        return self._evt.is_set()

    def result(self, timeout=None):
        if not self._evt.wait(timeout):
            raise TimeoutError('request %s not completed within %rs'
                               % (self.request_id, timeout))
        m = self._msg
        if m.get('ok'):
            return np.asarray(m.get('tokens', []), np.int32)
        if m.get('error') == 'OverloadError':
            raise OverloadError(m.get('message', 'request shed'),
                                reason=m.get('reason', 'queue_full'))
        if m.get('error') == 'ReplicaDead':
            raise ReplicaDeadError(
                m.get('message', 'replica dead'),
                replica=m.get('replica'),
                request_ids=m.get('request_ids') or ())
        raise RuntimeError(m.get('message')
                           or 'replica error: %r' % (m,))


def _free_port():
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


class SubprocessReplica:
    """One replica running as a REAL subprocess (``python -m
    chainermn_tpu_torch.serving.fleet --replica``): its own interpreter,
    its own engine, its own telemetry recorder and per-version SLO
    monitor -- the deployment shape the chaos scenarios test.  Speaks
    the :class:`LocalReplica` contract over newline-JSON on a local
    socket; the ``CHAINERMN_TPU_CHAOS`` handout (``replica_chaos``)
    is how a scenario ships a ``serve_slow`` regression inside the
    "new build" only.
    """

    def __init__(self, name, proc, sock, version, logf=None):
        self.name = name
        self.proc = proc
        self.state = 'serving'
        self.generation = True
        self._sock = sock
        self._rfile = sock.makefile('r')
        self._wlock = threading.Lock()
        self._pending = {}
        self._ids = itertools.count(1)
        self._version = int(version)
        self._logf = logf
        self._dead = False
        self.boot_s = None
        self._reader = threading.Thread(target=self._read_loop,
                                        daemon=True,
                                        name='fleet-rx-%s' % name)
        self._reader.start()

    # -- spawn ---------------------------------------------------------
    @classmethod
    def spawn(cls, name, snapshot, version, out, n_slots=2,
              max_prompt_len=4, max_queue=64, replica_chaos=None,
              env=None, python=None, boot_timeout=240.0,
              engine_args=None, replica_index=None, worker_out=None,
              model='demo', device=None):
        """Start ``python -m chainermn_tpu_torch.serving.fleet --replica``
        serving ``--model`` on ``device`` (None: the card) and wait up to
        ``boot_timeout`` for it to answer a ping (its imports, weights
        and graph captures included)."""
        port = _free_port()
        logdir = os.path.join(out, 'logs')
        os.makedirs(logdir, exist_ok=True)
        logf = open(os.path.join(logdir, '%s.log' % name), 'ab')
        env_base = {k: v for k, v in
                    (os.environ if env is None else env).items()
                    if k not in (_chaos.ENV_VAR, _chaos.REPLICA_ENV_VAR,
                                 _telemetry.ENV_VAR)}
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env_base['PYTHONPATH'] = (
            root + os.pathsep + env_base.get('PYTHONPATH', ''))
        if replica_chaos:
            env_base[_chaos.ENV_VAR] = replica_chaos
        if replica_index is not None:
            # the replica_kill site's membership gate: the handout
            # names WHICH fleet position this worker occupies
            env_base[_chaos.REPLICA_ENV_VAR] = str(int(replica_index))
        argv = [python or sys.executable, '-m',
                'chainermn_tpu_torch.serving.fleet', '--replica',
                '--name', name, '--port', str(port),
                '--snapshot', snapshot, '--version', str(version),
                '--parent-pid', str(os.getpid()),
                '--n-slots', str(n_slots),
                '--max-prompt-len', str(max_prompt_len),
                '--max-queue', str(max_queue), '--model', model]
        if device is not None:
            argv += ['--device', str(device)]
        if worker_out:
            # disk-backed telemetry: an in-memory recorder's flight
            # dump is a no-op, and the supervisor's post-mortem
            # quick_verdict needs the dead worker's capture on disk
            argv += ['--worker-out', worker_out]
        for extra in (engine_args or ()):
            argv.append(str(extra))
        t_spawn = time.monotonic()
        proc = subprocess.Popen(argv, env=env_base, stdout=logf,
                                stderr=subprocess.STDOUT)
        deadline = t_spawn + boot_timeout
        sock = None
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                logf.close()
                raise RuntimeError(
                    'replica %s died during boot (rc %s); see %s'
                    % (name, proc.returncode,
                       os.path.join(logdir, '%s.log' % name)))
            try:
                sock = socket.create_connection(('127.0.0.1', port),
                                                timeout=2.0)
                # the connect timeout must not become a READ timeout:
                # the reader blocks on this socket for the process's
                # whole life, and an idle gap is not a dead replica
                sock.settimeout(None)
                break
            except OSError:
                time.sleep(0.2)
        if sock is None:
            proc.kill()
            raise TimeoutError('replica %s did not open its port '
                               'within %.0fs' % (name, boot_timeout))
        rep = cls(name, proc, sock, version, logf=logf)
        rep._call('ping', timeout=boot_timeout)  # engine warmed
        #: seconds from the launch to the warmed engine's first answer
        rep.boot_s = round(time.monotonic() - t_spawn, 3)
        return rep

    # -- transport -----------------------------------------------------
    def _read_loop(self):
        try:
            for line in self._rfile:
                try:
                    msg = json.loads(line)
                except ValueError:
                    continue
                if 'token' in msg:
                    # incremental stream frame: the request is still
                    # in flight, so the cell stays pending
                    cell = self._pending.get(msg.get('id'))
                    if cell is not None and cell.on_token is not None:
                        try:
                            cell.on_token(cell.request_id,
                                          msg['token'])
                        except Exception:
                            pass
                    continue
                cell = self._pending.pop(msg.get('id'), None)
                if cell is not None:
                    cell._resolve(msg)
        except Exception:
            pass
        # read-loop EOF IS the positive death signal: resolve every
        # pending request typed, naming the whole in-flight set (the
        # front's requeue worklist travels with the error)
        self._dead = True
        rids = [c.request_id for c in self._pending.values()]
        for cell in list(self._pending.values()):
            cell._resolve({'ok': False, 'error': 'ReplicaDead',
                           'replica': self.name, 'request_ids': rids,
                           'message': 'replica %s connection closed'
                                      % self.name})
        self._pending.clear()

    def _send(self, msg):
        data = (json.dumps(msg) + '\n').encode()
        with self._wlock:
            self._sock.sendall(data)

    def _rpc(self, cmd, on_token=None, rid=None, **fields):
        if self._dead:
            raise ReplicaDeadError('replica %s is dead' % self.name,
                                   replica=self.name)
        mid = next(self._ids)
        cell = _Cell(rid or '%s#%d' % (cmd, mid), on_token=on_token)
        self._pending[mid] = cell
        self._send(dict(fields, id=mid, cmd=cmd))
        return cell

    def _call(self, cmd, timeout=60.0, **fields):
        cell = self._rpc(cmd, **fields)
        if not cell._evt.wait(timeout):
            raise TimeoutError('replica %s: %s timed out after %.0fs'
                               % (self.name, cmd, timeout))
        msg = cell._msg
        if not msg.get('ok'):
            if msg.get('error') == 'ReplicaDead':
                raise ReplicaDeadError(
                    msg.get('message', 'replica dead'),
                    replica=msg.get('replica', self.name),
                    request_ids=msg.get('request_ids') or ())
            raise RuntimeError('replica %s: %s failed: %s'
                               % (self.name, cmd,
                                  msg.get('message') or msg))
        return msg

    # -- the replica contract ------------------------------------------
    @property
    def version(self):
        return self._version

    def submit(self, prompt, max_new_tokens, deadline=None,
               request_id=None, on_token=None):
        # absolute controller-clock deadline -> relative seconds (the
        # worker re-anchors on its own monotonic clock)
        deadline_s = (None if deadline is None
                      else max(0.0, deadline - time.monotonic()))
        try:
            cell = self._rpc(
                'serve', on_token=on_token, rid=request_id,
                prompt=[int(t) for t in np.asarray(prompt).reshape(-1)],
                max_new_tokens=int(max_new_tokens),
                deadline_s=deadline_s, request_id=request_id,
                stream=on_token is not None)
        except ReplicaDeadError:
            raise   # typed: the front decides requeue-or-shed
        except OSError as e:
            self._dead = True
            raise ReplicaDeadError(
                'replica %s write failed: %s' % (self.name, e),
                replica=self.name)
        except Exception as e:
            raise OverloadError('replica %s unavailable: %s'
                                % (self.name, e),
                                reason='no_replica')
        return cell

    def inflight(self):
        return len(self._pending)

    def drain(self, timeout):
        try:
            msg = self._call('drain', timeout=timeout + 10.0,
                             timeout_s=timeout)
            return bool(msg.get('drained'))
        except Exception:
            return False

    def swap(self, path, version):
        msg = self._call('swap', timeout=300.0, path=path,
                         version=int(version))
        if not msg.get('swapped'):
            raise WeightSwapError(msg.get('message')
                                  or 'replica %s refused the swap'
                                  % self.name, version=version)
        self._version = int(version)
        return msg.get('swap_s')

    def reset_slo(self):
        self._call('reset_slo', timeout=30.0)

    def degrade(self, rung):
        """Ship one degradation-ladder rung to the worker engine."""
        try:
            return self._call('degrade', timeout=30.0,
                              rung=int(rung)).get('rung')
        except Exception:
            return None

    def slo_eval(self):
        try:
            return self._call('stats', timeout=30.0).get('slo')
        except Exception:
            return None

    def shed_total(self):
        try:
            q = self._call('stats', timeout=30.0).get('queue') or {}
            return (q.get('shed_queue_full', 0)
                    + q.get('shed_deadline', 0))
        except Exception:
            return 0

    def stats(self):
        try:
            st = self._call('stats', timeout=30.0)
        except Exception:
            st = {'ok': False}
        return dict(st, name=self.name, state=self.state,
                    version=self._version, boot_s=self.boot_s)

    def close(self):
        try:
            self._call('shutdown', timeout=10.0)
        except Exception:
            pass
        try:
            self.proc.terminate()
            self.proc.wait(timeout=10.0)
        except Exception:
            try:
                self.proc.kill()
                self.proc.wait(timeout=5.0)
            except Exception:
                pass
        try:
            self._sock.close()
        except OSError:
            pass
        if self._logf is not None:
            self._logf.close()

# ----------------------------------------------------------------------
# the admission front
# ----------------------------------------------------------------------

class FleetFront:
    """One admission edge over N replicas, with canary routing.

    Routing ladder per request: (1) a fresh
    :func:`~chainermn_tpu_torch.serving.next_request_id` is drawn FIRST so
    the hash-slice decision and the trace id are the same object;
    (2) while a canary is live (``canary_version`` set), ids inside
    the :func:`canary_slice` go to the replicas serving the candidate
    version, everything else to the incumbents; (3) round-robin
    within the chosen group's SERVING replicas; (4) a group emptied
    by a drain falls back to ANY serving replica -- version affinity
    yields to availability, which is precisely why a drain -> swap ->
    rejoin never sheds a request: traffic routes around the parked
    replica instead of queueing on it.  Only a fleet with NOTHING
    serving sheds (typed ``reason='no_replica'``); with N >= 2
    replicas and the one-at-a-time roll ladder, that cannot happen
    mid-roll.
    """

    def __init__(self, replicas, current_version, canary_fraction=0.25,
                 journal=None, clock=time.monotonic):
        self.replicas = list(replicas)
        self.current_version = int(current_version)
        self.canary_version = None
        self.canary_fraction = float(canary_fraction)
        #: :class:`RequestJournal` (None: journaling off, the
        #: zero-overhead default -- submit returns the replica's own
        #: handle and nothing survives a replica death).  With a
        #: journal, submit returns a :class:`FrontHandle` and
        #: :meth:`recover` can requeue a dead replica's in-flight
        #: requests as exact continuations.  Generation replicas
        #: only: the journal streams per-tick tokens.
        self.journal = journal
        #: :class:`DegradationPolicy` whose ``shed`` rung this front
        #: enforces at admission (set by the supervisor)
        self.degradation = None
        self.result_timeout = 120.0
        self._rr = itertools.count()
        self._clock = clock
        self._handles = {}
        self._hlock = threading.Lock()
        self.submitted = 0
        self.routed_canary = 0
        self.shed_no_replica = 0
        self.shed_degraded = 0
        self.recovered_requests = 0

    def by_name(self, name):
        for r in self.replicas:
            if r.name == name:
                return r
        raise KeyError(name)

    def serving(self, version=None):
        return [r for r in self.replicas
                if r.state == 'serving'
                and (version is None or r.version == version)]

    def submit(self, *args, deadline=None, **kw):
        rid = next_request_id()
        if (self.degradation is not None
                and self.degradation.sheds(rid)):
            self.shed_degraded += 1
            record_shed('degraded', request_id=rid)
            raise OverloadError(
                'degradation ladder at shed rung (request %s in the '
                'shed slice)' % rid, reason='degraded')
        to_canary = (self.canary_version is not None
                     and canary_slice(rid, self.canary_fraction))
        handle, admitted = None, False
        while True:
            group = self.serving(self.canary_version if to_canary
                                 else self.current_version)
            if not group:
                group = self.serving()  # availability beats affinity
            if not group:
                self.shed_no_replica += 1
                record_shed('no_replica', request_id=rid)
                if admitted:
                    self.journal.done(rid, outcome='shed',
                                      reason='no_replica')
                    self._drop_handle(rid)
                raise OverloadError(
                    'no serving replica available (all parked)',
                    reason='no_replica')
            r = group[next(self._rr) % len(group)]
            if self.journal is not None:
                if not admitted:
                    handle = FrontHandle(rid)
                    with self._hlock:
                        self._handles[rid] = handle
                    self.journal.admit(rid, args[0], args[1],
                                       deadline, r.name, r.version)
                    admitted = True
                else:
                    self.journal.reassign(rid, r.name)
                kw = dict(kw, on_token=self.journal.tokens)
            try:
                backend = r.submit(*args, deadline=deadline,
                                   request_id=rid, **kw)
            except ReplicaDeadError:
                # positively dead: park it (the supervisor requeues
                # ITS in-flight separately) and re-route this request
                r.state = 'dead'
                continue
            except OverloadError as e:
                if admitted:
                    self.journal.done(rid, outcome='shed',
                                      reason=e.reason)
                    self._drop_handle(rid)
                raise
            break
        self.submitted += 1
        if to_canary and r.version == self.canary_version:
            self.routed_canary += 1
        if self.journal is None:
            return backend
        self._watch(handle, backend, prefix=())
        return handle

    def _drop_handle(self, rid):
        with self._hlock:
            self._handles.pop(rid, None)

    def _watch(self, handle, backend, prefix):
        """Bind ``handle`` to ``backend``'s eventual resolution; a
        typed :class:`ReplicaDeadError` leaves the handle OPEN -- the
        journal still holds the request, and :meth:`recover` re-binds
        it to a continuation on a survivor."""
        rid = handle.request_id
        prefix = [int(t) for t in prefix]

        def wait():
            try:
                toks = backend.result(timeout=self.result_timeout)
            except ReplicaDeadError:
                return
            except OverloadError as e:
                if self.journal.done(rid, outcome='shed',
                                     reason=e.reason):
                    handle._fail(e)
                    self._drop_handle(rid)
            except Exception as e:
                if self.journal.done(rid, outcome='error',
                                     reason=type(e).__name__):
                    handle._fail(e)
                    self._drop_handle(rid)
            else:
                if self.journal.done(rid, outcome='served'):
                    handle._complete(prefix
                                     + [int(t) for t in toks])
                    self._drop_handle(rid)

        threading.Thread(target=wait, daemon=True,
                         name='fleet-front-%s' % rid).start()

    def recover(self, dead, ledger=None):
        """Exact-replay recovery of ``dead``'s journaled in-flight
        requests: each is re-dispatched to a survivor as a
        CONTINUATION -- teacher-forced prefill of ``prompt +
        emitted`` (the existing prefill path; chunked prefill meters
        long continuations), then greedy decode resumes.  Greedy
        determinism makes the continuation token-for-token identical
        to the uninterrupted run; the client's :class:`FrontHandle`
        resolves with journaled prefix + continuation, one seamless
        stream.  Already-expired deadlines shed TYPED with per-request
        attribution, never silently.  Returns ``(requeued_ids,
        shed_ids)``; ``ledger`` (the fleet ledger) gets ``requeue`` /
        ``requeue_shed`` / ``recovered`` events."""
        dead.state = 'dead'
        if self.journal is None:
            return [], []
        work = self.journal.inflight(replica=dead.name)
        requeued, shed, completed = [], [], []
        now = self._clock()
        for rid in sorted(work, key=admission_order):
            e = work[rid]
            with self._hlock:
                handle = self._handles.get(rid)
            if handle is None:
                handle = FrontHandle(rid)
                with self._hlock:
                    self._handles[rid] = handle
            emitted = [int(t) for t in e['emitted']]
            remaining = e['max_new'] - len(emitted)
            if remaining <= 0:
                # fully generated -- only the completion frame died
                # with the replica; the journal already holds every
                # token
                if self.journal.done(rid, outcome='served',
                                     recovered=True):
                    handle._complete(emitted)
                    self._drop_handle(rid)
                self.recovered_requests += 1
                completed.append(rid)
                continue
            if e['deadline'] is not None and now > e['deadline']:
                if self.journal.done(rid, outcome='shed',
                                     reason='deadline',
                                     replica=dead.name):
                    record_shed('deadline', request_id=rid,
                                replica=dead.name, phase='requeue')
                    handle._fail(OverloadError(
                        'deadline of %s expired before requeue '
                        '(died with replica %s)' % (rid, dead.name),
                        reason='deadline'))
                    self._drop_handle(rid)
                if ledger is not None:
                    ledger.append('requeue_shed', request_id=rid,
                                  replica=dead.name,
                                  reason='deadline')
                shed.append(rid)
                continue
            cont = list(e['prompt']) + emitted
            survivors = [r for r in self.serving() if r is not dead]
            backend, target, reason = None, None, 'no_replica'
            while survivors:
                cand = survivors[next(self._rr) % len(survivors)]
                try:
                    backend = cand.submit(
                        np.asarray(cont, np.int32), remaining,
                        deadline=e['deadline'], request_id=rid,
                        on_token=self.journal.tokens)
                except ReplicaDeadError:
                    cand.state = 'dead'
                    survivors = [r for r in survivors
                                 if r is not cand]
                    continue
                except OverloadError as exc:
                    reason = exc.reason
                except ValueError:
                    # continuation longer than the survivor's
                    # max_prompt_len: size recovery scenarios with
                    # max_prompt_len >= prompt + max_new - 1
                    reason = 'continuation_too_long'
                target = cand
                break
            if backend is None:
                if self.journal.done(rid, outcome='shed',
                                     reason=reason,
                                     replica=dead.name):
                    record_shed(reason, request_id=rid,
                                replica=dead.name, phase='requeue')
                    handle._fail(OverloadError(
                        'requeue of %s shed: %s' % (rid, reason),
                        reason=reason))
                    self._drop_handle(rid)
                if ledger is not None:
                    ledger.append('requeue_shed', request_id=rid,
                                  replica=dead.name, reason=reason)
                shed.append(rid)
                continue
            self.journal.reassign(rid, target.name)
            if ledger is not None:
                ledger.append('requeue', request_id=rid,
                              from_replica=dead.name,
                              to_replica=target.name,
                              emitted=len(emitted),
                              remaining=remaining)
            self._watch(handle, backend, prefix=emitted)
            self.recovered_requests += 1
            requeued.append(rid)
        if ledger is not None:
            ledger.append('recovered', replica=dead.name,
                          request_ids=requeued, shed=shed,
                          completed_at_death=completed)
        return requeued, shed

    def shed_total(self):
        return (self.shed_no_replica + self.shed_degraded
                + sum(r.shed_total() for r in self.replicas
                      if r.state != 'dead'))

    def stats(self):
        out = {'submitted': self.submitted,
               'routed_canary': self.routed_canary,
               'shed_no_replica': self.shed_no_replica,
               'shed_degraded': self.shed_degraded,
               'recovered_requests': self.recovered_requests,
               'current_version': self.current_version,
               'canary_version': self.canary_version,
               'replicas': [r.stats() for r in self.replicas]}
        if self.journal is not None:
            out['journal'] = {'admitted': self.journal.admitted,
                              'completed': self.journal.completed,
                              'inflight': len(self.journal.inflight())}
        return out


# ----------------------------------------------------------------------
# the canary judge
# ----------------------------------------------------------------------

class CanaryJudge:
    """Live A/B verdict over per-(replica, version) SLO evaluations.

    Two gates, both required to pass:

    - the candidate's OWN multi-window burn-rate verdict
      (:class:`~chainermn_tpu_torch.telemetry.slo.SLOMonitor`): an absolute
      SLO breach on the canary slice is a breach, full stop;
    - DELTAS against the incumbents' matched window: fast-window p99
      of each latency series (TTFT, inter-token, batch e2e) must stay
      under ``latency_ratio`` x the incumbents' (with an absolute
      ``latency_floor_ms`` so microsecond noise on a fast model can
      never page), and the shed fraction must not exceed the
      incumbents' by more than ``shed_delta``.

    The incumbent baseline is the MAX across incumbent replicas with
    enough data -- deliberately the loosest honest bar, so a noisy
    single incumbent sample cannot fake a regression.  Fewer than
    ``min_events`` fast-window samples on a series keeps that series
    out of the verdict; a window with NO judgeable series is
    ``'pending'`` (the controller's ``promote_on_quiet`` decides what
    a quiet canary means).
    """

    LATENCY_ROWS = ('ttft_p99', 'intertoken_p99', 'latency_p99')

    def __init__(self, latency_ratio=1.5, latency_floor_ms=5.0,
                 shed_delta=0.05, min_events=6):
        self.latency_ratio = float(latency_ratio)
        self.latency_floor_ms = float(latency_floor_ms)
        self.shed_delta = float(shed_delta)
        self.min_events = int(min_events)

    def describe(self):
        return {'latency_ratio': self.latency_ratio,
                'latency_floor_ms': self.latency_floor_ms,
                'shed_delta': self.shed_delta,
                'min_events': self.min_events}

    @staticmethod
    def _fast(row):
        return row.get('fast') or {}

    def judge(self, candidate, incumbents):
        """``{'verdict': 'ok'|'breach'|'pending', 'reasons': [...],
        'deltas': {...}}`` from one candidate evaluation and a list
        of incumbent evaluations (Nones tolerated)."""
        out = {'verdict': 'pending', 'reasons': [], 'deltas': {},
               'candidate_overall': None}
        if not candidate:
            return out
        verdict = candidate.get('verdict') or {}
        out['candidate_overall'] = verdict.get('overall')
        if verdict.get('overall') == 'breach':
            out['reasons'].append(
                'slo_breach:%s' % ','.join(verdict.get('breaches')
                                           or ()))
        rows = candidate.get('slos') or {}
        inc_rows = [(e.get('slos') or {}) for e in incumbents if e]
        judged_any = False
        for name in self.LATENCY_ROWS:
            crow = rows.get(name)
            if not crow:
                continue
            c_p99 = self._fast(crow).get('p99')
            c_n = self._fast(crow).get('count', 0)
            if c_p99 is None or c_n < self.min_events:
                continue
            baselines = []
            for ir in inc_rows:
                irow = ir.get(name)
                if not irow:
                    continue
                i_p99 = self._fast(irow).get('p99')
                if (i_p99 is not None and self._fast(irow).get(
                        'count', 0) >= self.min_events):
                    baselines.append(i_p99)
            if not baselines:
                continue
            judged_any = True
            base = max(baselines)
            out['deltas'][name] = {
                'candidate_p99_ms': round(c_p99 * 1e3, 3),
                'incumbent_p99_ms': round(base * 1e3, 3)}
            if (c_p99 > base * self.latency_ratio
                    and (c_p99 - base) * 1e3 > self.latency_floor_ms):
                out['reasons'].append(
                    '%s:%.1fms vs %.1fms incumbent (%.1fx)'
                    % (name, c_p99 * 1e3, base * 1e3,
                       c_p99 / max(base, 1e-9)))
        crow = rows.get('shed_fraction')
        if crow:
            c_frac = self._fast(crow).get('value') or 0.0
            c_n = self._fast(crow).get('count', 0)
            if c_n >= self.min_events:
                judged_any = True
                bases = [(self._fast(ir['shed_fraction']).get('value')
                          or 0.0)
                         for ir in inc_rows
                         if ir.get('shed_fraction')]
                base = max(bases) if bases else 0.0
                out['deltas']['shed_fraction'] = {
                    'candidate': round(c_frac, 4),
                    'incumbent': round(base, 4)}
                if c_frac - base > self.shed_delta:
                    out['reasons'].append(
                        'shed_fraction:%.1f%% vs %.1f%% incumbent'
                        % (100 * c_frac, 100 * base))
        if out['reasons']:
            out['verdict'] = 'breach'
        elif judged_any:
            out['verdict'] = 'ok'
        return out

# ----------------------------------------------------------------------
# the controller
# ----------------------------------------------------------------------

class FleetController:
    """Watch -> roll -> canary -> promote/rollback -> record, in a
    loop (module docstring).  Owns the append-only
    ``fleet_ledger.jsonl`` and the roll state machine; the front and
    replicas are handed in (built by :func:`build_local_fleet`, the
    CLI, or a test).

    ``boot`` is the ``(path, iteration)`` the replicas were loaded
    from -- the incumbent a breached canary rolls back to until the
    first promote replaces it.
    """

    def __init__(self, front, ckpt_dir, out, boot, watcher=None,
                 judge=None, canary_seconds=4.0, judge_interval=0.4,
                 drain_timeout=60.0, promote_on_quiet=True,
                 poll_interval=0.1, clock=time.monotonic,
                 sleep=time.sleep):
        self.front = front
        self.replicas = front.replicas
        self.ckpt_dir = ckpt_dir
        self.out = out
        self.current_path, self.current_version = boot
        self.current_version = int(self.current_version)
        self.watcher = watcher if watcher is not None else \
            CheckpointWatcher(ckpt_dir,
                              start_after=self.current_version)
        self.judge = judge if judge is not None else CanaryJudge()
        self.canary_seconds = float(canary_seconds)
        self.judge_interval = float(judge_interval)
        self.drain_timeout = float(drain_timeout)
        self.promote_on_quiet = promote_on_quiet
        self.poll_interval = float(poll_interval)
        self._clock = clock
        self._sleep = sleep
        self.ledger = Ledger(os.path.join(out, LEDGER_NAME))
        self.rolling = False
        self.promotes = 0
        self.rollbacks = 0
        self.swap_failures = 0
        self.dropped_during_swap = 0
        self.last_handled_version = None
        self.swap_downtimes = []   # per-replica out-of-rotation secs

    # -- lifecycle -----------------------------------------------------
    def start(self):
        """Append ``start``; when a PRIOR controller died mid-roll
        (a ``roll_start`` with no later ``promote``/``rollback`` in
        the ledger -- the ``swap_kill`` wreckage), record the
        reconciliation: every replica was booted from the newest
        VALID snapshot, so the fleet is already on ONE consistent
        version, and ``converged`` names it plus the roll it
        recovered from."""
        prior = Ledger.read(self.ledger.path)
        open_roll = None
        for e in prior:
            if e.get('event') == 'roll_start':
                open_roll = e
            elif e.get('event') in ('promote', 'rollback'):
                open_roll = None
        self.ledger.append(
            'start', out=self.out, ckpt_dir=self.ckpt_dir,
            version=self.current_version, path=self.current_path,
            replicas=[r.name for r in self.replicas],
            canary_fraction=self.front.canary_fraction,
            judge=self.judge.describe(),
            canary_seconds=self.canary_seconds)
        if open_roll is not None:
            # mixed-version stragglers cannot survive a restart (every
            # replica boots from the newest valid snapshot), so the
            # reconciliation is pure bookkeeping -- but it is the
            # bookkeeping the convergence contract is asserted on
            self._converged(recovered_roll=open_roll.get('version'))
        return self

    def _converged(self, **fields):
        self.ledger.append(
            'converged', version=self.current_version,
            replicas={r.name: r.version for r in self.replicas},
            **fields)

    def tick(self):
        """One watch-and-maybe-roll step; True when a roll ran."""
        cand = self.watcher.poll()
        if cand is None:
            return False
        kind, path, it = cand
        self.roll(kind, path, it)
        return True

    def run(self, stop=None, duration=None):
        """Tick until ``stop`` is set (and/or ``duration`` elapsed)."""
        t_end = (None if duration is None
                 else self._clock() + duration)
        while True:
            if stop is not None and stop.is_set():
                return
            if t_end is not None and self._clock() >= t_end:
                return
            if not self.tick():
                self._sleep(self.poll_interval)

    # -- the roll ladder -----------------------------------------------
    def roll(self, kind, path, version):
        """Roll snapshot ``path`` (iteration = ``version``) through
        the fleet: canary first, judged live, then promote or roll
        back.  Returns True on promote."""
        version = int(version)
        self.rolling = True
        try:
            return self._roll(kind, path, version)
        finally:
            self.rolling = False
            self.last_handled_version = version
            self.front.canary_version = None

    def _roll(self, kind, path, version):
        front = self.front
        canary, incumbents = self.replicas[0], self.replicas[1:]
        self.ledger.append('version_seen', kind=kind, path=path,
                           iteration=version, version=version)
        prev_path, prev_version = (self.current_path,
                                   self.current_version)
        self.ledger.append(
            'roll_start', version=version, from_version=prev_version,
            canary=canary.name,
            replicas=[r.name for r in self.replicas],
            canary_fraction=front.canary_fraction)
        if not self._swap_replica(canary, path, version,
                                  roll_version=version):
            self.ledger.append('rollback', version=version,
                               to_version=prev_version,
                               reason='canary_swap_failed')
            self.rollbacks += 1
            self._converged()
            return False
        # canary admission ON: fresh matched SLO windows on both arms
        canary.reset_slo()
        for r in incumbents:
            r.reset_slo()
        front.canary_version = version
        verdict = self._canary_window(canary, incumbents)
        self.ledger.append(
            'canary_verdict', version=version,
            verdict=verdict['verdict'], reasons=verdict['reasons'],
            deltas=verdict['deltas'],
            candidate_overall=verdict.get('candidate_overall'),
            routed_canary=front.routed_canary)
        if verdict['verdict'] == 'breach' or (
                verdict['verdict'] == 'pending'
                and not self.promote_on_quiet):
            front.canary_version = None
            ok = self._swap_replica(canary, prev_path, prev_version,
                                    roll_version=version,
                                    rollback=True)
            self.ledger.append(
                'rollback', version=version, to_version=prev_version,
                reason=('; '.join(verdict['reasons'])
                        or 'quiet canary (promote_on_quiet=False)'),
                swap_ok=ok)
            self.rollbacks += 1
            self._converged()
            return False
        # promote: the same ladder through the remaining replicas
        for r in incumbents:
            if self._swap_replica(r, path, version,
                                  roll_version=version):
                continue
            # a mid-promote swap failure: converge BACKWARD -- swap
            # every already-promoted replica (canary included) back
            front.canary_version = None
            for rr in self.replicas:
                if rr.version == version:
                    self._swap_replica(rr, prev_path, prev_version,
                                       roll_version=version,
                                       rollback=True)
            self.ledger.append(
                'rollback', version=version, to_version=prev_version,
                reason='replica %s swap failed mid-promote' % r.name)
            self.rollbacks += 1
            self._converged()
            return False
        self.current_path, self.current_version = path, version
        front.current_version = version
        front.canary_version = None
        self.promotes += 1
        self.ledger.append('promote', version=version,
                           from_version=prev_version)
        self._converged()
        return True

    def _canary_window(self, canary, incumbents):
        """Poll the judge every ``judge_interval`` for
        ``canary_seconds``; a breach returns IMMEDIATELY (the canary
        slice stops bleeding at detection, not at window end)."""
        t_end = self._clock() + self.canary_seconds
        verdict = {'verdict': 'pending', 'reasons': [], 'deltas': {},
                   'candidate_overall': None}
        while True:
            self._sleep(self.judge_interval)
            evals = [r.slo_eval() for r in incumbents]
            verdict = self.judge.judge(canary.slo_eval(),
                                       [e for e in evals if e])
            if verdict['verdict'] == 'breach':
                return verdict
            if self._clock() >= t_end:
                return verdict

    def _swap_replica(self, r, path, version, roll_version,
                      rollback=False):
        """drain -> swap -> rejoin for one replica, ledgered.  The
        ``swap_kill`` chaos point sits at the TOP: a fired site dies
        before this swap, leaving every prior ledger entry fsynced --
        the mid-roll wreckage the restart-convergence test replays.
        Returns True when the replica now serves ``version``."""
        if _chaos._active is not None:
            _chaos.on_swap(phase='rollback' if rollback else 'roll')
        shed0 = r.shed_total()
        old_version = r.version
        r.state = 'draining'   # the front routes around it from here
        t0 = self._clock()
        drained = r.drain(self.drain_timeout)
        t_drained = self._clock()
        r.state = 'swapping'
        err, swap_s = None, None
        try:
            swap_s = r.swap(path, version)
        except (WeightSwapError, failure.CheckpointCorruptError,
                RuntimeError, TimeoutError) as e:
            err = '%s: %s' % (type(e).__name__, e)
        r.state = 'serving'   # at the new version, or still the old
        t_back = self._clock()
        shed = r.shed_total() - shed0
        self.dropped_during_swap += shed
        if err is not None:
            self.swap_failures += 1
        else:
            self.swap_downtimes.append(t_back - t0)
        self.ledger.append(
            'replica_swap', roll_version=roll_version,
            replica=r.name, from_version=old_version,
            to_version=(version if err is None else old_version),
            ok=err is None, error=err, rollback=rollback,
            drained=drained, drain_s=round(t_drained - t0, 4),
            swap_s=swap_s,
            out_of_rotation_s=round(t_back - t0, 4),
            shed_during_swap=shed)
        return err is None

    # -- teardown ------------------------------------------------------
    def complete(self, **fields):
        """Final accounting entry (the CLI's exit record)."""
        return self.ledger.append(
            'complete', version=self.current_version,
            promotes=self.promotes, rollbacks=self.rollbacks,
            swap_failures=self.swap_failures,
            dropped_during_swap=self.dropped_during_swap,
            front=self.front.stats(), **fields)

    def close(self):
        for r in self.replicas:
            try:
                r.close()
            except Exception:
                pass

# ----------------------------------------------------------------------
# the replica supervisor: detect -> requeue -> respawn -> degrade
# ----------------------------------------------------------------------

def strip_oneshot_kills(spec, site='replica_kill'):
    """Drop one-shot ``@``-scheduled ``site`` rules from a chaos spec
    handout (keep ``p`` and ``*`` rules).  A respawned worker's
    occurrence counters restart at zero, so handing it the original
    ``replica_kill=@N`` rule would re-fire the already-consumed kill
    on every respawn -- while a ``*`` rule SHOULD keep firing: that
    is the crash-loop the restart policy must abort on."""
    if not spec:
        return spec
    kept = []
    for item in str(spec).split(';'):
        item = item.strip()
        if not item:
            continue
        name, _, rhs = item.partition('=')
        if name.strip() == site and rhs.strip().startswith('@'):
            continue
        kept.append(item)
    return ';'.join(kept)


class ReplicaSupervisor:
    """Fleet-level self-healing loop -- the serving twin of the
    training supervisor.  One :meth:`check` pass:

    1. **detect**: a subprocess replica whose process exited or whose
       read loop hit EOF, or a :class:`LocalReplica` marked ``dead``
       (by :meth:`LocalReplica.kill` or a typed submit failure);
    2. **classify + record**: ``classify_exit`` on the worker's
       returncode, the dead worker's flight dump read through the
       doctor's ``quick_verdict`` (when workers capture to disk via
       ``--worker-out``), a ``replica_dead`` ledger event naming
       every in-flight request id;
    3. **requeue**: :meth:`FleetFront.recover` -- exact-replay
       continuations on survivors, per-request attribution;
    4. **decide**: the training-side
       :class:`~chainermn_tpu_torch.training.supervisor.RestartPolicy`
       (crash-loop window, restart budget,
       :class:`~chainermn_tpu_torch.utils.failure.Backoff` pacing).  A
       crash loop (``replica_kill=*`` on every respawn) ABORTS typed
       instead of burning the budget;
    5. **respawn**: ``spawn_fn(name, path, version, index)`` boots a
       replacement from the controller's incumbent snapshot (the
       newest valid rolled head of the ``CheckpointWatcher`` /
       ``chain_heads`` chain) and splices it into the front at the
       dead replica's slot -- ``respawn`` ledger event, fresh name.

    The same loop drives the :class:`DegradationPolicy` from the live
    per-replica SLO verdicts and KV-page pressure (``degrade_interval``
    cadence), applying rungs 0-3 to every serving engine; rung 4's
    shed is enforced by the front itself.
    """

    def __init__(self, controller, spawn_fn=None, policy=None,
                 degradation=None, poll_interval=0.15,
                 degrade_interval=0.5, worker_out=None,
                 clock=time.monotonic):
        from chainermn_tpu_torch.training.supervisor import RestartPolicy
        self.controller = controller
        self.front = controller.front
        self.ledger = controller.ledger
        self.spawn_fn = spawn_fn
        self.policy = policy if policy is not None else RestartPolicy(
            max_restarts=8, crash_window=120.0, crash_threshold=3,
            shrink_causes=(),   # serving never shrinks: respawn or abort
            backoff=failure.Backoff(initial=0.2, factor=2.0,
                                    max_delay=2.0))
        self.degradation = degradation
        if degradation is not None:
            if degradation.ledger is None:
                degradation.ledger = self.ledger
            self.front.degradation = degradation
        self.poll_interval = float(poll_interval)
        self.degrade_interval = float(degrade_interval)
        self.worker_out = worker_out
        self._clock = clock
        self._stop = threading.Event()
        self._thread = None
        self._handled = set()
        self._respawn_gen = {}
        self._t_next_degrade = 0.0
        self.deaths = 0
        self.respawns = 0
        self.requeued = []
        self.shed = []
        self.aborted = False
        self.abort_reason = None

    # -- lifecycle -----------------------------------------------------
    def start(self):
        self._thread = threading.Thread(target=self._loop,
                                        daemon=True,
                                        name='fleet-supervisor')
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.check()
            except Exception:
                pass
            if self.aborted:
                return
            self._stop.wait(self.poll_interval)

    # -- one pass ------------------------------------------------------
    @staticmethod
    def _is_dead(r):
        if getattr(r, 'state', None) == 'dead':
            return True
        proc = getattr(r, 'proc', None)
        if proc is not None and (proc.poll() is not None
                                 or getattr(r, '_dead', False)):
            return True
        return False

    def check(self):
        """One detect/requeue/respawn/degrade pass (tests call this
        directly for determinism; :meth:`start` polls it)."""
        for idx, r in enumerate(list(self.front.replicas)):
            if r.name in self._handled or self.aborted:
                continue
            if self._is_dead(r):
                self._handle_death(idx, r)
        self._drive_degradation()
        return {'deaths': self.deaths, 'respawns': self.respawns,
                'aborted': self.aborted}

    def _quick_verdict(self, r):
        if not self.worker_out:
            return None
        try:
            from chainermn_tpu_torch.telemetry.diagnosis import quick_verdict
            v = quick_verdict(os.path.join(self.worker_out, r.name))
            if not v:
                return None
            return {'verdict': v.get('verdict'),
                    'causes': v.get('causes')}
        except Exception:
            return None

    def _handle_death(self, idx, r):
        self._handled.add(r.name)
        self.deaths += 1
        r.state = 'dead'
        proc = getattr(r, 'proc', None)
        rc = None
        if proc is not None:
            # the journal's committed prefix is only final at read-loop
            # EOF: frames already in the socket buffer land before it,
            # so wait for the reader before computing the worklist
            t_end = time.monotonic() + 5.0
            while (not getattr(r, '_dead', False)
                   and time.monotonic() < t_end):
                time.sleep(0.01)
            try:
                rc = proc.wait(timeout=10.0)
            except Exception:
                rc = proc.returncode
        exit_kind = (failure.classify_exit(rc)
                     if rc is not None else 'killed')
        inflight = sorted(
            self.front.journal.inflight(replica=r.name)
            if self.front.journal is not None else (),
            key=admission_order)
        self.ledger.append(
            'replica_dead', replica=r.name, returncode=rc,
            exit=exit_kind, request_ids=inflight,
            quick_verdict=self._quick_verdict(r))
        requeued, shed = self.front.recover(r, ledger=self.ledger)
        self.requeued.extend(requeued)
        self.shed.extend(shed)
        try:
            r.close()
        except Exception:
            pass
        cause = 'crash' if rc is not None else 'killed'
        decision = self.policy.on_failure(
            cause, nprocs=len(self.front.serving()) + 1)
        if decision.action == 'abort':
            self.aborted = True
            self.abort_reason = decision.reason
            self.ledger.append('abort', replica=r.name,
                               reason=decision.reason,
                               restarts=self.policy.restarts)
            return
        if self.spawn_fn is None:
            return   # requeue-only mode: survivors absorb the load
        if decision.delay:
            self._stop.wait(decision.delay)
        gen = self._respawn_gen.get(idx, 0) + 1
        self._respawn_gen[idx] = gen
        name = 'replica-%dr%d' % (idx, gen)
        try:
            replacement = self.spawn_fn(
                name=name, path=self.controller.current_path,
                version=self.controller.current_version, index=idx)
        except Exception as e:
            self.ledger.append('respawn_failed', replica=name,
                               replaces=r.name, error=str(e))
            return
        self.front.replicas[idx] = replacement
        self.respawns += 1
        self.policy.on_success()   # healthy boot: backoff resets
        self.ledger.append(
            'respawn', replica=name, replaces=r.name,
            version=self.controller.current_version,
            path=self.controller.current_path,
            delay_s=round(decision.delay, 4),
            restarts=self.policy.restarts)

    # -- degradation driving -------------------------------------------
    def _drive_degradation(self):
        pol = self.degradation
        if pol is None:
            return
        now = self._clock()
        if now < self._t_next_degrade:
            return
        self._t_next_degrade = now + self.degrade_interval
        order = {'ok': 0, 'warn': 1, 'breach': 2}
        worst, breaches = None, []
        kv_used = kv_total = 0
        for r in self.front.serving():
            try:
                ev = r.slo_eval()
            except Exception:
                ev = None
            if ev:
                verdict = ev.get('verdict') or {}
                o = verdict.get('overall')
                if o in order and (worst is None
                                   or order[o] > order[worst]):
                    worst = o
                if o == 'breach':
                    breaches.extend(verdict.get('breaches') or ())
            eng = getattr(r, 'engine', None)
            if eng is not None and getattr(eng, 'pool',
                                           None) is not None:
                kv_used += eng.pool.in_use()
                kv_total += eng.n_pages
        moved = pol.observe(worst, breaches=breaches,
                            kv_in_use=kv_used or None,
                            kv_total=kv_total or None)
        if moved is not None:
            for r in self.front.serving():
                try:
                    r.degrade(min(moved, 3))
                except Exception:
                    pass

    def describe(self):
        out = {'deaths': self.deaths, 'respawns': self.respawns,
               'requeued': sorted(self.requeued,
                                  key=admission_order),
               'shed': sorted(self.shed,
                              key=admission_order),
               'aborted': self.aborted,
               'abort_reason': self.abort_reason,
               'policy': self.policy.describe()}
        if self.degradation is not None:
            out['degradation'] = self.degradation.describe()
        if self.front.journal is not None:
            out['lost_requests'] = len(self.front.journal.inflight())
        return out

# ----------------------------------------------------------------------
# the built-in demo: an LM trained for real, served for real
# ----------------------------------------------------------------------

#: demo TransformerLM geometry: small enough that a replica boots in
#: seconds on the CPU, real enough that the train -> snapshot -> roll ->
#: serve loop runs genuine SGD steps and genuine generation
DEMO_MODEL = dict(vocab_size=32, d_model=16, n_heads=2, n_layers=1,
                  d_ff=32, max_len=32)
#: the serving LM at full width (the serve profile of the JAX package's
#: ``bench.py``), served in bf16
SERVE_MODEL = dict(vocab_size=32000, d_model=512, n_heads=8, n_layers=6,
                   d_ff=2048, max_len=512)
#: ``--model`` -> (geometry, engine policy name)
MODELS = {'demo': (DEMO_MODEL, None), 'serve': (SERVE_MODEL, 'bf16')}
DEMO_SEED = 0


def demo_model(config=None, device=None, seed=DEMO_SEED,
               dtype=torch.float32):
    """A :class:`~chainermn_tpu_torch.models.TransformerLM` of ``config``'s
    geometry (default :data:`DEMO_MODEL`) computing in ``dtype`` (its
    parameters are f32 either way), initialised from
    ``torch.Generator().manual_seed(seed)``.  On the ``'meta'`` device
    nothing is initialised: the model is its shapes alone, what a serving
    engine loading a snapshot needs (at full width the seeded init takes
    seconds)."""
    from chainermn_tpu_torch.models import TransformerLM
    meta = device is not None and torch.device(device).type == 'meta'
    with torch.device('meta') if meta else contextlib.nullcontext():
        return TransformerLM(dtype=dtype, device=device,
                             generator=torch.Generator().manual_seed(seed),
                             **(config or DEMO_MODEL))


def demo_params(seed=DEMO_SEED, config=None, device=None,
                dtype=torch.float32):
    """``(model, params)``: the deterministic init every fleet process
    (trainer, controller, replica workers) shares, so a snapshot's shape
    template never has to travel; ``params`` is the flax-keyed tree of
    :func:`~chainermn_tpu_torch.models.param_tree`."""
    from chainermn_tpu_torch.models import param_tree
    model = demo_model(config, device, seed, dtype)
    return model, param_tree(model)


def demo_train(ckpt_dir, steps, snapshot_every, lr=0.05, data_seed=1234,
               config=None, device=None):
    """Real next-token SGD on the demo LM (the port's own model, fused
    loss and ``torch.optim.SGD``), continuing from the newest valid
    snapshot under ``ckpt_dir`` (the fresh init otherwise), writing a
    ``snapshot_iter_<it>.npz`` with the manifest and its write-complete
    sentinel every ``snapshot_every`` steps and at the last.  Returns the
    paths written."""
    from chainermn_tpu_torch import serializers
    from chainermn_tpu_torch.models import (load_flax_variables, lm_loss,
                                            param_tree)
    from chainermn_tpu_torch.serving.engine import load_params
    from chainermn_tpu_torch.training import recovery
    from chainermn_tpu_torch.ops._common import resolve_device
    cfg = config or DEMO_MODEL
    _, path, start_it = recovery.latest_snapshot(ckpt_dir)
    if start_it is None:
        start_it = 0
        model = demo_model(cfg, device)
    else:
        # the snapshot's weights replace the init: build the shapes only
        model, template = demo_params(config=cfg, device='meta')
        model = model.to_empty(device=resolve_device(device))
        load_flax_variables(model, {'params': load_params(path, template)})
    rng = np.random.RandomState(data_seed)
    toks = torch.as_tensor(rng.randint(0, cfg['vocab_size'], size=(8, 12)),
                           dtype=torch.int32,
                           device=model.lnf_scale.device)
    loss_fn = lm_loss(model)
    opt = torch.optim.SGD(model.parameters(), lr=lr)
    written = []
    os.makedirs(ckpt_dir, exist_ok=True)
    for it in range(start_it + 1, start_it + steps + 1):
        opt.zero_grad(set_to_none=True)
        loss, _ = loss_fn(toks[:, :-1], toks[:, 1:])
        loss.backward()
        opt.step()
        if it % snapshot_every == 0 or it == start_it + steps:
            written.append(serializers.save_npz(
                os.path.join(ckpt_dir, 'snapshot_iter_%d' % it),
                {'params': param_tree(model)}))
    return written


def _policy_kw(policy):
    """The engine keyword of a :data:`MODELS` policy name (None: f32)."""
    if policy is None:
        return {}
    from chainermn_tpu_torch.precision import Policy
    return {'policy': Policy.from_string(policy)}


def _compute_dtype(engine_kw):
    """The dtype a served model computes in: its engine policy's."""
    return getattr((engine_kw or {}).get('policy'), 'compute_dtype',
                   torch.float32)


def build_local_fleet(ckpt_dir, out, n_replicas=2, n_slots=2,
                      max_prompt_len=4, max_queue=64, slos=None,
                      canary_fraction=0.25, engine_kw=None, journal=False,
                      warmup=True, config=None, device=None,
                      **controller_kw):
    """An in-process demo-LM fleet booted from the newest valid snapshot
    under ``ckpt_dir``; returns the (not yet started)
    :class:`FleetController`.  ``journal=True`` arms the crash-safe
    :class:`RequestJournal` (``OUT/request_journal.jsonl``) so a
    :class:`ReplicaSupervisor` can recover a dead replica's in-flight
    generations.  ``warmup=True`` prepares every bucket of every engine
    (captures its CUDA graph on the card) before any replica serves;
    ``False`` prepares each on first use.  ``config`` is the geometry
    (default :data:`DEMO_MODEL`), ``device`` where the replicas run."""
    from chainermn_tpu_torch.serving.generate import GenerationEngine
    from chainermn_tpu_torch.training import recovery
    kind, path, it = recovery.latest_snapshot(ckpt_dir)
    if path is None:
        raise ValueError('no valid snapshot under %r to boot the fleet '
                         'from' % ckpt_dir)
    model, template = demo_params(config=config, device='meta',
                                  dtype=_compute_dtype(engine_kw))
    engines = []
    for i in range(n_replicas):
        name = 'replica-%d' % i
        eng = GenerationEngine.from_checkpoint(
            path, model, template, n_slots=n_slots,
            max_prompt_len=max_prompt_len, label=name, version=it,
            device=device, **(engine_kw or {}))
        if warmup:
            eng.warmup()
        engines.append(eng)
    replicas = [LocalReplica(eng.label, eng, max_queue=max_queue,
                             slos=slos).start() for eng in engines]
    front = FleetFront(
        replicas, current_version=it, canary_fraction=canary_fraction,
        journal=(RequestJournal(os.path.join(out, JOURNAL_NAME))
                 if journal else None))
    return FleetController(front, ckpt_dir, out, boot=(path, it),
                           **controller_kw)


def local_respawn_fn(n_slots=2, max_prompt_len=4, max_queue=64, slos=None,
                     engine_kw=None, warmup=True, config=None, device=None):
    """A ``spawn_fn`` for :class:`ReplicaSupervisor` over in-process
    replicas: boots a fresh demo engine from the incumbent snapshot
    (capturing its graphs on the card while the survivors serve) and
    starts a :class:`LocalReplica` under the replacement name."""
    from chainermn_tpu_torch.serving.generate import GenerationEngine
    model, template = demo_params(config=config, device='meta',
                                  dtype=_compute_dtype(engine_kw))

    def spawn_fn(name, path, version, index):
        del index
        eng = GenerationEngine.from_checkpoint(
            path, model, template, n_slots=n_slots,
            max_prompt_len=max_prompt_len, label=name, version=version,
            device=device, **(engine_kw or {}))
        if warmup:
            eng.warmup()
        return LocalReplica(name, eng, max_queue=max_queue,
                            slos=slos).start()

    return spawn_fn


# ----------------------------------------------------------------------
# replica worker (the --replica subprocess)
# ----------------------------------------------------------------------

def _watch_parent(ppid):
    while True:
        if os.getppid() != ppid:
            os._exit(0)   # orphaned by a dead controller: leave
        time.sleep(0.5)


def _replica_main(args):
    """The ``--replica`` worker: boot the engine of ``--model`` from
    ``--snapshot`` on ``--device``, warm it up (capture every graph on the
    card), then serve newline-JSON commands from the controller over
    ``--port`` (serve / drain / swap / reset_slo / degrade / stats / ping /
    shutdown).  Chaos comes from the ``CHAINERMN_TPU_CHAOS`` handout;
    telemetry is a recorder (on disk under ``--worker-out``) feeding the
    per-version SLO monitor the controller polls through ``stats``."""
    from chainermn_tpu_torch.serving.generate import GenerationEngine
    if args.device == 'cpu':
        torch.set_num_threads(max(1, min(2, torch.get_num_threads())))
    _chaos.maybe_install_from_env()
    # --worker-out: capture to disk, so that a chaos kill's flight dump
    # survives for the supervisor's post-mortem
    _telemetry.enable(outdir=args.worker_out or None)
    if args.parent_pid:
        threading.Thread(target=_watch_parent, args=(args.parent_pid,),
                         daemon=True).start()
    config, policy = MODELS[args.model]
    engine_kw = _policy_kw(policy)
    model, template = demo_params(config=config, device='meta',
                                  dtype=_compute_dtype(engine_kw))
    engine = GenerationEngine.from_checkpoint(
        args.snapshot, model, template, n_slots=args.n_slots,
        max_prompt_len=args.max_prompt_len, label=args.name,
        version=args.version, device=args.device, **engine_kw)
    engine.warmup()
    queue = GenerationQueue(args.max_prompt_len, max_queue=args.max_queue,
                            label=args.name)
    stop = threading.Event()
    threading.Thread(target=engine.run, args=(queue, stop),
                     daemon=True).start()
    monitor = [_fresh_monitor(args.name, engine.param_version)]

    srv = socket.create_server(('127.0.0.1', args.port))
    conn, _addr = srv.accept()
    rfile = conn.makefile('r')
    wlock = threading.Lock()
    outstanding = [0]
    olock = threading.Lock()
    degrade_saved = {}

    def reply(obj):
        with wlock:
            conn.sendall((json.dumps(obj) + '\n').encode())

    def handle_serve(msg):
        mid = msg.get('id')
        on_token = None
        if msg.get('stream'):
            # one token frame per scheduler tick: the journaling front's
            # committed-prefix feed
            def on_token(_rid, toks):
                reply({'id': mid, 'token': toks})
        try:
            dl = (None if msg.get('deadline_s') is None
                  else time.monotonic() + float(msg['deadline_s']))
            req = queue.submit(msg['prompt'], msg['max_new_tokens'],
                               deadline=dl,
                               request_id=msg.get('request_id'),
                               on_token=on_token)
        except OverloadError as e:
            reply({'id': mid, 'ok': False, 'error': 'OverloadError',
                   'reason': e.reason, 'message': str(e)})
            return
        except Exception as e:
            reply({'id': mid, 'ok': False, 'error': type(e).__name__,
                   'message': str(e)})
            return

        def wait_result():
            try:
                toks = req.result(timeout=msg.get('result_timeout', 120.0))
                reply({'id': mid, 'ok': True,
                       'tokens': [int(t) for t in toks]})
            except OverloadError as e:
                reply({'id': mid, 'ok': False, 'error': 'OverloadError',
                       'reason': e.reason, 'message': str(e)})
            except Exception as e:
                reply({'id': mid, 'ok': False, 'error': type(e).__name__,
                       'message': str(e)})
            finally:
                with olock:
                    outstanding[0] -= 1

        with olock:
            outstanding[0] += 1
        threading.Thread(target=wait_result, daemon=True).start()

    def drained():
        with olock:
            busy = outstanding[0]
        return busy == 0 and queue.depth() == 0 and not engine._slots

    for line in rfile:
        try:
            msg = json.loads(line)
        except ValueError:
            continue
        cmd, mid = msg.get('cmd'), msg.get('id')
        if cmd == 'serve':
            handle_serve(msg)
        elif cmd == 'ping':
            reply({'id': mid, 'ok': True, 'version': engine.param_version})
        elif cmd == 'drain':
            deadline = time.monotonic() + float(msg.get('timeout_s', 30.0))
            while time.monotonic() < deadline and not drained():
                time.sleep(0.005)
            reply({'id': mid, 'ok': True, 'drained': drained()})
        elif cmd == 'swap':
            t0 = time.perf_counter()
            try:
                engine.swap_from_checkpoint(msg['path'],
                                            version=msg['version'])
            except (WeightSwapError, failure.CheckpointCorruptError) as e:
                reply({'id': mid, 'ok': True, 'swapped': False,
                       'message': '%s: %s' % (type(e).__name__, e)})
                continue
            if monitor[0] is not None:
                monitor[0].detach()
            monitor[0] = _fresh_monitor(args.name, engine.param_version)
            reply({'id': mid, 'ok': True, 'swapped': True,
                   'swap_s': round(time.perf_counter() - t0, 4)})
        elif cmd == 'reset_slo':
            if monitor[0] is not None:
                monitor[0].detach()
            monitor[0] = _fresh_monitor(args.name, engine.param_version)
            reply({'id': mid, 'ok': True})
        elif cmd == 'degrade':
            rung = apply_degradation_rung(engine, msg.get('rung', 0),
                                          degrade_saved)
            reply({'id': mid, 'ok': True, 'rung': rung})
        elif cmd == 'stats':
            st = engine.stats()
            reply({'id': mid, 'ok': True, 'version': engine.param_version,
                   'slo': (monitor[0].evaluate()
                           if monitor[0] is not None else None),
                   'queue': queue.stats(),
                   'engine': {k: st[k] for k in (
                       'prefills', 'decode_steps', 'tokens_generated',
                       'cancelled', 'decode_trace_count', 'compile_count',
                       'param_version')}})
        elif cmd == 'shutdown':
            reply({'id': mid, 'ok': True})
            break
        else:
            reply({'id': mid, 'ok': False,
                   'message': 'unknown cmd %r' % cmd})
    stop.set()
    queue.close()
    try:
        conn.close()
        srv.close()
    except OSError:
        pass
    return 0

# ----------------------------------------------------------------------
# demo traffic + the CLI
# ----------------------------------------------------------------------

class _TrafficGen:
    """Open-loop demo traffic through the front (the loadgen contract:
    arrivals on a clock, shedding is a measurement); prompts are drawn
    from ``vocab_size`` token ids (default :data:`DEMO_MODEL`'s)."""

    def __init__(self, front, rate, max_new_tokens=6,
                 prompt_len_range=(1, 4), deadline_s=None, seed=0,
                 vocab_size=None):
        self.front = front
        self.rate = float(rate)
        self.max_new_tokens = int(max_new_tokens)
        self.lo, self.hi = prompt_len_range
        self.deadline_s = deadline_s
        self.vocab_size = int(vocab_size or DEMO_MODEL['vocab_size'])
        self._rng = np.random.RandomState(seed)
        self._stop = threading.Event()
        self._handles = []
        self._hlock = threading.Lock()
        self.offered = 0
        self.shed_submit = 0
        self.served = 0
        self.shed_result = 0
        self.errors = 0
        self.tokens = 0
        self._threads = []

    def _submit_loop(self):
        t0 = time.monotonic()
        i = 0
        while not self._stop.is_set():
            target = t0 + i / self.rate
            delay = target - time.monotonic()
            if delay > 0:
                time.sleep(min(delay, 0.05))
                continue
            i += 1
            n = self._rng.randint(self.lo, self.hi + 1)
            prompt = self._rng.randint(0, self.vocab_size, size=n)
            self.offered += 1
            try:
                h = self.front.submit(
                    prompt, self.max_new_tokens,
                    deadline=(None if self.deadline_s is None
                              else time.monotonic() + self.deadline_s))
            except OverloadError:
                self.shed_submit += 1
                continue
            with self._hlock:
                self._handles.append(h)

    def _resolve_loop(self):
        while True:
            with self._hlock:
                h = self._handles.pop(0) if self._handles else None
            if h is None:
                if self._stop.is_set():
                    return
                time.sleep(0.01)
                continue
            try:
                toks = h.result(timeout=120.0)
                self.served += 1
                self.tokens += len(toks)
            except OverloadError:
                self.shed_result += 1
            except Exception:
                self.errors += 1

    def start(self):
        for fn in (self._submit_loop, self._resolve_loop):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=150.0)

    def stats(self):
        return {'offered': self.offered, 'served': self.served,
                'shed_submit': self.shed_submit,
                'shed_result': self.shed_result,
                'errors': self.errors, 'tokens': self.tokens}


def _spawn_all(kwargs_list):
    """``SubprocessReplica.spawn`` of every replica at once (their boots
    overlap); the first failure closes the others and raises."""
    results = [None] * len(kwargs_list)

    def boot(i):
        try:
            results[i] = SubprocessReplica.spawn(**kwargs_list[i])
        except BaseException as e:
            results[i] = e

    threads = [threading.Thread(target=boot, args=(i,), daemon=True)
               for i in range(len(kwargs_list))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300.0)   # spawn's own boot_timeout ends it first
    errors = [r if r is not None else TimeoutError('a replica boot hung')
              for r in results
              if r is None or isinstance(r, BaseException)]
    if errors:
        for r in results:
            if isinstance(r, SubprocessReplica):
                r.close()
        raise errors[0]
    return results


def _demo_main(args):
    """The default CLI mode: the whole train-to-serve loop in one
    invocation (module docstring).  The scenario verdicts live in
    ``fleet_ledger.jsonl`` and the summary JSON on stdout; exit 0, 1 when
    the replica supervisor aborted, 2 with no valid snapshot, 3 when a
    roll timed out."""
    from chainermn_tpu_torch.telemetry.slo import default_slos
    from chainermn_tpu_torch.training import recovery
    if args.device == 'cpu':
        torch.set_num_threads(max(1, min(2, torch.get_num_threads())))
    _chaos.maybe_install_from_env()   # the controller's swap_kill
    _telemetry.enable()
    config, policy = MODELS[args.model]
    out = args.out
    ckpt_dir = args.ckpt_dir or os.path.join(out, 'ckpt')
    os.makedirs(out, exist_ok=True)
    if recovery.latest_snapshot(ckpt_dir)[1] is None:
        demo_train(ckpt_dir, steps=args.boot_steps,
                   snapshot_every=args.boot_steps, config=config,
                   device=args.device)
    kind, path, it = recovery.latest_snapshot(ckpt_dir)
    if path is None:
        print('fleet: no valid snapshot under %s' % ckpt_dir,
              file=sys.stderr)
        return 2
    slos = default_slos(ttft_s=args.slo_ttft_s,
                        intertoken_s=args.slo_intertoken_s)
    judge = CanaryJudge(latency_ratio=args.latency_ratio,
                        latency_floor_ms=args.latency_floor_ms,
                        shed_delta=args.shed_delta,
                        min_events=args.min_events)
    worker_out = os.path.join(out, 'telemetry')
    if args.local:
        engine_kw = _policy_kw(policy)
        controller = build_local_fleet(
            ckpt_dir, out, n_replicas=args.replicas, n_slots=args.n_slots,
            max_prompt_len=args.max_prompt_len, max_queue=args.max_queue,
            slos=slos, canary_fraction=args.canary_fraction, judge=judge,
            canary_seconds=args.canary_seconds,
            judge_interval=args.judge_interval,
            drain_timeout=args.drain_timeout, watcher=None,
            journal=args.recover, engine_kw=engine_kw, config=config,
            device=args.device)
        controller.watcher.debounce_s = args.debounce
        spawn_fn = local_respawn_fn(
            n_slots=args.n_slots, max_prompt_len=args.max_prompt_len,
            max_queue=args.max_queue, slos=slos, engine_kw=engine_kw,
            config=config, device=args.device)
    else:
        spawn_kw = dict(n_slots=args.n_slots,
                        max_prompt_len=args.max_prompt_len,
                        max_queue=args.max_queue, model=args.model,
                        device=args.device)
        replicas = _spawn_all([dict(
            name='replica-%d' % i, snapshot=path, version=it, out=out,
            replica_chaos=args.replica_chaos, replica_index=i,
            worker_out=(os.path.join(worker_out, 'replica-%d' % i)
                        if args.recover else None), **spawn_kw)
            for i in range(args.replicas)])
        front = FleetFront(
            replicas, current_version=it,
            canary_fraction=args.canary_fraction,
            journal=(RequestJournal(os.path.join(out, JOURNAL_NAME))
                     if args.recover else None))
        controller = FleetController(
            front, ckpt_dir, out, boot=(path, it),
            watcher=CheckpointWatcher(ckpt_dir, debounce_s=args.debounce,
                                      start_after=it),
            judge=judge, canary_seconds=args.canary_seconds,
            judge_interval=args.judge_interval,
            drain_timeout=args.drain_timeout)
        # a respawned worker never inherits the one-shot @N kill (its
        # occurrence counters restart), but * rules stay, so that a crash
        # loop keeps crashing into the restart policy's abort
        respawn_chaos = strip_oneshot_kills(args.replica_chaos)

        def spawn_fn(name, path, version, index):
            return SubprocessReplica.spawn(
                name, path, version, out, replica_chaos=respawn_chaos,
                replica_index=index,
                worker_out=os.path.join(worker_out, name), **spawn_kw)
    controller.start()
    supervisor = None
    if args.recover:
        supervisor = ReplicaSupervisor(
            controller, spawn_fn=spawn_fn, degradation=DegradationPolicy(),
            worker_out=worker_out).start()
    stop_ctl = threading.Event()
    ctl_thread = threading.Thread(target=controller.run, args=(stop_ctl,),
                                  daemon=True)
    ctl_thread.start()
    traffic = _TrafficGen(
        controller.front, rate=args.rate,
        max_new_tokens=args.max_new_tokens,
        prompt_len_range=(1, args.traffic_prompt_max or args.max_prompt_len),
        seed=args.seed, vocab_size=config['vocab_size']).start()
    rc = 0
    try:
        # the train half: each round of SGD steps ends in a snapshot the
        # watcher picks up and rolls under the live traffic above
        for k in range(args.rolls):
            demo_train(ckpt_dir, steps=args.steps_per_roll,
                       snapshot_every=args.steps_per_roll, config=config,
                       device=args.device)
            target = it + (k + 1) * args.steps_per_roll
            deadline = time.monotonic() + args.roll_timeout
            while time.monotonic() < deadline:
                if (controller.last_handled_version is not None
                        and controller.last_handled_version >= target):
                    break
                time.sleep(0.1)
            else:
                print('fleet: roll of iteration %d timed out' % target,
                      file=sys.stderr)
                rc = 3
                break
        t_end = time.monotonic() + args.duration
        while time.monotonic() < t_end:
            if supervisor is not None and supervisor.aborted:
                break
            time.sleep(0.05)
    finally:
        traffic.stop()   # before supervisor.stop(): outstanding handles
        if supervisor is not None:   # may need a recovery
            supervisor.stop()
        stop_ctl.set()
        ctl_thread.join(timeout=60.0)
        summary = controller.complete(traffic=traffic.stats())
        controller.close()
    payload = {k: summary[k] for k in
               ('version', 'promotes', 'rollbacks', 'swap_failures',
                'dropped_during_swap', 'traffic')}
    if supervisor is not None:
        payload['recovery'] = supervisor.describe()
        if supervisor.aborted:
            rc = 1
    print(json.dumps(payload, sort_keys=True, default=repr))
    return rc


def main(argv=None):
    p = argparse.ArgumentParser(
        prog='python -m chainermn_tpu_torch.serving.fleet',
        description='train-to-serve continuous deployment: live weight '
                    'hot-swap, canary admission, SLO-gated rollback, '
                    'replica self-healing')
    p.add_argument('--replica', action='store_true',
                   help='internal: run as a replica worker')
    p.add_argument('--name', default='replica-0')
    p.add_argument('--port', type=int, default=0)
    p.add_argument('--snapshot', default=None)
    p.add_argument('--version', type=int, default=0)
    p.add_argument('--parent-pid', type=int, default=0)
    p.add_argument('--device', default=None,
                   help="where the trainer and the replicas run ('cpu', "
                        "'cuda:0'; default: the current CUDA device, and "
                        'an error on a machine without one)')
    p.add_argument('--model', choices=sorted(MODELS), default='demo',
                   help='demo: the tiny f32 LM; serve: the full-width '
                        'serving LM (vocab 32000, d 512, 8 heads, 6 '
                        'layers, d_ff 2048, max_len 512) served in bf16')
    p.add_argument('--out', default='result/fleet')
    p.add_argument('--ckpt-dir', default=None,
                   help='checkpoint chain to watch (default OUT/ckpt, '
                        'demo-trained when empty)')
    p.add_argument('--replicas', type=int, default=2)
    p.add_argument('--local', action='store_true',
                   help='in-process replicas instead of subprocesses')
    p.add_argument('--rolls', type=int, default=1,
                   help='new snapshots the inline trainer writes (0: no '
                        'training, just boot/converge/serve)')
    p.add_argument('--boot-steps', type=int, default=2)
    p.add_argument('--steps-per-roll', type=int, default=2)
    p.add_argument('--roll-timeout', type=float, default=300.0)
    p.add_argument('--duration', type=float, default=2.0,
                   help='extra serving seconds after the last roll')
    p.add_argument('--rate', type=float, default=30.0)
    p.add_argument('--max-new-tokens', type=int, default=6)
    p.add_argument('--n-slots', type=int, default=2)
    p.add_argument('--max-prompt-len', type=int, default=4)
    p.add_argument('--max-queue', type=int, default=64)
    p.add_argument('--canary-fraction', type=float, default=0.5)
    p.add_argument('--canary-seconds', type=float, default=3.0)
    p.add_argument('--judge-interval', type=float, default=0.3)
    p.add_argument('--latency-ratio', type=float, default=1.5)
    p.add_argument('--latency-floor-ms', type=float, default=20.0)
    p.add_argument('--shed-delta', type=float, default=0.05)
    p.add_argument('--min-events', type=int, default=6)
    p.add_argument('--slo-ttft-s', type=float, default=1.0)
    p.add_argument('--slo-intertoken-s', type=float, default=0.25)
    p.add_argument('--drain-timeout', type=float, default=60.0)
    p.add_argument('--debounce', type=float, default=0.3)
    p.add_argument('--replica-chaos', default=None,
                   help='CHAINERMN_TPU_CHAOS handout to replica '
                        'subprocesses (e.g. serve_slow=*:0.3 -- the '
                        'regression only bites on a swapped version; '
                        'replica_kill=@N:IDX hard-kills replica IDX at '
                        'its Nth decode tick)')
    p.add_argument('--recover', action='store_true',
                   help='arm the crash-safe request journal and the '
                        'ReplicaSupervisor self-healing loop (exact-replay '
                        'requeue + respawn + degradation ladder)')
    p.add_argument('--traffic-prompt-max', type=int, default=None,
                   help='cap demo-traffic prompt length below '
                        '--max-prompt-len so recovery continuations '
                        '(prompt + emitted tokens) still fit the prefill '
                        'window')
    p.add_argument('--worker-out', default=None,
                   help='internal: replica worker telemetry capture dir '
                        '(set by the controller under --recover)')
    p.add_argument('--seed', type=int, default=0)
    args = p.parse_args(argv)
    if args.replica:
        return _replica_main(args)
    return _demo_main(args)


if __name__ == '__main__':
    sys.exit(main())
