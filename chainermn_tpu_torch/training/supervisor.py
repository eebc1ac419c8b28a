"""Self-healing training: the single-host worker supervisor.

Counterpart of ``chainermn_tpu/training/supervisor.py``: the same policy
surface, ledger (``supervisor_ledger.jsonl``), handout variables
(``CMN_SUP_*``), per-attempt files (``workers/a<N>-rank<R>.json``,
``logs/``, ``live/a<N>/heartbeat-<R>.json``, ``telemetry/a<N>/``) and exit
codes, so either package's tools read the other's runs.  A launcher
that kills the whole world when one rank dies leaves recovery to a
human; this module is the loop that recovers unattended:

1. **spawn** N worker processes with ``subprocess`` (a negative return
   code is a signal), each with the ``CMN_SUP_*`` handout: its rank, the
   world size, a fresh rendezvous port per attempt (``torch.distributed``
   at ``tcp://127.0.0.1:<CMN_SUP_PORT>``), the output, live and telemetry
   directories, and a per-rank log;
2. **watch** exit codes and heartbeat progress (:class:`StallWatch`: a
   stale file, or fresh beats whose iteration froze);
3. **classify** the failure (:func:`classify_failure`): the typed exit
   code (:func:`~chainermn_tpu_torch.utils.failure.classify_exit`, which
   :func:`worker_main` produces) cross-checked against the telemetry
   doctor (:func:`~chainermn_tpu_torch.telemetry.diagnosis.
   quick_verdict`: dead ranks, flight-record reasons such as
   ``chaos:kill_step``);
4. **decide** (:class:`RestartPolicy`): restart at N or shrink to M (the
   relaunched workers ``auto_resume`` the shared checkpoint directory,
   resharding ZeRO-1 state N -> M), on a backoff schedule, within a
   restart budget, aborting a crash loop; a hang is escalated SIGTERM ->
   grace -> SIGKILL (:func:`escalate`);
5. **record** every step in the append-only ledger: cause, doctor
   verdict, world size before and after, resumed step, each recovery's
   downtime and the MTTR.

A chaos fault the doctor names as an attempt's cause (``kill_step``) is
stripped from the next attempt's spec (:func:`chaos.strip_sites`): a
one-shot fault models a one-off event, not one that fires on every
relaunch.

``python -m chainermn_tpu_torch.supervisor`` is the CLI; with no command
it supervises :func:`demo_worker`, a topology-independent ZeRO-1 MLP
whose trajectory is the same at any world size, so a run killed at 3
processes and resumed at 2 ends where the uninterrupted oracle does.
The policy surface takes injectable clocks and process tables, so the
decision engine is tested without processes.
"""

import collections
import datetime
import json
import os
import socket
import subprocess
import sys
import time

from chainermn_tpu_torch.telemetry import diagnosis
from chainermn_tpu_torch.utils import chaos, failure
from chainermn_tpu_torch.utils.ledger import Ledger  # noqa: F401

#: environment handout to supervised workers (the CMN_SUP_* contract)
ENV_RANK = 'CMN_SUP_RANK'
ENV_NPROCS = 'CMN_SUP_NPROCS'
ENV_PORT = 'CMN_SUP_PORT'
ENV_OUT = 'CMN_SUP_OUT'
ENV_ATTEMPT = 'CMN_SUP_ATTEMPT'
ENV_STEPS = 'CMN_SUP_STEPS'
ENV_CKPT_EVERY = 'CMN_SUP_CKPT_EVERY'
ENV_LIVE = 'CMN_SUP_LIVE'
#: devices per process: 1 (each process drives one device; a value
#: above 1, the JAX package's virtual CPU devices, has no meaning here)
ENV_LOCAL_DEVICES = 'CMN_SUP_LOCAL_DEVICES'
ENV_ORACLE = 'CMN_SUP_ORACLE'
#: the workers' device: ``cpu`` (gloo) or ``cuda`` (NCCL, one GPU a
#: process); unset, the worker takes the card
ENV_DEVICE = 'CMN_SUP_DEVICE'
#: number of failure-domain slices in the handout (the worker builds
#: ``MeshPlan.create(slices=N)`` when > 1); each rank additionally
#: receives its own slice id in ``chaos.SLICE_ENV_VAR``
ENV_SLICES = 'CMN_SUP_SLICES'

LEDGER_NAME = 'supervisor_ledger.jsonl'

#: variables a worker must not inherit: the telemetry directory (each
#: attempt gets its own) and a launcher's rendezvous (the handout is the
#: contract)
_SCRUBBED = ('CHAINERMN_TPU_TELEMETRY', 'RANK', 'WORLD_SIZE', 'LOCAL_RANK',
             'LOCAL_WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT')

#: causes for which losing the culprit's capacity is the likely truth
#: (machine loss / wedge), so coming back SMALLER beats waiting for a
#: rank that will not return.  State failures (corrupt checkpoint,
#: divergence) and plain timeouts restart at full size: the fleet is
#: fine, the state or the network hiccuped.
SHRINK_CAUSES = frozenset({'killed', 'hang', 'peer_dead', 'crash'})


def _free_port():
    s = socket.socket()
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ----------------------------------------------------------------------
# policy engine (pure logic; fake-clock testable)
# ----------------------------------------------------------------------

Decision = collections.namedtuple(
    'Decision', ['action', 'nprocs', 'delay', 'reason',
                 'granularity'])
Decision.__new__.__defaults__ = ('rank',)
Decision.__doc__ += (
    ': the policy verdict for one failure.  action is '
    "'restart' | 'shrink' | 'abort'; nprocs the next world size; "
    'delay the backoff sleep before relaunch (seconds); granularity '
    "is 'rank' (the default) or 'slice' when the lost unit was a "
    'whole failure-domain slice.')


class RestartPolicy:
    """Restart-vs-shrink-vs-abort decisions with a restart budget, a
    crash-loop window and a deterministic backoff schedule.

    - ``max_restarts``: total relaunches this supervisor may spend.
    - ``crash_threshold`` failures within ``crash_window`` seconds is
      a crash loop: the run is aborted -- retrying a failure that
      reproduces instantly (checkpoint corrupted on every restart,
      broken binary) only burns the budget and hides the bug.
    - shrink: when the ``cause`` is in ``shrink_causes`` and a
      specific culprit rank is known, relaunch at ``nprocs - dead``
      (never below ``min_procs``); the workers' elastic
      ``auto_resume`` does the N->M state reshard.
    - ``backoff``: a :class:`~chainermn_tpu_torch.utils.failure.Backoff`
      whose ``next()`` paces relaunches (reset on :meth:`on_success`).

    ``clock`` is injectable so the window arithmetic unit-tests with
    a fake clock and no sleeping.
    """

    def __init__(self, max_restarts=8, min_procs=1, crash_window=300.0,
                 crash_threshold=3, backoff=None, shrink_causes=None,
                 clock=time.monotonic):
        if min_procs < 1:
            raise ValueError('min_procs must be >= 1')
        self.max_restarts = max_restarts
        self.min_procs = min_procs
        self.crash_window = crash_window
        self.crash_threshold = crash_threshold
        self.backoff = backoff if backoff is not None else failure.Backoff(
            initial=0.5, factor=2.0, max_delay=30.0)
        self.shrink_causes = (SHRINK_CAUSES if shrink_causes is None
                              else frozenset(shrink_causes))
        self._clock = clock
        self._failures = []  # detection times, monotonic
        self.restarts = 0

    def describe(self):
        """Ledger-serializable policy parameters."""
        return {'max_restarts': self.max_restarts,
                'min_procs': self.min_procs,
                'crash_window_s': self.crash_window,
                'crash_threshold': self.crash_threshold,
                'backoff_delays_s': self.backoff.delays(4),
                'shrink_causes': sorted(self.shrink_causes)}

    def on_failure(self, cause, nprocs, dead_ranks=(),
                   granularity='rank', slice_size=1):
        """The :class:`Decision` for one classified failure of a
        ``nprocs``-wide attempt.  Order of precedence: crash-loop
        abort, budget abort, shrink, restart.

        One CALL is one incident: a whole-slice loss hands all its
        member ranks in ``dead_ranks`` but charges the crash-loop
        window exactly ONE failure -- counting correlated deaths
        ``world_size`` times would abort on the first slice loss.

        ``slice_size`` (ranks per failure-domain slice, from the
        supervisor's topology) makes shrink slice-aligned: the next
        world size is rounded DOWN to a multiple of it, so a shrink
        never splits a slice.  ``granularity`` annotates the decision
        (``'rank'`` | ``'slice'``) for the ledger."""
        now = self._clock()
        self._failures.append(now)
        recent = [t for t in self._failures
                  if now - t <= self.crash_window]
        if len(recent) >= self.crash_threshold:
            return Decision(
                'abort', nprocs, 0.0,
                'crash_loop: %d failures within %.0fs window '
                '(threshold %d)' % (len(recent), self.crash_window,
                                    self.crash_threshold),
                granularity)
        if self.restarts >= self.max_restarts:
            return Decision(
                'abort', nprocs, 0.0,
                'restart_budget: %d restarts already spent'
                % self.restarts, granularity)
        self.restarts += 1
        delay = self.backoff.next()
        dead = sorted(set(dead_ranks))
        if cause in self.shrink_causes and dead:
            shrunk = nprocs - len(dead)
            unit = 'rank(s)'
            if slice_size > 1:
                # never split a slice: a sliced mesh only builds at a
                # multiple of the slice width
                shrunk -= shrunk % slice_size
                if granularity == 'slice':
                    unit = 'slice (%d rank(s))' % len(dead)
            if shrunk >= self.min_procs:
                return Decision(
                    'shrink', shrunk, delay,
                    'cause %r lost %s %s: elastic shrink %d -> '
                    '%d' % (cause, unit, dead, nprocs, shrunk),
                    granularity)
            return Decision(
                'restart', nprocs, delay,
                'cause %r lost %s %s but shrink would go below '
                'min_procs=%d: restart at %d'
                % (cause, unit, dead, self.min_procs, nprocs),
                granularity)
        return Decision(
            'restart', nprocs, delay,
            'cause %r is not capacity loss (or no culprit named): '
            'restart at %d' % (cause, nprocs), granularity)

    def on_success(self):
        """A healthy attempt completed: the backoff schedule resets
        (the next failure, if any, is a fresh incident)."""
        self.backoff.reset()


# ----------------------------------------------------------------------
# liveness: heartbeat progress watch + hang escalation
# ----------------------------------------------------------------------

class StallWatch:
    """Progress watcher over per-rank heartbeat files.

    Two stall signals, because two distinct deaths exist:

    - **stale file** -- the heartbeat *timestamp* stopped advancing:
      the beat thread is dead (process frozen hard or gone).  This is
      plain :func:`~chainermn_tpu_torch.utils.failure.detect_stall`.
    - **frozen iteration** -- the file keeps getting fresh timestamps
      (the daemon thread beats on) but ``iteration`` stopped moving:
      the MAIN thread is wedged (a hung collective, chaos
      ``hang_step``).  Only this progress probe catches it.

    Startup handling without call-site special-casing: a missing file
    inside ``startup_grace`` reads as alive (``missing='alive'``),
    after it as stalled; an iteration that has NEVER advanced (first
    compile, resume, oracle replay) is startup too, judged only after
    the grace -- but an iteration that advanced and then froze for
    ``stall_timeout`` is a hang immediately, grace or not.

    A final beat stamped ``stopped: true`` (clean ``Heartbeat.stop``)
    exempts the rank: exiting is not stalling.
    """

    def __init__(self, live_dir, ranks, stall_timeout=30.0,
                 startup_grace=180.0, clock=time.monotonic):
        self.live_dir = live_dir
        self.ranks = list(ranks)
        self.stall_timeout = stall_timeout
        self.startup_grace = startup_grace
        self._clock = clock
        self._t0 = clock()
        self._seen = {}   # rank -> (iteration, t_changed)
        self._first = {}  # rank -> first observed iteration
        #: monotonic time of the first observed iteration ADVANCE on
        #: any rank -- the supervisor's downtime-ends marker
        self.first_progress_t = None

    def _path(self, rank):
        return os.path.join(self.live_dir,
                            'heartbeat-%d.json' % rank)

    def poll(self):
        """Ranks currently judged stalled (possibly empty)."""
        now = self._clock()
        in_grace = (now - self._t0) <= self.startup_grace
        stalled = []
        for r in self.ranks:
            beat = failure.read_heartbeat(self._path(r))
            if beat is None:
                if failure.detect_stall(
                        self._path(r), self.stall_timeout, now=now,
                        missing='alive' if in_grace else 'stalled'):
                    stalled.append(r)
                continue
            # record progress BEFORE the stopped check: a fast worker
            # can advance and stop between two polls, and its final
            # (stopped) beat is then the only evidence the advance
            # happened -- the downtime accounting must not lose it
            it = beat.get('iteration', 0)
            prev = self._seen.get(r)
            advanced = prev is not None and it != prev[0]
            if prev is None or advanced:
                self._seen[r] = (it, now)
                self._first.setdefault(r, it)
                if advanced and self.first_progress_t is None:
                    self.first_progress_t = now
            if beat.get('stopped'):
                continue  # clean shutdown in progress, not a stall
            if prev is None or advanced:
                continue
            progressed = it != self._first.get(r, it)
            frozen = (now - prev[1]) > self.stall_timeout
            stale = (now - beat.get('time', 0)) > self.stall_timeout
            if stale and not in_grace:
                stalled.append(r)
            elif frozen and (progressed or not in_grace):
                stalled.append(r)
        return stalled


class ProcTable:
    """Thin facade over ``{rank: Popen}`` -- :func:`escalate` talks to
    THIS protocol (``live_ranks`` / ``terminate`` / ``kill``) so the
    escalation-ordering unit tests drive a fake table instead of real
    processes."""

    def __init__(self, procs):
        self._procs = dict(procs)

    def live_ranks(self):
        return [r for r, p in sorted(self._procs.items())
                if p.poll() is None]

    def terminate(self, rank):
        try:
            self._procs[rank].terminate()
        except OSError:  # already reaped
            pass

    def kill(self, rank):
        try:
            self._procs[rank].kill()
        except OSError:
            pass


def escalate(table, term_grace, clock=time.monotonic,
             sleep=time.sleep, poll_interval=0.1):
    """The hang-escalation ladder, in the only defensible order:
    SIGTERM every live worker first (a responsive one checkpoints via
    its PreemptionHandler and exits ``EXIT_PREEMPTED`` -- state
    saved), wait up to ``term_grace`` seconds for voluntary exits,
    then SIGKILL only what is still alive.  Returns the ordered
    action log ``[('sigterm', rank), ..., ('sigkill', rank), ...]``
    the units assert on: no kill before every term, no kill inside
    the grace, no kill for a worker that left on its own."""
    log = []
    for r in table.live_ranks():
        table.terminate(r)
        log.append(('sigterm', r))
    deadline = clock() + term_grace
    while table.live_ranks() and clock() < deadline:
        sleep(poll_interval)
    for r in table.live_ranks():
        table.kill(r)
        log.append(('sigkill', r))
    return log


# ----------------------------------------------------------------------
# classification: exit codes cross-checked against the doctor
# ----------------------------------------------------------------------

def classify_failure(first_death, rank_rcs, doctor=None,
                     hang_ranks=()):
    """One ``(cause, culprit_rank, details)`` verdict for a failed
    attempt.

    First classifier: the typed exit-code taxonomy
    (:func:`~chainermn_tpu_torch.utils.failure.classify_exit`) on the FIRST
    worker observed dead -- in a synchronous pod the first corpse is
    the cause and every later death its echo.  Second: the telemetry
    doctor's verdict, which can (a) corroborate (``doctor_agrees``),
    (b) refine a generic ``crash``/``signal`` into ``killed`` with
    the injected chaos site named (from the victim's flight record,
    written BEFORE it died), and (c) re-attribute a survivor's
    ``peer_dead`` exit to the rank it accused.  ``hang_ranks``
    short-circuits to cause ``'hang'`` -- those deaths were inflicted
    by the supervisor's own escalation, so their exit codes prove
    nothing; the culprit is whoever's flight record says it wedged.

    Causes: ``killed`` | ``hang`` | ``preempted`` | ``divergence`` |
    ``checkpoint_corrupt`` | ``channel_timeout`` | ``peer_dead`` |
    ``uncaught`` | ``crash`` | ``clean``.
    """
    details = {
        'rank_exit_codes': {int(r): rc for r, rc in rank_rcs.items()},
        'exit_classes': {int(r): failure.classify_exit(rc)
                         for r, rc in rank_rcs.items()},
    }
    flights = {}
    chaos_fired = {}  # rank -> ['chaos:<site>', ...] from the events
    doctor_dead = []
    if doctor is not None:
        crash = doctor.get('crash') or {}
        for r, info in (crash.get('per_rank') or {}).items():
            reason = (info or {}).get('flight_reason')
            if reason:
                flights[int(r)] = str(reason)
            ev = (info or {}).get('chaos_events')
            if ev:
                chaos_fired[int(r)] = [str(x) for x in ev]
        doctor_dead = [int(r) for r in
                       (doctor.get('verdict') or {}).get(
                           'dead_ranks') or []]
        details['doctor_dead_ranks'] = doctor_dead
        details['doctor_summary'] = (doctor.get('verdict') or {}).get(
            'summary')

    # only sites whose firing is itself the attempt-terminal event
    # may be blamed (and later stripped) from the event history; a
    # benign fired site (delay_send, ckpt_flip) must never be
    # mistaken for the cause of death
    terminal = ('chaos:kill_step', 'chaos:kill_recv',
                'chaos:ckpt_kill', 'chaos:sigterm_step',
                'chaos:hang_step', 'chaos:slice_loss')

    def chaos_site_of(rank):
        # the flight record keeps only the LAST dump's reason (a
        # later sigterm/typed dump overwrites a chaos one), so fall
        # back to the rank's append-only chaos-event history
        reason = flights.get(rank, '')
        if reason.startswith('chaos:'):
            return reason.split(':', 1)[1]
        for name in chaos_fired.get(rank, ()):
            if name in terminal:
                return name.split(':', 1)[1]
        return None

    def fired_hang(rank):
        return (flights.get(rank, '').startswith('chaos:hang')
                or any(n.startswith('chaos:hang')
                       for n in chaos_fired.get(rank, ())))

    if hang_ranks:
        details['hang_ranks'] = sorted(hang_ranks)
        culprit = next((r for r in sorted(set(flights) | set(
            chaos_fired)) if fired_hang(r)), None)
        if culprit is None and len(doctor_dead) == 1:
            culprit = doctor_dead[0]
        if culprit is None and len(hang_ranks) == 1:
            # one frozen rank, the rest alive: unambiguous
            culprit = next(iter(hang_ranks))
        if culprit is not None:
            site = chaos_site_of(culprit)
            if site:
                details['chaos_site'] = site
            details['doctor_agrees'] = (culprit in doctor_dead
                                        if doctor_dead else None)
        return 'hang', culprit, details

    rank, rc = first_death
    culprit = int(rank)
    cause = failure.classify_exit(rc)
    if cause.startswith('signal:'):
        details['signal'] = cause.split(':', 1)[1]
        cause = 'killed'
    if cause == 'peer_dead' and doctor_dead:
        # the exiting worker was a SURVIVOR naming a corpse: blame the
        # corpse the doctor corroborates, not the messenger
        culprit = doctor_dead[0]
        cause = 'killed'
    site = chaos_site_of(culprit)
    if site:
        details['chaos_site'] = site
        if cause in ('crash', 'killed', 'uncaught'):
            cause = 'killed'
    details['doctor_agrees'] = (culprit in doctor_dead
                                if doctor_dead else None)
    return cause, culprit, details


#: exit classes that read as a HARD death (machine loss / injected
#: kill) for slice-domain accounting; 'preempted' and 'peer_dead'
#: exits are echoes -- survivors evacuating, not lost capacity
_HARD_EXITS = frozenset({'crash', 'killed', 'uncaught'})


def slice_verdict(culprit, rank_rcs, ranks_per_slice, doctor_dead=(),
                  forced=()):
    """``(granularity, dead_ranks)`` for a failed attempt on a sliced
    topology: the escalation from "rank R died" to "slice S died".

    A rank counts dead when the doctor names it or its exit class is
    a hard death (``crash``/``killed``/``uncaught``/``signal:*``) --
    survivors that left through SIGTERM evacuation (``preempted``) or
    a typed ``peer_dead`` are messengers, not corpses, and ranks in
    ``forced`` (SIGKILLed by the supervisor's OWN escalation) prove
    nothing either way.  When every member of the culprit's slice --
    or of any slice -- is dead, the verdict is
    ``('slice', all member ranks of every fully-dead slice)``: the
    restart policy then shrinks by whole slices in ONE decision.  Any
    partial-slice death stays ``('rank', [culprit])`` -- a sliced
    mesh cannot run a fractional slice, but the policy's
    slice-aligned rounding handles that, and the ledger should not
    claim a slice died when it did not."""
    if not ranks_per_slice or ranks_per_slice <= 1:
        return 'rank', ([int(culprit)] if culprit is not None else [])
    forced = set(int(r) for r in forced)
    dead = set(int(r) for r in doctor_dead)
    if culprit is not None:
        dead.add(int(culprit))
    for r, rc in rank_rcs.items():
        cls = failure.classify_exit(rc)
        if int(r) in forced:
            continue
        if cls in _HARD_EXITS or cls.startswith('signal:'):
            dead.add(int(r))
    by_slice = {}
    for r in dead:
        by_slice.setdefault(r // ranks_per_slice, set()).add(r)
    whole = sorted(s for s, members in by_slice.items()
                   if len(members) >= ranks_per_slice)
    if whole:
        ranks = sorted(r for s in whole
                       for r in range(s * ranks_per_slice,
                                      (s + 1) * ranks_per_slice))
        return 'slice', ranks
    return 'rank', ([int(culprit)] if culprit is not None else [])


# ----------------------------------------------------------------------
# the supervisor
# ----------------------------------------------------------------------

class Supervisor:
    """Spawn-watch-classify-decide-resume-record, in a loop, until
    the workers finish cleanly or the policy aborts.

    ``worker_argv=None`` supervises the built-in :func:`demo_worker`
    (re-invoking ``python -m chainermn_tpu_torch.supervisor --worker``);
    any other command list is launched per rank with the ``CMN_SUP_*``
    environment handout and inherits the same watching/restart loop
    (hang detection engages when the command writes heartbeat files
    into ``$CMN_SUP_LIVE``).

    :meth:`run` returns the supervisor's own exit code: 0 (training
    completed), 1 (aborted by policy: budget exhausted or crash
    loop).
    """

    def __init__(self, nprocs, out, worker_argv=None, steps=6,
                 ckpt_every=2, policy=None, local_devices=1,
                 stall_timeout=30.0, startup_grace=180.0,
                 term_grace=10.0, drain_grace=5.0,
                 attempt_timeout=900.0, poll_interval=0.25,
                 oracle=True, python=None, env=None,
                 clock=time.monotonic, sleep=time.sleep,
                 slices=None, device=None):
        if nprocs < 1:
            raise ValueError('nprocs must be >= 1')
        if slices is not None:
            if slices < 1 or nprocs % slices:
                raise ValueError(
                    'slices must divide nprocs (%d procs, %d slices)'
                    % (nprocs, slices))
        self.slices = slices
        #: ranks per failure-domain slice -- FIXED for the whole run
        #: (an elastic shrink removes whole slices, never resizes one)
        self.ranks_per_slice = (nprocs // slices
                                if slices else None)
        self.nprocs = nprocs
        self.out = out
        self.worker_argv = list(worker_argv) if worker_argv else None
        self.steps = steps
        self.ckpt_every = ckpt_every
        self.policy = policy if policy is not None else RestartPolicy()
        self.local_devices = local_devices
        self.stall_timeout = stall_timeout
        self.startup_grace = startup_grace
        self.term_grace = term_grace
        self.drain_grace = drain_grace
        self.attempt_timeout = attempt_timeout
        self.poll_interval = poll_interval
        self.oracle = oracle
        self.device = device
        self._python = python or sys.executable
        self._env = dict(os.environ if env is None else env)
        self._clock = clock
        self._sleep = sleep
        self.ledger = None

    # -- paths ---------------------------------------------------------

    def _worker_json(self, attempt, rank):
        return os.path.join(self.out, 'workers',
                            'a%d-rank%d.json' % (attempt, rank))

    def _read_resumed(self, attempt):
        try:
            with open(self._worker_json(attempt, 0)) as f:
                return json.load(f).get('resumed_at')
        except (OSError, ValueError):
            return None

    # -- the loop ------------------------------------------------------

    def run(self):
        os.makedirs(self.out, exist_ok=True)
        self.ledger = Ledger(os.path.join(self.out, LEDGER_NAME))
        chaos_spec = self._env.get(chaos.ENV_VAR) or None
        self.ledger.append('start', nprocs=self.nprocs, out=self.out,
                           steps=self.steps, chaos=chaos_spec,
                           worker=(self.worker_argv or 'demo'),
                           slices=self.slices,
                           ranks_per_slice=self.ranks_per_slice,
                           policy=self.policy.describe())
        nprocs, attempt = self.nprocs, 0
        downtimes = []
        last_fail_t = None
        while True:
            res = self._run_attempt(attempt, nprocs, chaos_spec,
                                    last_fail_t, downtimes)
            if res['status'] == 'ok':
                self.policy.on_success()
                mttr = (round(sum(downtimes) / len(downtimes), 3)
                        if downtimes else None)
                self.ledger.append(
                    'complete', attempt=attempt, world_size=nprocs,
                    restarts=self.policy.restarts,
                    resumed_step=self._read_resumed(attempt),
                    rank_exit_codes=res['rank_rcs'],
                    total_downtime_s=round(sum(downtimes), 3),
                    mttr_s=mttr)
                return 0
            cause, culprit, details = res['verdict']
            granularity = 'rank'
            dead = [culprit] if culprit is not None else []
            if self.ranks_per_slice and self.ranks_per_slice > 1:
                forced = [r for act, r in (res.get('escalation') or ())
                          if act == 'sigkill']
                granularity, dead = slice_verdict(
                    culprit, res['rank_rcs'], self.ranks_per_slice,
                    doctor_dead=details.get('doctor_dead_ranks') or (),
                    forced=forced)
            self.ledger.append('failure', attempt=attempt,
                               world_size=nprocs, cause=cause,
                               rank=culprit, granularity=granularity,
                               dead_ranks=dead, **details)
            decision = self.policy.on_failure(
                cause, nprocs, dead_ranks=dead,
                granularity=granularity,
                slice_size=self.ranks_per_slice or 1)
            self.ledger.append(
                'decision', attempt=attempt, action=decision.action,
                world_before=nprocs, world_after=decision.nprocs,
                delay_s=round(decision.delay, 3),
                reason=decision.reason,
                granularity=decision.granularity,
                restarts_used=self.policy.restarts)
            if decision.action == 'abort':
                self.ledger.append('abort', attempt=attempt,
                                   cause=cause,
                                   reason=decision.reason,
                                   restarts=self.policy.restarts)
                return 1
            if chaos_spec and details.get('chaos_site'):
                chaos_spec = chaos.strip_sites(
                    chaos_spec, [details['chaos_site']]) or None
            last_fail_t = res['t_detect']
            if decision.delay > 0:
                self._sleep(decision.delay)
            nprocs = decision.nprocs
            attempt += 1

    # -- one attempt ---------------------------------------------------

    def _spawn(self, attempt, nprocs, chaos_spec, port, live, tdir):
        logdir = os.path.join(self.out, 'logs')
        for d in (logdir, live, tdir,
                  os.path.join(self.out, 'workers')):
            os.makedirs(d, exist_ok=True)
        # scrub the previous attempt's chaos / telemetry wiring and a
        # launcher's rendezvous variables: the handout is the contract
        env_base = {k: v for k, v in self._env.items()
                    if k not in _SCRUBBED + (chaos.ENV_VAR,
                                             chaos.SLICE_ENV_VAR)}
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env_base['PYTHONPATH'] = (
            root + os.pathsep + env_base.get('PYTHONPATH', ''))
        common = {
            ENV_NPROCS: str(nprocs), ENV_PORT: str(port),
            ENV_OUT: self.out, ENV_ATTEMPT: str(attempt),
            ENV_STEPS: str(self.steps),
            ENV_CKPT_EVERY: str(self.ckpt_every),
            ENV_LIVE: live,
            ENV_LOCAL_DEVICES: str(self.local_devices),
            ENV_ORACLE: '1' if self.oracle else '0',
            'CHAINERMN_TPU_TELEMETRY': tdir,
        }
        if self.device is not None:
            common[ENV_DEVICE] = str(self.device)
        if self.ranks_per_slice:
            common[ENV_SLICES] = str(nprocs // self.ranks_per_slice)
        if chaos_spec:
            common[chaos.ENV_VAR] = chaos_spec
        argv = self.worker_argv or [
            self._python, '-m', 'chainermn_tpu_torch.supervisor',
            '--worker']
        procs, logs = {}, {}
        for r in range(nprocs):
            env = dict(env_base, **common)
            env[ENV_RANK] = str(r)
            if self.ranks_per_slice:
                env[chaos.SLICE_ENV_VAR] = str(
                    r // self.ranks_per_slice)
            logf = open(os.path.join(
                logdir, 'a%d-rank%d.log' % (attempt, r)), 'ab')
            procs[r] = subprocess.Popen(argv, env=env, stdout=logf,
                                        stderr=subprocess.STDOUT)
            logs[r] = logf
        return procs, logs

    def _run_attempt(self, attempt, nprocs, chaos_spec, last_fail_t,
                     downtimes):
        port = _free_port()
        live = os.path.join(self.out, 'live', 'a%d' % attempt)
        tdir = os.path.join(self.out, 'telemetry', 'a%d' % attempt)
        self.ledger.append('launch', attempt=attempt,
                           world_size=nprocs, port=port,
                           chaos=chaos_spec)
        procs, logs = self._spawn(attempt, nprocs, chaos_spec, port,
                                  live, tdir)
        table = ProcTable(procs)
        watch = StallWatch(live, range(nprocs), self.stall_timeout,
                           self.startup_grace, clock=self._clock)
        t0 = self._clock()
        first_death = None
        t_detect = None
        hang_ranks = ()
        escalation = None
        try:
            while True:
                rcs = {r: p.poll() for r, p in procs.items()}
                live_ranks = [r for r, rc in rcs.items() if rc is None]
                deaths = {r: rc for r, rc in rcs.items()
                          if rc not in (None, 0)}
                if not live_ranks:
                    if not deaths:
                        break  # everyone exited 0
                    if first_death is None:
                        r = min(deaths)
                        first_death = (r, deaths[r])
                        t_detect = self._clock()
                    break
                if first_death is None and deaths:
                    # in a synchronous pod the first corpse is the
                    # cause; min-rank among this poll batch is the
                    # deterministic pick (a single poll interval
                    # cannot order deaths within it)
                    r = min(deaths)
                    first_death = (r, deaths[r])
                    t_detect = self._clock()
                if (first_death is None and not hang_ranks
                        and self._clock() - t0 > self.attempt_timeout):
                    hang_ranks = tuple(live_ranks)
                    t_detect = self._clock()
                    self.ledger.append(
                        'timeout', attempt=attempt,
                        after_s=round(self._clock() - t0, 1))
                if first_death is None and not hang_ranks:
                    stalled = watch.poll()
                    if stalled:
                        hang_ranks = tuple(stalled)
                        t_detect = self._clock()
                if hang_ranks and escalation is None:
                    escalation = escalate(
                        table, self.term_grace, clock=self._clock,
                        sleep=self._sleep)
                elif (first_death is not None and escalation is None
                        and self._clock() - t_detect
                        > self.drain_grace):
                    # one worker died; its peers are wedged in
                    # collectives with no timeout -- drain them
                    escalation = escalate(
                        table, self.term_grace, clock=self._clock,
                        sleep=self._sleep)
                self._sleep(self.poll_interval)
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
            for p in procs.values():
                p.wait()
            for f in logs.values():
                f.close()
        rank_rcs = {r: p.returncode for r, p in procs.items()}
        # one final ingest: the monitor loop breaks the instant every
        # process is gone, which can be BEFORE it read the last
        # (stopped) beats carrying the final iteration advance -- the
        # downtime accounting must see them
        watch.poll()
        if (last_fail_t is not None
                and watch.first_progress_t is not None):
            downtime = watch.first_progress_t - last_fail_t
            downtimes.append(downtime)
            self.ledger.append(
                'recovered', attempt=attempt, world_size=nprocs,
                downtime_s=round(downtime, 3),
                resumed_step=self._read_resumed(attempt))
        if (not hang_ranks
                and all(rc == 0 for rc in rank_rcs.values())):
            return {'status': 'ok', 'rank_rcs': rank_rcs}
        doctor = diagnosis.quick_verdict(tdir, liveness_dirs=(live,))
        verdict = classify_failure(first_death, rank_rcs,
                                   doctor=doctor,
                                   hang_ranks=hang_ranks)
        return {'status': 'failed', 'verdict': verdict,
                't_detect': (t_detect if t_detect is not None
                             else self._clock()),
                'rank_rcs': rank_rcs, 'escalation': escalation}


# ----------------------------------------------------------------------
# worker side: the exit-code wrapper, the handout, the demo trainer
# ----------------------------------------------------------------------

def worker_main(fn, *args, **kwargs):
    """Run ``fn`` under the supervisor's exit-code contract: a typed
    failure leaves with its taxonomy code
    (:func:`~chainermn_tpu_torch.utils.failure.exit_code_for`), a
    ``'preempted'`` return as ``EXIT_PREEMPTED``, anything untyped as
    ``EXIT_UNCAUGHT`` with the traceback on stderr (the per-rank log the
    supervisor keeps).  Never returns."""
    try:
        rv = fn(*args, **kwargs)
    except SystemExit:
        raise
    except KeyboardInterrupt:
        sys.exit(130)
    except BaseException as e:
        import traceback
        traceback.print_exc()
        sys.exit(failure.exit_code_for(e))
    if rv == 'preempted':
        sys.exit(failure.EXIT_PREEMPTED)
    sys.exit(0 if rv in (None, 0, 'ok') else int(rv))


def handout_device():
    """The worker's device from the handout (``CMN_SUP_DEVICE``): the
    CPU, or the card (``cuda:<rank % cards>``, one GPU a process); unset,
    the card (``resolve_device`` raises without one).  Only one device a
    process: ``CMN_SUP_LOCAL_DEVICES`` other than 1 raises."""
    import torch
    from chainermn_tpu_torch.ops._common import resolve_device
    if int(os.environ.get(ENV_LOCAL_DEVICES, '1') or '1') != 1:
        raise ValueError(
            '%s=%s: each process drives one device here' % (
                ENV_LOCAL_DEVICES, os.environ[ENV_LOCAL_DEVICES]))
    want = os.environ.get(ENV_DEVICE) or None
    if want == 'cpu':
        return torch.device('cpu')
    if want not in (None, 'cuda'):
        return resolve_device(want)
    resolve_device(None)  # raises without a card
    rank = int(os.environ.get(ENV_RANK, '0'))
    return torch.device('cuda', rank % torch.cuda.device_count())


def init_process_group(device, timeout=120.0):
    """Join this attempt's world from the handout: ``torch.distributed``
    at ``tcp://127.0.0.1:<CMN_SUP_PORT>`` with ``CMN_SUP_RANK`` and
    ``CMN_SUP_NPROCS``, NCCL for a CUDA device (made current first), gloo
    for the CPU.  Returns ``(rank, nprocs)``."""
    import torch
    import torch.distributed as dist
    rank = int(os.environ[ENV_RANK])
    nprocs = int(os.environ[ENV_NPROCS])
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    dist.init_process_group(
        'nccl' if device.type == 'cuda' else 'gloo',
        init_method='tcp://127.0.0.1:%s' % os.environ[ENV_PORT],
        rank=rank, world_size=nprocs,
        timeout=datetime.timedelta(seconds=timeout))
    return rank, nprocs


#: the demo trainer's global batch rows: the same at every world size it
#: is divided by (1, 2, 3, 4, 6, 8, 12, 24 processes), so the loss
#: trajectory is the same at any world size -- the elastic-resume oracle
#: property (a run killed at 3 processes and resumed at 2 continues the
#: same curve)
DEMO_ROWS = 24


def _build_demo_train(rank, nprocs, comm, device):
    """The topology-independent ZeRO-1 MLP (8 -> 16 -> 16 -> 4, SGD 0.1
    with momentum 0.9, as the JAX package's demo): one fixed seed draws
    the ``DEMO_ROWS`` global batch, each process takes its slice.
    Returns ``(updater, batch)``."""
    import numpy as np
    import torch
    from chainermn_tpu_torch import models, training
    model = models.MLP(n_units=16, n_out=4, n_in=8, device=device)
    upd = training.StandardUpdater(
        iter([]), torch.optim.SGD(model.parameters(), lr=0.1,
                                  momentum=0.9),
        models.classifier_loss(model), model, comm, zero=True)
    rs = np.random.RandomState(1234)  # the same at every world size
    gx = rs.randn(DEMO_ROWS, 8).astype(np.float32)
    gy = (rs.rand(DEMO_ROWS) * 4).astype(np.int32)
    lo = DEMO_ROWS * rank // nprocs
    hi = DEMO_ROWS * (rank + 1) // nprocs
    batch = (torch.as_tensor(gx[lo:hi], device=device),
             torch.as_tensor(gy[lo:hi].astype(np.int64), device=device))
    return upd, batch


def _name_dead_peer(comm, wait):
    """The rank of a peer whose heartbeat stalls within ``wait`` seconds
    (peer liveness armed), else None."""
    deadline = time.monotonic() + wait
    while True:
        for p in range(comm.world_size):
            if comm.peer_state(p) == 'dead':
                return p
        if time.monotonic() > deadline:
            return None
        time.sleep(0.05)


def _demo_step(upd, batch):
    """One ``update_core``; returns the host loss.  When a step fails
    (gloo raises ``RuntimeError`` once a peer's socket closes) and a
    peer's heartbeat stalls within the liveness window, the failure
    becomes a typed
    :class:`~chainermn_tpu_torch.utils.failure.PeerDeadError` naming that
    peer: this process is a survivor, not the cause.  Otherwise the error
    propagates as it was."""
    try:
        metrics = upd.update_core(batch)
    except RuntimeError as e:
        live = upd.comm._liveness
        dead = (_name_dead_peer(upd.comm, live['timeout'] + 1.0)
                if live is not None else None)
        if dead is None:
            raise
        raise failure.PeerDeadError(
            'a collective of iteration %d failed: peer process %d is '
            'dead (%s)' % (upd.iteration, dead, e),
            process_index=dead) from e
    return float(metrics['loss'])


def _param_sum(upd):
    from chainermn_tpu_torch.models.flax_weights import _leaves
    return float(sum(float(leaf.sum()) for _, leaf in _leaves(upd.params)))


def _demo_oracle(rank, nprocs, comm, batch, steps, device):
    """The fixed-topology oracle at THIS world size: a second updater
    stepped ``steps`` times uninterrupted, shielded from chaos (its calls
    must not consume fault occurrences meant for the real run).  Returns
    ``(losses, final parameter sum)``."""
    saved = chaos.active()
    chaos.uninstall()
    try:
        oracle_upd, _ = _build_demo_train(rank, nprocs, comm, device)
        losses = [_demo_step(oracle_upd, batch) for _ in range(steps)]
        psum = _param_sum(oracle_upd)
    finally:
        if saved is not None:
            chaos.install(saved)
    return losses, psum


def write_worker_json(out, attempt, rank, res):
    """``workers/a<attempt>-rank<rank>.json`` (tmp + fsync + rename): what
    the supervisor reads ``resumed_at`` from."""
    d = os.path.join(out, 'workers')
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, 'a%d-rank%d.json' % (attempt, rank))
    tmp = path + '.tmp'
    with open(tmp, 'w') as f:
        json.dump(res, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def demo_worker():
    """The built-in supervised worker (``python -m
    chainermn_tpu_torch.supervisor --worker``): join the world from the
    ``CMN_SUP_*`` handout (:func:`init_process_group`), heartbeat into
    the live directory through the communicator's peer liveness,
    ``auto_resume`` the shared checkpoint directory (elastically when the
    world shrank), train the ZeRO-1 demo with periodic asynchronous
    checkpoints (each waited for, so a resumed step is exact), and leave
    through :func:`worker_main`'s exit codes.

    Two contracts the supervisor leans on, as in the JAX package:

    - a restart that finds snapshots but none valid raises
      :class:`~chainermn_tpu_torch.utils.failure.CheckpointCorruptError`
      (exit 75) instead of training from scratch, so a checkpoint
      corrupted on every restart is a crash loop the policy aborts;
    - ``workers/a<N>-rank<R>.json`` is written early with ``resumed_at``
      and again at the end with the losses, the final iteration, the
      parameter sum and, when ``CMN_SUP_ORACLE=1``, the oracle's.
    """
    import chainermn_tpu_torch as cmt
    from chainermn_tpu_torch import telemetry
    from chainermn_tpu_torch.training import recovery

    device = handout_device()
    rank, nprocs = init_process_group(device)
    out = os.environ[ENV_OUT]
    attempt = int(os.environ.get(ENV_ATTEMPT, '0'))
    steps = int(os.environ.get(ENV_STEPS, '6'))
    ckpt_every = int(os.environ.get(ENV_CKPT_EVERY, '2'))
    live = os.environ.get(ENV_LIVE) or os.path.join(out, 'live')
    want_oracle = os.environ.get(ENV_ORACLE, '1') != '0'
    slices = int(os.environ.get(ENV_SLICES, '0') or '0')

    if slices > 1:
        from chainermn_tpu_torch.parallel import MeshPlan
        comm = MeshPlan.create(slices=slices).communicator()
    else:
        comm = cmt.create_communicator('xla', device=device)
    hb = comm.enable_peer_liveness(live, interval=0.2, stall_timeout=1.0)
    try:
        upd, batch = _build_demo_train(rank, nprocs, comm, device)
        res = {'rank': rank, 'attempt': attempt, 'world_size': nprocs,
               'steps': steps,
               'chaos_spec': os.environ.get(chaos.ENV_VAR)}
        if want_oracle:
            res['oracle'], res['oracle_param_sum'] = _demo_oracle(
                rank, nprocs, comm, batch, steps, device)
        ckdir = os.path.join(out, 'state')
        handler = recovery.PreemptionHandler(upd, out=ckdir, async_=True)
        resumed_at = recovery.auto_resume(upd, ckdir)
        if resumed_at is None and recovery.snapshot_chain(ckdir):
            raise failure.CheckpointCorruptError(
                'restart found snapshots under %s but none valid -- '
                'refusing to train from scratch' % ckdir,
                path=ckdir, kind='crc')
        res['resumed_at'] = resumed_at
        write_worker_json(out, attempt, rank, res)  # early: the ledger
        hb.beat(upd.iteration)
        losses, preempted = [], False
        while upd.iteration < steps:
            losses.append(_demo_step(upd, batch))
            hb.beat(upd.iteration)
            if handler.maybe_checkpoint():
                preempted = True
                break
            if (ckpt_every and upd.iteration < steps
                    and upd.iteration % ckpt_every == 0):
                handler.checkpoint()
                handler.wait()
        res.update(losses=losses, final_iteration=upd.iteration,
                   preempted=preempted, param_sum=_param_sum(upd))
        write_worker_json(out, attempt, rank, res)
    finally:
        hb.stop()
    telemetry.flush()
    return 'preempted' if preempted else None
