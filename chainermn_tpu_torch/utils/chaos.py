"""Seeded, deterministic fault injection for the distributed stack.

Elastic-training systems earn trust by BREAKING themselves on purpose:
inject a fault deterministically, watch the recovery layer absorb it,
assert the run still converges.  This module is that injector for the
port -- the counterpart of ``chainermn_tpu/utils/chaos.py`` (the same
spec grammar, sites, seeds and occurrence logs, so one spec replays the
same faults in either package), of the detectors in
:mod:`chainermn_tpu_torch.utils.failure` and of the recovery layer in
:mod:`chainermn_tpu_torch.training.recovery`.

Wired in here: the training sites (``on_step`` at the top of
``StandardUpdater.update_core``, ``corrupt_batch`` where the updater
collates a batch), the channel sites (``maybe_install_from_env`` when a
communicator is built; ``before_send`` / ``duplicate_send`` in
``send_obj``, ``on_recv`` in ``recv_obj``, ``before_kv_wait`` before the
store waits of ``recv_obj`` and ``barrier``, ``extra_collectives`` in
``allreduce_obj``), the checkpoint sites (``on_checkpoint_write`` /
``corrupt_checkpoint`` in ``serializers.save_npz``) and the data sites
(``on_data_read`` / ``corrupt_record`` in ``data.ShardReader.read``).
The serving sites' hooks (``on_serve_submit``, ``on_serve_cancel``,
``on_swap``, ``on_serve_slow``, ``on_replica_kill``,
``on_serve_longprompt``) are ported as functions; wiring them into
``serving/`` comes with the serving fleet (ROADMAP.md item 9).

Design constraints:

- **Zero cost when off.**  Every hook first checks the module-global
  ``_active`` against ``None`` (one attribute load + identity check);
  no spec parsing, no rng, no environment reads happen on the hot
  path of a chaos-free run.
- **Deterministic under a fixed seed.**  Each site owns a
  ``random.Random`` seeded from ``(seed, crc32(site))`` -- NOT
  Python's per-process salted ``hash`` -- so two processes (or two
  runs) given the same spec replay the identical fault sequence.
  This is what lets the SIGTERM-mid-step scenario fire on every rank
  at the same iteration, making the collective checkpoint coherent.
- **Env/flag activated.**  ``CHAINERMN_TPU_CHAOS`` holds a spec
  string; :func:`maybe_install_from_env` (called when a communicator
  is built) installs it once per process.

Spec grammar (items separated by ``;``)::

    seed=INT                 rng seed (default 0)
    rank=INT                 restrict the whole spec to this
                             process's rank (default: all)
    SITE=WHEN[:ARG]          one fault rule

    WHEN := '@' i,j,...      fire at these 0-based occurrences of SITE
          | 'p' FLOAT        fire with this probability per occurrence
          | '*'              fire every occurrence
    ARG  := FLOAT            site-specific (delay seconds, burst
                             length, exit code)

Sites (the action is part of the site name):

==================  ====================================================
``drop_send``       the eager-p2p publish attempt fails (transient
                    store error); ``send_obj``'s bounded backoff loop
                    must retry it through
``delay_send``      sleep ARG (default 0.05 s) before the publish
``dup_send``        publish the message key twice (at-least-once
                    delivery duplicate)
``stall_kv``        sleep ARG (default 0.2 s) before each KV-store
                    wait slice (slow/contended coordination service)
``nan_batch``       poison the first ARG (default 1) elements of the
                    next host batch's first floating array with NaN --
                    the gradients of that step become NaN (divergence
                    burst for NanGuard integration)
``sigterm_step``    deliver SIGTERM to this process at the start of
                    update_core occurrence N (preemption mid-step)
``kill_step``       hard-kill (``os._exit(ARG or 42)``) at the start
                    of update_core occurrence N
``hang_step``       hang this process at the start of update_core
                    occurrence N: sleep ARG (default 3600) seconds
                    with the main thread wedged -- heartbeat files
                    keep getting fresh timestamps but the iteration
                    freezes, exactly the livelock a supervisor's
                    progress watch (not a time-based stall probe)
                    must catch and escalate
``kill_recv``       hard-kill at recv_obj call occurrence N (receiver
                    death mid-conversation)
``ckpt_kill``       hard-kill (``os._exit(ARG or 43)``) BETWEEN a
                    checkpoint's temp-file write and its atomic
                    rename -- the crash-mid-write case; the final
                    file must never appear and the previous snapshot
                    must survive intact
``ckpt_stall``      sleep ARG (default 0.5 s) BETWEEN a checkpoint's
                    temp-file fsync and its atomic rename -- a slow
                    or contended disk mid-commit.  Under the async
                    checkpoint writer the stall lands on the
                    BACKGROUND committer thread, so the training step
                    path must stay flat (p99 pinned) while the commit
                    completes late; under a synchronous handler the
                    same stall lands squarely in the step time --
                    exactly the cadence-vs-step-cost trade async
                    checkpointing removes
``slice_loss``      hard-kill (``os._exit(45)``) every process whose
                    failure-domain slice (``CHAINERMN_TPU_SLICE``
                    env; the supervisor's per-rank handout for
                    ``MeshPlan.create(slices=)`` topologies) equals
                    the rule ARG (default slice 0) at the start of
                    update_core occurrence N -- a whole ICI slice
                    dropping off the DCN at once.  Processes outside
                    the target slice never consult the occurrence
                    counter, so survivors record no chaos event and
                    the supervisor must classify the correlated
                    deaths as ONE slice-granularity failure and
                    shrink by whole slices, never splitting one
``ckpt_truncate``   truncate the just-committed checkpoint file to
                    ARG (default 0.5) of its size -- torn write /
                    filesystem loss; verification must reject it
``ckpt_flip``       XOR-flip ARG (default 8) evenly-spaced bytes of
                    the just-committed checkpoint -- silent bit rot;
                    crc verification must reject it
``serve_burst``     amplify a serving-queue submission: enqueue ARG
                    (default 4) extra synthetic copies of the
                    request -- a traffic spike the bounded queue must
                    absorb or SHED with a typed ``OverloadError``,
                    never wedge on (``serving/``)
``serve_cancel``    expire ARG (default 1) in-flight generation
                    requests' deadlines at a decode step -- the
                    mid-generation cancellation path: the request is
                    answered with a typed ``OverloadError``
                    (reason=deadline) and its cache slot is freed for
                    refill at the NEXT decode step, never leaked
                    (``serving/generate.py``)
``swap_kill``       hard-kill (``os._exit(ARG or 44)``) the fleet
                    controller at a weight-swap point of a rolling
                    deployment -- occurrence 0 is the canary swap,
                    occurrence k the k-th replica swap of the roll --
                    leaving the fleet MID-ROLL with replicas on mixed
                    parameter versions; a restarted fleet must
                    converge every replica to one consistent version
                    and record it in ``fleet_ledger.jsonl``
                    (``serving/fleet.py``)
``serve_slow``      sleep ARG (default 0.05) seconds before each
                    serve execution on an engine whose parameters
                    were HOT-SWAPPED to a version other than the one
                    it booted with -- models a latency regression
                    shipped by a roll: in an A/B fleet only the
                    canary replica slows down, the incumbents (still
                    at their boot version) never consult the rule,
                    and a rollback (swap back to the boot version)
                    restores full speed.  The canary gate's
                    breach-then-rollback scenario is driven by
                    exactly this site
``serve_longprompt``  inject ARG (default 3) EXTRA max-length prompts
                    into the open-loop generation arrival stream at
                    one arrival point -- a burst of worst-case
                    prefill work landing mid-window: a monolithic
                    prefill engine stalls every live sequence's next
                    token behind the long prompts' compute (windowed
                    inter-token SLO burn), while chunked prefill
                    (``prefill_chunk``) interleaves the same work
                    with decode ticks and holds the SLO
                    (``serving/loadgen.py``)
``replica_kill``    hard-kill (``os._exit(46)``) the engine-replica
                    WORKER process whose replica index
                    (``CHAINERMN_TPU_REPLICA`` env, or the index the
                    caller passes to ``on_replica_kill``) equals the
                    rule ARG (default replica 0) at the start of
                    DECODE tick N (live slots only, so the victim
                    always dies with generations in flight) -- an
                    UNPLANNED replica death mid-decode.  Processes
                    outside the target replica never consult the
                    occurrence counter (the ``slice_loss`` idiom), so
                    survivors record no chaos event; the fleet front
                    must detect the death typed
                    (``failure.ReplicaDeadError``), requeue every
                    journaled in-flight generation as an exact-greedy
                    continuation on a survivor, and respawn the
                    worker (``serving/fleet.py``)
``data_stall``      sleep ARG (default 0.05) seconds before a shard
                    record read (``data/recordio.py``)
                    -- a slow/contended filesystem; the loader's
                    prefetch depth must hide it, and the telemetry
                    report's input-bound line must surface it when
                    it cannot
``data_corrupt``    XOR-flip ARG (default 4) spread bytes of a just-
                    read record payload BEFORE its crc check -- bit
                    rot on the data path; the reader must reject it
                    with a typed ``failure.DataCorruptError``
                    (kind=crc, shard+offset named) and the loader
                    must skip-and-count it, never silently consume
``extra_collective``  record ARG (default 1) PHANTOM eager collective
                    span(s) after an ``allreduce_obj`` rendezvous:
                    the per-rank eager ``seq`` counter advances and
                    the span lands in the telemetry capture, but no
                    peer participates -- this rank's recorded
                    collective stream diverges while the run itself
                    completes.  Combine with ``rank=N`` to model the
                    classic SPMD bug (a Python branch on rank issuing
                    an extra collective); the doctor's
                    protocol-divergence verdict must replay the
                    capture and name the divergence point
==================  ====================================================

Example -- drop the first publish, delay half the rest, stall the
store, SIGTERM at step 3::

    CHAINERMN_TPU_CHAOS='seed=7;drop_send=@0;delay_send=p0.5:0.02;
                         stall_kv=p0.5:0.05;sigterm_step=@3'

(one line in a real environment; wrapped here for width)
"""

import os
import signal
import time
import zlib

ENV_VAR = 'CHAINERMN_TPU_CHAOS'

SITES = ('drop_send', 'delay_send', 'dup_send', 'stall_kv',
         'nan_batch', 'sigterm_step', 'kill_step', 'hang_step',
         'kill_recv', 'ckpt_kill', 'ckpt_truncate', 'ckpt_flip',
         'ckpt_stall', 'slice_loss',
         'serve_burst', 'serve_cancel', 'swap_kill', 'serve_slow',
         'data_stall', 'data_corrupt', 'extra_collective',
         'serve_longprompt', 'replica_kill')

#: environment variable naming this process's failure-domain slice
#: (the supervisor's per-rank handout; MeshPlan.create(slices=)
#: builds the matching mesh axis).  ``slice_loss`` consults it.
SLICE_ENV_VAR = 'CHAINERMN_TPU_SLICE'

#: environment variable naming this process's serving-replica index
#: (the fleet controller's per-worker handout).  ``replica_kill``
#: consults it (or the index passed to :func:`on_replica_kill`).
REPLICA_ENV_VAR = 'CHAINERMN_TPU_REPLICA'


def slice_id():
    """This process's slice index from :data:`SLICE_ENV_VAR`, or
    None when the run declares no slice topology."""
    v = os.environ.get(SLICE_ENV_VAR)
    if v in (None, ''):
        return None
    return int(v)


class InjectedFault(RuntimeError):
    """Raised by the injector to model a transient failure (e.g. a
    dropped publish).  The message carries 'UNAVAILABLE' so generic
    transient-error classifiers treat it as retryable, which is the
    point: recovery code must survive it without special-casing."""

    def __init__(self, site, occurrence):
        super().__init__(
            'UNAVAILABLE (chaos: injected %s at occurrence %d)'
            % (site, occurrence))
        self.site = site
        self.occurrence = occurrence


class Rule:
    __slots__ = ('site', 'prob', 'at', 'always', 'arg')

    def __init__(self, site, prob=None, at=None, always=False, arg=None):
        self.site = site
        self.prob = prob
        self.at = at
        self.always = always
        self.arg = arg


def parse_spec(spec):
    """``(seed, rank, {site: Rule})`` from a spec string (grammar in
    the module docstring).  Raises ValueError on malformed items so a
    typo'd env var fails loudly at install, not silently mid-run."""
    seed, rank, rules = 0, None, {}
    for item in filter(None, (s.strip() for s in spec.split(';'))):
        name, _, rhs = item.partition('=')
        name = name.strip()
        if name == 'seed':
            seed = int(rhs)
            continue
        if name == 'rank':
            rank = int(rhs)
            continue
        if name not in SITES:
            raise ValueError('chaos spec: unknown site %r (one of %s)'
                             % (name, '/'.join(SITES)))
        when, _, argtxt = rhs.partition(':')
        when = when.strip()
        rule = Rule(name, arg=float(argtxt) if argtxt else None)
        if when.startswith('@'):
            rule.at = frozenset(int(x) for x in when[1:].split(','))
        elif when.startswith('p'):
            rule.prob = float(when[1:])
            if not 0.0 <= rule.prob <= 1.0:
                raise ValueError('chaos spec: probability %r out of '
                                 '[0,1]' % when)
        elif when == '*':
            rule.always = True
        else:
            raise ValueError(
                'chaos spec: bad WHEN %r for %s (use @i,j / pFLOAT / *)'
                % (when, name))
        rules[name] = rule
    return seed, rank, rules


class FaultInjector:
    """Deterministic per-site fault scheduler.

    ``fires(site)`` advances that site's occurrence counter and
    returns the matching :class:`Rule` when the fault fires (else
    ``None``).  ``log`` records every decision as
    ``(site, occurrence, fired)`` -- the determinism tests replay two
    injectors and assert identical logs.
    """

    def __init__(self, spec='', seed=None):
        import random
        pseed, self.rank, self.rules = parse_spec(spec)
        self.seed = pseed if seed is None else seed
        self.spec = spec
        self._counts = {}
        self._rngs = {
            site: random.Random(
                (self.seed & 0xffffffff) * 1000003
                + zlib.crc32(site.encode()))
            for site in self.rules}
        self.log = []

    def fires(self, site):
        rule = self.rules.get(site)
        if rule is None:
            return None
        idx = self._counts.get(site, 0)
        self._counts[site] = idx + 1
        if rule.prob is not None:
            hit = self._rngs[site].random() < rule.prob
        elif rule.at is not None:
            hit = idx in rule.at
        else:
            hit = rule.always
        self.log.append((site, idx, hit))
        if hit:
            # emit the injection into the telemetry timeline so a
            # fault and its latency consequences (retry spans, typed
            # timeouts, checkpoint writes) correlate in one place.
            # Lazy import: chaos must stay importable standalone, and
            # the kill/exit sites flush below before the process dies.
            from chainermn_tpu_torch import telemetry
            if telemetry._active is not None:
                telemetry.event('chaos:' + site, kind='chaos',
                                occurrence=idx, arg=rule.arg)
                if site in ('kill_step', 'kill_recv', 'ckpt_kill',
                            'hang_step', 'swap_kill', 'slice_loss',
                            'replica_kill'):
                    # os._exit skips atexit: flush the timeline AND
                    # drop the crash-safe flight record NOW, or the
                    # fatal injection is invisible post-mortem
                    # (dump_flight flushes internally and never
                    # raises).  hang_step dumps too: the hung process
                    # usually ends SIGKILLed by the supervisor, and
                    # the flight record is what lets the post-mortem
                    # name the wedged rank among the frozen ones.
                    telemetry.dump_flight('chaos:' + site,
                                          occurrence=idx)
        return rule if hit else None

    def counts(self):
        return dict(self._counts)


# ----------------------------------------------------------------------
# Module-level activation (the zero-cost-when-off switch)
# ----------------------------------------------------------------------

_active = None
_env_checked = False


def active():
    """The installed :class:`FaultInjector`, or None."""
    return _active


def install(injector):
    global _active
    _active = injector
    return injector


def uninstall():
    global _active, _env_checked
    _active, _env_checked = None, False


def strip_sites(spec, sites):
    """``spec`` minus the rules for ``sites`` (``seed=``/``rank=``
    and every other rule preserved textually; unknown site names in
    ``sites`` are ignored).

    The supervisor's already-delivered-fault accounting: a
    deterministic one-shot fault (``kill_step=@3``) that a dead
    attempt consumed must NOT be re-delivered to the relaunched pod
    -- per-process occurrence counters restart from zero in a new
    process, so without stripping, every restart replays the same
    death and no restart policy can converge.  The supervisor learns
    *which* site fired from the victim's flight record
    (``chaos:<site>``) and hands the remaining spec to the next
    attempt: the environment replays WITHOUT the fault that was
    already delivered, exactly like a real one-off preemption."""
    sites = set(sites)
    kept = []
    for item in filter(None, (s.strip() for s in spec.split(';'))):
        if item.partition('=')[0].strip() in sites:
            continue
        kept.append(item)
    return ';'.join(kept)


def maybe_install_from_env(env_var=ENV_VAR):
    """Install an injector from ``CHAINERMN_TPU_CHAOS`` once per
    process (no-op when unset, already checked, or the spec's
    ``rank=`` does not match this process)."""
    global _env_checked
    if _active is not None or _env_checked:
        return _active
    _env_checked = True
    spec = os.environ.get(env_var)
    if not spec:
        return None
    inj = FaultInjector(spec)
    if inj.rank is not None:
        from chainermn_tpu_torch.utils.failure import process_index
        if process_index() != inj.rank:
            return None
    return install(inj)


# ----------------------------------------------------------------------
# Hook points (called from communicators/base.py, training/updater.py,
# serializers.py and data/recordio.py)
# Every hook is a no-op returning instantly when no injector is
# installed; call sites additionally guard on ``chaos._active is not
# None`` so the off path costs one attribute load.
# ----------------------------------------------------------------------

def before_send():
    """p2p publish hooks: ``delay_send`` sleeps, ``drop_send`` raises
    :class:`InjectedFault` (the bounded-retry loop in ``send_obj``
    must absorb it)."""
    inj = _active
    if inj is None:
        return
    r = inj.fires('delay_send')
    if r is not None:
        time.sleep(r.arg if r.arg is not None else 0.05)
    r = inj.fires('drop_send')
    if r is not None:
        raise InjectedFault('drop_send', inj._counts['drop_send'] - 1)


def duplicate_send():
    """True when the just-published message should be published again
    (at-least-once duplicate)."""
    inj = _active
    return inj is not None and inj.fires('dup_send') is not None


def before_kv_wait():
    """``stall_kv``: sleep before a KV-store wait slice."""
    inj = _active
    if inj is None:
        return
    r = inj.fires('stall_kv')
    if r is not None:
        time.sleep(r.arg if r.arg is not None else 0.2)


def on_recv():
    """``kill_recv``: hard-kill this process at a recv_obj call."""
    inj = _active
    if inj is None:
        return
    r = inj.fires('kill_recv')
    if r is not None:
        os._exit(int(r.arg) if r.arg is not None else 42)


def on_step(iteration):
    """Per-train-step hooks: ``sigterm_step`` (graceful preemption --
    the handler checkpoints and stops), ``kill_step`` (hard kill) and
    ``hang_step`` (wedge the main thread; the heartbeat daemon keeps
    the liveness file fresh while the iteration freezes -- only a
    progress-based watcher catches it)."""
    inj = _active
    if inj is None:
        return
    r = inj.fires('sigterm_step')
    if r is not None:
        os.kill(os.getpid(), signal.SIGTERM)
    r = inj.fires('kill_step')
    if r is not None:
        os._exit(int(r.arg) if r.arg is not None else 42)
    r = inj.fires('hang_step')
    if r is not None:
        time.sleep(r.arg if r.arg is not None else 3600.0)
    # slice_loss: membership gate BEFORE the occurrence counter --
    # survivors outside the target slice must not advance it (their
    # step cadence may differ post-shrink) and must record no chaos
    # event, so the post-mortem sees correlated deaths only on the
    # lost slice.
    rule = inj.rules.get('slice_loss')
    if rule is not None:
        target = int(rule.arg) if rule.arg is not None else 0
        if slice_id() == target and inj.fires('slice_loss') is not None:
            os._exit(45)


def on_checkpoint_write(tmp_path):
    """``ckpt_kill``: hard-kill this process BETWEEN writing a
    checkpoint's temp file and the atomic rename -- the mid-write
    crash.  With tmp+rename discipline the final filename never
    appears, so the previous snapshot must remain the resume point
    (``tests/test_chaos.py`` pins exactly that)."""
    inj = _active
    if inj is None:
        return
    r = inj.fires('ckpt_kill')
    if r is not None:
        os._exit(int(r.arg) if r.arg is not None else 43)
    # ckpt_stall: a slow/contended disk mid-commit.  Landing between
    # fsync and rename means the stalled snapshot is invisible to
    # chain_heads()/CheckpointWatcher for the whole stall -- and under
    # the async writer the sleep is on the background committer, so
    # the step path must not feel it.
    r = inj.fires('ckpt_stall')
    if r is not None:
        time.sleep(r.arg if r.arg is not None else 0.5)
    del tmp_path  # reserved for future partial-write faults


def corrupt_checkpoint(path):
    """``ckpt_truncate`` / ``ckpt_flip``: damage the just-committed
    checkpoint file in place (AFTER the atomic rename -- the file is
    "complete" on disk, so only content verification can reject it).

    ``ckpt_truncate``: keep only ARG (default 0.5) of the bytes.
    ``ckpt_flip``: XOR ARG (default 8) bytes spread evenly across
    the file -- deterministic, so tests replay the identical bit
    rot, and dense enough that at least one flip always lands in a
    checked region (a single flip can disappear into npz alignment
    padding).
    """
    inj = _active
    if inj is None:
        return
    r = inj.fires('ckpt_truncate')
    if r is not None:
        frac = r.arg if r.arg is not None else 0.5
        size = os.path.getsize(path)
        with open(path, 'r+b') as f:
            f.truncate(max(0, int(size * frac)))
        return
    r = inj.fires('ckpt_flip')
    if r is not None:
        n = max(1, int(r.arg) if r.arg is not None else 8)
        size = os.path.getsize(path)
        if size == 0:
            return
        with open(path, 'r+b') as f:
            for i in range(n):
                off = min(size - 1, (size * (i + 1)) // (n + 1))
                f.seek(off)
                byte = f.read(1)
                f.seek(off)
                f.write(bytes([byte[0] ^ 0xFF]))


def on_serve_submit():
    """``serve_burst``: the number of EXTRA synthetic copies of the
    incoming request the serving queue should enqueue (0 = no burst).
    The queue enqueues them through its normal bounded admission path,
    so a burst past capacity exercises the typed-shed contract, not a
    special case."""
    inj = _active
    if inj is None:
        return 0
    r = inj.fires('serve_burst')
    if r is None:
        return 0
    return max(1, int(r.arg) if r.arg is not None else 4)


def extra_collectives():
    """``extra_collective``: the number of PHANTOM eager collective
    spans ``allreduce_obj`` should record after the real rendezvous
    (0 = none).  The phantom advances this rank's per-(name, tag)
    eager ``seq`` counter and is recorded like a real collective, but
    no cross-process rendezvous happens -- the run completes while
    this rank's captured protocol stream gains ops its peers never
    issued, which is exactly the divergence ``telemetry doctor``'s
    protocol-divergence replay (``commcheck.verify_streams``) must
    name."""
    inj = _active
    if inj is None:
        return 0
    r = inj.fires('extra_collective')
    if r is None:
        return 0
    return max(1, int(r.arg) if r.arg is not None else 1)


def on_swap(phase=None):
    """``swap_kill``: hard-kill THIS process at a fleet weight-swap
    point.  The fleet controller calls this immediately before each
    replica swap of a roll (occurrence 0 = the canary swap), so a
    fired site leaves the fleet mid-roll with replicas on MIXED
    parameter versions -- the exact wreckage the restart-convergence
    contract (one consistent version, recorded in the ledger) must
    clean up.  ``phase`` is advisory (span labeling by the caller);
    the occurrence counter, not the phase, decides firing."""
    inj = _active
    if inj is None:
        return
    r = inj.fires('swap_kill')
    if r is not None:
        os._exit(int(r.arg) if r.arg is not None else 44)
    del phase


def on_serve_slow(swapped):
    """``serve_slow``: sleep before one serve execution, but ONLY on
    an engine serving a hot-swapped parameter version (``swapped``
    True: ``param_version != `` the version the engine booted with).
    Engines at their boot version never consult the rule -- which is
    what lets one process-wide spec slow exactly the canary replica
    of an in-process A/B fleet, and lets a rollback restore speed."""
    inj = _active
    if inj is None or not swapped:
        return
    r = inj.fires('serve_slow')
    if r is not None:
        time.sleep(r.arg if r.arg is not None else 0.05)


def replica_index():
    """This process's serving-replica index from
    :data:`REPLICA_ENV_VAR`, or None when the process serves no
    replica role."""
    v = os.environ.get(REPLICA_ENV_VAR)
    if v in (None, ''):
        return None
    return int(v)


def on_replica_kill(index=None):
    """``replica_kill``: hard-kill (``os._exit(46)``) THIS process at
    the start of a generation-engine DECODE tick, but ONLY when
    its replica index equals the rule ARG (default replica 0).  The
    ``slice_loss`` idiom: the membership gate runs BEFORE the
    occurrence counter, so non-target replicas never advance it (their
    tick cadence differs) and record no chaos event -- the post-mortem
    sees exactly one unplanned death, and the fleet front must requeue
    the victim's journaled in-flight generations on the survivors.

    ``index`` overrides :data:`REPLICA_ENV_VAR` (in-process fleets
    have no per-process env to consult)."""
    inj = _active
    if inj is None:
        return
    rule = inj.rules.get('replica_kill')
    if rule is None:
        return
    target = int(rule.arg) if rule.arg is not None else 0
    me = replica_index() if index is None else index
    if me == target and inj.fires('replica_kill') is not None:
        os._exit(46)


def on_serve_longprompt():
    """``serve_longprompt``: the number of EXTRA max-length synthetic
    prompts the open-loop generator should inject at this arrival
    point (0 = none).  The burst arrives through the queue's normal
    bounded admission, so what it really tests is the ENGINE's
    prefill scheduling: monolithic prefill serializes the long
    prompts' compute ahead of every live sequence's next token
    (inter-token SLO burn), chunked prefill interleaves it."""
    inj = _active
    if inj is None:
        return 0
    r = inj.fires('serve_longprompt')
    if r is None:
        return 0
    return max(1, int(r.arg) if r.arg is not None else 3)


def on_serve_cancel():
    """``serve_cancel``: the number of in-flight generation requests
    whose deadlines the generation engine should force-expire at this
    decode step (0 = none).  The engine routes the cancellation
    through its NORMAL deadline-expiry path -- typed
    ``OverloadError(reason='deadline')`` to the client, slot freed for
    refill at the next step -- so the chaos site exercises the real
    cancellation machinery, not a special case."""
    inj = _active
    if inj is None:
        return 0
    r = inj.fires('serve_cancel')
    if r is None:
        return 0
    return max(1, int(r.arg) if r.arg is not None else 1)


def on_data_read():
    """``data_stall``: sleep before one shard record read (a slow or
    contended filesystem on the input path)."""
    inj = _active
    if inj is None:
        return
    r = inj.fires('data_stall')
    if r is not None:
        time.sleep(r.arg if r.arg is not None else 0.05)


def corrupt_record(payload):
    """``data_corrupt``: XOR-flip ARG (default 4) evenly-spaced bytes
    of a just-read record payload BEFORE the reader's crc check --
    silent bit rot on the data path, which the crc must catch and
    type as ``DataCorruptError(kind='crc')``.  Returns the (possibly
    new) payload; never mutates the caller's bytes."""
    inj = _active
    if inj is None:
        return payload
    r = inj.fires('data_corrupt')
    if r is None or not payload:
        return payload
    n = max(1, int(r.arg) if r.arg is not None else 4)
    blob = bytearray(payload)
    size = len(blob)
    for i in range(n):
        off = min(size - 1, (size * (i + 1)) // (n + 1))
        blob[off] ^= 0xFF
    return bytes(blob)


def corrupt_batch(arrays):
    """``nan_batch``: poison the first ARG elements of the first
    floating array of a host batch (tuple/list of numpy arrays) --
    the resulting gradients are a NaN burst.  Returns the (possibly
    new) batch; never mutates the caller's arrays.  A column that is a
    torch tensor (the updater collates a policy's bf16 columns as CPU
    tensors) stays one."""
    inj = _active
    if inj is None:
        return arrays
    r = inj.fires('nan_batch')
    if r is None:
        return arrays
    import numpy as np
    import torch
    n = max(1, int(r.arg) if r.arg is not None else 1)
    out, poisoned = [], False
    for a in arrays:
        if isinstance(a, torch.Tensor):
            if not poisoned and a.is_floating_point():
                a = a.clone()
                a.view(-1)[:n] = float('nan')
                poisoned = True
            out.append(a)
            continue
        arr = np.asarray(a)
        if not poisoned and arr.dtype.kind == 'f':
            arr = np.array(arr, copy=True)
            arr.reshape(-1)[:n] = np.nan
            poisoned = True
        out.append(arr)
    return tuple(out) if isinstance(arrays, tuple) else out
