"""Communicator base class on ``torch.distributed``.

Counterpart of ``chainermn_tpu/communicators/base.py``.  The JAX
communicator is a mesh-backed object whose collectives run inside a
traced SPMD step; here every process drives one device, as in the
reference ChainerMN, and the collectives are eager ``torch.distributed``
calls: NCCL for CUDA tensors, gloo for CPU tensors.

Correspondence with the JAX package:

- ``rank`` / ``size``   -> process rank / world size (one device each)
- ``inter_size`` / ``intra_size``, ``inter_rank()`` / ``intra_rank()`` /
  ``axis_rank()`` -> the (inter, intra) mesh of processes
  (``mesh_utility``), with an intra-node and an inter-node sub-group
- ``allreduce_grad``    -> mean over all processes, strategy-defined
- ``allreduce(x, op)``  -> metrics and BatchNorm statistics
- ``broadcast_data``    -> root's values to every process
- ``allreduce_obj`` / ``bcast_obj`` -> one scalar / one picklable
  object (the evaluator's collectives)
- ``send_obj`` / ``recv_obj`` / ``barrier`` / ``p2p_gc`` -> the eager
  object channel with bounded waits, over the default group's c10d
  store

Unlike the JAX versions, ``allreduce_grad`` and ``broadcast_data``
update their tensors IN PLACE.

The object channel reaches the default group's store through
``torch.distributed.distributed_c10d._get_default_store()``, a private
function: no public call returns the store a group was made with, and a
store made here could not reach the ranks of a group joined from a
``FileStore`` or a ``HashStore``.

Every wait of the channel is bounded and typed, as in the JAX package:
after :meth:`CommunicatorBase.enable_peer_liveness` a wait on a peer
whose heartbeat went stale raises
:class:`~chainermn_tpu_torch.utils.failure.PeerDeadError`, a wait that
merely expires :class:`~chainermn_tpu_torch.utils.failure.ChannelTimeout`.
The channel's calls record telemetry spans (``barrier`` and
``allreduce_obj`` as ``kind='collective'`` with a per-stream ``seq``,
which the doctor pairs across ranks; ``send_obj`` / ``recv_obj`` as
``kind='p2p'``) and carry the chaos channel sites (``drop_send``,
``delay_send``, ``dup_send``, ``kill_recv``, ``stall_kv``,
``extra_collective``); building a communicator installs the injector
from ``CHAINERMN_TPU_CHAOS`` (:func:`chaos.maybe_install_from_env`).
"""

import datetime
import os
import pickle
import time

import torch
import torch.distributed as dist

from chainermn_tpu_torch import telemetry as _telemetry
from chainermn_tpu_torch.communicators import memory_utility, mesh_utility
from chainermn_tpu_torch.ops._common import resolve_device
from chainermn_tpu_torch.utils import chaos
from chainermn_tpu_torch.utils.failure import (
    Backoff, ChannelTimeout, Deadline, Heartbeat, PeerDeadError,
    detect_stall)

_KEYS = 'chainermn_tpu_torch'

_OPS = {'sum': dist.ReduceOp.SUM, 'mean': dist.ReduceOp.SUM,
        'max': dist.ReduceOp.MAX, 'min': dist.ReduceOp.MIN}


def join_default_group(device=None):
    """``(device, made)``: this process's device (``LOCAL_RANK``'s card
    under ``torchrun`` when none is given) and whether the default group
    was made here.  The group is joined if it exists; else it is made
    from the ``torchrun`` environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``); else it is a world of one.  CUDA
    devices use NCCL and the CPU gloo; a group of the other backend is
    refused."""
    if (device is None and torch.cuda.is_available()
            and 'LOCAL_RANK' in os.environ):
        device = 'cuda:%d' % int(os.environ['LOCAL_RANK'])
    device = resolve_device(device)
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    backend = 'nccl' if device.type == 'cuda' else 'gloo'
    made = False
    if not dist.is_initialized():
        if 'RANK' in os.environ and 'WORLD_SIZE' in os.environ:
            dist.init_process_group(backend, init_method='env://')
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
        made = True
    joined = str(dist.get_backend())
    if backend not in joined:
        raise RuntimeError('the process group uses %r, but device %s needs %r'
                           % (joined, device, backend))
    return device, made


class CommunicatorBase:
    """One process per device, on the default process group.

    The group is joined if it exists; else it is made from the
    ``torchrun`` environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``); else it is a world of one.  CUDA devices use NCCL
    and the CPU uses gloo; a group of the other backend is refused.

    ``reduce_dtype`` (e.g. ``torch.bfloat16``): gradients are cast to it
    before the strategy's reduction and restored after
    (:meth:`allreduce_grad` only).

    Construction ends with one all_reduce of one element over the
    default group, after the sub-groups are made (every rank makes every
    communicator, in the same order).

    ``mesh_shape=(inter, intra)`` lays the processes out as
    ``mesh_utility.resolve_mesh_shape`` does (default: from torchrun's
    ``LOCAL_WORLD_SIZE``); the intra-node and inter-node sub-groups are
    made here, once, by every rank in the same order.
    """

    def __init__(self, device=None, reduce_dtype=None, mesh_shape=None):
        self.device, self._owns_group = join_default_group(device)
        self.reduce_dtype = reduce_dtype
        self.mesh_shape = mesh_utility.resolve_mesh_shape(self.world_size,
                                                          mesh_shape)
        self._intra_group, self._inter_group = self._make_groups()
        # one collective over the default group, by every rank, after the
        # sub-groups: no rank returns while a peer is still connecting
        # them (gloo's connect finishes on one side first; a rank that
        # then exited closed the socket its peer was still reading), and
        # a point-to-point call that leaves a rank out (functions.send in
        # a MultiNodeChainList) is never the group's first, which NCCL's
        # process group requires
        dist.all_reduce(torch.zeros(1, device=self.device))
        # the object channel's key namespace: this communicator's place
        # among the communicators its process made (all ranks make the
        # same communicators in the same order: making the sub-groups
        # above is a collective)
        self._channel = 'c%d' % self._store().add(
            '%s/communicators/%d' % (_KEYS, self.world_rank), 1)
        self._send_seq, self._recv_seq, self._barrier_epochs = {}, {}, {}
        self._p2p_sent = {}
        self._eager_coll_seq = {}
        self._liveness = None
        # env-activated fault injection and telemetry (no-ops unless
        # CHAINERMN_TPU_CHAOS / CHAINERMN_TPU_TELEMETRY are set)
        chaos.maybe_install_from_env()
        _telemetry.maybe_enable_from_env()

    def _make_groups(self):
        """This process's ``(intra group, inter group)`` over
        ``mesh_shape``, made here by every rank in the same order."""
        return mesh_utility.build_groups(*self.mesh_shape, self.world_rank)

    @property
    def size(self):
        return dist.get_world_size()

    @property
    def rank(self):
        return dist.get_rank()

    @property
    def world_size(self):
        """The processes of the default group (``size`` unless a
        subclass counts something else, as ``MeshPlanCommunicator``
        counts data replicas)."""
        return dist.get_world_size()

    @property
    def world_rank(self):
        return dist.get_rank()

    # -- topology (the JAX package's mesh coordinates) ----------------------
    @property
    def inter_size(self):
        return self.mesh_shape[0]

    @property
    def intra_size(self):
        return self.mesh_shape[1]

    def intra_rank(self):
        return self.rank % self.intra_size

    def inter_rank(self):
        return self.rank // self.intra_size

    def axis_rank(self):
        """Global rank on the (inter, intra) mesh: node-major, which is
        ``rank``."""
        return self.inter_rank() * self.intra_size + self.intra_rank()

    def close(self):
        """Destroy the process group if this communicator made it."""
        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self._owns_group = False

    # -- flat-buffer helpers ---------------------------------------------
    def _all_reduce(self, buf, op, group=None):
        """Reduce ``buf`` IN PLACE over ``group`` (default: the world);
        ``'mean'`` divides by the world size.  Returns ``buf``."""
        dist.all_reduce(buf, op=_OPS[op], group=group)
        if op == 'mean':
            buf /= self.world_size
        return buf

    def _reduce_grouped(self, tensors, op):
        """Reduce ``tensors`` with one collective per dtype
        (``memory_utility.fused_reduce``).  Returns new tensors, in
        order."""
        return memory_utility.fused_reduce(
            tensors, lambda buf: self._all_reduce(buf, op))

    # -- collectives -------------------------------------------------------
    def allreduce_grad(self, grads):
        """Mean-allreduce a list of gradient tensors IN PLACE (``None``
        entries are skipped); returns the list."""
        live = [g for g in grads if g is not None]
        if not live:
            return grads
        work = live if self.reduce_dtype is None else [
            g.to(self.reduce_dtype) for g in live]
        reduced = self._allreduce_impl(work)
        with torch.no_grad():
            for g, r in zip(live, reduced):
                if r is not g:
                    g.copy_(r)
        return grads

    def _allreduce_impl(self, tensors):
        """Mean over processes; returns the reduced tensors (may be the
        inputs, reduced in place)."""
        raise NotImplementedError

    def allreduce(self, x, op='mean'):
        """Allreduce a tensor, a list of tensors or a dict of tensors
        (or Python numbers, reduced as f32) over all processes; returns
        new values in the same structure."""
        if op not in _OPS:
            raise ValueError('op must be one of %s, got %r'
                             % (sorted(_OPS), op))
        if isinstance(x, dict):
            keys = list(x)
            vals = self.allreduce([self._as_tensor(x[k]) for k in keys], op)
            return dict(zip(keys, vals))
        if isinstance(x, (list, tuple)):
            return self._reduce_grouped([self._as_tensor(t) for t in x], op)
        return self._reduce_grouped([self._as_tensor(x)], op)[0]

    def _as_tensor(self, v):
        if isinstance(v, torch.Tensor):
            return v.detach()
        return torch.as_tensor(v, dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def broadcast_data(self, params, root=0):
        """Every process receives ``root``'s values, IN PLACE (one
        broadcast per dtype); returns ``params``."""
        params = list(params)
        if not params:
            return params
        groups = {}
        for p in params:
            groups.setdefault(p.dtype, []).append(p)
        for ps in groups.values():
            buf = torch.cat([p.detach().reshape(-1) for p in ps])
            dist.broadcast(buf, src=root)
            offset = 0
            for p in ps:
                n = p.numel()
                p.copy_(buf[offset:offset + n].view(p.shape))
                offset += n
        return params

    # -- object collectives (the evaluator's) -------------------------------
    def allreduce_obj(self, value, op='mean', timeout=None):
        """Allreduce one scalar (a Python number, a numpy scalar or a
        0-d tensor) over all processes, in f64; returns a Python float.
        The reference's pickle-based ``mpi_comm.allreduce`` of a metric
        (``multi_node_evaluator.py:31-38``).  ``timeout`` (seconds)
        bounds the wait: a :meth:`barrier` with that budget runs first,
        so a missing peer raises ``PeerDeadError`` (dead, after
        :meth:`enable_peer_liveness`) or ``ChannelTimeout`` instead of
        blocking the collective for good."""
        if self.world_size == 1:
            return float(self.allreduce(torch.tensor(
                float(value), dtype=torch.float64, device=self.device), op))
        if timeout is not None:
            self.barrier(timeout=timeout, tag='allreduce_obj')
        with _telemetry.span('allreduce_obj', kind='collective', op=op,
                             seq=self._next_eager_seq('allreduce_obj')):
            out = float(self.allreduce(torch.tensor(
                float(value), dtype=torch.float64, device=self.device), op))
        if chaos._active is not None:
            for _ in range(chaos.extra_collectives()):
                # a phantom collective: the span and the seq of a real
                # one, but no peer takes part, so this rank's recorded
                # protocol stream diverges while the run goes on
                with _telemetry.span(
                        'allreduce_obj', kind='collective', op=op,
                        seq=self._next_eager_seq('allreduce_obj')):
                    pass
        return out

    def bcast_obj(self, obj, root=0):
        """Every process receives ``root``'s picklable ``obj``."""
        box = [obj]
        dist.broadcast_object_list(box, src=root, device=self.device)
        return box[0]

    # -- the eager object channel -------------------------------------------
    @staticmethod
    def _store():
        return dist.distributed_c10d._get_default_store()

    @staticmethod
    def _wait_key(store, key, deadline, backoff, between=None):
        """Wait for ``key`` in slices of the backoff schedule, none past
        the deadline; True when it is there, False at the deadline.
        ``between()``, when given, runs after each slice that expired (it
        may raise).  The chaos ``stall_kv`` site sleeps before each slice.
        (A store's timeout is a ``RuntimeError``: ``DistStoreError`` from
        some stores, a plain one from ``FileStore``.)"""
        while True:
            if chaos._active is not None:
                chaos.before_kv_wait()
            try:
                store.wait([key], datetime.timedelta(
                    seconds=deadline.slice(backoff.next())))
                return True
            except RuntimeError:
                if between is not None:
                    between()
                if deadline.expired():
                    return False

    @staticmethod
    def _key_state(store, key):
        """``'present'``, ``'absent'`` (the receiver consumed and deleted
        it) or ``'unknown'`` (the store failed: neither is safe)."""
        try:
            return 'present' if store.check([key]) else 'absent'
        except RuntimeError:
            return 'unknown'

    def _p2p_key(self, channel, src, dest, tag, seq):
        return '%s/p2p/%s/%d/%d/%s/%d' % (_KEYS, channel, src, dest, tag,
                                          seq)

    def _next_eager_seq(self, name):
        """The next sequence number of the eager collective ``name``:
        every process counts the same rendezvous alike, so the doctor
        pairs the spans across ranks by (name, tag, seq)."""
        n = self._eager_coll_seq.get(name, 0)
        self._eager_coll_seq[name] = n + 1
        return n

    # -- peer liveness (heartbeat-backed dead-peer detection) ---------------
    def enable_peer_liveness(self, directory, interval=1.0,
                             stall_timeout=5.0):
        """Start this process's heartbeat under ``directory`` (shared by
        all peers, one ``heartbeat-<rank>.json`` each) and arm dead-peer
        detection: every bounded wait of the channel (:meth:`recv_obj`,
        :meth:`barrier`, :meth:`allreduce_obj` with a ``timeout``) then
        tells a slow peer (:class:`ChannelTimeout`) from a dead one
        (:class:`PeerDeadError`) by the age of the peer's heartbeat
        against ``stall_timeout``.  Returns the started
        :class:`~chainermn_tpu_torch.utils.failure.Heartbeat` (stop it at
        teardown)."""
        hb = Heartbeat(os.path.join(directory,
                                    'heartbeat-%d.json' % self.world_rank),
                       interval=interval).start()
        self._liveness = {'dir': directory, 'timeout': stall_timeout,
                          'enabled_at': time.monotonic()}
        self._heartbeat = hb
        # the doctor pairs this capture's flight records with these beats
        rec = _telemetry.active()
        if rec is not None:
            rec.liveness_dir = os.path.abspath(directory)
            _telemetry.event('liveness_enabled', kind='liveness',
                             dir=rec.liveness_dir, interval=interval,
                             stall_timeout=stall_timeout)
        return hb

    def peer_state(self, process_index):
        """``'alive'`` / ``'dead'`` / ``'unknown'`` for a peer, from its
        heartbeat file: ``'unknown'`` when liveness was never enabled, or
        when the peer's file has not appeared yet within the start-up
        grace (a peer slow to write its first beat is not dead)."""
        live = self._liveness
        if live is None:
            return 'unknown'
        if process_index == self.world_rank:
            return 'alive'
        path = os.path.join(live['dir'], 'heartbeat-%d.json' % process_index)
        if not os.path.exists(path):
            grace_over = (time.monotonic() - live['enabled_at']
                          > live['timeout'])
            return 'dead' if grace_over else 'unknown'
        return 'dead' if detect_stall(path, live['timeout']) else 'alive'

    def _raise_if_peer_dead(self, process_index, doing):
        if self.peer_state(process_index) == 'dead':
            raise PeerDeadError(
                '%s: peer process %d is dead (heartbeat stalled past '
                '%.1fs)' % (doing, process_index, self._liveness['timeout']),
                process_index=process_index)

    def barrier(self, timeout=60.0, tag='barrier'):
        """Bounded rendezvous of all processes: each must arrive within
        ``timeout`` seconds, else the wait fails typed:
        :class:`PeerDeadError` naming a peer whose heartbeat stalled
        (after :meth:`enable_peer_liveness`), else
        :class:`ChannelTimeout` naming the tag, the epoch and how many
        arrived.  Epochs are counted per tag; in a world of one it
        returns at once."""
        if self.world_size == 1:
            return
        n = self._barrier_epochs[tag] = self._barrier_epochs.get(tag, 0) + 1
        with _telemetry.span('barrier', kind='collective', tag=tag, seq=n):
            self._barrier_impl(timeout, tag, n)

    def _barrier_impl(self, timeout, tag, n):
        store = self._store()
        key = '%s/barrier/%s/%s/%d' % (_KEYS, self._channel, tag, n)
        # the last to arrive opens the barrier for all
        if store.add(key, 1) == self.world_size:
            store.set(key + '/open', b'1')

        def check_peers():
            for p in range(self.world_size):
                self._raise_if_peer_dead(
                    p, 'barrier %r epoch %d' % (tag, n))

        if not self._wait_key(store, key + '/open', Deadline(timeout),
                              Backoff(initial=0.05, max_delay=1.0),
                              between=check_peers):
            raise ChannelTimeout(
                'barrier %r epoch %d: %d of %d processes arrived within '
                '%.1fs' % (tag, n, store.add(key, 0), self.world_size,
                           timeout))

    def send_obj(self, obj, dest, tag=0, channel=None, timeout=30.0):
        """Ship a picklable object to process ``dest``; messages are FIFO
        per (source, dest, tag, channel).  A publish that fails is
        retried with backoff until ``timeout`` seconds, then raises
        :class:`ChannelTimeout` with the send cursor NOT advanced (the
        call can be issued again); a retry that finds the key already
        there counts the earlier attempt as delivered.  The receiver
        deletes the key when it takes the message."""
        store = self._store()
        channel = channel or self._channel
        stream = (dest, tag, channel)
        seq = self._send_seq.get(stream, 0)
        key = self._p2p_key(channel, self.world_rank, dest, tag, seq)
        payload = pickle.dumps(obj)
        deadline = Deadline(timeout)
        backoff = Backoff(initial=0.05, max_delay=1.0)
        with _telemetry.span('send_obj', kind='p2p', dest=dest, tag=tag,
                             seq=seq):
            while True:
                try:
                    if chaos._active is not None:
                        chaos.before_send()  # delay_send / drop_send
                    store.set(key, payload)
                    if chaos._active is not None and chaos.duplicate_send():
                        store.set(key, payload)  # at-least-once duplicate
                    break
                except RuntimeError as e:
                    if self._key_state(store, key) == 'present':
                        break
                    if deadline.expired():
                        raise ChannelTimeout(
                            'send_obj to process %d (tag %s seq %d): '
                            'publish kept failing for %.1fs (last: %r)'
                            % (dest, tag, seq, timeout, e)) from e
                    backoff.sleep(deadline)
        self._send_seq[stream] = seq + 1
        self._p2p_sent[key] = (stream, seq, time.monotonic())
        if len(self._p2p_sent) > 128:
            # drop records of messages taken long ago, a few a send
            now = time.monotonic()
            old = sorted((k for k, v in self._p2p_sent.items()
                          if now - v[2] > 60.0),
                         key=lambda k: self._p2p_sent[k][2])[:2]
            for k in old:
                if self._key_state(store, k) == 'absent':
                    del self._p2p_sent[k]

    def recv_obj(self, source, tag=0, timeout=120.0, channel=None):
        """The next object from process ``source`` on (tag, channel).
        The wait polls the store in backoff slices, none past the
        ``timeout`` deadline, and between slices reads the sender's
        heartbeat when :meth:`enable_peer_liveness` armed it: a dead
        sender raises :class:`PeerDeadError` as soon as its heartbeat
        stalls, a message that merely never came :class:`ChannelTimeout`
        at the deadline.  Either way the cursor is NOT advanced, so the
        call can be retried."""
        if chaos._active is not None:
            chaos.on_recv()  # kill_recv
        store = self._store()
        channel = channel or self._channel
        stream = (source, tag, channel)
        seq = self._recv_seq.get(stream, 0)
        key = self._p2p_key(channel, source, self.world_rank, tag, seq)
        with _telemetry.span('recv_obj', kind='p2p', source=source,
                             tag=tag, seq=seq):
            arrived = self._wait_key(
                store, key, Deadline(timeout),
                Backoff(initial=0.1, max_delay=2.0),
                between=lambda: self._raise_if_peer_dead(
                    source, 'recv_obj(source=%d, tag=%s, seq=%d)'
                    % (source, tag, seq)))
        if not arrived:
            raise ChannelTimeout(
                'recv_obj from process %d (tag %s seq %d): nothing arrived '
                'within %.1fs' % (source, tag, seq, timeout))
        payload = store.get(key)
        # delete before advancing the cursor: the sender's p2p_gc takes
        # a key still there for one never delivered
        store.delete_key(key)
        self._recv_seq[stream] = seq + 1
        return pickle.loads(payload)

    def p2p_gc(self, grace=0.0, timeout=None):
        """Delete the keys this process sent that no receiver took, for
        streams whose outstanding keys are ALL older than ``grace``
        seconds (a stream with a younger key is left whole), and roll
        each swept stream's send cursor back to its first swept slot, so
        a re-send lands where the receiver still waits.  ``grace=0``
        sweeps everything: use it only when no receiver can be inside
        ``recv_obj`` (the store has no atomic get-and-delete).
        ``timeout`` (seconds) bounds the sweep; records left unswept are
        kept for a later pass.  Nothing sweeps on its own: a key that no
        receiver takes stays in the store until this runs or the group's
        store ends with the job."""
        if not self._p2p_sent or not dist.is_initialized():
            return
        deadline = Deadline(timeout)
        now = time.monotonic()
        young = {v[0] for v in self._p2p_sent.values() if now - v[2] < grace}
        old = {k: v for k, v in self._p2p_sent.items() if v[0] not in young}
        store = self._store()
        swept = {}
        for key in sorted(old):
            if deadline.expired():
                break
            stream, seq, _ = old[key]
            state = self._key_state(store, key)
            if state == 'unknown':
                continue
            if state == 'present':
                try:
                    store.delete_key(key)
                except RuntimeError:
                    continue
                swept[stream] = min(swept.get(stream, seq), seq)
            del self._p2p_sent[key]
        for stream, seq in swept.items():
            self._send_seq[stream] = min(self._send_seq.get(stream, seq),
                                         seq)

    def __repr__(self):
        return '%s(rank=%d, size=%d, inter=%d, intra=%d, device=%s)' % (
            type(self).__name__, self.rank, self.size, self.inter_size,
            self.intra_size, self.device)
