"""Recording fake communicator for cross-rank protocol verification.

Counterpart of ``chainermn_tpu/communicators/recording.py``.
:class:`RecordingCommunicator` mirrors the EAGER protocol surface of
:class:`~chainermn_tpu_torch.communicators.base.CommunicatorBase`
(``barrier`` / ``allreduce_obj`` / ``broadcast_data`` / ``send_obj`` /
``recv_obj``) but performs NO communication: every call appends one
``(op, kind, peer, tag, seq)`` record to ``self.records``, numbered as
the port's object channel numbers its calls:

* ``barrier``: a 1-based epoch counter per tag (``_barrier_epochs``),
* ``allreduce_obj`` / ``broadcast_data``: a 0-based counter per name
  (``_next_eager_seq``),
* ``send_obj`` / ``recv_obj``: 0-based cursors per (peer, tag,
  channel), and the channel's own key format
  (``chainermn_tpu_torch/p2p/<channel>/<src>/<dest>/<tag>/<seq>``), so
  the matcher in :mod:`chainermn_tpu_torch.analysis.commcheck` reasons
  about the keys the store would hold -- the seq-0 collision of a
  communicator rebuilt over a live channel included.

:func:`simulate_protocol` drives one protocol function once per
simulated rank and hands the per-rank record streams to
``commcheck.verify_streams`` / ``commcheck.match_p2p``.
"""

P2P_KEY_FMT = 'chainermn_tpu_torch/p2p/%s/%d/%d/%s/%d'


class RecordingCommunicator:
    """A fake eager communicator that logs instead of communicating.

    Args:
      rank: the simulated process index this instance plays.
      size: the simulated process count (world size).
      channel: the p2p channel namespace (the real communicator takes
        ``c<k>`` from its place among the communicators its process
        made; any stable string works here).
      records: share another instance's record list -- what
        :meth:`rebuilt` uses to model a communicator rebuilt over the
        same channel.
    """

    def __init__(self, rank, size, channel='sim', records=None):
        self.rank = int(rank)
        self.size = int(size)
        self.channel = channel
        self.records = records if records is not None else []
        self._eager_coll_seq = {}
        self._barrier_epochs = {}
        self._send_seq = {}
        self._recv_seq = {}

    @property
    def world_rank(self):
        return self.rank

    @property
    def world_size(self):
        return self.size

    def rebuilt(self):
        """A fresh communicator over the SAME channel with its counters
        reset: its first ``send_obj`` reuses a key already published
        (the hazard a communicator rebuilt mid-conversation meets)."""
        return RecordingCommunicator(self.rank, self.size,
                                     channel=self.channel,
                                     records=self.records)

    def _rec(self, **kw):
        kw['rank'] = self.rank
        self.records.append(kw)
        return kw

    def _next_eager_seq(self, name):
        n = self._eager_coll_seq.get(name, 0)
        self._eager_coll_seq[name] = n + 1
        return n

    # -- eager collectives ---------------------------------------------
    def barrier(self, timeout=60.0, tag='barrier'):
        if self.size == 1:
            return
        n = self._barrier_epochs[tag] = self._barrier_epochs.get(tag, 0) + 1
        self._rec(op='barrier', kind='collective', tag=tag, seq=n)

    def allreduce_obj(self, value, op='mean', timeout=None):
        if self.size == 1:
            return value
        if timeout is not None:
            self.barrier(timeout=timeout, tag='allreduce_obj')
        self._rec(op='allreduce_obj', kind='collective', tag=None,
                  seq=self._next_eager_seq('allreduce_obj'), detail=op)
        return value

    def broadcast_data(self, params, root=0):
        # recorded for the stream comparison; the matcher does not treat
        # it as a blocking rendezvous
        self._rec(op='broadcast_data', kind='collective', tag=None,
                  seq=self._next_eager_seq('broadcast_data'), detail=root)
        return params

    # -- eager p2p ------------------------------------------------------
    def send_obj(self, obj, dest, tag=0, channel=None, timeout=30.0):
        dest = int(dest)
        channel = channel or self.channel
        stream = (dest, tag, channel)
        seq = self._send_seq.get(stream, 0)
        self._rec(op='send_obj', kind='p2p', peer=dest, tag=tag, seq=seq,
                  channel=channel,
                  key=P2P_KEY_FMT % (channel, self.rank, dest, tag, seq))
        self._send_seq[stream] = seq + 1

    def recv_obj(self, source, tag=0, timeout=120.0, channel=None):
        source = int(source)
        channel = channel or self.channel
        stream = (source, tag, channel)
        seq = self._recv_seq.get(stream, 0)
        self._rec(op='recv_obj', kind='p2p', peer=source, tag=tag, seq=seq,
                  channel=channel,
                  key=P2P_KEY_FMT % (channel, source, self.rank, tag, seq))
        self._recv_seq[stream] = seq + 1
        return None


def simulate_protocol(protocol, world_size, channel='sim'):
    """``{rank: [record, ...]}`` from running ``protocol(comm)`` once per
    simulated rank of a ``world_size`` world.

    Each rank gets a fresh :class:`RecordingCommunicator`; the protocol
    sees the eager surface (``comm.rank`` / ``comm.size`` /
    ``comm.barrier`` / ...), so real protocol code runs against it
    unchanged.  A Python branch on ``comm.rank`` that adds or reorders a
    collective shows as diverging streams, which
    ``commcheck.verify_streams`` reports as SL013.
    """
    streams = {}
    for rank in range(world_size):
        comm = RecordingCommunicator(rank, world_size, channel=channel)
        protocol(comm)
        streams[rank] = comm.records
    return streams
