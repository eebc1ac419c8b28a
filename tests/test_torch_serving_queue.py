"""The port's batch queue and telemetry core against the JAX package.

``bucket_edges`` / ``bucket_of`` / ``pack_sizes``, the ``RequestQueue``
(bounded admission, deadlines, the typed shed, packing through ``take``),
request ids and shed records, and the telemetry core (the histograms'
nearest-rank percentiles, the registry's Prometheus text, the request
traces rebuilt from the records): each on the same inputs, built from a
seed with numpy, through both packages.
"""

import itertools
import time

import numpy as np
import pytest
import torch

from chainermn_tpu import serving as jserving
from chainermn_tpu import telemetry as jtelemetry
from chainermn_tpu.telemetry import recorder as jrecorder
from chainermn_tpu.telemetry import report as jreport
from chainermn_tpu_torch import serving, telemetry
from chainermn_tpu_torch.serving import (OverloadError, RequestQueue,
                                         bucket_edges, bucket_of,
                                         pack_sizes)
from chainermn_tpu_torch.telemetry import recorder, report

torch.set_num_threads(2)


@pytest.fixture
def recording():
    """An in-memory telemetry session of the port, removed after."""
    rec = telemetry.enable()
    yield rec
    telemetry.disable()


# ---------------------------------------------------------------------
# buckets + packing

class TestBuckets:
    @pytest.mark.parametrize('max_batch', [1, 2, 5, 16, 24, 32])
    def test_edges_equal_the_jax_edges(self, max_batch):
        assert bucket_edges(max_batch) == jserving.bucket_edges(max_batch)

    def test_edges_power_of_two_up_to_max(self):
        assert bucket_edges(32) == (1, 2, 4, 8, 16, 32)
        assert bucket_edges(24) == (1, 2, 4, 8, 16, 24)
        assert bucket_edges(1) == (1,)

    def test_bucket_of_smallest_fit(self):
        edges = bucket_edges(16)
        for n in range(1, 17):
            assert bucket_of(n, edges) == jserving.bucket_of(n, edges)
        assert bucket_of(3, edges) == 4

    def test_bucket_of_oversize_and_degenerate_typed(self):
        with pytest.raises(ValueError, match='exceeds the largest'):
            bucket_of(17, bucket_edges(16))
        with pytest.raises(ValueError):
            bucket_of(0, bucket_edges(16))


class TestPackingDeterminism:
    @pytest.mark.parametrize('seed', range(6))
    def test_pack_sizes_equals_jax_in_any_order(self, seed):
        """The same groups and buckets as the JAX packing, for the same
        sizes in several arrival orders, and the same multiset of
        (bucket, sizes) groups whatever the order."""
        rng = np.random.RandomState(seed)
        edges = bucket_edges(16)
        sizes = list(rng.randint(1, 17, size=12))
        ref = None
        for _ in range(4):
            order = list(rng.permutation(len(sizes)))
            arrived = [sizes[i] for i in order]
            got = pack_sizes(arrived, 16, edges)
            assert got == jserving.pack_sizes(arrived, 16, edges)
            groups = sorted((b, sorted(arrived[i] for i in m))
                            for b, m in got)
            ref = ref or groups
            assert groups == ref

    def test_distinct_sizes_any_order_identical_assignment(self):
        edges = bucket_edges(16)
        mix = [7, 3, 5, 1, 9, 2]
        ref = None
        for perm in itertools.islice(itertools.permutations(range(6)),
                                     0, 720, 97):
            sizes = [mix[i] for i in perm]
            packed = pack_sizes(sizes, 16, edges)
            assign = {sizes[i]: bucket
                      for bucket, members in packed for i in members}
            shapes = sorted(b for b, _ in packed)
            ref = ref or (assign, shapes)
            assert (assign, shapes) == ref

    def test_degenerate_and_oversize(self):
        assert pack_sizes([3], 16, bucket_edges(16)) == [(4, [0])]
        assert sorted(b for b, _ in pack_sizes([4, 4, 4], 8,
                                               bucket_edges(8))) == [4, 8]
        with pytest.raises(ValueError, match='exceeds max_batch'):
            pack_sizes([17], 16, bucket_edges(16))

    def test_groups_never_exceed_max_batch(self):
        rng = np.random.RandomState(0)
        edges = bucket_edges(16)
        for _ in range(20):
            sizes = list(rng.randint(1, 17, size=12))
            for bucket, members in pack_sizes(sizes, 16, edges):
                total = sum(sizes[i] for i in members)
                assert total <= 16 and bucket == bucket_of(total, edges)

    @pytest.mark.parametrize('seed', range(3))
    def test_take_gives_the_jax_queues_batches(self, seed):
        """The real queues: the same payloads submitted in the same
        (shuffled) order give the same packed batches -- members,
        buckets, padded shapes and masks -- in both packages, and the
        port's shapes do not depend on the order."""
        rng = np.random.RandomState(10 + seed)
        sizes = list(rng.randint(1, 9, size=7))

        def drain(queue_cls, order):
            q = queue_cls(max_batch=16, max_wait=0.0, max_queue=64)
            reqs = [q.submit(np.full((sizes[i], 3), i, np.float32))
                    for i in order]
            out = []
            for pb in q.take(timeout=0.5):
                x, mask = pb.collate()
                assert x.shape[0] == pb.bucket and mask.sum() == pb.total
                out.append((pb.bucket, [reqs.index(r) for r in pb.requests],
                            np.asarray(x).tolist(), np.asarray(mask).tolist()))
            return out

        shapes = None
        for _ in range(3):
            order = list(rng.permutation(len(sizes)))
            got = drain(RequestQueue, order)
            assert got == drain(jserving.RequestQueue, order)
            this = sorted((b, len(x)) for b, _, x, _ in got)
            shapes = shapes or this
            assert this == shapes


# ---------------------------------------------------------------------
# queue admission

class TestRequestQueue:
    def test_coalesces_into_buckets(self):
        q = RequestQueue(max_batch=8, max_wait=0.0, max_queue=64)
        for n in (3, 2):
            q.submit(np.ones((n, 4), np.float32))
        batches = q.take(timeout=0.5)
        assert len(batches) == 1
        assert batches[0].bucket == 8 and batches[0].total == 5
        x, mask = batches[0].collate()
        assert x.shape == (8, 4)
        assert mask.tolist() == [1, 1, 1, 1, 1, 0, 0, 0]
        assert batches[0].pad_waste() == 3 / 8.0

    def test_collate_casts_to_a_torch_dtype_on_the_host(self):
        q = RequestQueue(max_batch=4, max_wait=0.0, max_queue=8)
        q.submit(np.ones((3, 2), np.float32))
        (pb,) = q.take(timeout=0.5)
        x, mask = pb.collate(dtype=torch.bfloat16)
        assert x.dtype == torch.bfloat16 and x.device.type == 'cpu'
        assert mask.dtype == torch.float32 and float(mask.sum()) == 3

    def test_bounded_queue_sheds_typed(self):
        q = RequestQueue(max_batch=4, max_wait=10.0, max_queue=4)
        for _ in range(4):
            q.submit(np.zeros((1, 2), np.float32))
        with pytest.raises(OverloadError) as ei:
            q.submit(np.zeros((1, 2), np.float32))
        assert ei.value.reason == 'queue_full'
        assert ei.value.queue_depth == 4
        assert q.shed_queue_full == 1
        with pytest.raises(ValueError, match='could never fill'):
            RequestQueue(max_batch=8, max_queue=4)

    def test_deadline_expired_sheds_typed_at_drain(self):
        clock = [0.0]
        q = RequestQueue(max_batch=4, max_wait=0.0, max_queue=16,
                         clock=lambda: clock[0])
        req = q.submit(np.zeros((1, 2), np.float32), deadline=0.5)
        live = q.submit(np.zeros((1, 2), np.float32))
        clock[0] = 1.0
        batches = q.take(timeout=0.1)
        with pytest.raises(OverloadError) as ei:
            req.result(timeout=0)
        assert ei.value.reason == 'deadline'
        assert [r for b in batches for r in b.requests] == [live]
        assert q.stats()['shed_deadline'] == 1

    def test_oversize_submit_rejected_before_queueing(self):
        q = RequestQueue(max_batch=4, max_queue=16)
        with pytest.raises(ValueError, match='exceeds the largest'):
            q.submit(np.zeros((5, 2), np.float32))
        assert q.depth() == 0

    def test_close_sheds_pending_shutdown(self):
        q = RequestQueue(max_batch=8, max_wait=60.0, max_queue=16)
        req = q.submit(np.zeros((1, 2), np.float32))
        q.close()
        with pytest.raises(OverloadError) as ei:
            req.result(timeout=0)
        assert ei.value.reason == 'shutdown'
        with pytest.raises(OverloadError):
            q.submit(np.zeros((1, 2), np.float32))
        assert q.take(timeout=0.01) == []

    def test_max_wait_triggers_partial_batch(self):
        q = RequestQueue(max_batch=64, max_wait=0.01, max_queue=128)
        q.submit(np.zeros((2, 3), np.float32))
        t0 = time.monotonic()
        batches = q.take(timeout=1.0)
        assert batches and batches[0].total == 2
        assert time.monotonic() - t0 < 0.5

    def test_take_times_out_empty(self):
        q = RequestQueue(max_batch=4, max_queue=8)
        assert q.take(timeout=0.01) == []

    def test_request_ids_unique_monotonic_shared_and_passed_through(self):
        g = serving.GenerationQueue(max_prompt_len=4)
        ids = [g.submit([1], 2).request_id for _ in range(4)]
        nums = [int(i[1:]) for i in ids]
        assert len(set(ids)) == 4 and nums == sorted(nums)
        rq = RequestQueue(max_batch=4)
        assert int(rq.submit(np.zeros((1, 3))).request_id[1:]) > nums[-1]
        assert rq.submit(np.zeros((1, 3)),
                         request_id='r777').request_id == 'r777'
        assert g.submit([1], 2, request_id='r778').request_id == 'r778'
        assert sorted(['r10', 'x', 'r9'], key=serving.admission_order) \
            == sorted(['r10', 'x', 'r9'], key=jserving.admission_order)

    def test_shed_records_carry_forensics(self, recording):
        """queue_full, deadline and shutdown sheds of both queues record a
        ``shed`` request event with the id, reason and queue depth, and
        bump the per-reason counters (shutdown outside the total)."""
        clock = [0.0]
        q = RequestQueue(max_batch=1, max_wait=0.0, max_queue=1,
                         clock=lambda: clock[0], label='rep-1')
        q.submit(np.zeros((1, 2)), deadline=0.5)
        with pytest.raises(OverloadError):
            q.submit(np.zeros((1, 2)))
        clock[0] = 1.0
        assert q.take(timeout=0.01) == []
        g = serving.GenerationQueue(max_prompt_len=4)
        g.submit([1], 2)
        g.close()
        sheds = [e for e in recording.events
                 if e.get('kind') == 'request' and e['name'] == 'shed']
        assert [e['reason'] for e in sheds] == ['queue_full', 'deadline',
                                                'shutdown']
        assert sheds[0]['queue_depth'] == 1 and sheds[0]['request_id']
        assert sheds[0]['replica'] == 'rep-1'
        assert sheds[1]['waited_ms'] >= 500.0
        snap = recording.registry.snapshot()
        assert snap['serve_shed_total']['value'] == 2.0
        assert snap['serve_shed_shutdown_total']['value'] == 1.0


# ---------------------------------------------------------------------
# the telemetry core

class TestTelemetryCore:
    @pytest.mark.parametrize('n', [1, 2, 7, 100, 1001])
    def test_percentiles_equal_the_references(self, n):
        rng = np.random.RandomState(n)
        vals = sorted(float(v) for v in rng.exponential(size=n))
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert recorder._percentile(vals, q) \
                == jrecorder._percentile(vals, q)
        assert recorder._percentile([], 0.5) is None
        h, jh = recorder.Histogram('h'), jrecorder.Histogram('h')
        for v in rng.permutation(vals):
            h.observe(v)
            jh.observe(v)
        assert h.summary() == jh.summary()

    def test_registry_snapshot_and_prometheus_equal_the_references(self):
        rng = np.random.RandomState(0)
        ours, theirs = recorder.Registry(), jrecorder.Registry()
        for reg in (ours, theirs):
            reg.counter('serve_requests_total', help='a "count"\\n').inc(3)
            reg.gauge('active_slots').set(5)
            reg.gauge('unset')
        samples = rng.rand(50)
        for v in samples:
            ours.histogram('serve_latency_seconds', help='lat').observe(v)
            theirs.histogram('serve_latency_seconds', help='lat').observe(v)
        assert ours.snapshot() == theirs.snapshot()
        assert ours.to_prometheus() == theirs.to_prometheus()
        snap = ours.snapshot()
        snap['x'] = {'type': 'counter', 'value': 1.0,
                     'labels': {'replica': 'a"b\\c\nd'}}
        assert recorder.snapshot_to_prometheus(snap) \
            == jrecorder.snapshot_to_prometheus(snap)
        with pytest.raises(TypeError):
            ours.gauge('serve_requests_total')

    def test_disabled_calls_are_no_ops(self):
        assert telemetry.active() is None and not telemetry.enabled()
        with telemetry.span('x') as sp:
            sp.set(a=1)
            assert sp.sync(3) == 3
        telemetry.event('x')
        telemetry.request_stage('r1', 'queue_wait', 0.0, 1.0)
        telemetry.request_event('r1', 'complete')
        assert telemetry.registry() is None and telemetry.flush() is None

    def test_spans_events_and_flush(self, tmp_path):
        rec = telemetry.enable()
        try:
            assert telemetry.enable(str(tmp_path)) is rec
            with telemetry.span('serve_execute', kind='serve',
                                bucket=4) as sp:
                sp.set(aot=False)
                sp.sync(torch.zeros(1))
            telemetry.event('weight_swap', kind='serve', version=2)
            telemetry.request_stage('r5', 'queue_wait', rec.now() - 1e-3)
            telemetry.registry().counter('c').inc()
            path = telemetry.flush()
        finally:
            telemetry.disable()
        lines = [line for line in open(path)]
        assert '"type": "meta"' in lines[0] and len(lines) == 4
        span = rec.events[0]
        assert span['name'] == 'serve_execute' and span['aot'] is False
        assert span['t1'] >= span['t0'] and 'synced' not in span
        assert (tmp_path / 'metrics-rank0.json').exists()

    def test_request_traces_and_summary_equal_the_references(self):
        """Records of three requests (one shed, one in flight) rebuilt by
        both packages' report functions."""
        t = 100.0
        records = [
            {'type': 'span', 'kind': 'request', 'name': 'queue_wait',
             'request_id': 'r1', 't0': t, 't1': t + 0.002},
            {'type': 'span', 'kind': 'request', 'name': 'bucket_pack',
             'request_id': 'r1', 't0': t + 0.002, 't1': t + 0.0025},
            {'type': 'span', 'kind': 'request', 'name': 'prefill',
             'request_id': 'r1', 't0': t + 0.0025, 't1': t + 0.01},
            {'type': 'span', 'kind': 'request', 'name': 'decode',
             'request_id': 'r1', 't0': t + 0.01, 't1': t + 0.013},
            {'type': 'event', 'kind': 'request', 'name': 'complete',
             'request_id': 'r1', 't': t + 0.013, 'tokens': 2},
            {'type': 'span', 'kind': 'request', 'name': 'queue_wait',
             'request_id': 'r2', 't0': t, 't1': t + 0.001},
            {'type': 'event', 'kind': 'request', 'name': 'shed',
             'request_id': 'r2', 't': t + 0.001, 'reason': 'deadline'},
            {'type': 'span', 'kind': 'request', 'name': 'queue_wait',
             'request_id': 'r3', 't0': t, 't1': t + 0.004},
            {'type': 'span', 'kind': 'serve', 'name': 'serve_execute',
             't0': t, 't1': t + 1},
        ]
        assert report.request_traces(records) \
            == jreport.request_traces(records)
        assert report.request_summary(records) \
            == jreport.request_summary(records)
        assert report.request_summary(records[-1:]) is None
        assert report.REQUEST_STAGES == jreport.REQUEST_STAGES

    def test_live_recorders_trace_the_same_queue_stage(self, recording):
        """A shed through the port's queue and through the JAX queue gives
        the same request record (but for the times and the id)."""
        jrec = jtelemetry.enable()
        try:
            for queue_cls in (RequestQueue, jserving.RequestQueue):
                q = queue_cls(max_batch=1, max_wait=0.0, max_queue=1)
                q.submit(np.zeros((1, 2)))
                with pytest.raises(Exception, match='queue full'):
                    q.submit(np.zeros((1, 2)))
        finally:
            jtelemetry.disable()
        strip = ('t', 'request_id')
        ours = [{k: v for k, v in e.items() if k not in strip}
                for e in recording.events]
        theirs = [{k: v for k, v in e.items() if k not in strip}
                  for e in jrec.events]
        assert ours == theirs
