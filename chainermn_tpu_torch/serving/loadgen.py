"""Synthetic open-loop load generators for the serving engines
(:func:`open_loop` for the batch :class:`InferenceEngine`,
:func:`open_loop_generate` for the :class:`GenerationEngine`).

Counterpart of ``chainermn_tpu/serving/loadgen.py``.  Open loop: request
``i`` is submitted at ``t0 + i / rate`` whatever the engine is doing;
when the engine falls behind, the bounded queue fills and submissions
shed with the typed ``OverloadError``, which is the measurement, not a
failure: the report separates served throughput and latency from the
shed fraction.

Determinism: the size mix (and the prompts) come from
``np.random.RandomState(seed)``, drawn in the JAX package's order, so
both packages offer the same requests for the same ``(seed, rate, n)``.
Latency percentiles come from the telemetry registry's raw-sample
histograms.  The chaos site ``serve_longprompt`` and the live SLO monitor
(``slo_monitor=``) are ROADMAP.md A9.
"""

import threading
import time

import numpy as np

from chainermn_tpu_torch import telemetry as _telemetry
from chainermn_tpu_torch.utils.failure import OverloadError


def _hist_summary(reg, name):
    if reg is None:
        return {}
    snap = reg.snapshot().get(name)
    return (snap or {}).get('summary') or {}


def _worst_request(recorder):
    """The worst traced request's stage decomposition from the live
    recorder's records (``report.request_summary``): a bad p99 names its
    stage.  None when nothing was traced."""
    if recorder is None:
        return None
    from chainermn_tpu_torch.telemetry.report import request_summary
    summary = request_summary(list(recorder.events))
    if not summary:
        return None
    return {'e2e_ms': summary.get('e2e_ms'),
            'stage_p99_ms': summary.get('stage_p99_ms'),
            'worst': summary.get('worst'),
            'completed': summary.get('completed'),
            'shed': summary.get('shed')}


def _ms(summary, key):
    return (summary.get(key) or 0.0) * 1e3 if summary else None


def _window(engine, queue, submit_all, result_timeout, clock, capture_dir):
    """Run ``engine.run`` on a thread of its own, call ``submit_all()``
    (the arrivals), wait for every admitted request, and stop the worker.
    Telemetry is enabled in memory for the window when it was off.
    Returns ``(admitted, shed_submit, counts, t0, t1, registry, worst)``
    with ``counts`` the served / deadline-shed / errored requests and
    the tokens served."""
    installed = _telemetry.active() is None
    recorder = _telemetry.enable()
    stop = threading.Event()
    worker = threading.Thread(target=engine.run, args=(queue, stop),
                              daemon=True)
    worker.start()
    try:
        t0 = clock()
        admitted, shed_submit = submit_all(t0)
        counts = dict(served=0, shed_deadline=0, errored=0, tokens=0)
        for req in admitted:
            try:
                out = req.result(timeout=result_timeout)
                counts['served'] += 1
                counts['tokens'] += len(out)
            except OverloadError:
                counts['shed_deadline'] += 1
            except Exception:
                counts['errored'] += 1
        t1 = clock()
        reg = _telemetry.registry()
    finally:
        stop.set()
        worker.join(timeout=result_timeout)
        queue.close()
        if capture_dir is not None:
            recorder.flush(capture_dir)
        worst = _worst_request(recorder)
        if installed:
            _telemetry.disable()
    if worker.is_alive():
        raise RuntimeError('the serving worker did not stop within %rs'
                           % result_timeout)
    return admitted, shed_submit, counts, t0, t1, reg, worst


def _arrivals(rate, n, clock):
    """Yield ``i`` at ``t0 + i / rate``, sleeping until each arrival."""
    def gen(t0):
        for i in range(n):
            delay = t0 + i / float(rate) - clock()
            if delay > 0:
                time.sleep(delay)
            yield i
    return gen


def open_loop_generate(engine, queue, rate, n_requests, seed=0,
                       prompt_len_range=None, max_new_tokens=16,
                       vocab_size=None, deadline_s=None,
                       result_timeout=60.0, clock=time.monotonic,
                       capture_dir=None, slo_monitor=None):
    """Open-loop driver for the :class:`GenerationEngine`: the unit of
    work is a sequence and the report's currency tokens -- generated
    tokens/s over the serve window, time to first token, inter-token time
    and decode-step p50 / p99 from the telemetry histograms.  The engine
    (idle) is warmed first, so that every bucket's graph is captured
    before the window.

    Args:
      rate: offered request rate (req/s).
      prompt_len_range: ``(lo, hi)`` inclusive prompt-length mix (default
        ``(1, engine.max_prompt_len)``).
      max_new_tokens: tokens to generate per request.
      vocab_size: token-id range of the synthetic prompts (default the
        engine model's).
      deadline_s: per-request deadline (expiry mid-generation sheds
        typed).
      slo_monitor: not ported (ROADMAP.md A9); must be None.
    """
    if slo_monitor is not None:
        raise NotImplementedError('the live SLO monitor is not ported yet '
                                  '(ROADMAP.md A9)')
    lo, hi = prompt_len_range or (1, engine.max_prompt_len)
    vocab = vocab_size or engine.model.vocab_size
    rng = np.random.RandomState(seed)
    lens = rng.randint(lo, hi + 1, size=n_requests)
    prompts = [rng.randint(0, vocab, size=n).astype(np.int32) for n in lens]
    arrivals = _arrivals(rate, n_requests, clock)

    def submit_all(t0):
        admitted, shed = [], 0
        for i in arrivals(t0):
            try:
                admitted.append(queue.submit(
                    prompts[i], max_new_tokens,
                    deadline=(None if deadline_s is None
                              else clock() + deadline_s)))
            except OverloadError:
                shed += 1
        return admitted, shed

    # every bucket captured (or run once) before the window, so that no
    # capture is paid inside it
    engine.warmup()
    st0 = engine.stats()
    admitted, shed_submit, c, t0, t1, reg, worst = _window(
        engine, queue, submit_all, result_timeout, clock, capture_dir)
    ttft = _hist_summary(reg, 'serve_ttft_seconds')
    itl = _hist_summary(reg, 'serve_intertoken_seconds')
    dstep = _hist_summary(reg, 'serve_decode_seconds')
    st = engine.stats()
    wall = max(t1 - t0, 1e-9)
    offered = int(n_requests)
    shed = shed_submit + c['shed_deadline']
    return {
        'offered': offered,
        'longprompt_injected': 0,
        'offered_rate': float(rate),
        'admitted': len(admitted),
        'served': c['served'],
        'shed_submit': shed_submit,
        'shed_deadline': c['shed_deadline'],
        'errored': c['errored'],
        'shed_fraction': shed / float(offered) if offered else 0.0,
        'served_req_per_s': c['served'] / wall,
        'tokens_served': c['tokens'],
        'tokens_generated': (st['tokens_generated']
                             - st0['tokens_generated']),
        'tokens_per_s': c['tokens'] / wall,
        'wall_s': wall,
        'ttft_p50_ms': _ms(ttft, 'p50'),
        'ttft_p99_ms': _ms(ttft, 'p99'),
        'intertoken_p50_ms': _ms(itl, 'p50'),
        'intertoken_p99_ms': _ms(itl, 'p99'),
        'decode_step_p50_ms': _ms(dstep, 'p50'),
        'decode_step_p99_ms': _ms(dstep, 'p99'),
        'prefills': st['prefills'] - st0['prefills'],
        'decode_steps': st['decode_steps'] - st0['decode_steps'],
        'cancelled': st['cancelled'] - st0['cancelled'],
        'compile_count': st['compile_count'],
        'prefill_trace_count': st['prefill_trace_count'],
        'decode_trace_count': st['decode_trace_count'],
        'aot': st['aot'],
        'int8_kv': st['int8_kv'],
        'quantized': st['quantized'],
        'n_slots': st['n_slots'],
        'paged': ({k: st.get(k) for k in (
            'page_size', 'n_pages', 'pages_in_use', 'pages_free',
            'peak_pages_in_use', 'prefill_chunk', 'prefill_chunks',
            'cow_copies', 'copy_trace_count', 'prefix_lookups',
            'prefix_hits', 'prefix_hit_rate', 'prefix_tokens_reused')}
                  if st.get('paged') else None),
        'worst_request': worst,
        'speculative': _spec_report(st, st0),
        'slo': None,
    }


def _spec_report(st, st0):
    """The speculative slice of a generate report: windowed deltas of the
    draft / verify accounting, ``accepted_draft_rate`` and
    ``verify_per_token``; None on a non-speculative engine."""
    spec, spec0 = st.get('speculative'), st0.get('speculative')
    if not spec:
        return None
    spec0 = spec0 or {}
    proposed = spec['draft_proposed'] - spec0.get('draft_proposed', 0)
    accepted = spec['draft_accepted'] - spec0.get('draft_accepted', 0)
    verify_steps = spec['verify_steps'] - spec0.get('verify_steps', 0)
    tokens = st['tokens_generated'] - st0['tokens_generated']
    return {
        'spec_tokens': spec['spec_tokens'],
        'draft_steps': spec['draft_steps'] - spec0.get('draft_steps', 0),
        'verify_steps': verify_steps,
        'draft_proposed': proposed,
        'draft_accepted': accepted,
        'accepted_draft_rate': accepted / proposed if proposed else None,
        'verify_per_token': verify_steps / tokens if tokens else None,
        'draft_trace_count': spec['draft_trace_count'],
        'verify_trace_count': spec['verify_trace_count'],
    }


def open_loop(engine, queue, rate, n_requests, seed=0,
              max_request_items=None, deadline_s=None, result_timeout=30.0,
              clock=time.monotonic, capture_dir=None):
    """Drive ``engine`` through ``queue`` with an open-loop arrival process
    and return the serving report.

    Args:
      rate: offered request rate (req/s); arrivals at ``i / rate``.
      n_requests: total offered requests.
      seed: request-size mix seed (sizes uniform in ``[1,
        max_request_items]``).
      max_request_items: per-request item cap (default half the queue's
        ``max_batch``, so coalescing has something to do).
      deadline_s: per-request deadline; expired requests shed typed.
      result_timeout: drain allowance after the last arrival.
      capture_dir: when set, the telemetry window is flushed there.

    Returns offered / admitted / served / shed counts and fractions,
    req/s over the serve window, latency and queue-wait p50 / p99 (ms,
    from raw-sample histograms), the pad-waste fraction, the bucket hit
    rate, and the engine's capture accounting.
    """
    max_items = max_request_items or max(1, queue.max_batch // 2)
    rng = np.random.RandomState(seed)
    sizes = rng.randint(1, max_items + 1, size=n_requests).astype(int)
    item_shape = engine._item_shape
    if engine._in_dtype.is_floating_point:
        payload = rng.rand(max_items, *item_shape).astype(np.float32)
    else:
        payload = rng.randint(0, 2, size=(max_items,) + item_shape)
    arrivals = _arrivals(rate, n_requests, clock)

    def submit_all(t0):
        admitted, shed = [], 0
        for i in arrivals(t0):
            try:
                admitted.append(queue.submit(
                    payload[:sizes[i]],
                    deadline=(None if deadline_s is None
                              else clock() + deadline_s)))
            except OverloadError:
                shed += 1
        return admitted, shed

    compiles_before = engine.compile_count
    admitted, shed_submit, c, t0, t1, reg, worst = _window(
        engine, queue, submit_all, result_timeout, clock, capture_dir)
    lat = _hist_summary(reg, 'serve_latency_seconds')
    wait = _hist_summary(reg, 'serve_queue_wait')
    pad = _hist_summary(reg, 'serve_pad_waste')
    st = engine.stats()
    wall = max(t1 - t0, 1e-9)
    offered = int(n_requests)
    shed = shed_submit + c['shed_deadline']
    return {
        'offered': offered,
        'offered_rate': float(rate),
        'admitted': len(admitted),
        'served': c['served'],
        'shed_submit': shed_submit,
        'shed_deadline': c['shed_deadline'],
        'errored': c['errored'],
        'shed_fraction': shed / float(offered) if offered else 0.0,
        'served_req_per_s': c['served'] / wall,
        'wall_s': wall,
        'latency_p50_ms': _ms(lat, 'p50'),
        'latency_p99_ms': _ms(lat, 'p99'),
        'queue_wait_p50_ms': _ms(wait, 'p50'),
        'queue_wait_p99_ms': _ms(wait, 'p99'),
        'pad_waste_fraction': pad.get('mean') if pad else None,
        # executions that reused a graph captured before the window (a
        # miss is a capture during traffic)
        'bucket_hit_rate': (
            (st['executions'] - max(0, st['compile_count']
                                    - compiles_before))
            / float(st['executions']) if st['executions'] else None),
        'buckets_compiled': len(st['buckets']),
        'compile_count': st['compile_count'],
        'trace_count': st['trace_count'],
        'executions': st['executions'],
        'aot': st['aot'],
        'quantized': st['quantized'],
        'worst_request': worst,
    }
